"""Image classifiers for the im-consistency analysis (whether a classifier
also fires for each hallucinated object); port of
``dropoutdecoding_tpu/evalsuite/im_classifier.py``.  Two producers of
``evalsuite.consistency.image_consistency``'s labels:

1. ``projection`` (no extra weights): the engine's own visual-token ->
   text-token table, the prefill's top-k ids of every visual token's
   logits (``PrefillState.topk_ids``, K2's table on the card; the overlap
   mask reads the same table).  A COCO class fires when the first token of
   any of its synonym words is in it.
2. ``clip`` (a full CLIP checkpoint): zero-shot prompts over the 80 COCO
   classes through ``models/clip_text.py`` and the CLIP vision tower; a
   class fires when its cosine similarity ranks in the top n.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from .chair import _load_synonyms


def coco_class_words(synonyms_path: str | None = None) -> dict:
    """{node word: [surface words]} for the 80 COCO classes, from the
    synonym table CHAIR canonicalizes with, so that the labels are node
    words as ``image_consistency`` compares them."""
    _, inverse = _load_synonyms(synonyms_path)
    by_node = defaultdict(list)
    for word, node in inverse.items():
        by_node[node].append(word)
    return {n: sorted(ws) for n, ws in sorted(by_node.items())}


def class_token_table(tokenizer, class_words: dict) -> dict:
    """{node: set(first token id of ' ' + word and of word)}: the
    mid-sentence BPE form, as class words appear in the projection table."""
    table = {}
    for node, words in class_words.items():
        ids = set()
        for w in words:
            for form in (" " + w, w):
                enc = tokenizer(form, add_special_tokens=False)["input_ids"]
                if enc:
                    ids.add(int(enc[0]))
        table[node] = ids
    return table


def projection_labels(topk_ids, token_table: dict) -> set:
    """The classes whose token ids appear in one image's top-k projection
    table ``topk_ids`` [N, k] (a row of ``PrefillState.topk_ids``)."""
    present = set(torch.as_tensor(topk_ids).reshape(-1).tolist())
    return {node for node, ids in token_table.items() if ids & present}


class ClipZeroShot:
    """CLIP zero-shot over the COCO classes.

    Args:
      vision_cfg, vision_params: ``models/clip_vit`` tower, every layer run.
      post_ln: (weight, bias) of the checkpoint's vision post-layernorm.
      visual_projection: [D, P] (HF ``visual_projection.weight``
        transposed).
      text_cfg, text_params: ``models/clip_text`` tower.
      tokenizer: the CLIP tokenizer (it adds BOS and EOS).
      class_names: node words; the prompts are "a photo of a {name}".
    The towers run where their params are; the text side once, here.
    """

    @torch.no_grad()
    def __init__(self, vision_cfg, vision_params, post_ln, visual_projection, text_cfg,
                 text_params, tokenizer, class_names, prompt="a photo of a {}"):
        from ..models import clip_text

        device = vision_params["patch_embedding"].device
        self.class_names = list(class_names)
        enc = [tokenizer(prompt.format(n))["input_ids"] for n in self.class_names]
        S = max(len(e) for e in enc)
        ids = torch.zeros((len(enc), S), dtype=torch.long)
        eos = torch.tensor([len(e) - 1 for e in enc])
        for i, e in enumerate(enc):
            ids[i, : len(e)] = torch.as_tensor(e)
        t = clip_text.apply(text_cfg, text_params, ids.to(device), eos.to(device)).float()
        self._text_embeds = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        ln_w, ln_b = (torch.as_tensor(x, device=device) for x in post_ln)
        proj = torch.as_tensor(visual_projection, device=device).float()
        self._vision = (vision_cfg, vision_params, (ln_w, ln_b), proj)

    @torch.no_grad()
    def similarities(self, pixel_values) -> np.ndarray:
        """The cosine similarity of one [1, 3, H, W] image to each class
        prompt, [n_classes] on the host."""
        from ..models import clip_vit
        from ..ops.basic import layer_norm

        cfg, params, (ln_w, ln_b), proj = self._vision
        pixels = torch.as_tensor(pixel_values, device=proj.device)
        hidden = clip_vit.apply(cfg, params, pixels, feature_layer=cfg.num_hidden_layers)
        pooled = layer_norm(hidden[:, 0], ln_w, ln_b, cfg.layer_norm_eps).float()
        v = pooled @ proj
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        return (v @ self._text_embeds.T)[0].cpu().numpy()

    def labels(self, pixel_values, top_n: int = 10) -> set:
        """The classes in the top ``top_n`` cosine ranks for one [1, 3, H, W]
        image (COCO scenes hold several objects: a rank set, not an
        argmax)."""
        order = np.argsort(self.similarities(pixel_values))[::-1][:top_n]
        return {self.class_names[i] for i in order}
