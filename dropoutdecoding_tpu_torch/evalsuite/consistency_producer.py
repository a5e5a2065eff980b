"""The inputs of the LM-consistency analysis: the language model's
next-word distribution at each word of a caption under a blank image; port
of ``dropoutdecoding_tpu/evalsuite/consistency_producer.py``.

``evalsuite/consistency.lm_consistency`` reads ``{image_id: {word_idx:
{word: prob}}}``.  The caption is teacher-forced after the prompt with an
all-zero image, so only language priors drive the logits: one prefill
through the engine's merge and ``llama.prefill`` (K2 does not run; nor does
it in JAX, which calls ``llama.prefill`` too), the head at the row before
each caption word's first token, and that row's top ``topk`` tokens as
words.  Each whitespace word is encoded with a leading space (the Llama BPE
mid-sentence form); a word of several tokens is read at its first.
LLaVA-1.5 only, as the JAX CLI's analysis.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import llama as llama_mod


def caption_word_starts(tokenizer, caption: str):
    """([(word, its first token's index in the caption's token stream)],
    the caption's token ids)."""
    words = caption.split()
    tok_ids = []
    starts = []
    for i, w in enumerate(words):
        piece = (" " + w) if i > 0 else w
        ids = tokenizer(piece, add_special_tokens=False)["input_ids"]
        starts.append((w, len(tok_ids)))
        tok_ids.extend(int(t) for t in ids)
    return starts, tok_ids


@torch.no_grad()
def blank_image_distributions(engine, processor, prompt: str, caption: str, topk: int = 50):
    """{word_idx: {word: prob}} for one caption under a blank image;
    ``word_idx`` indexes ``caption.split()``, as the CHAIR results'
    ``hallucination_idxs`` do."""
    cfg, lm = engine.cfg, engine.params.lm
    tokenizer = processor.tokenizer
    prompt_ids = np.asarray(processor(prompt)["input_ids"], np.int64)
    starts, cap_ids = caption_word_starts(tokenizer, caption)
    if not cap_ids:
        return {}
    ids = np.concatenate([prompt_ids, np.asarray([cap_ids], np.int64)], axis=1)
    sz = cfg.vision.image_size
    blank = np.zeros((1, 3, sz, sz), np.float32)
    _, merged, _ = engine._merge_inputs(ids, blank)
    B, S, _ = merged.shape
    hidden, _ = llama_mod.prefill(lm, cfg.text, merged, engine._positions(B, S))
    # caption token i sits at merged position S - len(cap_ids) + i; the row
    # before it holds its next-word distribution
    base = S - len(cap_ids)
    rows = torch.tensor([base + t_start - 1 for _, t_start in starts], device=hidden.device)
    probs = torch.softmax(llama_mod.lm_head(lm, hidden[0, rows]), dim=-1).cpu().numpy()
    out = {}
    for w_idx, row in enumerate(probs):
        dist = {}
        for t in np.argsort(row)[::-1][:topk]:
            word = tokenizer.decode([int(t)]).strip()
            if not word:
                continue
            # sub-token duplicates merge at their max (rank-preserving)
            dist[word] = max(dist.get(word, 0.0), float(row[t]))
        out[w_idx] = dist
    return out
