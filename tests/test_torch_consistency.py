"""The CHAIR CLI's two consistency analyses in the port
(``evalsuite/consistency.py``, ``consistency_producer.py``,
``im_classifier.py``, ``models/clip_text.py``) against the JAX package,
fp32 on the CPU.

The tiny LLaVA of ``test_torch_models`` carries one set of numpy weights to
both packages, behind a word-level stub tokenizer (one token a word, so the
word alignment is exact).  The blank-image distributions agree word for
word and rank for rank, their probabilities within rtol 1e-5 (fp32 on both
sides, two layers of summation order); the projection labels are equal.
The CLIP towers load one HF-named state dict (names and shapes from a tiny
``transformers.CLIPModel``, values from numpy) in both packages and agree
within 1e-5 (atol and rtol); the zero-shot labels are equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dropoutdecoding_tpu.engine.generate import LlavaEngine as JaxEngine
from dropoutdecoding_tpu.evalsuite import consistency as jcons
from dropoutdecoding_tpu.evalsuite import consistency_producer as jprod
from dropoutdecoding_tpu.evalsuite import im_classifier as jimc
from dropoutdecoding_tpu.models import clip_text as jtext
from dropoutdecoding_tpu.models import clip_vit as jvit
from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
from dropoutdecoding_tpu_torch.evalsuite import consistency as tcons
from dropoutdecoding_tpu_torch.evalsuite import consistency_producer as tprod
from dropoutdecoding_tpu_torch.evalsuite import im_classifier as timc
from dropoutdecoding_tpu_torch.models import clip_text as ttext
from dropoutdecoding_tpu_torch.models import clip_vit as tvit
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils.convert import llava_params_from_numpy
from test_torch_models import INPUT_IDS, tiny_config, tiny_tree


class StubTokenizer:
    """One token a whitespace word (id a stable hash below ``vocab``);
    ``bos_eos`` wraps an encoding as CLIP's tokenizer does."""

    eos_token_id = 2

    def __init__(self, vocab=64, bos_eos=False):
        self.vocab, self.bos_eos = vocab, bos_eos

    def _wid(self, w):
        return 4 + (sum(map(ord, w)) % (self.vocab - 4))

    def __call__(self, text, add_special_tokens=True):
        ids = [self._wid(w) for w in text.split()]
        if self.bos_eos and add_special_tokens:
            ids = [1] + ids + [2]
        return {"input_ids": ids}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{int(t)}" for t in ids)


class StubProcessor:
    def __init__(self, cfg):
        self.cfg = cfg
        self.tokenizer = StubTokenizer(cfg.text.vocab_size)

    def __call__(self, prompt, image=None):
        return {"input_ids": np.array([[1, 5, self.cfg.image_token_index, 9]], np.int32)}


@pytest.fixture(scope="module")
def engines():
    tree, pixels = tiny_tree()
    je = JaxEngine(cfg=tiny_config(jax_config), params=jax.tree.map(jnp.asarray, tree),
                   gen=jax_config.GenerationConfig(max_new_tokens=4, eos_token_id=-1, pad_token_id=0),
                   max_len=64, ensemble=False)
    je.param_dtype = jnp.float32
    te = LlavaEngine(cfg=tiny_config(torch_config), params=llava_params_from_numpy(tree),
                     gen=torch_config.GenerationConfig(max_new_tokens=4, eos_token_id=-1,
                                                       pad_token_id=0),
                     max_len=64, ensemble=False)
    return je, te, pixels


def assert_distributions_equal(got: dict, want: dict, rtol=1e-5):
    """Word-index keys, words and their order equal; probabilities within
    ``rtol`` (and 1e-8 absolute)."""
    assert list(got) == list(want)
    for idx in want:
        assert list(got[idx]) == list(want[idx]), idx
        np.testing.assert_allclose(list(got[idx].values()), list(want[idx].values()), rtol=rtol,
                                   atol=1e-8)


# --- the consumers ------------------------------------------------------------------


def _cap_dict(seed, n=6):
    """A CHAIR result of ``n`` captions: hallucinated words at word
    indices, metrics per caption."""
    r = np.random.default_rng(seed)
    words = ["dog", "cat", "chair", "table", "car"]
    sents = []
    for i in range(n):
        k = int(r.integers(0, 4))
        sents.append({
            "image_id": 100 + i,
            "mscoco_hallucinated_words": [(words[j % 5], words[j % 5]) for j in range(i, i + k)],
            "hallucination_idxs": [int(x) for x in r.integers(0, 8, k)],
            "metrics": {"CIDEr": float(r.random()), "CHAIRs": int(k > 0)},
        })
    return {"sentences": sents}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_consumers_match_jax(seed):
    r = np.random.default_rng(10 + seed)
    cap = _cap_dict(seed)
    vocab = ["dog", "cat", "chair", "table", "car", "a", "the"]
    dists = {s["image_id"]: {int(i): {w: float(p) for w, p in zip(vocab, r.random(len(vocab)))}
                             for i in range(0, 8, 2)} for s in cap["sentences"]}
    labels = {s["image_id"]: set(r.choice(vocab[:5], 2)) for s in cap["sentences"]}
    assert tcons.lm_consistency(cap, dists) == jcons.lm_consistency(cap, dists)
    assert tcons.image_consistency(cap, labels) == jcons.image_consistency(cap, labels)
    for metric in ("CIDEr", "CHAIRs", "SPICE"):
        assert tcons.metric_hallucination_correlation(cap, metric) == \
            jcons.metric_hallucination_correlation(cap, metric)
    for d in dists[100].values():
        for w in vocab + ["absent"]:
            assert tcons.lm_consistency_rank(d, w) == jcons.lm_consistency_rank(d, w)


# --- the blank-image distributions ------------------------------------------------------


def test_caption_word_starts_match_jax():
    tok = StubTokenizer()
    for caption in ("a dog near chair", "", "one"):
        assert tprod.caption_word_starts(tok, caption) == jprod.caption_word_starts(tok, caption)


@pytest.mark.parametrize("caption,topk", [("a dog near the chair", 20), ("dog", 64),
                                          ("a cat on a table by the window", 8)])
def test_blank_image_distributions_match_jax(engines, caption, topk):
    je, te, _ = engines
    want = jprod.blank_image_distributions(je, StubProcessor(je.cfg), "prompt", caption, topk=topk)
    got = tprod.blank_image_distributions(te, StubProcessor(te.cfg), "prompt", caption, topk=topk)
    assert len(got) == len(caption.split())
    assert_distributions_equal(got, want)
    assert tprod.blank_image_distributions(te, StubProcessor(te.cfg), "prompt", "") == {}


def test_blank_image_ranks_end_to_end(engines):
    """The producer's output through the consumer: the top word of a
    position ranks 1, as in JAX."""
    _, te, _ = engines
    dists = tprod.blank_image_distributions(te, StubProcessor(te.cfg), "prompt", "a dog near chair",
                                            topk=64)
    top = max(dists[2].items(), key=lambda kv: kv[1])[0]
    cap = {"sentences": [{"image_id": 7, "mscoco_hallucinated_words": [(top, "node")],
                          "hallucination_idxs": [2]}]}
    assert tcons.lm_consistency(cap, {7: dists}) == {"mean_rank": 1.0, "per_image": {7: 1.0}}


# --- the projection classifier --------------------------------------------------------------


def test_class_table_and_projection_labels_match_jax(engines):
    je, te, pixels = engines
    assert timc.coco_class_words() == jimc.coco_class_words()
    assert len(timc.coco_class_words()) == 80
    tok = StubTokenizer()
    table = timc.class_token_table(tok, timc.coco_class_words())
    assert table == jimc.class_token_table(tok, jimc.coco_class_words())
    want = jimc.projection_labels(je.prefill(INPUT_IDS, pixels).topk_ids[0], table)
    got = timc.projection_labels(te.prefill(INPUT_IDS, pixels).topk_ids[0], table)
    assert got == want and got  # the tiny model's table fires some classes


# --- CLIP zero-shot ----------------------------------------------------------------------


TEXT = dict(vocab_size=64, hidden_size=24, intermediate_size=48, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=16, projection_dim=16)
VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
              image_size=28, patch_size=7, projection_dim=16)
CLASSES = ["dog", "chair", "cat", "car", "person", "table", "bed", "bus"]


@pytest.fixture(scope="module")
def clip_state_dict():
    """A full CLIP checkpoint's state dict: the names and shapes of a tiny
    ``transformers.CLIPModel``, normal(0, 0.2) values from numpy (the
    integer position-id buffers dropped)."""
    from transformers import CLIPConfig, CLIPModel

    hf = CLIPModel(CLIPConfig(text_config={k: v for k, v in TEXT.items() if k != "projection_dim"},
                              vision_config={k: v for k, v in VISION.items()
                                             if k != "projection_dim"},
                              projection_dim=16))
    r = np.random.default_rng(4)
    return {k: (1.0 if k.endswith("norm.weight") or "layer_norm" in k and k.endswith("weight")
                else 0.0) + (0.2 * r.normal(size=tuple(v.shape))).astype(np.float32)
            for k, v in hf.state_dict().items() if v.is_floating_point() and k != "logit_scale"}


def test_clip_text_params_and_apply_match_jax(clip_state_dict):
    tcfg, jcfg = torch_config.ClipTextConfig(**TEXT), jax_config.ClipTextConfig(**TEXT)
    tp = ttext.params_from_hf(tcfg, clip_state_dict, torch.float32, "cpu")
    jp = jtext.params_from_hf(jcfg, clip_state_dict, jnp.float32)
    assert sorted(tp) == sorted(jp) and sorted(tp["layers"]) == sorted(jp["layers"])
    for k in tp["layers"]:
        np.testing.assert_array_equal(tp["layers"][k].numpy(), np.asarray(jp["layers"][k]))
    assert tp["text_projection"].shape == (24, 16)  # [in, out] from HF's [out, in]
    ids = np.random.default_rng(5).integers(3, 64, (3, 9))
    eos = np.array([8, 4, 6])
    got = ttext.apply(tcfg, tp, torch.from_numpy(ids), torch.from_numpy(eos))
    want = jtext.apply(jcfg, jp, jnp.asarray(ids), jnp.asarray(eos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_clip_text_init_params_have_the_jax_leaves():
    cfg = torch_config.ClipTextConfig(**TEXT)
    tp = ttext.init_params(cfg, "cpu", torch.float32, seed=1)
    jp = jtext.init_params(jax_config.ClipTextConfig(**TEXT), jax.random.key(1), jnp.float32)
    flat = lambda t: {k: tuple(v.shape) for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}  # noqa: E731
    assert {jax.tree_util.keystr(k): s for k, s in flat(jp).items()} == \
        {jax.tree_util.keystr(k): s for k, s in flat(jax.tree.map(np.asarray, tp)).items()}
    out = ttext.apply(cfg, tp, torch.tensor([[1, 9, 2]]), torch.tensor([2]))
    assert out.shape == (1, 16) and torch.isfinite(out).all()


def test_clip_zero_shot_matches_jax(clip_state_dict):
    """The labels and the normalised text embeddings of ``ClipZeroShot`` over
    both towers from the HF-named state dict."""
    sd = clip_state_dict
    tv, jv = torch_config.ClipVisionConfig(**VISION), jax_config.ClipVisionConfig(**VISION)
    tt, jt = torch_config.ClipTextConfig(**TEXT), jax_config.ClipTextConfig(**TEXT)
    post = (sd["vision_model.post_layernorm.weight"], sd["vision_model.post_layernorm.bias"])
    vproj = sd["visual_projection.weight"].T
    tok = StubTokenizer(bos_eos=True)
    zs = timc.ClipZeroShot(tv, tvit.params_from_hf(tv, sd, torch.float32, "cpu"),
                           tuple(torch.from_numpy(x) for x in post), torch.from_numpy(vproj), tt,
                           ttext.params_from_hf(tt, sd, torch.float32, "cpu"), tok, CLASSES)
    jzs = jimc.ClipZeroShot(jv, jvit.params_from_hf(jv, sd, jnp.float32), post, vproj, jt,
                            jtext.params_from_hf(jt, sd, jnp.float32), tok, CLASSES)
    np.testing.assert_allclose(zs._text_embeds.numpy(), np.asarray(jzs._text_embeds), rtol=1e-5,
                               atol=1e-5)
    r = np.random.default_rng(6)
    for _ in range(3):
        px = r.normal(size=(1, 3, 28, 28)).astype(np.float32)
        for top_n in (1, 3):
            assert zs.labels(px, top_n=top_n) == jzs.labels(px, top_n=top_n)
    assert len(zs.labels(px, top_n=3)) == 3
