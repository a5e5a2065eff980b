"""The POPE path of the port against the JAX package: the extend attention,
``prefill_extend`` and the int8 prefix layout, the engines' ``probe``,
``probe_prefix`` and ``probe_extend``, the evalsuite's POPE module and the
POPE CLI.

Weights are numpy from a seed and go to both packages: the tiny LLaVA of
``test_torch_models`` (LM 48 wide, MHA) and the narrow LLaVA-NeXT of
``test_torch_llavanext`` (LM 64 wide, 4 heads over 2 KV heads; 1312 visual
slots, so its prompts pass the JAX package's S >= 1024 switch; a 150 x 220
image fills 982 of them, so its prefixes carry 330 pad slots).  Tolerances,
all fp32:

- the extend attention: atol 1e-5 (one softmax, summation order only);
- ``kv_int8_reader_layout``: bit-equal (one quantizer, IEEE division);
- ``prefill_extend``: rtol 1e-5, atol 1e-4 (a few layers compound, as in
  ``test_torch_models``); the port's own factorization (extend against the
  tail rows of one prefill) atol 2e-5;
- the engines: first tokens equal, ``last_logits`` within 1e-5 (rtol and
  atol); LLaVA-NeXT's, which cross a 1300-token prefill, rtol 1e-5 / atol
  1e-4;
- the evalsuite and the CLI: equal, file for file.
"""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from dropoutdecoding_tpu.cli import chair_test as jchair
from dropoutdecoding_tpu.cli import pope_test as jpope
from dropoutdecoding_tpu.engine.generate import LlavaEngine as JaxEngine
from dropoutdecoding_tpu.engine.llavanext_engine import LlavaNextEngine as JaxNextEngine
from dropoutdecoding_tpu.evalsuite import pope as jeval
from dropoutdecoding_tpu.models import llama as jllama
from dropoutdecoding_tpu.ops import attention as jattn
from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu.utils import quantize as jq
from dropoutdecoding_tpu_torch.cli import chair_test as tchair
from dropoutdecoding_tpu_torch.cli import pope_test as tpope
from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
from dropoutdecoding_tpu_torch.evalsuite import pope as teval
from dropoutdecoding_tpu_torch.models import llama as tllama
from dropoutdecoding_tpu_torch.models import llavanext as tnext
from dropoutdecoding_tpu_torch.ops import attention as tattn
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils.convert import (
    _to_torch,
    llava_params_from_numpy,
    llavanext_params_from_numpy,
)
from test_pope_cli_end_to_end import _TinyProcessor, synthetic_coco  # noqa: F401 (fixture)
from test_torch_llavanext import IMAGE as NEXT_IMAGE
from test_torch_llavanext import SIZE, narrow_config, narrow_tree, tiles_for
from test_torch_models import tiny_config, tiny_tree

ATTN = dict(rtol=0, atol=1e-5)
TOWER = dict(rtol=1e-5, atol=1e-4)
LOGITS = dict(rtol=1e-5, atol=1e-5)
NEXT_LOGITS = dict(rtol=1e-5, atol=1e-4)
IMAGE = 32  # the tiny LLaVA's image token


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, ref, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)


# --- extend attention -----------------------------------------------------------


def _extend_inputs(rng, Bp, G, B=3, T=5, P=11, KH=2, D=8):
    H = KH * G

    def n(*shape):
        return rng.normal(size=shape).astype(np.float32)

    mask = rng.random((Bp, P)) > 0.3
    mask[:, 0] = True  # every row attends at least one prefix slot
    return n(B, T, H, D), n(B, T, KH, D), n(B, T, KH, D), n(Bp, P, KH, D), n(Bp, P, KH, D), mask


CASES = [(bp, g, m) for bp in ("one", "B") for g in (1, 4) for m in (False, True)]
IDS = [f"Bp={bp}-G={g}-{'masked' if m else 'unmasked'}" for bp, g, m in CASES]


@pytest.mark.parametrize("bp,G,masked", CASES, ids=IDS)
def test_extend_attention_matches_jax(rng, bp, G, masked):
    q, kn, vn, kp, vp, mask = _extend_inputs(rng, 1 if bp == "one" else 3, G)
    mask = mask if masked else None
    ref = jattn.extend_attention(*map(jnp.asarray, (q, kn, vn, kp, vp)),
                                 None if mask is None else jnp.asarray(mask))
    got = tattn.extend_attention(*map(_t, (q, kn, vn, kp, vp)), None if mask is None else _t(mask))
    _close(got, ref, ATTN)
    if bp == "one":  # the shared prefix: equal to every row holding its own copy
        rep = [np.repeat(a, 3, axis=0) for a in (kp, vp)]
        again = tattn.extend_attention(*map(_t, (q, kn, vn, *rep)),
                                       None if mask is None else _t(np.repeat(mask, 3, axis=0)))
        _close(got, again.numpy(), ATTN)


@pytest.mark.parametrize("bp,G,masked", CASES, ids=IDS)
def test_extend_attention_int8prefix_matches_jax(rng, bp, G, masked):
    q, kn, vn, kp, vp, mask = _extend_inputs(rng, 1 if bp == "one" else 3, G)
    mask = mask if masked else None
    Bp, P, KH, _ = kp.shape
    kq = rng.integers(-127, 128, size=kp.shape).astype(np.int8)
    vq = rng.integers(-127, 128, size=vp.shape).astype(np.int8)
    ks = rng.uniform(0.01, 0.03, size=(Bp, KH, P)).astype(np.float32)
    vs = rng.uniform(0.01, 0.03, size=(Bp, KH, P)).astype(np.float32)
    args = (q, kn, vn, kq, ks, vq, vs)
    ref = jattn.extend_attention_int8prefix(*map(jnp.asarray, args),
                                            None if mask is None else jnp.asarray(mask))
    got = tattn.extend_attention_int8prefix(*map(_t, args), None if mask is None else _t(mask))
    _close(got, ref, ATTN)


def test_kv_int8_reader_layout_bit_equal(rng):
    x = rng.normal(size=(2, 1, 9, 2, 8)).astype(np.float32)
    x[0, 0, 3, 1] = 0.0  # an all-zero (token, head): scale 1
    got, ref = tllama.kv_int8_reader_layout(_t(x)), jllama.kv_int8_reader_layout(jnp.asarray(x))
    assert got["q"].dtype == torch.int8 and got["q"].shape == (2, 1, 9, 16)
    assert got["s"].dtype == torch.float32 and got["s"].shape == (2, 1, 2, 9)
    for k in ("q", "s"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


# --- prefill_extend -----------------------------------------------------------------


@pytest.fixture(scope="module")
def tower():
    """The narrow NeXT's LM (GQA 4 / 2) in both packages, dense and quantized
    (quantized by JAX and carried across)."""
    lm = narrow_tree().lm
    jlm = jax.tree.map(jnp.asarray, lm)
    tiers = {
        "dense": jlm,
        "int8": jq.fuse_projections(jq.quantize_llama_params(jlm)),
        "int4": jq.fuse_projections(jq.quantize_llama_params_int4(jlm)),
    }
    return {
        "jcfg": narrow_config(jax_config).text,
        "tcfg": narrow_config(torch_config).text,
        "tiers": {
            k: (v, _to_torch(jax.tree.map(np.asarray, v), "cpu", torch.float32))
            for k, v in tiers.items()
        },
    }


def _prefix(pkg_llama, kv, int8):
    if not int8:
        return kv
    return pkg_llama.KVCache(pkg_llama.kv_int8_reader_layout(kv.k), pkg_llama.kv_int8_reader_layout(kv.v))


@pytest.mark.parametrize("tier", ["dense", "int8", "int4"])
@pytest.mark.parametrize("prefix_kind", ["dense", "int8"])
def test_prefill_extend_matches_jax(tower, rng, tier, prefix_kind):
    """A prefix of 13 slots, the last 3 pads (masked), shared by 3 tails of
    5 tokens whose positions start at its real length 10."""
    jp, tp = tower["tiers"][tier]
    jcfg, tcfg = tower["jcfg"], tower["tcfg"]
    P, real, T, B = 13, 10, 5, 3
    xp = rng.normal(size=(1, P, 64)).astype(np.float32)
    xt = rng.normal(size=(B, T, 64)).astype(np.float32)
    pmask = np.arange(P)[None] < real
    pos_p = np.arange(P)[None]
    pos_t = np.broadcast_to(real + np.arange(T)[None], (B, T))
    _, jkv = jllama.prefill(jp, jcfg, jnp.asarray(xp), jnp.asarray(pos_p), key_mask=jnp.asarray(pmask))
    _, tkv = tllama.prefill(tp, tcfg, _t(xp), _t(pos_p), key_mask=_t(pmask))
    int8 = prefix_kind == "int8"
    jpre, tpre = _prefix(jllama, jkv, int8), _prefix(tllama, tkv, int8)
    ref_h, ref_kv = jllama.prefill_extend(jp, jcfg, jnp.asarray(xt), jnp.asarray(pos_t), jpre,
                                          prefix_mask=jnp.asarray(pmask))
    got_h, got_kv = tllama.prefill_extend(tp, tcfg, _t(xt), _t(pos_t), tpre, prefix_mask=_t(pmask))
    _close(got_h, ref_h, TOWER)
    _close(got_kv.k, ref_kv.k, TOWER)
    _close(got_kv.v, ref_kv.v, TOWER)


@pytest.mark.parametrize("pad", [0, 4])
def test_prefill_extend_equals_one_prefill(tower, rng, pad):
    """The port's own factorization: tails over a prefix (Bp = 1, with
    ``pad`` masked pad slots past its real length) give the hidden rows and
    K/V of one causal prefill of [prefix + tail], row by row; without pad,
    also ``prefill_hidden``'s rows."""
    _, tp = tower["tiers"]["dense"]
    cfg = tower["tcfg"]
    real, T, B = 9, 4, 3
    xp = torch.from_numpy(rng.normal(size=(1, real + pad, 64)).astype(np.float32))
    xt = torch.from_numpy(rng.normal(size=(B, T, 64)).astype(np.float32))
    pmask = torch.arange(real + pad)[None] < real
    _, kv = tllama.prefill(tp, cfg, xp, torch.arange(real + pad)[None], key_mask=pmask)
    pos_t = (real + torch.arange(T))[None].expand(B, T)
    h_ext, kv_tail = tllama.prefill_extend(tp, cfg, xt, pos_t, kv, prefix_mask=pmask)
    for b in range(B):
        full = torch.cat([xp[:, :real], xt[b : b + 1]], dim=1)
        h_full, kv_full = tllama.prefill(tp, cfg, full, torch.arange(real + T)[None])
        np.testing.assert_allclose(h_ext[b].numpy(), h_full[0, real:].numpy(), rtol=0, atol=2e-5)
        np.testing.assert_allclose(kv_tail.k[:, b].numpy(), kv_full.k[:, 0, real:].numpy(),
                                   rtol=0, atol=2e-5)
        if not pad:
            hidden = tllama.prefill_hidden(tp, cfg, full, torch.arange(real + T)[None])
            np.testing.assert_array_equal(hidden.numpy(), h_full.numpy())


# --- the engines ----------------------------------------------------------------


@pytest.fixture(scope="module")
def llava_weights():
    tree, pixels = tiny_tree()
    other = np.random.default_rng(8).normal(size=pixels.shape).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), llava_params_from_numpy(tree), np.concatenate([pixels, other])


def _llava_engines(weights, int8_prefix_cache=False):
    jp, tp, _ = weights
    kw = dict(max_len=64, int8_prefix_cache=int8_prefix_cache)
    je = JaxEngine(cfg=tiny_config(jax_config), params=jp, **kw)
    je.param_dtype = jnp.float32
    return je, LlavaEngine(cfg=tiny_config(torch_config), params=tp, **kw)


def _same_probe(got, ref, tol=LOGITS):
    np.testing.assert_array_equal(got.first_token.numpy(), np.asarray(ref.first_token))
    _close(got.last_logits, ref.last_logits, tol)


def _handle(jax_kv):
    """A JAX int8 prefix handle, leaf for leaf in the port's tensors."""
    return tllama.KVCache(*({k: _t(v) for k, v in leaf.items()} for leaf in jax_kv))


def _same_int8_handle(got, ref, handle, jax_handle, on_jax_handle, tol):
    """An int8 prefix, port against JAX: the handles' bytes within one
    step (the two packages' fp32 prefix K/V differ in the last bits, so a
    value on a rounding boundary may round apart) and their scales within
    ``LOGITS``; the port's extend over JAX's own handle within ``tol`` of
    JAX's; over the port's handle, the same first tokens, the logits within
    1e-2 (what those one-step differences leave)."""
    for mine, theirs in zip(handle, jax_handle):
        _close(mine["q"].int(), theirs["q"], dict(rtol=0, atol=1))
        _close(mine["s"], theirs["s"], LOGITS)
    _same_probe(on_jax_handle, ref, tol)
    _same_probe(got, ref, dict(rtol=0, atol=1e-2))


# four right-padded rows over two images: real lengths 9, 6, 7, 9
LLAVA_ROWS = np.array([
    [1, 5, 9, IMAGE, 11, 13, 17, 19, 23],
    [1, 7, IMAGE, 3, 4, 8, 0, 0, 0],
    [1, 5, IMAGE, 12, 14, 16, 18, 0, 0],
    [1, IMAGE, 2, 4, 6, 8, 10, 12, 14],
])
LLAVA_LENS = np.array([9, 6, 7, 9])
INDEX = np.array([0, 1, 1, 0])


def test_llava_probe_matches_jax(llava_weights):
    """``probe`` with ``text_lens`` and ``image_index`` (two unique images,
    four rows): as JAX's, and as the first token of ``prefill`` on every
    row's own image."""
    je, te = _llava_engines(llava_weights)
    pixels = llava_weights[2]
    ref = je.probe(LLAVA_ROWS, pixels, text_lens=LLAVA_LENS, image_index=INDEX)
    got = te.probe(LLAVA_ROWS, pixels, text_lens=LLAVA_LENS, image_index=INDEX)
    _same_probe(got, ref)
    state = te.prefill(LLAVA_ROWS, pixels[INDEX], text_lens=LLAVA_LENS)
    np.testing.assert_array_equal(got.first_token.numpy(), state.first_token.numpy())
    _close(got.last_logits, state.last_logits.numpy(), LOGITS)
    plain = te.probe(LLAVA_ROWS[:1], pixels[:1])  # no text_lens, no image_index
    _same_probe(plain, je.probe(LLAVA_ROWS[:1], pixels[:1]))


@pytest.mark.parametrize("int8_prefix_cache", [False, True], ids=["dense", "int8-prefix"])
def test_llava_prefix_extend_matches_jax(llava_weights, int8_prefix_cache):
    """A prefix of 6 ids (the image at 3) shared by three right-padded
    tails: as JAX's ``probe_prefix`` + ``probe_extend``; dense, also as
    ``probe`` of the whole rows."""
    je, te = _llava_engines(llava_weights, int8_prefix_cache)
    pixels = llava_weights[2][:1]
    prefix = LLAVA_ROWS[:1, :6]
    tails = np.array([[17, 19, 23], [21, 0, 0], [25, 27, 0]])
    lens = np.array([3, 1, 2])
    jh, th = je.probe_prefix(prefix, pixels), te.probe_prefix(prefix, pixels)
    ref = je.probe_extend(jh, jnp.asarray(tails), lens)
    got = te.probe_extend(th, tails, lens)
    if int8_prefix_cache:
        assert th.k["q"].dtype == torch.int8 and th.k["s"].shape[-2:] == (4, 6 + 15)
        _same_int8_handle(got, ref, th, jh, te.probe_extend(_handle(jh), tails, lens), LOGITS)
    else:
        _same_probe(got, ref)
    if not int8_prefix_cache:
        rows = np.zeros((3, 9), np.int64)
        for i, (t, n) in enumerate(zip(tails, lens)):
            rows[i, :6], rows[i, 6 : 6 + n] = prefix[0], t[:n]
        whole = te.probe(rows, pixels, text_lens=6 + lens, image_index=np.zeros(3, int))
        _same_probe(got, whole)


@pytest.fixture(scope="module")
def next_weights():
    tree = narrow_tree()
    return jax.tree.map(jnp.asarray, tree), llavanext_params_from_numpy(tree)


def _next_engines(weights, int8_prefix_cache=False):
    jp, tp = weights
    kw = dict(max_len=1344, seed=506, int8_prefix_cache=int8_prefix_cache)
    je = JaxNextEngine(cfg=narrow_config(jax_config), params=jp, **kw)
    je.param_dtype = jnp.float32
    return je, LlavaNextEngine(cfg=narrow_config(torch_config), params=tp, **kw)


NEXT_ROWS = np.array([
    [1, 5, 9, NEXT_IMAGE, 11, 13, 17, 19, 23],
    [1, NEXT_IMAGE, 7, 8, 9, 10, 0, 0, 0],
    [1, 5, NEXT_IMAGE, 12, 14, 16, 18, 20, 0],
])
NEXT_LENS = np.array([9, 6, 8])
NEXT_SIZES = [SIZE, (100, 230)]  # 5 and 3 tiles


def test_llavanext_probe_matches_jax(next_weights):
    """Three right-padded rows over two images of 5 and 3 tiles (rows 0 and
    2 read the first): as JAX's ``probe``, and as ``prefill``'s first
    tokens."""
    je, te = _next_engines(next_weights)
    cfg = te.cfg
    tiles = [tiles_for(cfg, s, seed=b) for b, s in enumerate(NEXT_SIZES)]
    index = np.array([0, 1, 0])
    ref = je.probe(NEXT_ROWS, tiles, NEXT_SIZES, text_lens=NEXT_LENS, image_index=index)
    got = te.probe(NEXT_ROWS, tiles, NEXT_SIZES, text_lens=NEXT_LENS, image_index=index)
    _same_probe(got, ref, NEXT_LOGITS)
    state = te.prefill(NEXT_ROWS, [tiles[i] for i in index], [NEXT_SIZES[i] for i in index],
                       text_lens=NEXT_LENS)
    np.testing.assert_array_equal(got.first_token.numpy(), state.first_token.numpy())
    _close(got.last_logits, state.last_logits.numpy(), NEXT_LOGITS)


@pytest.mark.parametrize("int8_prefix_cache", [False, True], ids=["dense", "int8-prefix"])
def test_llavanext_prefix_extend_matches_jax(next_weights, int8_prefix_cache):
    """The NeXT prefix (6 ids, 982 real visual tokens of 1312 slots: 330 pad
    slots) shared by three tails: as JAX's, and dense as ``probe`` of the
    whole rows, which counts no pad in the tails' positions."""
    je, te = _next_engines(next_weights, int8_prefix_cache)
    tiles = tiles_for(te.cfg, SIZE)
    prefix = NEXT_ROWS[:1, :6]
    tails = np.array([[17, 19, 23], [21, 0, 0], [25, 27, 0]])
    lens = np.array([3, 1, 2])
    jh, th = je.probe_prefix(prefix, tiles, SIZE), te.probe_prefix(prefix, tiles, SIZE)
    kv, real_len, key_mask = th
    assert int(real_len[0]) == 5 + 982 and key_mask.shape == (1, 5 + 1312)
    assert int((~key_mask).sum()) == 330
    np.testing.assert_array_equal(key_mask.numpy(), np.asarray(jh[2]))
    ref = je.probe_extend(jh, jnp.asarray(tails), lens)
    got = te.probe_extend(th, tails, lens)
    if int8_prefix_cache:
        same = te.probe_extend((_handle(jh[0]), _t(jh[1]), _t(jh[2])), tails, lens)
        _same_int8_handle(got, ref, kv, jh[0], same, NEXT_LOGITS)
    else:
        _same_probe(got, ref, NEXT_LOGITS)
    if not int8_prefix_cache:
        rows = np.zeros((3, 9), np.int64)
        for i, (t, n) in enumerate(zip(tails, lens)):
            rows[i, :6], rows[i, 6 : 6 + n] = prefix[0], t[:n]
        whole = te.probe(rows, [tiles], [SIZE], text_lens=6 + lens, image_index=np.zeros(3, int))
        _same_probe(got, whole, NEXT_LOGITS)


# --- evalsuite/pope.py ---------------------------------------------------------------


def _segments(seed=3, n=12):
    r = np.random.default_rng(seed)
    vocab = ["dog", "chair", "cat", "car", "person", "bench", "apple", "umbrella", "oven"]
    return [{"image": f"im{i}.jpg",
             "objects": [vocab[j] for j in r.choice(len(vocab), r.integers(1, 6), replace=False)]}
            for i in range(n)]


@pytest.mark.parametrize("strategy", ["random", "popular", "adversarial"])
def test_build_questions_matches_jax(strategy):
    segs = _segments()
    for seed in (0, 7):
        got = teval.build_questions(segs, 3, strategy, seed=seed)
        assert got == jeval.build_questions(segs, 3, strategy, seed=seed)
        assert {q["label"] for q in got} == {"yes", "no"}
    assert teval.ground_truth_objects(segs) == jeval.ground_truth_objects(segs)
    assert teval.co_occurrence(segs) == jeval.co_occurrence(segs)
    with pytest.raises(ValueError):
        teval.build_questions(segs, 3, "unknown", seed=0)


def test_answers_normalize_and_score_as_jax(tmp_path):
    texts = ["Yes", "No", "No.", "Yes, there is.", "There is not a dog.", "no", "Not sure. no",
             "yes. No", "", "I see no, dog", "No, there is", "Nope", "The answer is No"]
    for t in texts:
        assert teval.normalize_answer(t) == jeval.normalize_answer(t), t
    answers = [{"question": f"q{i}", "answer": t} for i, t in enumerate(texts)]
    labels = ["yes", "no"] * 6 + ["no"]
    for number in (None, 5):
        assert teval.score_answers(answers, labels, number) == jeval.score_answers(answers, labels, number)
    zero = teval.score_answers([{"answer": "no"}], ["no"])
    assert zero == jeval.score_answers([{"answer": "no"}], ["no"]) and zero["precision"] == 0.0
    qs = teval.build_questions(_segments(), 3, "popular", seed=1)
    path = teval.write_questions(qs, str(tmp_path), "coco", "popular")
    assert path == os.path.join(str(tmp_path), "coco_pope_popular.json")
    assert teval.parse_question_file(path) == jeval.parse_question_file(path) == qs


def test_vendored_question_sets_are_the_jax_packages():
    """``data/pope/`` is a byte-for-byte copy, and ``seed_question_dir``
    copies it as JAX's does."""
    for rel in ("PROVENANCE.md", "coco/coco_pope_random.json", "coco/coco_pope_popular.json",
                "coco/coco_pope_adversarial.json", "coco/coco_ground_truth_objects.json",
                "coco/coco_co_occur.json"):
        got = os.path.join(os.path.dirname(teval.vendored_question_dir()), rel)
        ref = os.path.join(os.path.dirname(jeval.vendored_question_dir()), rel)
        with open(got, "rb") as a, open(ref, "rb") as b:
            assert a.read() == b.read(), rel
    assert "dropoutdecoding_tpu_torch" in teval.vendored_question_dir()


# --- the CLI --------------------------------------------------------------------------


class _WordProcessor(_TinyProcessor):
    """A stand-in tokenizer over the prompt's words: "<image>" is the image
    token, any other word a hash of it, then 1-3 ids more, a hash of the
    whole prompt, so that questions differ in their ids, their last id and
    their lengths;
    pixels only for LLaVA-1.5 (NeXT's tiles come from ``next_image_prep``).
    ``decode`` is ``_TinyProcessor``'s: "Yes" for an even token."""

    def __call__(self, prompt, image=None):
        import zlib

        V, img = self.cfg.text.vocab_size, self.cfg.image_token_index

        def word(w):
            return 3 + zlib.crc32(w.encode()) % (img - 3)

        ids = [1] + [img if w == "<image>" else word(w) for w in prompt.split()]
        ids += [word(prompt)] * (1 + len(prompt) % 3)
        out = {"input_ids": np.array([ids], np.int32)}
        if image is not None and V == 64:
            arr = np.asarray(image.resize((28, 28)), np.float32) / 255.0
            out["pixel_values"] = arr.transpose(2, 0, 1)[None]
        return out


def _jax_make_engine(model, llava_weights, next_weights):
    def make(args):
        assert args.model == {"llava": "llava-1.5", "llava-next": "llava-next"}[model]
        gen = jax_config.GenerationConfig(max_new_tokens=4, eos_token_id=2, pad_token_id=2)
        kw = dict(gen=gen, int8_prefix_cache=jchair.str2bool(args.int8_prefix_cache),
                  w8a8_prefill=args.quantize == "w8a8")
        if model == "llava":
            params = llava_weights[0]
            if args.quantize == "w8a8":  # the JAX CLI's maybe_quantize on one device
                params = params._replace(lm=jq.fuse_projections(jq.quantize_llama_params(params.lm)))
            eng = JaxEngine(cfg=tiny_config(jax_config), params=params, max_len=64, **kw)
        else:
            eng = JaxNextEngine(cfg=narrow_config(jax_config), params=next_weights[0], max_len=1344,
                                **kw)
        eng.param_dtype = jnp.float32
        return eng, _WordProcessor(eng.cfg)

    return make


def _port_make_engine(model, llava_weights, next_weights, engines):
    def make(args, device="cuda"):
        assert device == "cpu"
        gen = torch_config.GenerationConfig(max_new_tokens=4, eos_token_id=2, pad_token_id=2)
        # the real build_engine's plumbing, on the tiny model's weights
        kw = dict(gen=gen, int8_prefix_cache=tchair.str2bool(args.int8_prefix_cache),
                  w8a8_prefill=args.quantize == "w8a8")
        if model == "llava":
            params = llava_weights[1]
            if args.quantize:
                params = tchair.maybe_quantize(args, params)
            eng = LlavaEngine(cfg=tiny_config(torch_config), params=params, max_len=64, **kw)
        else:
            eng = LlavaNextEngine(cfg=narrow_config(torch_config), params=next_weights[1],
                                  max_len=1344, **kw)
        engines.append(eng)
        return eng, _WordProcessor(eng.cfg)

    return make


def _run(cli, coco, pope_dir, model, extra, **main_kw):
    """``cli.main``; returns (answer archives by strategy, their sidecars,
    the question files by name)."""
    args = cli.build_parser().parse_args(
        ["--model", model, "--model-path", "/unused", "--coco-data-dir", str(coco),
         "--pope-dir", str(pope_dir), "--seed", "0"] + extra
    )
    cli.main(args, **main_kw)
    answers, metas = {}, {}
    for f in os.listdir(pope_dir / "answer"):
        strategy = f.split("_")[-2]
        if f.endswith("_ans.json"):
            answers[strategy] = [json.loads(line) for line in open(pope_dir / "answer" / f)]
        else:
            metas[strategy] = json.load(open(pope_dir / "answer" / f))
    qdir = pope_dir / "output" / "coco"
    questions = {f: (qdir / f).read_bytes() for f in sorted(os.listdir(qdir))}
    return answers, metas, questions


def _vendored_coco(tmp_path, number):
    """val2014 images for the first ``number`` vendored questions of each
    strategy, and no annotations."""
    coco = tmp_path / "coco"
    (coco / "val2014").mkdir(parents=True)
    r = np.random.default_rng(0)
    for strategy in ("random", "popular", "adversarial"):
        qs = teval.parse_question_file(
            os.path.join(teval.vendored_question_dir(), f"coco_pope_{strategy}.json"))
        for q in qs[:number]:
            path = coco / "val2014" / q["image"]
            if not path.exists():
                Image.fromarray((r.random((40, 52, 3)) * 255).astype(np.uint8), "RGB").save(path, "JPEG")
    return coco


CLI_CASES = [("llava", "refresh"), ("llava-next", "refresh"), ("llava", "vendored")]


@pytest.mark.parametrize("model,questions", CLI_CASES, ids=[f"{m}-{q}" for m, q in CLI_CASES])
def test_main_writes_what_the_jax_main_writes(synthetic_coco, tmp_path, monkeypatch, llava_weights,
                                              next_weights, model, questions):
    """The JAX ``main`` serial, then the port's serial, ``--batch-size 4``
    and ``--prefix-cache True``: the same question files and answer
    archives (5 questions, 2 images, a short last group; vendored: 8
    questions, both modes' groups across two images)."""
    if questions == "refresh":
        coco, extra = synthetic_coco, ["--refresh-data", "True", "--number", "5"]
    else:
        coco, extra = _vendored_coco(tmp_path, 8), ["--number", "8"]
    monkeypatch.setattr(jchair, "make_engine", _jax_make_engine(model, llava_weights, next_weights))
    ref = _run(jpope, coco, tmp_path / "jax", model, extra)
    engines = []
    monkeypatch.setattr(tchair, "make_engine",
                        _port_make_engine(model, llava_weights, next_weights, engines))
    for name, mode in (("serial", []), ("batch", ["--batch-size", "4"]),
                       ("prefix", ["--prefix-cache", "True"])):
        answers, metas, qs = _run(tpope, coco, tmp_path / name, model, extra + mode, device="cpu")
        assert answers == ref[0], name
        assert qs == ref[2], name
        for strategy, meta in metas.items():
            assert os.path.isdir(meta.pop("question_snapshot"))
            want = dict(ref[1][strategy])
            want.pop("question_snapshot")
            assert meta == want, name
    assert sorted(ref[0]) == ["adversarial", "popular", "random"]
    assert all(len(v) == int(extra[-1]) for v in ref[0].values())
    said = {a["answer"] for v in ref[0].values() for a in v}
    assert said == {"Yes", "No"}, said  # the tokens differ, so the parity is not vacuous
    assert [e.gen.max_new_tokens for e in engines] == [1, 1, 1]


def test_int8_prefix_cache_matches_the_jax_main(synthetic_coco, tmp_path, monkeypatch,
                                                llava_weights, next_weights):
    """``--prefix-cache True --int8-prefix-cache True`` on LLaVA-1.5: the
    JAX main's archives, the engines built with int8 handles."""
    extra = ["--refresh-data", "True", "--number", "5", "--prefix-cache", "True",
             "--int8-prefix-cache", "True"]
    monkeypatch.setattr(jchair, "make_engine", _jax_make_engine("llava", llava_weights, next_weights))
    ref = _run(jpope, synthetic_coco, tmp_path / "jax", "llava", extra)
    engines = []
    monkeypatch.setattr(tchair, "make_engine",
                        _port_make_engine("llava", llava_weights, next_weights, engines))
    got = _run(tpope, synthetic_coco, tmp_path / "port", "llava", extra, device="cpu")
    assert got[0] == ref[0]
    assert [e.int8_prefix_cache for e in engines] == [True]


def test_w8a8_matches_the_jax_main(synthetic_coco, tmp_path, monkeypatch, llava_weights,
                                   next_weights):
    """``--quantize w8a8`` on LLaVA-1.5, serial, ``--batch-size 4`` and
    ``--prefix-cache True``: the JAX main's archives (its serial run), from
    engines with int8 fused weights and int8 activations in every prefill."""
    extra = ["--refresh-data", "True", "--number", "5", "--quantize", "w8a8"]
    monkeypatch.setattr(jchair, "make_engine", _jax_make_engine("llava", llava_weights, next_weights))
    ref = _run(jpope, synthetic_coco, tmp_path / "jax", "llava", extra)
    engines = []
    monkeypatch.setattr(tchair, "make_engine",
                        _port_make_engine("llava", llava_weights, next_weights, engines))
    for name, mode in (("serial", []), ("batch", ["--batch-size", "4"]),
                       ("prefix", ["--prefix-cache", "True"])):
        got = _run(tpope, synthetic_coco, tmp_path / name, "llava", extra + mode, device="cpu")
        assert got[0] == ref[0], name
    assert all(e.w8a8_prefill and "qkv_proj" in e.params.lm["layers"] for e in engines)
    assert engines[0].params.lm["layers"]["qkv_proj"]["q"].dtype == torch.int8


def test_prefix_cache_with_instructblip_exits_as_the_jax_cli(tmp_path):
    argv = ["--model", "instructblip", "--model-path", "/unused", "--coco-data-dir",
            str(tmp_path / "coco"), "--pope-dir", str(tmp_path / "pope"), "--prefix-cache", "True"]
    with pytest.raises(SystemExit, match="Q-Former") as got:
        tpope.main(tpope.build_parser().parse_args(argv), device="cpu")
    with pytest.raises(SystemExit, match="Q-Former") as ref:
        jpope.main(jpope.build_parser().parse_args(argv))
    assert str(got.value) == str(ref.value)


def _actions(parser):
    return sorted(
        (tuple(a.option_strings), a.dest, repr(a.default), getattr(a.type, "__name__", a.type),
         a.choices and tuple(a.choices), a.required)
        for a in parser._actions
    )


def test_parser_and_prompts_match_jax():
    assert _actions(tpope.build_parser()) == _actions(jpope.build_parser())
    assert tpope.POPE_PROMPTS == jpope.POPE_PROMPTS


def test_grouping_and_padding():
    """The id-array helpers the paths and ``chip_smoke.py`` share."""
    a, b = np.array([1, 5, 9, 32, 11, 13, 40]), np.array([1, 5, 9, 32, 11, 14, 41, 42])
    assert tpope.template_prefix_len(a, b) == 5
    assert tpope.template_prefix_len(a[:4], b) == 4
    rows = [np.array([1, 2, 3, 4, 9]), np.array([1, 2, 3, 5, 9, 9]), np.array([1, 2, 3, 4, 8])]
    assert tpope.group_prefix_len(rows, 5) == 3  # shrunk to the rows' common start
    assert tpope.group_prefix_len([np.array([1, 2, 3])], 5) == 2  # a tail token kept
    tail_ids, lens = tpope.pad_tails([np.array([4, 9]), np.array([5, 9, 9]), np.array([4, 8])])
    assert tail_ids.shape == (8, 8) and lens.tolist() == [2, 3, 2, 1, 1, 1, 1, 1]
    assert tail_ids[1, :3].tolist() == [5, 9, 9] and not tail_ids[1, 3:].any()
    ids, mask = tpope.pad_rows(rows + [np.arange(9)])
    assert ids.shape == (4, 16) and mask.sum(axis=1).tolist() == [5, 6, 5, 9]
    index, unique = tpope.image_slots(["b", "b", "a", "b", "c"])
    assert index == [0, 0, 1, 0, 2] and unique == ["b", "a", "c"]
    assert tpope.fill_rows([0, 1], 4) == [0, 1, 1, 1]
    assert tpope.image_runs(["x", "x", "y", "x"]) == [("x", 0, 2), ("y", 2, 3), ("x", 3, 4)]
