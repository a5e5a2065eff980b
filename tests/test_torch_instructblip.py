"""The InstructBLIP slice: the port's EVA ViT, Q-Former, ``visual_tokens``
and ``InstructBlipEngine`` against the JAX package, fp32 on the CPU.

The narrow model: a ViT of 3 layers x 32 wide (4 heads) on 28 px images in
7 px patches (17 tokens), a Q-Former of 4 layers x 32 wide with
cross-attention in layers 0 and 2 and 8 query tokens, and an LM of 2 layers
x 64 wide.  Weights are numpy from seed 5217 (the reference's InstructBLIP
seed) at std 0.2, so that argmax decisions are stable against fp32
summation order, and go to both packages through
``instructblip_params_from_numpy``.  The JAX engine's own mask draws are
injected into the port (and VCD's noised pixels and Gumbel draws), so
tokens must be equal.  Tolerances: the towers within 1e-5
(atol and rtol; fp32 on both sides, three layers of summation-order
differences); the LM's logits and K/V, and epis, within 1e-5 of their
largest value (logits of O(10) after 64-wide dots; the port's epis takes
K2's exact entropy form, the JAX CPU path log(p + 1e-10)).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dropoutdecoding_tpu.cli import chair_test as jcli
from dropoutdecoding_tpu.cli import pope_test as jpope
from dropoutdecoding_tpu.decoding.vcd import diffusion_noise as jax_diffusion_noise
from dropoutdecoding_tpu.decoding.vcd import noise_key
from dropoutdecoding_tpu.engine import baselines as jbase
from dropoutdecoding_tpu.engine import opera as jopera
from dropoutdecoding_tpu.engine.instructblip_engine import InstructBlipEngine as JaxEngine
from dropoutdecoding_tpu.models import blip_vit as jvit
from dropoutdecoding_tpu.models import instructblip as jib
from dropoutdecoding_tpu.models import qformer as jqf
from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu.utils import processor as jproc
from dropoutdecoding_tpu_torch.cli import chair_test as tcli
from dropoutdecoding_tpu_torch.cli import pope_test as tpope
from dropoutdecoding_tpu_torch.engine import baselines as tbase
from dropoutdecoding_tpu_torch.engine import opera as topera
from dropoutdecoding_tpu_torch.engine.instructblip_engine import NO_SHARED_PREFIX, InstructBlipEngine
from dropoutdecoding_tpu_torch.models import blip_vit as tvit
from dropoutdecoding_tpu_torch.models import instructblip as tib
from dropoutdecoding_tpu_torch.models import qformer as tqf
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils import processor as tproc
from dropoutdecoding_tpu_torch.utils.convert import instructblip_params_from_numpy
from test_chair_cli_end_to_end import synthetic_coco  # noqa: F401 (fixture)
from test_torch_baselines import jax_cd_gumbel, jax_cd_noise
from test_torch_engine import jax_uniform
from test_torch_pope import _vendored_coco

SEED = 5217  # the reference's InstructBLIP seed
TOL = dict(rtol=1e-5, atol=1e-5)
Q = 8  # query tokens of the narrow model
INPUT_IDS = np.array([[1, 5, 9, 11, 13, 17]])
QFORMER_IDS = np.array([[3, 7, 11, 13, 2]])
# the reference's InstructBLIP arm: epis_quantile masks, no accumulation, top-10 table
IB_ENS = dict(mask_policy="epis_quantile", mask_accumulate=False, topk=10)


def narrow_config(C):
    """The narrow InstructBLIP config, from config module ``C`` (either
    package's)."""
    return C.InstructBlipConfig(
        text=C.LlamaConfig(
            vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4, head_dim=16,
            max_position_embeddings=256,
        ),
        vision=C.BlipVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
            image_size=28, patch_size=7,
        ),
        qformer=C.QFormerConfig(
            vocab_size=48, hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
            intermediate_size=64, cross_attention_frequency=2, encoder_hidden_size=32,
            max_position_embeddings=64, num_query_tokens=Q,
        ),
        num_query_tokens=Q,
    )


def narrow_tree(seed=SEED, std=0.2):
    """Numpy InstructBlipParams of the narrow config, in the JAX layout."""
    r = np.random.default_rng(seed)

    def n(*shape, sc=std):
        return (sc * r.normal(size=shape)).astype(np.float32)

    def one(*shape):
        return (1 + 0.1 * r.normal(size=shape)).astype(np.float32)

    D, I, L, P = 32, 64, 3, 7
    vision = {
        "class_embedding": n(D), "patch_embedding": n(3 * P * P, D), "patch_bias": n(D, sc=0.1),
        "position_embedding": n(17, D), "post_ln_w": one(D), "post_ln_b": n(D, sc=0.1),
        "layers": {
            "ln1_w": one(L, D), "ln1_b": n(L, D, sc=0.1),
            "ln2_w": one(L, D), "ln2_b": n(L, D, sc=0.1),
            "qkv_w": n(L, D, 3 * D), "q_b": n(L, D, sc=0.1), "v_b": n(L, D, sc=0.1),
            "proj_w": n(L, D, D), "proj_b": n(L, D, sc=0.1),
            "fc1_w": n(L, D, I), "fc1_b": n(L, I, sc=0.1),
            "fc2_w": n(L, I, D), "fc2_b": n(L, D, sc=0.1),
        },
    }
    Dq, Iq, E = 32, 64, 32

    def lin(name, d_in, d_out):
        return {f"{name}_w": n(d_in, d_out), f"{name}_b": n(d_out, sc=0.1)}

    def norm(name):
        return {f"{name}_w": one(Dq), f"{name}_b": n(Dq, sc=0.1)}

    layers = []
    for i in range(4):
        lp = {**lin("self_q", Dq, Dq), **lin("self_k", Dq, Dq), **lin("self_v", Dq, Dq),
              **lin("self_out", Dq, Dq), **norm("self_ln"), **lin("interq", Dq, Iq),
              **lin("outq", Iq, Dq), **norm("outq_ln"), **lin("inter", Dq, Iq),
              **lin("out", Iq, Dq), **norm("out_ln")}
        if i % 2 == 0:
            lp.update({**lin("cross_q", Dq, Dq), **lin("cross_k", E, Dq),
                       **lin("cross_v", E, Dq), **lin("cross_out", Dq, Dq), **norm("cross_ln")})
        layers.append(lp)
    qformer = {
        "word_embeddings": n(48, Dq, sc=1.0), "position_embeddings": n(64, Dq),
        "emb_ln_w": one(Dq), "emb_ln_b": n(Dq, sc=0.1), "query_tokens": n(Q, Dq, sc=1.0),
        "layers": layers,
    }
    E2, L2, V, F, H, Dh = 64, 2, 128, 128, 4, 16
    lm = {
        "embed_tokens": n(V, E2, sc=1.0),
        "layers": {
            "input_ln": one(L2, E2), "post_attn_ln": one(L2, E2),
            "q_proj": n(L2, E2, H * Dh), "k_proj": n(L2, E2, H * Dh),
            "v_proj": n(L2, E2, H * Dh), "o_proj": n(L2, H * Dh, E2),
            "gate_proj": n(L2, E2, F), "up_proj": n(L2, E2, F), "down_proj": n(L2, F, E2),
        },
        "norm": one(E2),
        "lm_head": n(E2, V, sc=0.5),
    }
    return jib.InstructBlipParams(vision=vision, qformer=qformer,
                                  projection={"w": n(Dq, E2), "b": n(E2, sc=0.1)}, lm=lm)


def pixels_for(B, seed=1):
    return np.random.default_rng(seed).normal(size=(B, 3, 28, 28)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    tree = narrow_tree()
    return jax.tree.map(jnp.asarray, tree), instructblip_params_from_numpy(tree)


def _engines(weights, ensemble=True, max_new_tokens=6, max_len=64, eos=-1, gen=None, **ens):
    """(JAX engine, port engine) on the narrow weights, the JAX mask draws
    and VCD draws injected into the port; ``gen`` more GenerationConfig
    fields, ``ens`` EnsembleConfig fields.  ``max_len`` a multiple of 32: the
    JAX engine rounds it up to one."""
    jp, tp = weights
    ens = {**IB_ENS, **ens}
    kw = dict(max_new_tokens=max_new_tokens, eos_token_id=eos, pad_token_id=0, **(gen or {}))
    je = JaxEngine(
        cfg=narrow_config(jax_config), params=jp, ens=jax_config.EnsembleConfig(**ens),
        gen=jax_config.GenerationConfig(**kw), max_len=max_len, seed=SEED, ensemble=ensemble,
    )
    je.param_dtype = jnp.float32
    te = InstructBlipEngine(
        cfg=narrow_config(torch_config), params=tp, ens=torch_config.EnsembleConfig(**ens),
        gen=torch_config.GenerationConfig(**kw), max_len=max_len, seed=SEED, ensemble=ensemble,
        uniform=jax_uniform(SEED), cd_noise=jax_cd_noise(), cd_gumbel=jax_cd_gumbel(),
    )
    return je, te


def _padded_rows():
    """Three right-padded rows, their LM text lengths and their Q-Former
    instructions with a mask (the batched POPE shapes)."""
    rows = [[1, 9, 21, 33, 40], [1, 11, 23], [1, 13, 25, 37]]
    q_rows = [[3, 7, 11, 13], [3, 7], [3, 9, 11]]
    B, S, Sq = len(rows), 5, 4
    ids, q_ids, q_mask = (np.zeros((B, n), np.int32) for n in (S, Sq, Sq))
    for i in range(B):
        ids[i, : len(rows[i])] = rows[i]
        q_ids[i, : len(q_rows[i])] = q_rows[i]
        q_mask[i, : len(q_rows[i])] = 1
    return rows, q_rows, ids, np.array([len(r) for r in rows], np.int32), q_ids, q_mask


def _close_to_scale(got, ref, rel=1e-5):
    """Every element within ``rel`` of the largest |ref| (logits of O(10)
    sum 64-wide fp32 dots in another order on each side)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=rel * np.abs(ref).max())


def _t(a, dtype=None):
    return torch.from_numpy(np.asarray(a)) if dtype is None else torch.as_tensor(np.asarray(a), dtype=dtype)


# --- the towers -----------------------------------------------------------------


def test_vision_tower_matches_jax(weights):
    jp, tp = weights
    px = pixels_for(2)
    ref = jvit.apply(narrow_config(jax_config).vision, jp.vision, jnp.asarray(px))
    got = tvit.apply(narrow_config(torch_config).vision, tp.vision, torch.from_numpy(px))
    assert got.shape == (2, 17, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_vision_tower_has_no_k_bias(weights):
    """A k bias would shift every score of a query row by one constant,
    which the softmax removes, so the tower's output cannot show one; a q
    bias moves the output.  The port's qkv has no k third to hold a bias."""
    _, tp = weights
    assert set(tp.vision["layers"]) >= {"qkv_w", "q_b", "v_b"} and "k_b" not in tp.vision["layers"]
    cfg = narrow_config(torch_config).vision
    px = torch.from_numpy(pixels_for(1))
    base = tvit.apply(cfg, tp.vision, px)
    moved = dict(tp.vision, layers={**tp.vision["layers"], "q_b": tp.vision["layers"]["q_b"] + 1})
    assert (tvit.apply(cfg, moved, px) - base).abs().max() > 1e-2


@pytest.mark.parametrize("case", ["whole", "padded", "no text"])
def test_qformer_matches_jax(weights, case):
    """With and without a padded instruction mask, and at T = 0 (the text
    branch skipped); cross-attention in layers 0 and 2 only."""
    jp, tp = weights
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(3, 17, 32)).astype(np.float32)
    if case == "no text":
        ids, mask = np.zeros((3, 0), np.int32), None
    else:
        _, _, _, _, ids, mask = _padded_rows()
        mask = None if case == "whole" else mask
    ref = jqf.apply(narrow_config(jax_config).qformer, jp.qformer, jnp.asarray(ids),
                    jnp.asarray(emb), None if mask is None else jnp.asarray(mask))
    got = tqf.apply(narrow_config(torch_config).qformer, tp.qformer, _t(ids, torch.long),
                    torch.from_numpy(emb), None if mask is None else _t(mask))
    assert got.shape == (3, Q, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_qformer_mask_drops_the_pads(weights):
    """A padded row reads as its unpadded self: the pads are masked, not
    attended (the non-vacuity of the padded case above)."""
    _, tp = weights
    cfg = narrow_config(torch_config).qformer
    emb = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 17, 32)).astype(np.float32))
    padded = tqf.apply(cfg, tp.qformer, torch.tensor([[3, 7, 0, 0]]), emb, torch.tensor([[1, 1, 0, 0]]))
    short = tqf.apply(cfg, tp.qformer, torch.tensor([[3, 7]]), emb)
    unmasked = tqf.apply(cfg, tp.qformer, torch.tensor([[3, 7, 0, 0]]), emb)
    np.testing.assert_allclose(padded.numpy(), short.numpy(), **TOL)
    assert (unmasked - short).abs().max() > 1e-3


def test_visual_tokens_with_image_index_match_jax(weights):
    """Four rows over two unique images: the ViT runs twice, the Q-Former
    four times; equal to the rows' own images, and to JAX."""
    jp, tp = weights
    _, _, _, _, q_ids, q_mask = _padded_rows()
    q_ids, q_mask = np.concatenate([q_ids, q_ids[:1]]), np.concatenate([q_mask, q_mask[:1]])
    unique = pixels_for(2)
    index = np.array([0, 1, 1, 0], np.int32)
    ref = jib.visual_tokens(narrow_config(jax_config), jp, jnp.asarray(unique), jnp.asarray(q_ids),
                            jnp.asarray(q_mask), image_index=jnp.asarray(index))
    tc = narrow_config(torch_config)
    got = tib.visual_tokens(tc, tp, torch.from_numpy(unique), _t(q_ids, torch.long), _t(q_mask),
                            image_index=_t(index, torch.long))
    assert got.shape == (4, Q, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    whole = tib.visual_tokens(tc, tp, torch.from_numpy(unique[index]), _t(q_ids, torch.long),
                              _t(q_mask))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0, atol=1e-6)


def test_qformer_ids_outside_the_vocabulary_raise(weights):
    """JAX's gather clamps an id past the Q-Former's vocabulary (LM ids from
    a checkpoint with no qformer_tokenizer/); the port names the vocabulary
    before any lookup."""
    _, te = _engines(weights, ensemble=False)
    for bad in ([[3, 48]], [[3, -1]]):
        with pytest.raises(ValueError, match="vocabulary of 48 ids"):
            te.prefill(INPUT_IDS, pixels_for(1), np.array(bad))
    te.prefill(INPUT_IDS, pixels_for(1), np.array([[3, 47]]))


# --- the engine -------------------------------------------------------------------


def test_prefill_state_matches_jax(weights):
    """B = 3 right-padded rows with their Q-Former masks: fill (text + 8),
    the first token, the top-k table and epis."""
    je, te = _engines(weights)
    _, _, ids, lens, q_ids, q_mask = _padded_rows()
    px = pixels_for(3)
    js = je.prefill(ids, px, q_ids, text_lens=lens, qformer_attention_mask=q_mask)
    ts = te.prefill(ids, px, q_ids, text_lens=lens, qformer_attention_mask=q_mask)
    assert ts.cur_len.tolist() == (lens + Q).tolist() == np.asarray(js.cur_len).tolist()
    assert ts.image_pos.tolist() == [0, 0, 0] and bool(ts.visual_mask.all())
    np.testing.assert_array_equal(ts.first_token.numpy(), np.asarray(js.first_token))
    np.testing.assert_array_equal(ts.topk_ids.numpy(), np.asarray(js.topk_ids))
    np.testing.assert_array_equal(ts.probe_ids.numpy(), np.asarray(js.probe_ids))
    scale = np.abs(np.asarray(js.epis)).max()
    np.testing.assert_allclose(ts.epis.numpy(), np.asarray(js.epis), rtol=0, atol=1e-5 * scale)
    _close_to_scale(ts.last_logits.numpy(), js.last_logits)
    for b, n in enumerate(ts.cur_len.tolist()):
        _close_to_scale(ts.cache.k[:, b, :n].numpy(), js.cache.k[:, b, :n])


GEN_CASES = [(False, {}), (True, {}), (True, {"fused_step": True})]


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("ensemble,ens", GEN_CASES, ids=["greedy", "exact", "fused"])
def test_generate_matches_jax_engine(weights, ensemble, ens, B):
    """Greedy, exact K = 3 and fused K = 3 under ``epis_quantile``, JAX's
    draws injected, at B = 1 and B = 2 (two images, two instructions)."""
    je, te = _engines(weights, ensemble=ensemble, **ens)
    ids = np.concatenate([INPUT_IDS, INPUT_IDS[:, ::-1]])[:B]
    q_ids = np.concatenate([QFORMER_IDS, QFORMER_IDS[:, ::-1]])[:B]
    px = pixels_for(B)
    ref = je.generate(ids, px, q_ids)
    got = te.generate(ids, px, q_ids)
    assert got.tokens.shape == (B, 6)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.num_tokens, ref.num_tokens)


def test_ensemble_masks_change_the_output(weights):
    """Exact K = 3 departs from greedy within the 6 tokens compared above,
    so that parity is not vacuous."""
    _, greedy = _engines(weights, ensemble=False)
    _, exact = _engines(weights, ensemble=True)
    px = pixels_for(1)
    assert not np.array_equal(greedy.generate(INPUT_IDS, px, QFORMER_IDS).tokens,
                              exact.generate(INPUT_IDS, px, QFORMER_IDS).tokens)


def test_probe_matches_jax(weights):
    """The batched POPE probe: right-padded rows with ``text_lens``, their
    Q-Former masks and four rows over two unique images."""
    je, te = _engines(weights)
    _, _, ids, lens, q_ids, q_mask = _padded_rows()
    ids, lens = np.concatenate([ids, ids[:1]]), np.concatenate([lens, lens[:1]])
    q_ids, q_mask = np.concatenate([q_ids, q_ids[:1]]), np.concatenate([q_mask, q_mask[:1]])
    unique, index = pixels_for(2), np.array([0, 0, 1, 1], np.int32)
    kw = dict(text_lens=lens, qformer_attention_mask=q_mask, image_index=index)
    ref = je.probe(ids, unique, q_ids, **kw)
    got = te.probe(ids, unique, q_ids, **kw)
    np.testing.assert_array_equal(got.first_token.numpy(), np.asarray(ref.first_token))
    _close_to_scale(got.last_logits.numpy(), ref.last_logits)


def test_padded_probe_rows_equal_their_own_prefills(weights):
    """Each right-padded row's first token and logits are those of its own
    unpadded prefill: the fill is text + 8, not LLaVA's text + 8 - 1."""
    _, te = _engines(weights)
    rows, q_rows, ids, lens, q_ids, q_mask = _padded_rows()
    px = pixels_for(3)
    got = te.probe(ids, px, q_ids, text_lens=lens, qformer_attention_mask=q_mask)
    for i in range(3):
        own = te.prefill(np.array([rows[i]]), px[i : i + 1], np.array([q_rows[i]]))
        assert int(own.cur_len[0]) == len(rows[i]) + Q
        assert int(got.first_token[i]) == int(own.first_token[0])
        _close_to_scale(got.last_logits[i].numpy(), own.last_logits[0].numpy())


def test_generate_requires_qformer_ids(weights):
    je, te = _engines(weights)
    for eng in (je, te):
        with pytest.raises(ValueError, match="qformer_input_ids is required"):
            eng.generate(INPUT_IDS, pixels_for(1))


def test_kv_capacity_guard_at_max_len_as_jax(weights):
    """The merged prompt is 6 + 8 = 14 slots: 14 + 51 - 1 = 64 fills a cache
    of 64 exactly, and both packages generate; one token more, both raise
    (the port before any work)."""
    px = pixels_for(1)
    je, te = _engines(weights, ensemble=False, max_new_tokens=51)
    np.testing.assert_array_equal(te.generate(INPUT_IDS, px, QFORMER_IDS).tokens,
                                  je.generate(INPUT_IDS, px, QFORMER_IDS).tokens)
    je, te = _engines(weights, ensemble=False, max_new_tokens=52)
    with pytest.raises(ValueError, match="prompt \\(14 tokens\\) \\+ max_new_tokens \\(52\\)"):
        te.generate(INPUT_IDS, None, QFORMER_IDS)  # no pixels: the guard fires first
    with pytest.raises(ValueError, match="exceeds max_len"):
        je.generate(INPUT_IDS, px, QFORMER_IDS)


def test_entry_points_that_do_not_apply_raise(weights):
    _, te = _engines(weights)
    for method in ("probe_prefix", "probe_extend"):
        with pytest.raises(ValueError, match="no\\s+shared LM prefix exists"):
            getattr(te, method)(INPUT_IDS, pixels_for(1))
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        te.prefill_chunked(INPUT_IDS)


# --- the baselines ------------------------------------------------------------------


@pytest.mark.parametrize("B", [1, 2])
def test_vcd_matches_jax(weights, B):
    """The CLI's --vcd arm: the ViT reads the noised pixels (JAX's, injected)
    and the Q-Former its features; sampled with JAX's draws."""
    je, te = _engines(weights, ensemble=False, max_new_tokens=8, gen={"use_cd": True})
    ids = np.repeat(INPUT_IDS, B, 0)
    q_ids = np.repeat(QFORMER_IDS, B, 0)
    px = pixels_for(B)
    step = je.gen.cd_noise_step
    noised = np.asarray(jax.vmap(lambda p: jax_diffusion_noise(noise_key(), p, step))(
        jnp.asarray(px)))
    ref = jbase.vcd_generate(je, states=(je.prefill(ids, px, q_ids), je.prefill(ids, noised, q_ids)))
    t_noised = torch.stack([tbase.noised_pixels(te, p) for p in px])
    np.testing.assert_allclose(t_noised.numpy(), noised, rtol=0, atol=0)  # injected
    got = tbase.vcd_generate(te, states=(te.prefill(ids, px, q_ids),
                                         te.prefill(ids, t_noised, q_ids)))
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.num_tokens, ref.num_tokens)


@pytest.mark.parametrize("B", [1, 2])
def test_beam_search_matches_jax(weights, B):
    je, te = _engines(weights, ensemble=False, max_new_tokens=8, eos=2)
    ids = np.concatenate([INPUT_IDS, INPUT_IDS[:, ::-1]])[:B]
    q_ids = np.concatenate([QFORMER_IDS, QFORMER_IDS[:, ::-1]])[:B]
    px = pixels_for(B)
    ref = jbase.beam_generate(je, state=je.prefill(ids, px, q_ids), num_beams=3)
    got = tbase.beam_generate(te, state=te.prefill(ids, px, q_ids), num_beams=3)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.num_tokens, ref.num_tokens)


@pytest.mark.parametrize(
    "knobs", [dict(num_beams=3, num_attn_candidates=1, scale_factor=5.0, threshold=15),
              dict(num_beams=3, num_attn_candidates=2, scale_factor=50.0, threshold=2)],
    ids=["cli-defaults", "fan-out-rollback"])
def test_opera_matches_jax(weights, knobs):
    je, te = _engines(weights, ensemble=False, max_new_tokens=8)
    px = pixels_for(1)
    ref = jopera.opera_generate(je, state=je.prefill(INPUT_IDS, px, QFORMER_IDS), **knobs)
    stats = {}
    got = topera.opera_generate(te, state=te.prefill(INPUT_IDS, px, QFORMER_IDS), stats=stats,
                                **knobs)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.num_tokens, ref.num_tokens)
    if knobs["threshold"] == 2:
        assert stats["rollbacks"] >= 1  # the search rolled back


# --- HF names and the checkpoint ----------------------------------------------------


@pytest.fixture(scope="module")
def hf_model():
    """A tiny random HF InstructBLIP (3 ViT layers, 4 Q-Former layers with
    cross-attention in 0 and 2, 2 LM layers)."""
    from transformers import InstructBlipConfig as HFCfg
    from transformers import InstructBlipForConditionalGeneration, InstructBlipQFormerConfig
    from transformers import InstructBlipVisionConfig, LlamaConfig

    torch.manual_seed(5)
    cfg = HFCfg(
        vision_config=InstructBlipVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
            image_size=28, patch_size=7).to_dict(),
        qformer_config=InstructBlipQFormerConfig(
            vocab_size=48, hidden_size=24, num_hidden_layers=4, num_attention_heads=4,
            intermediate_size=48, cross_attention_frequency=2, encoder_hidden_size=32,
            max_position_embeddings=64).to_dict(),
        text_config=LlamaConfig(
            vocab_size=64, hidden_size=40, intermediate_size=80, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=128).to_dict(),
        num_query_tokens=4,
    )
    return InstructBlipForConditionalGeneration(cfg).eval().float()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _leaves(sub, f"{prefix}{i}/").items()}
    return {prefix: np.asarray(tree)}


def test_config_fills_what_the_hf_config_leaves_out():
    """A sub-config that leaves a core dim out takes transformers' default,
    as ``from_pretrained`` does (the JAX copy requires them): the EVA
    ViT-g/14, the 12-layer Q-Former (HF's vocabulary default 30522) and the
    Llama-7B widths."""
    from transformers import InstructBlipConfig as HFCfg

    hf = HFCfg()
    got = torch_config.InstructBlipConfig.from_hf_dict(
        {"vision_config": {}, "qformer_config": {}, "text_config": {}})
    for ours, ref in ((got.vision, hf.vision_config), (got.qformer, hf.qformer_config)):
        for f in dataclasses.fields(ours):
            if hasattr(ref, f.name) and f.name != "num_query_tokens":
                assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert got.qformer.vocab_size == 30522 and got.vision.num_positions == 257
    assert (got.text.hidden_size, got.text.num_hidden_layers, got.num_query_tokens) == (4096, 32, 32)


def test_params_from_hf_match_jax(hf_model):
    """The HF name map of every module, leaf for leaf against JAX's, from
    the same state dict; the qkv bias's k third is not kept."""
    from dropoutdecoding_tpu_torch.utils.hf_io import state_dict_from_torch_module

    sd = state_dict_from_torch_module(hf_model)
    jc = jax_config.InstructBlipConfig.from_hf_dict(hf_model.config.to_dict())
    tc = torch_config.InstructBlipConfig.from_hf_dict(hf_model.config.to_dict())
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    ref = _leaves(jib.params_from_hf(jc, sd, jnp.float32)._asdict())
    got = _leaves(tib.params_from_hf(tc, sd, torch.float32, "cpu")._asdict())
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert "qformer/layers/1/cross_q_w/" not in got and "qformer/layers/2/cross_q_w/" in got


def test_params_from_hf_fail_on_a_missing_or_stray_cross_layer(hf_model):
    from dropoutdecoding_tpu_torch.utils.hf_io import state_dict_from_torch_module

    sd = state_dict_from_torch_module(hf_model)
    tc = torch_config.InstructBlipConfig.from_hf_dict(hf_model.config.to_dict())
    missing = {k: v for k, v in sd.items()
               if not k.startswith("qformer.encoder.layer.2.crossattention.")}
    with pytest.raises(KeyError, match="layer.2.crossattention"):
        tib.params_from_hf(tc, missing, torch.float32, "cpu")
    every_layer = dataclasses.replace(tc.qformer, cross_attention_frequency=4)
    with pytest.raises(ValueError, match="layer 2 runs none"):
        tqf.params_from_hf(every_layer, sd, torch.float32, "cpu")


def test_load_reads_an_hf_checkpoint(hf_model, tmp_path):
    """``load`` of the directory ``save_pretrained`` writes (config.json and
    safetensors) gives the parameters ``params_from_hf`` makes; the visual
    tokens equal JAX's on them."""
    from dropoutdecoding_tpu_torch.utils.hf_io import state_dict_from_torch_module

    hf_model.save_pretrained(tmp_path, safe_serialization=True)
    cfg, params = tib.load(str(tmp_path), torch.float32, "cpu", cache=False)
    assert cfg == torch_config.InstructBlipConfig.from_hf_dict(hf_model.config.to_dict())
    assert cfg.vision.num_positions == 17 and len(params.qformer["layers"]) == 4
    sd = state_dict_from_torch_module(hf_model)
    jc = jax_config.InstructBlipConfig.from_hf_dict(hf_model.config.to_dict())
    jp = jib.params_from_hf(jc, sd, jnp.float32)
    px, q_ids = pixels_for(1), np.array([[3, 7, 11]])
    ref = jib.visual_tokens(jc, jp, jnp.asarray(px), jnp.asarray(q_ids))
    got = tib.visual_tokens(cfg, params, torch.from_numpy(px), torch.from_numpy(q_ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_chip_smoke_writer_round_trips(hf_model, tmp_path):
    """``chip_smoke``'s InstructBLIP writer (the inverse name map its CLI
    phase writes 7B with): three shards and an index that transformers
    loads with no key missing or unexpected, and that the port loads back
    bit for bit (the qkv bias's k third written as zeros and dropped)."""
    from transformers import InstructBlipForConditionalGeneration

    from chip_smoke import instructblip_hf_tensors, write_hf_checkpoint
    from dropoutdecoding_tpu_torch.utils.convert import synthetic_instructblip_params

    config = hf_model.config.to_dict()
    cfg = torch_config.InstructBlipConfig.from_hf_dict(config)
    params = synthetic_instructblip_params(cfg, "cpu", torch.float32, seed=4)
    write_hf_checkpoint(str(tmp_path), instructblip_hf_tensors(cfg, params), {"config.json": config})
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    assert len(set(index["weight_map"].values())) == 3
    _, info = InstructBlipForConditionalGeneration.from_pretrained(str(tmp_path),
                                                                   output_loading_info=True)
    assert info["missing_keys"] == [] and info["unexpected_keys"] == []
    got_cfg, got = tib.load(str(tmp_path), torch.float32, "cpu", cache=False)
    assert got_cfg == cfg
    want, got = _leaves(params._asdict()), _leaves(got._asdict())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- the image processor --------------------------------------------------------------


def test_blip_preprocessor_config_resizes_without_a_crop(tmp_path):
    """InstructBLIP's preprocessor_config.json (HF BlipImageProcessor: size
    {height, width}, no crop): the port resizes straight to 224 x 224, as
    transformers does; the JAX package's copy reads no shortest edge there
    and falls to 336 px (577 ViT tokens against 257 positions)."""
    from transformers import BlipImageProcessor

    cfg = {
        "do_convert_rgb": True, "do_normalize": True, "do_rescale": True, "do_resize": True,
        "image_mean": [0.48145466, 0.4578275, 0.40821073],
        "image_processor_type": "BlipImageProcessor",
        "image_std": [0.26862954, 0.26130258, 0.27577711],
        "processor_class": "InstructBlipProcessor", "resample": 3,
        "rescale_factor": 0.00392156862745098, "size": {"height": 224, "width": 224},
    }
    (tmp_path / "preprocessor_config.json").write_text(json.dumps(cfg))
    img = Image.fromarray(np.random.default_rng(0).integers(0, 256, (90, 130, 3), dtype=np.uint8))
    ours = tproc.image_preprocessor_from_checkpoint(str(tmp_path))
    got = ours(img)
    assert got.shape == (3, 224, 224)
    want = BlipImageProcessor.from_pretrained(str(tmp_path))(img, return_tensors="np")
    np.testing.assert_allclose(got, want["pixel_values"][0], rtol=0, atol=2e-6)
    assert jproc.ClipImagePreprocessor.from_checkpoint(str(tmp_path))(img).shape == (3, 336, 336)
    vlm = tproc.VlmProcessor(None, ours)
    assert vlm.image.batch([img]).shape == (1, 3, 224, 224)


# --- the CLIs -------------------------------------------------------------------------


class _IbProcessor:
    """A stand-in for InstructBLIP's processor pair: LM ids and Q-Former ids
    of the prompt's words (hashes below each vocabulary, so that prompts
    differ in their ids and lengths), 28 px pixels; decode reads "Yes" for
    an even token."""

    class _Tok:
        eos_token_id = 2

    tokenizer = _Tok()

    def __init__(self, lm_vocab=128, qformer_vocab=48):
        self.lm_vocab, self.qformer_vocab = lm_vocab, qformer_vocab

    @staticmethod
    def _ids(prompt, vocab):
        import zlib

        words = [3 + zlib.crc32(w.encode()) % (vocab - 3) for w in prompt.split()]
        return np.array([[1] + words + words[-1:] * (len(prompt) % 3)], np.int32)

    def __call__(self, prompt, image=None):
        out = {"input_ids": self._ids(prompt, self.lm_vocab)}
        if image is not None:
            arr = np.asarray(image.resize((28, 28)), np.float32) / 255.0
            out["pixel_values"] = arr.transpose(2, 0, 1)[None]
        return out

    def qformer_ids(self, prompt):
        return self._ids(prompt, self.qformer_vocab)

    def decode(self, token_ids, skip_special_tokens=True):
        toks = [int(t) for t in token_ids]
        head = ("Yes" if toks and toks[0] % 2 == 0 else "No") + "."
        return head + " a dog next to a chair" + "".join(f" t{t}" for t in toks)


def _gen(C, args, max_new_tokens=4):
    es = getattr(args, "early_stopping", "false")
    return C.GenerationConfig(
        max_new_tokens=max_new_tokens, eos_token_id=2, pad_token_id=2,
        num_beams=tcli.beam_count(args), length_penalty=getattr(args, "length_penalty", 1.0),
        early_stopping="never" if es == "never" else jcli.str2bool(es),
        use_cd=jcli.str2bool(getattr(args, "vcd", False)),
    )


def _arm(args):
    opera = jcli.str2bool(args.opera)
    return not (jcli.str2bool(args.original) or jcli.str2bool(args.vcd) or opera), opera


def _jax_make_engine(weights, engines=None):
    def make(args):
        assert args.model == "instructblip"
        ensemble, opera = _arm(args)
        eng = JaxEngine(cfg=narrow_config(jax_config), params=weights[0],
                        ens=jcli.build_ensemble_config(args, args.model),
                        gen=_gen(jax_config, args), max_len=64, seed=args.seed, ensemble=ensemble)
        eng.param_dtype = jnp.float32
        if opera:
            eng._opera = tcli.opera_knobs(args, tcli.beam_count(args))
        return eng, _IbProcessor()

    return make


def _port_make_engine(weights, engines):
    def make(args, device="cuda"):
        assert device == "cpu" and args.model == "instructblip"
        tcli.check_ported(args)
        ensemble, opera = _arm(args)
        eng = InstructBlipEngine(
            cfg=narrow_config(torch_config), params=tcli.maybe_quantize(args, weights[1]),
            ens=tcli.build_ensemble_config(args, args.model), gen=_gen(torch_config, args),
            max_len=64, seed=args.seed, ensemble=ensemble, uniform=jax_uniform(args.seed),
            cd_noise=jax_cd_noise(), cd_gumbel=jax_cd_gumbel(),
        )
        if opera:
            eng._opera = tcli.opera_knobs(args, tcli.beam_count(args))
        engines.append(eng)
        return eng, _IbProcessor()

    return make


def _chair_run(cli, coco, workdir, extra, monkeypatch, n=3, **main_kw):
    workdir.mkdir()
    monkeypatch.chdir(workdir)
    argv = ["--model", "instructblip", "--method", "itest", "--coco-data-dir", str(coco),
            "--model-path", "/unused", "--image-numbers", str(n), "--seed", str(SEED),
            "--output-dir", str(workdir / "outputs"),
            "--sample-save-name", str(workdir / "sample.log")] + extra
    cli.main(cli.build_parser().parse_args(argv), **main_kw)
    (captions,) = [f for f in os.listdir(workdir / "outputs") if f.startswith("itest")]
    stem = workdir / "results/itest/llava_instructblip/coco/llava_instructblip_coco_num_images_500"
    return {
        "captions": [json.loads(line) for line in open(workdir / "outputs" / captions)],
        "vlm_results": json.load(open(workdir / "vlm_results" / captions)),
        "chair.json": json.load(open(f"{stem}_chair_results.json")),
    }


CHAIR_ARMS = {
    "dropout-decoding": [], "original": ["--original", "True"],
    "dropout-decoding-batched": ["--batch-size", "2"],
    "vcd": ["--vcd", "True"], "vcd-batched": ["--vcd", "True", "--batch-size", "2"],
    "beam": ["--original", "True", "--num-beams", "3"],
    "beam-batched": ["--original", "True", "--num-beams", "3", "--batch-size", "2"],
    "opera": ["--opera", "True"],
}


@pytest.mark.parametrize("arm", list(CHAIR_ARMS))
def test_chair_main_writes_what_the_jax_main_writes(synthetic_coco, tmp_path, monkeypatch, weights,
                                                    arm):
    """``--model instructblip`` through both CLIs' ``main`` on the narrow
    model: the same captions, self-critical JSON and CHAIR results, serial
    and batched (3 images: a padded last group)."""
    monkeypatch.setattr(jcli, "make_engine", _jax_make_engine(weights))
    ref = _chair_run(jcli, synthetic_coco, tmp_path / "jax", CHAIR_ARMS[arm], monkeypatch)
    engines = []
    monkeypatch.setattr(tcli, "make_engine", _port_make_engine(weights, engines))
    got = _chair_run(tcli, synthetic_coco, tmp_path / "port", CHAIR_ARMS[arm], monkeypatch,
                     device="cpu")
    assert got == ref
    assert len(got["captions"]) == 3
    (eng,) = engines
    assert (eng.ens.mask_policy, eng.ens.mask_accumulate, eng.ens.topk) == ("epis_quantile", False, 10)


def test_chair_arms_differ(synthetic_coco, tmp_path, monkeypatch, weights):
    """The parity above is not vacuous: the arms' captions differ."""
    engines = []
    monkeypatch.setattr(tcli, "make_engine", _port_make_engine(weights, engines))
    caps = {arm: _chair_run(tcli, synthetic_coco, tmp_path / arm, CHAIR_ARMS[arm], monkeypatch,
                            device="cpu")["captions"]
            for arm in ("dropout-decoding", "original", "vcd", "beam")}
    assert len({json.dumps(c) for c in caps.values()}) == 4


def _pope_run(cli, coco, pope_dir, extra, **main_kw):
    args = cli.build_parser().parse_args(
        ["--model", "instructblip", "--model-path", "/unused", "--coco-data-dir", str(coco),
         "--pope-dir", str(pope_dir), "--seed", "0", "--number", "8"]
        + extra)
    cli.main(args, **main_kw)
    answers = {}
    for f in os.listdir(pope_dir / "answer"):
        if f.endswith("_ans.json"):
            answers[f.split("_")[-2]] = [json.loads(line) for line in open(pope_dir / "answer" / f)]
    return answers


def test_pope_main_writes_what_the_jax_main_writes(tmp_path, monkeypatch, weights):
    """The JAX POPE ``main`` serial, then the port's serial and with
    ``--batch-size 4`` (padded Q-Former rows, ``image_index``): the same
    answer archives, 8 vendored questions a strategy over two images."""
    coco = _vendored_coco(tmp_path, 8)
    monkeypatch.setattr(jcli, "make_engine", _jax_make_engine(weights))
    ref = _pope_run(jpope, coco, tmp_path / "jax", [])
    engines = []
    monkeypatch.setattr(tcli, "make_engine", _port_make_engine(weights, engines))
    for name, mode in (("serial", []), ("batch", ["--batch-size", "4"])):
        assert _pope_run(tpope, coco, tmp_path / name, mode, device="cpu") == ref, name
    assert sorted(ref) == ["adversarial", "popular", "random"]
    said = {a["answer"].split(".")[0] for v in ref.values() for a in v}
    assert said == {"Yes", "No"}, said  # the tokens differ, so the parity is not vacuous
    assert [e.gen.max_new_tokens for e in engines] == [1, 1]


@pytest.fixture
def tiny_checkpoint(hf_model, tmp_path, monkeypatch):
    """``hf_model`` saved as an HF checkpoint directory, the CLI's processor
    a stand-in at its vocabularies (no tokenizer files), and the engines the
    CLI's own ``make_engine`` builds from it (bf16 on the CPU)."""
    ckpt = tmp_path / "ckpt"
    hf_model.save_pretrained(ckpt, safe_serialization=True)
    proc = _IbProcessor(lm_vocab=64, qformer_vocab=48)
    monkeypatch.setattr(tcli, "load_processor", lambda path: proc)
    engines, make = [], tcli.make_engine

    def recorded(args, device="cuda"):
        engines.append(make(args, device)[0])
        return engines[-1], proc

    monkeypatch.setattr(tcli, "make_engine", recorded)
    return str(ckpt), proc, engines


def test_chair_main_on_a_tiny_hf_checkpoint(tiny_checkpoint, synthetic_coco, tmp_path, monkeypatch):
    """The CLI's own ``build_engine`` on an HF checkpoint directory: each
    ``--original`` caption equals the built engine's ``generate`` on the
    image and the instruction's two id sequences."""
    ckpt, proc, engines = tiny_checkpoint
    out = _chair_run(tcli, synthetic_coco, tmp_path / "run",
                     ["--model-path", ckpt, "--original", "True"], monkeypatch, device="cpu")
    (eng,) = engines
    assert isinstance(eng, InstructBlipEngine) and eng.max_len == 4 + 64 + 512
    prompt = tcli.PROMPTS["instructblip"]
    for rec in out["captions"]:
        image = Image.open(synthetic_coco / "val2014" / f"COCO_val2014_{rec['image_id']:012d}.jpg")
        inputs = proc(prompt, image.convert("RGB"))
        r = eng.generate(inputs["input_ids"], inputs["pixel_values"], proc.qformer_ids(prompt))
        text = proc.decode(r.tokens[0][: r.num_tokens[0]]).strip()
        assert rec["caption"] == ".".join(s for s in text.split(".") if "unk" not in s)


def test_pope_main_on_a_tiny_hf_checkpoint(tiny_checkpoint, tmp_path):
    """The POPE CLI on the checkpoint through ``build_engine``: serial and
    ``--batch-size 4`` write the same archives."""
    ckpt, _, engines = tiny_checkpoint
    coco = _vendored_coco(tmp_path, 8)

    def run(name, extra):
        args = tpope.build_parser().parse_args(
            ["--model", "instructblip", "--model-path", ckpt, "--coco-data-dir", str(coco),
             "--pope-dir", str(tmp_path / name), "--number", "8"] + extra)
        tpope.main(args, device="cpu")
        answer = tmp_path / name / "answer"
        return {f.split("_")[-2]: open(answer / f).read() for f in os.listdir(answer)
                if f.endswith("_ans.json")}

    serial = run("serial", [])
    assert run("batch", ["--batch-size", "4"]) == serial and len(serial) == 3
    assert len(engines) == 2 and all(isinstance(e, InstructBlipEngine) for e in engines)


def test_pope_prefix_cache_exits_with_the_engines_reason(tmp_path):
    argv = ["--model", "instructblip", "--model-path", "/unused", "--coco-data-dir",
            str(tmp_path / "coco"), "--pope-dir", str(tmp_path / "pope"), "--prefix-cache", "True"]
    with pytest.raises(SystemExit) as got:
        tpope.main(tpope.build_parser().parse_args(argv), device="cpu")
    assert str(got.value) == NO_SHARED_PREFIX
    assert not os.path.exists(tmp_path / "pope")


@pytest.fixture
def fake_load(monkeypatch, weights):
    calls = []
    monkeypatch.setattr(tib, "load", lambda *a: calls.append(a) or (narrow_config(torch_config),
                                                                     weights[1]))
    monkeypatch.setattr(tcli, "load_processor", lambda path: _IbProcessor())
    return calls


@pytest.mark.parametrize("extra", [[], ["--quantize", "int8", "--int8-kv", "True",
                                        "--original", "True", "--seed", "3"]])
def test_build_engine_for_instructblip(fake_load, extra):
    """``--model instructblip``: the JAX CLI's cache capacity (32 + 64 + 512
    at full width; 8 + 64 + 512 here), seed 5217, the reference's ensemble
    defaults, quantization on ``params.lm`` only."""
    args = tcli.build_parser().parse_args(
        ["--coco-data-dir", "d", "--model-path", "/ckpt", "--model", "instructblip"] + extra)
    eng, proc = tcli.make_engine(args, device="cpu")
    assert isinstance(eng, InstructBlipEngine)
    assert fake_load == [("/ckpt", torch.bfloat16, "cpu", True)]
    assert eng.max_len == Q + 64 + 512 and eng.gen.eos_token_id == proc.tokenizer.eos_token_id
    assert eng.seed == (3 if extra else SEED) and eng.ensemble != bool(extra)
    assert (eng.ens.mask_policy, eng.ens.mask_accumulate, eng.ens.topk) == ("epis_quantile", False, 10)
    assert isinstance(eng.params.lm["lm_head"], dict) == bool(extra) and eng.int8_kv == bool(extra)
    assert eng.params.vision["layers"]["qkv_w"].dtype == torch.float32  # the towers stay as loaded
