"""Every decoding arm of the port's engines against the JAX engines: fused
mode, sampling, the text-mask policies, "epis_kl" (exact and lagged) and
the other mask policies, ``use_avg`` downstream, right-padded rows; and
the functions under them.

All three of the JAX engine's streams are injected into the port (the mask
draws, the text-mask draws of stream 7919 and the Gumbel noise of stream
104729 that ``jax.random.categorical`` adds), so generated tokens must be
equal.  The JAX engine rounds ``max_len`` up to 32 and draws its text
uniforms at that length: the engines here use 64 (LLaVA) and 1344 (NeXT).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dropoutdecoding_tpu.decoding import masks as jmasks
from dropoutdecoding_tpu.engine import generate as jgen
from dropoutdecoding_tpu.engine.generate import LlavaEngine as JaxEngine
from dropoutdecoding_tpu.engine.llavanext_engine import LlavaNextEngine as JaxNextEngine
from dropoutdecoding_tpu.ops import sampling as jsampling
from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu_torch.decoding import masks as tmasks
from dropoutdecoding_tpu_torch.engine import generate as tgen
from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
from dropoutdecoding_tpu_torch.ops import sampling as tsampling
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils.convert import (
    llava_params_from_numpy,
    llavanext_params_from_numpy,
)
from dropoutdecoding_tpu_torch.utils.prng import (
    SAMPLE_STREAM,
    TEXT_STREAM,
    PhiloxGumbel,
    PhiloxTextUniform,
    leaf_seed,
)
from test_torch_engine import jax_gumbel, jax_text_uniform, jax_uniform
from test_torch_llavanext import SIZE as NEXT_SIZE
from test_torch_llavanext import INPUT_IDS as NEXT_IDS
from test_torch_llavanext import narrow_config, narrow_tree, tiles_for
from test_torch_models import INPUT_IDS, tiny_config, tiny_tree

SEED = 24
WIDE_V = 768  # a vocab that holds the "?" marker, 727
SAMPLE = {"do_sample": True, "temperature": 0.7, "top_k": 5, "top_p": 0.9}


def _wide(C):
    """The tiny config with ``WIDE_V`` tokens."""
    cfg = tiny_config(C)
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, vocab_size=WIDE_V))


@pytest.fixture(scope="module")
def weights():
    """{"tiny": (jax params, port params, pixels), "wide": the same with a
    768-token embedding and head}."""
    tree, pixels = tiny_tree()
    r = np.random.default_rng(7)
    lm = dict(tree.lm)
    lm["embed_tokens"] = r.normal(size=(WIDE_V, 48)).astype(np.float32)
    lm["lm_head"] = (0.2 * r.normal(size=(48, WIDE_V))).astype(np.float32)
    wide = tree._replace(lm=lm)
    return {
        name: (jax.tree.map(jnp.asarray, t), llava_params_from_numpy(t), pixels)
        for name, t in (("tiny", tree), ("wide", wide))
    }


def _engines(w, ensemble=True, max_new_tokens=6, gen=None, text=None, wide=False, **ens):
    """(JAX engine, port engine) on one set of weights, the port drawing
    JAX's three streams.  ``text``: the text-mask policy."""
    jp, tp, _ = w["wide" if wide else "tiny"]
    kw = dict(max_new_tokens=max_new_tokens, eos_token_id=-1, pad_token_id=0, **(gen or {}))
    common = dict(max_len=64, seed=SEED, ensemble=ensemble, text_mask_policy=text or "none")
    cfg = _wide if wide else tiny_config
    je = JaxEngine(
        cfg=cfg(jax_config), params=jp, ens=jax_config.EnsembleConfig(**ens),
        gen=jax_config.GenerationConfig(**kw), **common,
    )
    je.param_dtype = jnp.float32
    te = LlavaEngine(
        cfg=cfg(torch_config), params=tp, ens=torch_config.EnsembleConfig(**ens),
        gen=torch_config.GenerationConfig(**kw), **common, uniform=jax_uniform(SEED),
        text_uniform=jax_text_uniform(SEED), gumbel=jax_gumbel(SEED),
    )
    return je, te


def _assert_same_generate(je, te, ids, pixels):
    ref, got = je.generate(ids, pixels), te.generate(ids, pixels)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.num_tokens, ref.num_tokens)
    return got.tokens


ARMS = {  # id: (engine kwargs)
    "fused-epis": dict(fused_step=True),
    "fused-none": dict(fused_step=True, mask_policy="none"),
    "fused-epis_kl-lagged": dict(fused_step=True, mask_policy="epis_kl"),
    "fused-avg": dict(fused_step=True, use_avg=True),
    "fused-avg-sampled": dict(fused_step=True, use_avg=True, gen=SAMPLE),
    "exact-epis_kl": dict(mask_policy="epis_kl"),
    "exact-epis_quantile": dict(mask_policy="epis_quantile", mask_accumulate=False),
    "exact-keep_overlap": dict(mask_policy="keep_overlap"),
    "exact-aggressive": dict(mask_policy="aggressive"),
    "exact-all_image": dict(mask_policy="all_image"),
    "greedy-sampled": dict(ensemble=False, gen=SAMPLE),
    "exact-sampled": dict(gen=SAMPLE),
    "fused-sampled": dict(fused_step=True, gen=SAMPLE),
    "exact-text-logits": dict(text="logits", max_new_tokens=10),
    "exact-text-entropy": dict(text="entropy", max_new_tokens=10),
    "fused-text-logits": dict(fused_step=True, text="logits", max_new_tokens=10),
    "fused-text-entropy": dict(fused_step=True, text="entropy", max_new_tokens=10),
    "fused-epis_kl-entropy-sampled": dict(
        fused_step=True, mask_policy="epis_kl", text="entropy", max_new_tokens=10, gen=SAMPLE
    ),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_generate_matches_jax_engine(weights, arm):
    je, te = _engines(weights, **ARMS[arm])
    tokens = _assert_same_generate(je, te, INPUT_IDS, weights["tiny"][2])
    assert tokens.shape == (1, te.gen.max_new_tokens)


def test_text_logit_mask_flag_is_the_logits_policy(weights):
    je, te = _engines(weights, max_new_tokens=10)
    je.text_logits_mask = True
    te = dataclasses.replace(te, text_logits_mask=True)
    assert te.text_policy == "logits"
    _assert_same_generate(je, te, INPUT_IDS, weights["tiny"][2])


@pytest.mark.parametrize(
    "arm",
    ["fused-epis", "fused-sampled", "exact-epis_kl", "exact-aggressive"],
)
def test_the_arms_are_not_vacuous(weights, arm):
    """Each of these arms departs from the default arm's tokens on the tiny
    model within the tokens the parity above compares."""
    kw = ARMS[arm]
    _, default = _engines(weights, max_new_tokens=kw.get("max_new_tokens", 6))
    _, te = _engines(weights, **kw)
    pixels = weights["tiny"][2]
    assert not np.array_equal(
        default.generate(INPUT_IDS, pixels).tokens, te.generate(INPUT_IDS, pixels).tokens
    )


@pytest.mark.parametrize("arm", ["exact-text-logits", "exact-text-entropy", "fused-text-logits",
                                 "fused-text-entropy"])
def test_text_policies_drop_generated_slots(weights, arm):
    """The text arms of the parity above drop generated positions (and only
    those before the last 3) in some member at some step."""
    _, te = _engines(weights, **ARMS[arm])
    dropped = []
    slots_of = te._member_drop_slots

    def spy(state, argmax_src, step, logits_for_kl=None, cur_len=None, tm=None):
        drop = slots_of(state, argmax_src, step, logits_for_kl, cur_len, tm)
        start, end = int(state.cur_len[0]), int(cur_len[0])
        assert not drop[0, :, max(start, end - 3):].any()
        dropped.append(bool(drop[0, :, start:end].any()))
        return drop

    te._member_drop_slots = spy
    te.generate(INPUT_IDS, weights["tiny"][2])
    assert any(dropped)


def test_vqa_matches_jax_engine(weights):
    """The "vqa" policy on a prompt whose '?' (727) is followed by ids from
    the visual tokens' top-k table, so that the probe keep set is not
    empty.  Tokens after the image do not change the table (causal)."""
    je, te = _engines(weights, wide=True, mask_policy="vqa")
    pixels = weights["wide"][2]
    table = te.prefill(INPUT_IDS, pixels).topk_ids[0]
    ids = np.array([[1, 5, 9, 32, 727, int(table[0, 0]), int(table[3, 1]), 17]])
    state = te.prefill(ids, pixels)
    assert state.probe_ids[0, :3].tolist() == [int(table[0, 0]), int(table[3, 1]), 17]
    assert (state.probe_ids[0, 3:] == -1).all()
    assert tmasks.overlap_keep_mask_multi(state.probe_ids, state.topk_ids).any()
    _assert_same_generate(je, te, ids, pixels)


@pytest.mark.parametrize("arm", ["exact", "fused-entropy-sampled"])
def test_right_padded_batch_matches_jax(weights, arm):
    """B = 2, the second row right-padded (``text_lens``): the state's
    fill, first token and probe ids, then the decode loop's tokens."""
    ens = {} if arm == "exact" else dict(fused_step=True, text="entropy", gen=SAMPLE)
    je, te = _engines(weights, max_new_tokens=8, wide=True, **ens)
    pixels = np.repeat(weights["wide"][2], 2, axis=0)
    ids = np.array([[1, 5, 9, 32, 11, 727, 13, 17], [1, 7, 32, 727, 3, 0, 0, 0]])
    lens = np.array([8, 5])
    js, ts = je.prefill(ids, pixels, lens), te.prefill(ids, pixels, lens)
    np.testing.assert_array_equal(ts.cur_len.numpy(), np.asarray(js.cur_len))
    np.testing.assert_array_equal(ts.first_token.numpy(), np.asarray(js.first_token))
    np.testing.assert_array_equal(ts.probe_ids.numpy(), np.asarray(js.probe_ids))
    assert ts.probe_ids[1].tolist() == [3] + [-1] * 7  # no pad id taken
    assert ts.rng_id.tolist() == [0, 1] and ts.rng_id.device.type == "cpu"
    ref = np.asarray(je._decode(je.params, js)[0])
    np.testing.assert_array_equal(te.decode(ts).numpy(), ref)


def test_epis_kl_keeps_the_image_logits(weights):
    """Under "epis_kl" the state holds the visual-token logits, [B, N, V]
    fp32, equal to JAX's; every other policy a [B, N, 1] stub."""
    je, te = _engines(weights, mask_policy="epis_kl")
    pixels = weights["tiny"][2]
    js, ts = je.prefill(INPUT_IDS, pixels), te.prefill(INPUT_IDS, pixels)
    assert ts.image_logits.shape == (1, 16, 64) and ts.image_logits.dtype == torch.float32
    np.testing.assert_allclose(
        ts.image_logits.numpy(), np.asarray(js.image_logits), rtol=1e-5, atol=1e-4
    )
    _, plain = _engines(weights)
    assert plain.prefill(INPUT_IDS, pixels).image_logits.shape == (1, 16, 1)


def test_unknown_text_policy_raises(weights):
    with pytest.raises(ValueError, match="text-mask policy"):
        _engines(weights, text="bogus")


# --- LLaVA-NeXT --------------------------------------------------------------


@pytest.fixture(scope="module")
def next_weights():
    tree = narrow_tree()
    return jax.tree.map(jnp.asarray, tree), llavanext_params_from_numpy(tree)


@pytest.mark.parametrize(
    "ens", [dict(fused_step=True), dict(mask_policy="epis_kl"),
            dict(fused_step=True, mask_policy="epis_kl")],
    ids=["fused", "exact-epis_kl", "fused-epis_kl-lagged"],
)
def test_llavanext_matches_jax_engine(next_weights, ens):
    jp, tp = next_weights
    ens = {"mask_accumulate": False, "topk": 10, **ens}  # the LLaVA-NeXT defaults
    kw = dict(max_new_tokens=6, eos_token_id=-1, pad_token_id=0)
    common = dict(max_len=1344, seed=506, ensemble=True)
    je = JaxNextEngine(
        cfg=narrow_config(jax_config), params=jp, ens=jax_config.EnsembleConfig(**ens),
        gen=jax_config.GenerationConfig(**kw), **common,
    )
    je.param_dtype = jnp.float32
    te = LlavaNextEngine(
        cfg=narrow_config(torch_config), params=tp, ens=torch_config.EnsembleConfig(**ens),
        gen=torch_config.GenerationConfig(**kw), **common, uniform=jax_uniform(506),
        text_uniform=jax_text_uniform(506), gumbel=jax_gumbel(506),
    )
    tiles = tiles_for(te.cfg, NEXT_SIZE)
    ref = je.generate(NEXT_IDS, tiles, NEXT_SIZE)
    got = te.generate(NEXT_IDS, tiles, NEXT_SIZE)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    if ens.get("mask_policy") == "epis_kl":
        state = te.prefill(NEXT_IDS, tiles, NEXT_SIZE)
        assert state.image_logits.shape == (1, te.n_visual, te.cfg.text.vocab_size)


# --- the functions under the arms --------------------------------------------


NEW_POLICIES = ["epis_quantile", "epis_kl", "keep_overlap", "vqa", "aggressive", "all_image"]


@pytest.mark.parametrize("policy", NEW_POLICIES)
@pytest.mark.parametrize("with_valid", [False, True])
def test_member_drop_masks_match_jax(rng, policy, with_valid):
    N = 40
    epis = rng.gamma(2.0, 1.0, size=N).astype(np.float32)
    overlap = rng.random(N) > 0.8
    kl = rng.random(N) > 0.9
    valid = np.arange(N) < 31 if with_valid else None
    prev_j, prev_t = jnp.zeros((N,), bool), torch.zeros(N, dtype=torch.bool)
    for m, cap in enumerate((0.3, 0.5, 0.7)):
        key = jax.random.fold_in(jax.random.key(5), m)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (N,))))
        ref = jmasks.build_member_drop_mask(
            key, policy, jnp.asarray(epis), cap, jnp.asarray(overlap), prev_j, True,
            kl_keep=jnp.asarray(kl), valid=None if valid is None else jnp.asarray(valid),
        )
        got = tmasks.build_member_drop_mask(
            u, policy, torch.from_numpy(epis), cap, torch.from_numpy(overlap), prev_t, True,
            kl_keep=torch.from_numpy(kl), valid=None if valid is None else torch.from_numpy(valid),
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        prev_j, prev_t = ref, got


def test_masks_work_on_a_batch(rng):
    """The port's policies take a leading batch axis: row b of a batch call
    equals the call on row b."""
    B, N = 3, 24
    epis = torch.from_numpy(rng.gamma(2.0, 1.0, size=(B, N)).astype(np.float32))
    u = torch.from_numpy(rng.random((B, N)).astype(np.float32))
    overlap = torch.from_numpy(rng.random((B, N)) > 0.8)
    valid = torch.from_numpy(rng.random((B, N)) > 0.2)
    prev = torch.zeros((B, N), dtype=torch.bool)
    for policy in tmasks.POLICIES:
        batch = tmasks.build_member_drop_mask(
            u, policy, epis, 0.5, overlap, prev, True, kl_keep=overlap, valid=valid
        )
        for b in range(B):
            one = tmasks.build_member_drop_mask(
                u[b], policy, epis[b], 0.5, overlap[b], prev[b], True, kl_keep=overlap[b],
                valid=valid[b],
            )
            assert torch.equal(batch[b], one), policy


@pytest.mark.parametrize("with_valid", [False, True])
def test_epis_quantile_threshold_matches_jax(rng, with_valid):
    epis = rng.gamma(2.0, 1.0, size=(4, 57)).astype(np.float32)
    valid = rng.random((4, 57)) > 0.3 if with_valid else None
    for cap in (0.3, 0.5, 0.7, 0.9):
        got = tmasks.epis_quantile_threshold(
            torch.from_numpy(epis), cap, None if valid is None else torch.from_numpy(valid)
        )[:, 0]
        if valid is None:
            ref = jax.vmap(lambda e: jnp.quantile(e, 1.0 - cap))(jnp.asarray(epis))
        else:
            ref = jax.vmap(lambda e, v: jnp.nanquantile(jnp.where(v, e, jnp.nan), 1.0 - cap))(
                jnp.asarray(epis), jnp.asarray(valid))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_aggressive_drops_a_fixed_count(rng):
    u = torch.from_numpy(rng.random((2, 100)).astype(np.float32))
    z = torch.zeros((2, 100), dtype=torch.bool)
    drop = tmasks.build_member_drop_mask(u, "aggressive", u, 0.3, z, z, False)
    assert drop.sum(dim=-1).tolist() == [int(0.3 * 99)] * 2


def test_overlap_keep_mask_multi_matches_jax(rng):
    topk = rng.integers(0, 20, size=(2, 30, 5))
    probes = np.array([[3, 11, -1, -1], [-1, -1, -1, -1]])
    ref = jax.vmap(jmasks.overlap_keep_mask_multi)(jnp.asarray(probes), jnp.asarray(topk))
    got = tmasks.overlap_keep_mask_multi(torch.from_numpy(probes), torch.from_numpy(topk))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[0].any() and not got[1].any()  # -1 pads never keep a token


@pytest.mark.parametrize("with_lens", [False, True])
def test_extract_probe_ids_matches_jax(with_lens):
    ids = np.array([
        [1, 5, 727, 9, 11, 13, 0, 0],  # '?' then three real ids, two pads
        [1, 2, 3, 4, 5, 6, 7, 8],  # no '?'
        [1, 727, 4, 727, 6, 7, 8, 9],  # the first '?' counts
        [1, 2, 3, 4, 5, 6, 7, 727],  # '?' last: nothing after it
    ])
    lens = np.array([6, 8, 8, 8]) if with_lens else None
    ref = jgen.extract_probe_ids(jnp.asarray(ids), text_lens=None if lens is None else jnp.asarray(lens))
    got = tgen.extract_probe_ids(torch.from_numpy(ids), text_lens=lens)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.int32
    assert got[0].tolist() == [9, 11, 13] + ([-1] * 5 if with_lens else [0, 0, -1, -1, -1])


WARPS = [(1.0, None, 1.0), (0.7, None, 1.0), (1.0, 10, 1.0), (1.0, None, 0.9),
         (0.8, 7, 0.85), (2.5, 3, 0.5), (1.0, 1, 1.0), (1.0, None, 0.05), (0.7, 5, 0.9)]


@pytest.mark.parametrize("temp,k,p", WARPS)
def test_warp_logits_matches_jax(temp, k, p):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(5, 64)) * 3).astype(np.float32)
    logits[0, :4] = logits[0].max()  # ties at the top
    ref = np.asarray(jsampling.warp_logits(jnp.asarray(logits), temp, k, p))
    got = tsampling.warp_logits(torch.from_numpy(logits), temp, k, p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    kept = np.isfinite(ref)
    np.testing.assert_allclose(got[kept], ref[kept], rtol=1e-6, atol=1e-6)
    assert kept.any(axis=-1).all()


@pytest.mark.parametrize("temp,k,p", WARPS)
def test_warp_logits_matches_hf_warpers(temp, k, p):
    """The JAX package's HF golden (``tests/test_sampling.py``), inherited:
    the kept sets and surviving values of ``transformers``' warpers."""
    logits_process = pytest.importorskip("transformers.generation.logits_process")
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(5, 64)) * 3).astype(np.float32)
    ref = torch.from_numpy(logits.copy())
    if temp != 1.0:
        ref = logits_process.TemperatureLogitsWarper(temp)(None, ref)
    if k is not None:
        ref = logits_process.TopKLogitsWarper(k)(None, ref)
    if p < 1.0:
        ref = logits_process.TopPLogitsWarper(top_p=p)(None, ref)
    ref = ref.numpy()
    got = tsampling.warp_logits(torch.from_numpy(logits), temp, k, p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    np.testing.assert_allclose(got[np.isfinite(got)], ref[np.isfinite(ref)], rtol=1e-6)


@pytest.mark.parametrize("temp,k,p", [(1.0, None, 1.0), (0.7, 5, 0.9), (2.5, 3, 0.5)])
def test_sample_token_equals_jax_categorical(temp, k, p):
    """With the Gumbel noise of the key injected, the port's draw is
    ``jax.random.categorical``'s on that key, row by row."""
    gen = torch_config.GenerationConfig(temperature=temp, top_k=k, top_p=p)
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(8, 64)) * 2).astype(np.float32)
    keys = [jax.random.fold_in(jax.random.key(3), b) for b in range(8)]
    warped = jsampling.warp_logits(jnp.asarray(logits), temp, k, p)
    ref = [int(jax.random.categorical(key, warped[b])) for b, key in enumerate(keys)]
    noise = torch.from_numpy(
        np.stack([np.array(jax.random.gumbel(key, (64,), jnp.float32)) for key in keys])
    )
    got = tsampling.sample_token(torch.from_numpy(logits), noise, gen)
    assert got.tolist() == ref
    assert len(set(ref)) > 1


@pytest.mark.parametrize("step", [0, 2, 9])  # 9: past T, written at T - 1
def test_record_text_stats_matches_jax(rng, step):
    B, T, V = 3, 6, 64
    logits = (rng.normal(size=(B, V)) * 3 + 1).astype(np.float32)
    jtm = jgen.TextMaskState(*(jnp.zeros((B, T)) for _ in range(3)))
    ref = jgen._record_text_stats(jtm, jnp.full((B,), step), jnp.asarray(logits))
    ttm = tgen.TextMaskState(*(torch.zeros((B, T)) for _ in range(3)))
    got = tgen._record_text_stats(ttm, step, torch.from_numpy(logits))
    for name in ("prob", "ent", "vent"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=1e-5, atol=1e-5
        )
    assert (got.prob[:, min(step, T - 1)] != 0).all() and int((got.prob != 0).sum()) == B


def test_streams_have_their_own_leaves():
    """No leaf of one stream is a leaf of another: the text and sampling
    trees hang under negative tags where the mask tree has a step."""
    masks = {leaf_seed(SEED, s, r, m) for s in range(6) for r in range(3) for m in range(3)}
    text = {leaf_seed(SEED, TEXT_STREAM, s, r) for s in range(6) for r in range(3)}
    sample = {leaf_seed(SEED, SAMPLE_STREAM, s, r) for s in range(6) for r in range(3)}
    assert len(masks) == 54 and len(text) == len(sample) == 18
    assert not (masks & text) and not (masks & sample) and not (text & sample)
    u = PhiloxTextUniform(SEED, "cpu")
    a = u(3, 1, 40)
    assert a.shape == (40,) and ((a >= 0) & (a < 1)).all()
    assert torch.equal(a, u(3, 1, 40)) and not torch.equal(a, u(3, 0, 40))
    g = PhiloxGumbel(SEED, "cpu")(0, 0, 4096)
    assert torch.isfinite(g).all()
    assert abs(g.mean().item() - 0.5772) < 0.08  # the Gumbel mean, Euler's constant


def test_sampling_is_deterministic_and_seed_sensitive(weights):
    """The production Gumbel source: one seed gives one draw, and at a high
    temperature another seed gives another."""
    _, tp, pixels = weights["tiny"]
    gen = torch_config.GenerationConfig(
        max_new_tokens=8, eos_token_id=-1, do_sample=True, temperature=8.0
    )

    def run(seed):
        eng = LlavaEngine(cfg=tiny_config(torch_config), params=tp, gen=gen, max_len=64,
                          seed=seed, ensemble=False)
        return eng.generate(INPUT_IDS, pixels).tokens

    first = run(24)
    np.testing.assert_array_equal(first, run(24))
    assert not (np.array_equal(first, run(1)) and np.array_equal(first, run(2)))


@pytest.mark.parametrize("mode", ["greedy", "exact", "fused"])
def test_do_sample_top_k_1_equals_greedy(weights, mode):
    """The JAX test ``tests/test_sampling.py:92`` on the port with its own
    Philox noise: top-k 1 leaves only the argmax."""
    _, tp, pixels = weights["tiny"]
    kw = dict(cfg=tiny_config(torch_config), params=tp, max_len=64, ensemble=mode != "greedy",
              ens=torch_config.EnsembleConfig(fused_step=mode == "fused"))
    base = torch_config.GenerationConfig(max_new_tokens=8, eos_token_id=-1)
    sampled = dataclasses.replace(base, do_sample=True, top_k=1, temperature=0.7)
    np.testing.assert_array_equal(
        LlavaEngine(gen=base, **kw).generate(INPUT_IDS, pixels).tokens,
        LlavaEngine(gen=sampled, **kw).generate(INPUT_IDS, pixels).tokens,
    )
