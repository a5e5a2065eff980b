"""The int8 tier of the port against the JAX package: weight conversion,
the quantizers, K3's and K4's plain twins, the int8 decoder and the engine.

Tolerances:
- quantizers, cache seed and cache append: **bit-equal** (both sides take
  IEEE fp32 division by the scale and round half to even);
- K3's twin in fp32: 1e-5 (summation order only); in bf16: 2e-2 of
  max|ref| (bf16 keeps 8 bits; the JAX tests hold the TPU kernel to the
  same bound, ``tests/test_pallas_kernels.py``);
- ``decode_step``: atol 1e-4 (fp32, a few layers of summation-order
  differences compound, as in ``test_torch_models.py``);
- the engine: generated tokens **equal** with JAX's mask draws injected.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dropoutdecoding_tpu.utils import quantize as jq
from dropoutdecoding_tpu_torch.utils.convert import llava_params_from_numpy
from test_torch_models import tiny_tree


def test_convert_keeps_int8_leaves():
    """A quantized JAX tree converts with ``q`` int8 and ``s`` fp32, whatever
    dtype is asked for, with the values unchanged."""
    tree, _ = tiny_tree()
    lm = jq.quantize_llama_params(jax.tree.map(jnp.asarray, tree.lm))
    qtree = tree._replace(lm=jax.tree.map(np.asarray, lm))
    tp = llava_params_from_numpy(qtree, dtype=torch.bfloat16)
    for name in ("q_proj", "down_proj"):
        leaf, ref = tp.lm["layers"][name], qtree.lm["layers"][name]
        assert leaf["q"].dtype == torch.int8 and leaf["s"].dtype == torch.float32
        np.testing.assert_array_equal(leaf["q"].numpy(), ref["q"])
        np.testing.assert_array_equal(leaf["s"].numpy(), ref["s"])
    assert tp.lm["lm_head"]["q"].dtype == torch.int8
    assert tp.lm["embed_tokens"].dtype == torch.bfloat16


# --- the quantizers: bit-equal ----------------------------------------------


def _with_ties(x, axis):
    """Plant, along ``axis`` of ``x``, a slice with amax 31.75 (scale 0.25
    exactly) holding values at exact .5 ties of the scale, and an all-zero
    slice (scale 1)."""
    x = np.moveaxis(x.copy(), axis, -1)
    ties = np.array([31.75, 0.125, 0.375, 0.625, -0.125, -0.625, 2.5 * 0.25, -31.75])
    x[..., 0, : ties.size] = ties
    x[..., 0, ties.size:] = 0.0
    x[..., 1, :] = 0.0
    return np.moveaxis(x, -1, axis).astype(np.float32)


def _equal(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_quantize_matrix_bit_equal(rng):
    from dropoutdecoding_tpu_torch.utils import quantize as tq

    w = _with_ties(rng.normal(size=(2, 16, 9)) * 0.05, axis=-2)  # channels are columns
    got, ref = tq.quantize_matrix(torch.from_numpy(w)), jq.quantize_matrix(jnp.asarray(w))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    _equal(got["q"], ref["q"])
    _equal(got["s"], ref["s"])
    assert got["s"][0, 0, 0] == 0.25 and got["s"][0, 0, 1] == 1.0
    _equal(tq.dequantize_matrix(got), jq.dequantize_matrix(ref))


def test_quantize_kv_bit_equal(rng):
    from dropoutdecoding_tpu_torch.utils import quantize as tq

    x = _with_ties(rng.normal(size=(2, 3, 4, 16)), axis=-1)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        xj = jnp.asarray(x, jdtype)
        xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(dtype)
        got, ref = tq.quantize_kv(xt), jq.quantize_kv(xj)
        _equal(got["q"], ref["q"])
        _equal(got["s"], ref["s"])


def test_quantize_llama_params_and_fuse_bit_equal():
    from dropoutdecoding_tpu_torch.utils import quantize as tq

    tree, _ = tiny_tree()
    lm_t = llava_params_from_numpy(tree).lm
    lm_j = jax.tree.map(jnp.asarray, tree.lm)
    for fuse in (False, True):
        got, ref = tq.quantize_llama_params(lm_t), jq.quantize_llama_params(lm_j)
        if fuse:
            got, ref = tq.fuse_projections(got), jq.fuse_projections(ref)
            assert tq.fuse_projections(got) is got
        flat_ref = jax.tree_util.tree_leaves_with_path(ref)
        assert len(flat_ref) == len(jax.tree_util.tree_leaves(got))
        for path, leaf in flat_ref:
            t = got
            for key in path:
                t = t[key.key]
            assert t.dtype == {np.int8: torch.int8}.get(np.dtype(leaf.dtype).type, torch.float32)
            _equal(t, leaf)
    dense = tq.fuse_projections(lm_t)["layers"]["gate_up_proj"]
    _equal(dense, jq.fuse_projections(lm_j)["layers"]["gate_up_proj"])


def test_synthetic_int8_lm():
    from dropoutdecoding_tpu_torch.utils.config import LlamaConfig
    from dropoutdecoding_tpu_torch.utils.convert import synthetic_int8_lm

    cfg = LlamaConfig(vocab_size=64, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, head_dim=12)
    lm = synthetic_int8_lm(cfg, "cpu", seed=1)
    assert set(lm["layers"]) == {
        "input_ln", "post_attn_ln", "o_proj", "down_proj", "qkv_proj", "gate_up_proj"
    }
    qkv = lm["layers"]["qkv_proj"]
    assert qkv["q"].shape == (2, 48, 96) and qkv["q"].dtype == torch.int8
    assert qkv["s"].shape == (2, 1, 96) and qkv["s"].dtype == torch.float32
    assert lm["layers"]["gate_up_proj"]["q"].shape == (2, 48, 192)
    assert lm["layers"]["down_proj"]["q"].shape == (2, 96, 48)
    assert lm["lm_head"]["q"].shape == (48, 64) and lm["embed_tokens"].dtype == torch.bfloat16
    assert torch.all(qkv["s"] == torch.tensor(0.02 / 73.9))
    q = lm["layers"]["down_proj"]["q"].float()
    assert q.min() >= -128 and q.max() <= 127 and 60 < q.std() < 90
    again = synthetic_int8_lm(cfg, "cpu", seed=1)
    assert torch.equal(again["layers"]["down_proj"]["q"], lm["layers"]["down_proj"]["q"])


def test_synthetic_int8_engine_runs():
    """The full-width card path at a tiny size on the CPU: synthetic bf16
    vision and projector, ``synthetic_int8_lm`` and an int8 cache, through
    ``LlavaEngine.generate`` in exact K=3 mode."""
    from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
    from dropoutdecoding_tpu_torch.models.llava import LlavaParams
    from dropoutdecoding_tpu_torch.utils import config as torch_config
    from dropoutdecoding_tpu_torch.utils.convert import synthetic_int8_lm, synthetic_llava_params
    from test_torch_models import INPUT_IDS, tiny_config

    cfg = tiny_config(torch_config)
    dense = synthetic_llava_params(cfg, "cpu", torch.bfloat16, seed=2)
    params = LlavaParams(dense.vision, dense.projector, synthetic_int8_lm(cfg.text, "cpu", seed=2))
    pixels = np.random.default_rng(2).normal(
        size=(1, 3, cfg.vision.image_size, cfg.vision.image_size)
    ).astype(np.float32)
    eng = LlavaEngine(
        cfg=cfg, params=params, max_len=64, int8_kv=True,
        gen=torch_config.GenerationConfig(max_new_tokens=6, eos_token_id=-1, pad_token_id=0),
    )
    state = eng.prefill(INPUT_IDS, pixels)
    assert state.cache.k["q"].dtype == torch.int8 and state.cache.v["s"].dtype == torch.float32
    for v in state.uncertainty.values():
        assert torch.isfinite(v).all()
    tokens = eng.generate(INPUT_IDS, pixels).tokens
    assert tokens.shape == (1, 6)
    assert ((tokens >= 0) & (tokens < cfg.text.vocab_size)).all()


# --- K3's plain twin against the JAX op --------------------------------------


def _int8kv_inputs(rng, B, M, KH, G, D, S, fill=None):
    H = KH * G
    fill = np.asarray([S - 6] * B if fill is None else fill)  # a row's filled slots
    q = rng.normal(size=(B, M, H, D)).astype(np.float32)
    kq = rng.integers(-127, 128, (B, S, KH, D)).astype(np.int8)
    vq = rng.integers(-127, 128, (B, S, KH, D)).astype(np.int8)
    ks = rng.uniform(0.01, 0.03, (B, KH, S)).astype(np.float32)
    vs = rng.uniform(0.01, 0.03, (B, KH, S)).astype(np.float32)
    kn = rng.normal(size=(B, M, KH, D)).astype(np.float32)
    vn = rng.normal(size=(B, M, KH, D)).astype(np.float32)
    mask = (np.arange(S)[None, None] < fill[:, None, None]) & (rng.random((B, M, S)) < 0.7)
    mask[0, M - 1] = False  # a member that attends only its own token
    return q, kq, ks, vq, vs, kn, vn, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2])
def test_int8kv_attention_twin_matches_jax(rng, G, dtype):
    from dropoutdecoding_tpu.ops.attention import ensemble_decode_attention_int8kv as jop
    from dropoutdecoding_tpu_torch.ops.cuda_decode_attention import (
        ensemble_decode_attention_int8kv_fused,
    )

    args = _int8kv_inputs(rng, B=2, M=3, KH=2, G=G, D=32, S=70)  # S not a multiple of 32
    act = (0, 5, 6)  # q, k_new, v_new take the activation dtype
    jargs = [jnp.asarray(a, dtype) if i in act else jnp.asarray(a) for i, a in enumerate(args)]
    ref = np.asarray(jop(*jargs).astype(jnp.float32))
    targs = [torch.from_numpy(np.array(a.astype(jnp.float32) if i in act else a))
             for i, a in enumerate(jargs)]
    targs = [t.to(getattr(torch, dtype)) if i in act else t for i, t in enumerate(targs)]
    got = ensemble_decode_attention_int8kv_fused(*targs)  # CPU tensors: the twin
    assert got.dtype == getattr(torch, dtype) and got.shape == ref.shape
    err = np.abs(got.float().numpy() - ref).max()
    bound = 1e-5 if dtype == "float32" else 2e-2 * np.abs(ref).max()
    assert err <= bound, (err, bound)


@pytest.mark.parametrize(
    "B,M,KH,G,fill",
    [(1, 4, 2, 4, None), (1, 6, 2, 4, None), (2, 3, 2, 2, [3, 64]), (2, 3, 2, 2, [0, 70])],
    ids=["16 rows a group", "24 rows a group", "two rows, fills 3 and 64",
         "two rows, one with no filled slot"],
)
def test_int8kv_attention_twin_geometries_match_jax(rng, B, M, KH, G, fill):
    """The query rows of a kv group fill one 16-row tensor-core tile, or take
    two; batch rows with their own fills."""
    from dropoutdecoding_tpu.ops.attention import ensemble_decode_attention_int8kv as jop
    from dropoutdecoding_tpu_torch.ops.cuda_decode_attention import (
        ensemble_decode_attention_int8kv_fused,
    )

    args = _int8kv_inputs(rng, B, M, KH, G, D=16, S=70, fill=fill)
    ref = np.asarray(jop(*map(jnp.asarray, args)))
    got = ensemble_decode_attention_int8kv_fused(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_kernel_wrappers_never_fall_back(rng):
    from dropoutdecoding_tpu_torch.ops.cuda_cache_append import cache_append_int8
    from dropoutdecoding_tpu_torch.ops.cuda_decode_attention import (
        ensemble_decode_attention_int8kv_fused,
    )

    args = _int8kv_inputs(rng, B=1, M=2, KH=2, G=1, D=8, S=8)
    meta = [torch.empty(a.shape, dtype=torch.from_numpy(a).dtype, device="meta") for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        ensemble_decode_attention_int8kv_fused(*meta)
    kq = torch.empty(2, 1, 8, 16, dtype=torch.int8, device="meta")
    ks = torch.empty(2, 1, 2, 8, device="meta")
    new = torch.empty(2, 1, 2, 8, device="meta")
    cur = torch.zeros(1, dtype=torch.long, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cache_append_int8(kq, ks, kq, ks, cur, new, new)


# --- the int8 cache: seed and append (K4's twin), bit-equal -------------------


def _int8_caches(tcfg, jcfg, B, Smax, S0, rng):
    """Both packages' int8 caches seeded with one set of dense prefill K/V."""
    from dropoutdecoding_tpu.models import llama as jllama
    from dropoutdecoding_tpu_torch.models import llama as tllama

    L, KH, D = tcfg.num_hidden_layers, tcfg.num_key_value_heads, tcfg.head_dim
    k = _with_ties(rng.normal(size=(L, B, S0, KH, D)), axis=-1)
    v = rng.normal(size=(L, B, S0, KH, D)).astype(np.float32)
    cj = jllama.cache_seed(
        jllama.empty_cache(jcfg, B, Smax, jnp.float32, quantized=True),
        jllama.KVCache(jnp.asarray(k), jnp.asarray(v)),
    )
    ct = tllama.cache_seed(
        tllama.empty_cache(tcfg, B, Smax, torch.float32, "cpu", quantized=True),
        tllama.KVCache(torch.from_numpy(k), torch.from_numpy(v)),
    )
    return ct, cj


def _caches_equal(ct, cj):
    for leaf_t, leaf_j in ((ct.k, cj.k), (ct.v, cj.v)):
        assert leaf_t["q"].dtype == torch.int8 and leaf_t["s"].dtype == torch.float32
        _equal(leaf_t["q"], leaf_j["q"])
        _equal(leaf_t["s"], leaf_j["s"])


@pytest.fixture(scope="module")
def cfgs():
    from dropoutdecoding_tpu.utils import config as jax_config
    from dropoutdecoding_tpu_torch.utils import config as torch_config
    from test_torch_models import tiny_config

    return tiny_config(torch_config), tiny_config(jax_config)


def test_cache_seed_int8_bit_equal(rng, cfgs):
    ct, cj = _int8_caches(cfgs[0].text, cfgs[1].text, B=2, Smax=24, S0=10, rng=rng)
    assert ct.k["q"].shape == (2, 2, 24, 48) and ct.k["s"].shape == (2, 2, 4, 24)
    _caches_equal(ct, cj)
    assert (ct.k["s"][..., 10:] == 1).all() and (ct.k["q"][:, :, 10:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_set_rows_int8_bit_equal(rng, cfgs, dtype):
    """K4's twin, through ``cache_set_rows``: rows with different
    ``cur_len`` write their quantized K/V and scales in place, and every
    other slot stays as it was."""
    from dropoutdecoding_tpu.models import llama as jllama
    from dropoutdecoding_tpu_torch.models import llama as tllama

    ct, cj = _int8_caches(cfgs[0].text, cfgs[1].text, B=2, Smax=24, S0=10, rng=rng)
    before = {(n, f): getattr(ct, n)[f].clone() for n in ("k", "v") for f in ("q", "s")}
    cur = np.array([10, 13])
    kn = jnp.asarray(_with_ties(rng.normal(size=(2, 2, 4, 12)), axis=-1), dtype)
    vn = jnp.asarray(rng.normal(size=(2, 2, 4, 12)), dtype)
    cj = jllama.cache_set_rows(cj, jnp.asarray(cur), kn, vn)

    def t(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))

    out = tllama.cache_set_rows(ct, torch.from_numpy(cur), t(kn), t(vn))
    assert out.k["q"] is ct.k["q"]  # in place
    _caches_equal(ct, cj)
    written = np.zeros((2, 24), bool)
    written[[0, 1], cur] = True
    for (n, f), old in before.items():
        new = getattr(ct, n)[f]
        if f == "q":
            keep = ~torch.from_numpy(written)[None, :, :, None].expand_as(new)
        else:
            keep = ~torch.from_numpy(written)[None, :, None, :].expand_as(new)
        assert torch.equal(new[keep], old[keep])
        assert not torch.equal(new, old)


# --- the int8 decoder and engine ---------------------------------------------


def _int8_params(fused):
    """(JAX lm, port lm): the tiny tree's LM quantized by each package
    (bit-equal, tested above), fused or not."""
    from dropoutdecoding_tpu_torch.utils import quantize as tq

    tree, pixels = tiny_tree()
    lm_j = jq.quantize_llama_params(jax.tree.map(jnp.asarray, tree.lm))
    lm_t = tq.quantize_llama_params(llava_params_from_numpy(tree).lm)
    if fused:
        lm_j, lm_t = jq.fuse_projections(lm_j), tq.fuse_projections(lm_t)
    return tree, pixels, lm_j, lm_t


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_decode_step_int8_matches_jax(rng, cfgs, fused):
    """``decode_step`` with int8 weights on an int8 cache (K3's twin per
    layer), M = 3 members with one fully masked, from one int8 cache."""
    from dropoutdecoding_tpu.models import llama as jllama
    from dropoutdecoding_tpu_torch.models import llama as tllama

    tcfg, jcfg = cfgs[0].text, cfgs[1].text
    _, _, lm_j, lm_t = _int8_params(fused)
    S0, Smax, M = 10, 32, 3
    x0 = rng.normal(size=(1, S0, 48)).astype(np.float32)
    pos = np.arange(S0)[None]
    _, kvj = jllama.prefill(lm_j, jcfg, jnp.asarray(x0), jnp.asarray(pos))
    cj = jllama.cache_seed(jllama.empty_cache(jcfg, 1, Smax, jnp.float32, quantized=True), kvj)
    # the port reads the very same int8 cache, so only decode_step is compared
    ct = tllama.KVCache(*({f: torch.from_numpy(np.array(a[f])) for f in ("q", "s")} for a in cj))

    x = np.repeat(rng.normal(size=(1, 1, 48)).astype(np.float32), M, axis=1)
    cur = np.array([S0])
    mask = (np.arange(Smax)[None, None] < S0) & (rng.random((1, M, Smax)) > 0.3)
    mask[0, 2] = False
    hj, kj, vj = jllama.decode_step(lm_j, jcfg, jnp.asarray(x), jnp.asarray(cur), cj,
                                    jnp.asarray(mask))
    ht, kt, vt = tllama.decode_step(lm_t, tcfg, torch.from_numpy(x), torch.from_numpy(cur), ct,
                                    torch.from_numpy(mask))
    tol = dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **tol)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **tol)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **tol)
    np.testing.assert_allclose(
        tllama.lm_head(lm_t, ht).numpy(), np.asarray(jllama.lm_head(lm_j, hj)), **tol
    )


@pytest.mark.parametrize(
    "ensemble,ens",
    [(False, {}), (True, {}), (True, {"use_avg": True})],
    ids=["greedy", "exact-vote", "exact-avg"],
)
def test_int8_engine_matches_jax_engine(ensemble, ens):
    """The int8 tier as a whole: int8 fused weights and ``int8_kv=True`` in
    both engines, fp32 activations, JAX's mask draws injected."""
    from dropoutdecoding_tpu.engine.generate import LlavaEngine as JaxEngine
    from dropoutdecoding_tpu.models.llava import LlavaParams as JaxParams
    from dropoutdecoding_tpu.utils import config as jax_config
    from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
    from dropoutdecoding_tpu_torch.models.llava import LlavaParams
    from dropoutdecoding_tpu_torch.utils import config as torch_config
    from test_torch_engine import SEED, jax_uniform
    from test_torch_models import INPUT_IDS, tiny_config

    tree, pixels, lm_j, lm_t = _int8_params(fused=True)
    dense = llava_params_from_numpy(tree)
    kw = dict(max_new_tokens=8, eos_token_id=-1, pad_token_id=0)
    je = JaxEngine(
        cfg=tiny_config(jax_config),
        params=JaxParams(*jax.tree.map(jnp.asarray, (tree.vision, tree.projector)), lm_j),
        ens=jax_config.EnsembleConfig(**ens), gen=jax_config.GenerationConfig(**kw),
        max_len=64, seed=SEED, ensemble=ensemble, int8_kv=True,
    )
    je.param_dtype = jnp.float32
    te = LlavaEngine(
        cfg=tiny_config(torch_config), params=LlavaParams(dense.vision, dense.projector, lm_t),
        ens=torch_config.EnsembleConfig(**ens), gen=torch_config.GenerationConfig(**kw),
        max_len=64, seed=SEED, ensemble=ensemble, int8_kv=True, uniform=jax_uniform(SEED),
    )
    ref = je.generate(INPUT_IDS, pixels)
    got = te.generate(INPUT_IDS, pixels)
    assert got.tokens.shape == (1, 8)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.num_tokens, ref.num_tokens)
    state = te.prefill(INPUT_IDS, pixels)
    assert state.cache.k["q"].dtype == torch.int8 and state.cache.k["q"].shape == (2, 1, 64, 48)
