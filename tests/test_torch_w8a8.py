"""w8a8 in the port against the JAX package: int8 activations x int8
weights (``utils/quantize.quantize_activations``,
``models/llama._mm_w8a8``) in the decoder's layers and in the engine.

Tolerances:
- the activation quantizer and ``_mm_w8a8``: **bit-equal** (fp32 division
  by a tensor scale, round half to even, exact int32 sums, JAX's order of
  the two scale products);
- ``prefill``, ``prefill_extend`` and ``decode_step`` with ``w8a8=True``:
  atol 2e-3 / rtol 1e-3 of fp32 outputs near 1.  Each layer quantizes its
  input rows again, and an input that differs in the last bit between the
  packages (summation order) can round to the neighbouring int8 step: one
  step of one activation moves an output by scale x weight, about 1e-3
  here, where a wrong scale or layout moves it by 1e-1 or more;
- the engine: tokens **equal** with JAX's mask draws injected.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dropoutdecoding_tpu.engine.generate import LlavaEngine as JaxEngine
from dropoutdecoding_tpu.models import llama as jllama
from dropoutdecoding_tpu.models.llava import LlavaParams as JaxParams
from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu.utils import quantize as jq
from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
from dropoutdecoding_tpu_torch.models import llama as tllama
from dropoutdecoding_tpu_torch.models.llava import LlavaParams
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils import quantize as tq
from dropoutdecoding_tpu_torch.utils.convert import llava_params_from_numpy
from test_torch_engine import SEED, jax_uniform
from test_torch_models import INPUT_IDS, tiny_config, tiny_tree

LAYER_TOL = dict(rtol=1e-3, atol=2e-3)
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _same(got: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(jnp.asarray(ref, jnp.float32)))


def _inputs(rng, shape, jdtype):
    """(JAX array, torch tensor) of one set of values in ``jdtype``, with a
    zero row (scale 1) and a row at exact ties of its scale."""
    x = rng.normal(size=shape).astype(np.float32)
    x[0, 0] = 0.0
    x[0, 1, :8] = [12.7, 0.05, 0.15, -0.05, 0.25, -12.7, 0.35, 0.45]  # scale 0.1
    xj = jnp.asarray(x, jdtype)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16 if jdtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=["fp32", "bf16"])
def test_quantize_activations_bit_equal(rng, dtype, jdtype):
    xj, xt = _inputs(rng, (3, 5, 48), jdtype)
    qj, sj = jq.quantize_activations(xj)
    qt, st = tq.quantize_activations(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32 and st.shape == (3, 5, 1)
    _same(qt, qj)
    _same(st, sj)
    assert st[0, 0, 0] == 1.0


def _int8_leaf(rng, D, E):
    w = (0.2 * rng.normal(size=(D, E))).astype(np.float32)
    wj = jq.quantize_matrix(jnp.asarray(w))
    return wj, {"q": torch.from_numpy(np.array(wj["q"])), "s": torch.from_numpy(np.array(wj["s"]))}


@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows", [1, 3, 40], ids=lambda r: f"{r}rows")
def test_mm_w8a8_bit_equal(rng, dtype, jdtype, rows):
    """int8 weights: s8 x s8 -> s32, both scales in fp32, rounded to x's
    dtype, bit-equal to JAX's; at the decode's few rows and a prefill's."""
    xj, xt = _inputs(rng, (1, rows + 1, 48), jdtype)
    wj, wt = _int8_leaf(rng, 48, 40)
    got, ref = tllama._mm_w8a8(xt, wt), jllama._mm_w8a8(xj, wj)
    assert got.dtype == dtype and got.shape == (1, rows + 1, 40)
    _same(got, ref)
    # the int32 sums are exact: the same as an int64 product of the int8s
    qx, sx = tq.quantize_activations(xt)
    exact = (qx.long() @ wt["q"].long()).float() * sx * wt["s"][0]
    assert torch.equal(got, exact.to(dtype))


def test_mm_w8a8_leaves_dense_and_int4_weights_to_mm(rng):
    """Dense and int4 leaves take ``_mm`` (int4: K6's twin), as in JAX."""
    x = torch.from_numpy(rng.normal(size=(2, 64)).astype(np.float32))
    dense = torch.from_numpy((0.2 * rng.normal(size=(64, 24))).astype(np.float32))
    int4 = tq.quantize_matrix_int4(dense, group_size=16)
    for w in (dense, int4):
        assert torch.equal(tllama._mm_w8a8(x, w), tllama._mm(x, w))


def _params():
    """(JAX lm, port lm): the tiny tree's LM quantized int8 by each package
    (bit-equal quantizers, ``test_torch_quantize.py``), projections fused."""
    tree, _ = tiny_tree()
    lm_j = jq.fuse_projections(jq.quantize_llama_params(jax.tree.map(jnp.asarray, tree.lm)))
    lm_t = tq.fuse_projections(tq.quantize_llama_params(llava_params_from_numpy(tree).lm))
    return lm_j, lm_t


def _close(got: torch.Tensor, ref) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LAYER_TOL)


def test_layers_with_w8a8_match_jax(rng):
    """``prefill``, then ``prefill_extend`` over its K/V, then
    ``decode_step`` (M = 3 members, one masked out) on a cache seeded from
    it, every projection s8 x s8 in both packages; and w8a8 moves the
    outputs from the int8 weight-only path by far more than the bound."""
    jcfg, tcfg = tiny_config(jax_config).text, tiny_config(torch_config).text
    lm_j, lm_t = _params()
    S0, T, Smax, M = 9, 4, 32, 3
    x = rng.normal(size=(1, S0 + T, 48)).astype(np.float32)
    pos = np.arange(S0 + T)[None]
    hj, kvj = jllama.prefill(lm_j, jcfg, jnp.asarray(x[:, :S0]), jnp.asarray(pos[:, :S0]),
                             w8a8=True)
    ht, kvt = tllama.prefill(lm_t, tcfg, torch.from_numpy(x[:, :S0]),
                             torch.from_numpy(pos[:, :S0]), w8a8=True)
    _close(ht, hj)
    _close(kvt.k, kvj.k)
    weight_only, _ = tllama.prefill(lm_t, tcfg, torch.from_numpy(x[:, :S0]),
                                    torch.from_numpy(pos[:, :S0]))
    assert (weight_only - ht).abs().max() > 10 * LAYER_TOL["atol"]

    # the tail over the prefix JAX made, so only prefill_extend is compared
    prefix_t = tllama.KVCache(torch.from_numpy(np.array(kvj.k)), torch.from_numpy(np.array(kvj.v)))
    ej, _ = jllama.prefill_extend(lm_j, jcfg, jnp.asarray(x[:, S0:]), jnp.asarray(pos[:, S0:]),
                                  kvj, w8a8=True)
    et, _ = tllama.prefill_extend(lm_t, tcfg, torch.from_numpy(x[:, S0:]),
                                  torch.from_numpy(pos[:, S0:]), prefix_t, w8a8=True)
    _close(et, ej)

    cj = jllama.cache_seed(jllama.empty_cache(jcfg, 1, Smax, jnp.float32), kvj)
    ct = tllama.cache_seed(tllama.empty_cache(tcfg, 1, Smax, torch.float32, "cpu"), prefix_t)
    xs = np.repeat(x[:, S0:S0 + 1], M, axis=1)
    mask = (np.arange(Smax)[None, None] < S0) & (rng.random((1, M, Smax)) > 0.3)
    mask[0, 2] = False
    cur = np.array([S0])
    dj = jllama.decode_step(lm_j, jcfg, jnp.asarray(xs), jnp.asarray(cur), cj, jnp.asarray(mask),
                            w8a8=True)
    dt = tllama.decode_step(lm_t, tcfg, torch.from_numpy(xs), torch.from_numpy(cur), ct,
                            torch.from_numpy(mask), w8a8=True)
    for got, ref in zip(dt, dj):
        _close(got, ref)


ARMS = {  # engine fields and ensemble config of each engine-level case
    "greedy w8a8 prefill": (dict(ensemble=False, w8a8_prefill=True), {}),
    "exact w8a8 prefill and decode": (dict(w8a8_prefill=True, w8a8_decode=True), {}),
    "fused w8a8 decode, int8 cache": (dict(w8a8_decode=True, int8_kv=True),
                                      {"fused_step": True}),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_engine_w8a8_matches_jax_engine(arm):
    """The engine with ``w8a8_prefill`` / ``w8a8_decode`` on int8 fused
    weights (the CLI's ``--quantize w8a8`` / ``--w8a8-decode``), fp32
    activations, JAX's mask draws injected: equal tokens."""
    fields, ens = ARMS[arm]
    tree, pixels = tiny_tree()
    lm_j, lm_t = _params()
    dense = llava_params_from_numpy(tree)
    kw = dict(max_new_tokens=8, eos_token_id=-1, pad_token_id=0)
    je = JaxEngine(
        cfg=tiny_config(jax_config),
        params=JaxParams(*jax.tree.map(jnp.asarray, (tree.vision, tree.projector)), lm_j),
        ens=jax_config.EnsembleConfig(**ens), gen=jax_config.GenerationConfig(**kw),
        max_len=64, seed=SEED, **fields,
    )
    je.param_dtype = jnp.float32
    te = LlavaEngine(
        cfg=tiny_config(torch_config), params=LlavaParams(dense.vision, dense.projector, lm_t),
        ens=torch_config.EnsembleConfig(**ens), gen=torch_config.GenerationConfig(**kw),
        max_len=64, seed=SEED, uniform=jax_uniform(SEED), **fields,
    )
    ref = je.generate(INPUT_IDS, pixels)
    got = te.generate(INPUT_IDS, pixels)
    assert got.tokens.shape == (1, 8)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    js, ts = je.prefill(INPUT_IDS, pixels), te.prefill(INPUT_IDS, pixels)
    np.testing.assert_allclose(ts.last_logits.numpy(), np.asarray(js.last_logits), **LAYER_TOL)


def test_int8_column_major_keeps_every_value_and_product():
    """The w8a8 layout: each layer's int8 "q" column-major, values, the
    w8a8 and weight-only products, and the dense and int4 leaves unchanged;
    the CLI lays int8 weights out so under ``--quantize w8a8`` and
    ``--w8a8-decode``."""
    from dropoutdecoding_tpu_torch.cli import chair_test as tcli

    _, lm = _params()
    col = tq.int8_column_major(lm)
    r = np.random.default_rng(5)
    for name, leaf in lm["layers"].items():
        got = tllama._layer(col["layers"], 1)[name]
        if isinstance(leaf, dict):
            want = tllama._layer(lm["layers"], 1)[name]
            x = torch.from_numpy(r.normal(size=(3, want["q"].shape[0])).astype(np.float32))
            assert got["q"].stride() == (1, got["q"].shape[0]) and torch.equal(got["q"], want["q"])
            assert torch.equal(tllama._mm_w8a8(x, got), tllama._mm_w8a8(x, want))
            assert torch.equal(tllama._mm(x, got), tllama._mm(x, want))
        else:
            assert torch.equal(got, leaf[1])
    assert col["lm_head"] is lm["lm_head"]
    tree, _ = tiny_tree()
    params = llava_params_from_numpy(tree)
    for argv, colmajor in ((["--quantize", "w8a8"], True),
                           (["--quantize", "int8", "--w8a8-decode", "True"], True),
                           (["--quantize", "int8"], False)):
        args = tcli.build_parser().parse_args(["--coco-data-dir", "d", "--model-path", "m"] + argv)
        q = tcli.maybe_quantize(args, params).lm["layers"]["qkv_proj"]["q"][0]
        assert (q.stride() == (1, q.shape[0])) == colmajor, argv
