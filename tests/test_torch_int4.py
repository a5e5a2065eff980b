"""The int4 tier of the port against the JAX package: the quantizer, K6's
plain twin, the decoder with packed int4 leaves, and the engine.

Tolerances:
- the quantizer (``q4``, ``s4``, the nibble planes, the dequantized matrix,
  ``_fit_group``): **bit-equal**.  Both sides divide in IEEE fp32, round half
  to even and compare the clip search's fp32 error sums; on these seeded
  matrices no group picks another clip;
- K6's twin against JAX's portable ``_mm_int4`` in fp32: 1e-5 of max|ref|
  (JAX multiplies the scale into the weight before the dot, the twin scales
  the group's fp32 partial: rounding and summation order only);
- K6's twin against the TPU kernel in interpret mode, x representable in
  bf16: its "i32" unpack to 1e-5 of max|ref| (the same sums in another
  order), its "mxu3" unpack to 5e-3, the bound the JAX package's own test
  pins for it (``tests/test_pallas_kernels.py``);
- ``prefill`` / ``decode_step`` / ``lm_head``: atol 1e-4, rtol 1e-5 (fp32, a
  few layers compound), an int4 head fed bf16 activations atol 2e-2 (one
  bf16 step of the hidden state can differ);
- the engine: generated tokens **equal**, the weights quantized by JAX and
  carried across, JAX's mask draws injected.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dropoutdecoding_tpu.models import llama as jllama
from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu.utils import quantize as jq
from dropoutdecoding_tpu_torch.models import llama as tllama
from dropoutdecoding_tpu_torch.ops import cuda_int4_matmul as k6
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils import quantize as tq
from dropoutdecoding_tpu_torch.utils.convert import _to_torch, llava_params_from_numpy
from test_torch_models import INPUT_IDS, tiny_config, tiny_tree

TOL = dict(rtol=1e-5, atol=1e-4)
# (R, D, E, g): a 7B-like case, the JAX test's ragged-E case, and 43 groups
# a half (down_proj's count) with E not a multiple of 4
MATMUL_CASES = [(4, 512, 384, 128), (3, 256, 130, 64), (5, 2 * 43 * 16, 73, 16)]


def _equal(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _same_tree(got, ref):
    """Every leaf of the JAX tree ``ref`` is bit-equal in ``got``, int8 and
    fp32 types kept."""
    flat = jax.tree_util.tree_leaves_with_path(ref)
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat:
        t = got
        for key in path:
            t = t[key.key]
        assert t.dtype == (torch.int8 if leaf.dtype == jnp.int8 else torch.float32), path
        _equal(t, leaf)


# --- the quantizer: bit-equal --------------------------------------------------


@pytest.mark.parametrize(
    "shape,g", [((2, 256, 130), 64), ((512, 96), 128), ((2 * 43 * 32, 40), 32), ((3, 96, 48), 16)]
)
def test_quantize_matrix_int4_bit_equal(rng, shape, g):
    w = (rng.normal(size=shape) * 0.05).astype(np.float32)
    w[..., :g, 1] = 0.0  # an all-zero group: scale 1
    for grid in (jq.INT4_CLIP_GRID, (1.0,)):
        got = tq.quantize_matrix_int4(torch.from_numpy(w), g, grid)
        ref = jq.quantize_matrix_int4(jnp.asarray(w), g, grid)
        assert got["q4"].dtype == torch.int8 and got["s4"].dtype == torch.float32
        assert got["q4"].shape == (*shape[:-2], shape[-2] // 2, shape[-1])
        _equal(got["q4"], ref["q4"])
        _equal(got["s4"], ref["s4"])
        for plane, ref_plane in zip(tq.unpack_int4(got["q4"]), jq.unpack_int4(ref["q4"])):
            assert plane.dtype == torch.int8 and plane.abs().max() <= 7
            _equal(plane, ref_plane)
        _equal(tq.dequantize_matrix_int4(got), jq.dequantize_matrix_int4(ref))
    assert (got["s4"][..., 0, 1] == 1.0).all()
    searched = tq.quantize_matrix_int4(torch.from_numpy(w), g)
    # the search only ever clips below amax / 7, and does so somewhere
    assert (searched["s4"] <= got["s4"]).all() and (searched["s4"] < got["s4"]).any()
    with pytest.raises(ValueError, match="not divisible"):
        tq.quantize_matrix_int4(torch.from_numpy(w), 5 * g)


def test_unpack_int4_every_byte():
    """All 256 byte values, -8 in either nibble included, decode as JAX's
    int8 shifts do."""
    packed = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    lo, hi = tq.unpack_int4(torch.from_numpy(packed))
    ref_lo, ref_hi = jq.unpack_int4(jnp.asarray(packed))
    _equal(lo, ref_lo)
    _equal(hi, ref_hi)
    assert lo.min() == hi.min() == -8 and lo.max() == hi.max() == 7
    wq = {"q4": torch.from_numpy(packed), "s4": torch.full((2, 16), 0.5)}
    ref = jq.dequantize_matrix_int4({"q4": jnp.asarray(packed), "s4": jnp.full((2, 16), 0.5)})
    _equal(tq.dequantize_matrix_int4(wq), ref)


@pytest.mark.parametrize("D", [4096, 11008, 256, 96, 48, 6, 7])
def test_fit_group_matches_jax(D):
    try:
        ref = jq._fit_group(D, jq.INT4_GROUP)
    except ValueError:
        with pytest.raises(ValueError, match="no valid int4 group"):
            tq._fit_group(D, tq.INT4_GROUP)
        return
    assert tq._fit_group(D, tq.INT4_GROUP) == ref
    assert tq.INT4_GROUP == jq.INT4_GROUP and tq.INT4_CLIP_GRID == jq.INT4_CLIP_GRID


@pytest.mark.parametrize("lm_head", ["int8", "int4", None])
def test_quantize_llama_params_int4_and_fuse_bit_equal(lm_head):
    tree, _ = tiny_tree()
    got = tq.quantize_llama_params_int4(llava_params_from_numpy(tree).lm, lm_head=lm_head)
    ref = jq.quantize_llama_params_int4(jax.tree.map(jnp.asarray, tree.lm), lm_head=lm_head)
    _same_tree(got, ref)
    assert got["layers"]["q_proj"]["s4"].shape == (2, 48 // 8, 48)  # g fitted to 8
    assert got["layers"]["down_proj"]["s4"].shape == (2, 96 // 16, 48)  # and to 16
    fused, ref_fused = tq.fuse_projections(got), jq.fuse_projections(ref)
    _same_tree(fused, ref_fused)
    assert fused["layers"]["qkv_proj"]["q4"].shape == (2, 24, 144)
    assert fused["layers"]["gate_up_proj"]["s4"].shape == (2, 6, 192)
    assert tq.fuse_projections(fused) is fused
    with pytest.raises(ValueError, match="lm_head"):
        tq.quantize_llama_params_int4(got, lm_head="int2")


def test_convert_keeps_int4_leaves():
    """A packed JAX tree converts with ``q4`` int8 and ``s4`` fp32 whatever
    dtype is asked for, the values unchanged."""
    tree, _ = tiny_tree()
    lm = jq.quantize_llama_params_int4(jax.tree.map(jnp.asarray, tree.lm), lm_head="int4")
    qtree = tree._replace(lm=jax.tree.map(np.asarray, lm))
    tp = llava_params_from_numpy(qtree, dtype=torch.bfloat16)
    for leaf, ref in (
        (tp.lm["layers"]["o_proj"], qtree.lm["layers"]["o_proj"]),
        (tp.lm["lm_head"], qtree.lm["lm_head"]),
    ):
        assert leaf["q4"].dtype == torch.int8 and leaf["s4"].dtype == torch.float32
        _equal(leaf["q4"], ref["q4"])
        _equal(leaf["s4"], ref["s4"])
    assert tp.lm["embed_tokens"].dtype == torch.bfloat16
    one = _to_torch({"q4": np.zeros((2, 3), np.int8), "s4": np.ones((2, 3))}, "cpu", torch.bfloat16)
    assert one["q4"].dtype == torch.int8 and one["s4"].dtype == torch.float32


# --- K6's plain twin -----------------------------------------------------------


def _packed(rng, D, E, g):
    """Uniform bytes (every nibble value, -8 included) and varied scales."""
    q4 = rng.integers(-128, 128, (D // 2, E)).astype(np.int8)
    s4 = rng.uniform(0.002, 0.006, (D // g, E)).astype(np.float32)
    return q4, s4


@pytest.mark.parametrize("R,D,E,g", MATMUL_CASES)
def test_twin_matches_jax_mm_int4(rng, R, D, E, g):
    """fp32 against the JAX package's portable form, which the JAX models
    run on the CPU; also a leading batch shape and ``out_dtype``."""
    q4, s4 = _packed(rng, D, E, g)
    x = rng.normal(size=(2, R, D)).astype(np.float32)
    wq = {"q4": jnp.asarray(q4), "s4": jnp.asarray(s4)}
    ref = np.asarray(jllama._mm_int4(jnp.asarray(x), wq))
    t = torch.from_numpy
    got = k6.int4_matmul(t(x), t(q4), t(s4))  # CPU tensors: the twin
    assert got.shape == (2, R, E) and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    dense = t(x) @ tq.dequantize_matrix_int4({"q4": t(q4), "s4": t(s4)})
    assert (got - dense).abs().max() <= 1e-5 * dense.abs().max()
    half = k6.int4_matmul_twin(t(x).bfloat16(), t(q4), t(s4))
    wide = k6.int4_matmul_twin(t(x).bfloat16(), t(q4), t(s4), out_dtype=torch.float32)
    assert half.dtype == torch.bfloat16 and wide.dtype == torch.float32
    assert torch.equal(half, wide.bfloat16())


@pytest.mark.parametrize("lead", [(130,), (2, 75)], ids=["R=130", "batched-2x75"])
def test_twin_matches_jax_mm_int4_at_prefill_rows(rng, lead):
    """A prefill-like row count: more rows than one row tile of the card's
    prefill kernel (120), with a ragged last tile, three groups a half and
    E = 272 = 2 * 128 + 16 channels.  1e-5 of max|ref|, as the cases above:
    rounding and summation order only."""
    D, E, g = 2 * 3 * 128, 272, 128
    q4, s4 = _packed(rng, D, E, g)
    x = rng.normal(size=(*lead, D)).astype(np.float32)
    ref = np.asarray(jllama._mm_int4(jnp.asarray(x), {"q4": jnp.asarray(q4), "s4": jnp.asarray(s4)}))
    t = torch.from_numpy
    got = k6.int4_matmul(t(x), t(q4), t(s4))  # CPU tensors: the twin
    assert got.shape == (*lead, E) and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    R = int(np.prod(lead))
    assert k6.prefill_route(R, D // 2, E, g, aligned=True) == "wgmma"
    assert R > k6.wgmma_row_tile(R, E)  # several row tiles


@pytest.mark.parametrize("unpack,rtol", [("i32", 1e-5), ("mxu3", 5e-3)])
@pytest.mark.parametrize("R,D,E,g", MATMUL_CASES)
def test_twin_matches_the_tpu_kernel(rng, monkeypatch, R, D, E, g, unpack, rtol):
    """Against ``ops/pallas_int4_matmul.int4_matmul`` in interpret mode, as
    the JAX package's own tests run it, and the layered form on one layer
    of a stack."""
    from jax.experimental import pallas as pl

    from dropoutdecoding_tpu.ops import pallas_int4_matmul as tpu

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    q4, s4 = _packed(rng, D, E, g)
    xj = jnp.asarray(rng.normal(size=(R, D)), jnp.bfloat16)
    x = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).bfloat16()
    ref = np.asarray(
        tpu.int4_matmul(xj, jnp.asarray(q4), jnp.asarray(s4), out_dtype=jnp.float32, unpack=unpack)
    )
    got = k6.int4_matmul(x, torch.from_numpy(q4), torch.from_numpy(s4), out_dtype=torch.float32)
    bound = rtol * np.abs(ref).max()
    assert np.abs(got.numpy() - ref).max() <= bound

    stack_q = np.stack([np.zeros_like(q4), q4, np.zeros_like(q4)])
    stack_s = np.stack([np.ones_like(s4), s4, np.ones_like(s4)])
    layered = np.asarray(
        tpu.int4_matmul_layered(
            jnp.asarray(1), xj, jnp.asarray(stack_q), jnp.asarray(stack_s),
            out_dtype=jnp.float32, unpack=unpack,
        )
    )
    tq_stack, ts_stack = torch.from_numpy(stack_q), torch.from_numpy(stack_s)
    view = tq_stack[1]
    assert view.data_ptr() == tq_stack.data_ptr() + q4.size  # the layer in place, no copy
    got = k6.int4_matmul(x, view, ts_stack[1], out_dtype=torch.float32)
    assert np.abs(got.numpy() - layered).max() <= bound


def test_twin_rejects_bad_shapes():
    x = torch.zeros(2, 64)
    q4 = torch.zeros(32, 8, dtype=torch.int8)
    for bad_s in (torch.ones(3, 8), torch.ones(2, 7), torch.ones(10, 8)):
        with pytest.raises(ValueError, match="shape mismatch"):
            k6.int4_matmul(x, q4, bad_s)
    with pytest.raises(ValueError, match="shape mismatch"):
        k6.int4_matmul(torch.zeros(2, 60), q4, torch.ones(2, 8))
    with pytest.raises(ValueError, match="2-D"):
        k6.int4_matmul(x, q4[None], torch.ones(1, 2, 8))


def test_wrapper_never_falls_back():
    """Off the CPU the wrapper launches its kernel or raises: a tensor that
    is neither on the CPU nor on a card never reaches the twin."""
    x = torch.empty(3, 512, dtype=torch.bfloat16, device="meta")
    q4 = torch.empty(256, 64, dtype=torch.int8, device="meta")
    s4 = torch.empty(4, 64, device="meta")
    before = k6.int4_matmul.launches
    with pytest.raises(ValueError, match="no kernel"):
        k6.int4_matmul(x, q4, s4)
    assert k6.int4_matmul.launches == before


PLAN_CASES = [  # (R, D2, E, g): the 7B leaves, the narrow model's, a tiny one, g = 32
    (1, 2048, 12288, 128), (3, 2048, 4096, 128), (3, 2048, 22016, 128), (1, 5504, 4096, 128),
    (16, 5504, 4096, 128), (73, 128, 768, 128), (595, 2048, 22016, 128), (2, 16, 8, 16),
    (3, 1376, 130, 32),
]


@pytest.mark.parametrize("R,D2,E,g", PLAN_CASES)
def test_split_plans_cover_the_contraction(R, D2, E, g):
    """Both plans.  The FMA kernel's: blocks of whole steps that cover D2,
    enough of them to fill the card where the matrix allows.  The whole-tile
    kernel's, for the shapes its route takes: every (tile, box) of the
    product lies in exactly one item, a tile's items follow one another in
    one block from box 0 to the last, none holds more than ``TILE_BOXES``
    boxes, and block b takes tiles b, b + blocks, ..."""
    tiles = -(-E // 128)
    block_k, splits = k6.split_plan(R, D2, E)
    assert block_k % k6.K_STEP == 0 and k6.K_STEP <= block_k <= 1024
    assert splits == -(-D2 // block_k) and (splits - 1) * block_k < D2 <= splits * block_k
    assert splits * tiles * -(-R // 4) >= min(528, -(-D2 // 128) * tiles) // 2

    if k6.prefill_route(R, D2, E, g, aligned=True) != "tiles":
        assert R > k6.SMALL_ROWS or g % k6.TILE_ROWS or E % 16
        return
    tiles, items, blocks = k6.tile_plan(D2, E)
    boxes = D2 // k6.TILE_ROWS
    assert tiles == -(-E // k6.TILE_CHANNELS) and 1 <= blocks <= min(132, tiles)
    walk = k6.tile_walk(D2, E)
    assert len(walk) == blocks
    seen = {}
    for b, its in enumerate(walk):
        assert len(its) == items * len(range(b, tiles, blocks))
        for n, (t, lo, hi) in enumerate(its):
            assert t % blocks == b and 0 < hi - lo <= k6.TILE_BOXES and lo % k6.TILE_BOXES == 0
            if lo:  # the item before it is the same tile's, and ends where this one starts
                assert its[n - 1][0] == t and its[n - 1][2] == lo
            for box in range(lo, hi):
                assert (t, box) not in seen
                seen[t, box] = b
    assert len(seen) == tiles * boxes
    assert {t for t, _ in seen} == set(range(tiles)) and {x for _, x in seen} == set(range(boxes))


# --- the decoder with int4 leaves ----------------------------------------------


def _int4_params(fused, lm_head="int8"):
    """(tree, pixels, JAX lm, port lm): the tiny tree's LM quantized by JAX
    and carried across as numpy, so parity never hangs on the clip pick."""
    tree, pixels = tiny_tree()
    lm_j = jq.quantize_llama_params_int4(jax.tree.map(jnp.asarray, tree.lm), lm_head=lm_head)
    if fused:
        lm_j = jq.fuse_projections(lm_j)
    lm_t = llava_params_from_numpy(tree._replace(lm=jax.tree.map(np.asarray, lm_j))).lm
    return tree, pixels, lm_j, lm_t


@pytest.mark.parametrize(
    "fused,lm_head", [(False, "int8"), (True, "int8"), (True, "int4")],
    ids=["split", "fused", "fused-int4-head"],
)
def test_prefill_decode_and_head_int4_match_jax(rng, fused, lm_head):
    """``prefill``, then ``decode_step`` on an int8 cache (M = 3 members,
    one fully masked), then ``lm_head``, every projection through K6's twin."""
    tcfg, jcfg = tiny_config(torch_config).text, tiny_config(jax_config).text
    _, _, lm_j, lm_t = _int4_params(fused, lm_head)
    names = {"qkv_proj", "gate_up_proj"} if fused else {"q_proj", "gate_proj"}
    assert names <= set(lm_t["layers"]) and "q4" in lm_t["layers"]["o_proj"]
    S0, Smax, M = 10, 32, 3
    x0 = rng.normal(size=(1, S0, 48)).astype(np.float32)
    pos = np.arange(S0)[None]
    hj0, kvj = jllama.prefill(lm_j, jcfg, jnp.asarray(x0), jnp.asarray(pos))
    ht0, kvt = tllama.prefill(lm_t, tcfg, torch.from_numpy(x0), torch.from_numpy(pos))
    np.testing.assert_allclose(ht0.numpy(), np.asarray(hj0), **TOL)
    np.testing.assert_allclose(kvt.k.numpy(), np.asarray(kvj.k), **TOL)
    np.testing.assert_allclose(kvt.v.numpy(), np.asarray(kvj.v), **TOL)

    cj = jllama.cache_seed(jllama.empty_cache(jcfg, 1, Smax, jnp.float32, quantized=True), kvj)
    ct = tllama.KVCache(*({f: torch.from_numpy(np.array(a[f])) for f in ("q", "s")} for a in cj))
    x = np.repeat(rng.normal(size=(1, 1, 48)).astype(np.float32), M, axis=1)
    cur = np.array([S0])
    mask = (np.arange(Smax)[None, None] < S0) & (rng.random((1, M, Smax)) > 0.3)
    mask[0, 2] = False
    hj, kj, vj = jllama.decode_step(lm_j, jcfg, jnp.asarray(x), jnp.asarray(cur), cj,
                                    jnp.asarray(mask))
    ht, kt, vt = tllama.decode_step(lm_t, tcfg, torch.from_numpy(x), torch.from_numpy(cur), ct,
                                    torch.from_numpy(mask))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **TOL)
    # a quantized head rounds its input to bf16: feed both the same hidden
    logits = tllama.lm_head(lm_t, torch.from_numpy(np.asarray(hj)))
    ref = np.asarray(jllama.lm_head(lm_j, hj))
    assert logits.dtype == torch.float32 and logits.shape == (1, M, 64)
    atol = 2e-2 if lm_head == "int4" else 1e-4
    np.testing.assert_allclose(logits.numpy(), ref, rtol=1e-5, atol=atol)


def test_w8a8_on_int4_weights_matches_jax(rng):
    """w8a8 leaves int4 projections on K6 (JAX ``_mm_w8a8`` takes ``_mm``
    for them): ``prefill`` with ``w8a8=True`` on int4 weights equals its own
    run without, bit for bit, and JAX's within ``TOL``."""
    tcfg, jcfg = tiny_config(torch_config).text, tiny_config(jax_config).text
    _, _, lm_j, lm_t = _int4_params(fused=True)
    x = rng.normal(size=(1, 7, 48)).astype(np.float32)
    pos = np.arange(7)[None]
    hj, kvj = jllama.prefill(lm_j, jcfg, jnp.asarray(x), jnp.asarray(pos), w8a8=True)
    ht, kvt = tllama.prefill(lm_t, tcfg, torch.from_numpy(x), torch.from_numpy(pos), w8a8=True)
    plain, _ = tllama.prefill(lm_t, tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert torch.equal(ht, plain)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
    np.testing.assert_allclose(kvt.k.numpy(), np.asarray(kvj.k), **TOL)


# --- the engine ----------------------------------------------------------------


@pytest.mark.parametrize("ensemble", [False, True], ids=["greedy", "exact-K3"])
def test_int4_engine_matches_jax_engine(ensemble):
    """The int4 tier as a whole: packed int4 fused projections, an int8 head
    and ``int8_kv=True`` in both engines, fp32 activations."""
    from dropoutdecoding_tpu.engine.generate import LlavaEngine as JaxEngine
    from dropoutdecoding_tpu.models.llava import LlavaParams as JaxParams
    from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
    from dropoutdecoding_tpu_torch.models.llava import LlavaParams
    from test_torch_engine import SEED, jax_uniform

    tree, pixels, lm_j, lm_t = _int4_params(fused=True)
    dense = llava_params_from_numpy(tree)
    kw = dict(max_new_tokens=8, eos_token_id=-1, pad_token_id=0)
    je = JaxEngine(
        cfg=tiny_config(jax_config),
        params=JaxParams(*jax.tree.map(jnp.asarray, (tree.vision, tree.projector)), lm_j),
        gen=jax_config.GenerationConfig(**kw), max_len=64, seed=SEED, ensemble=ensemble,
        int8_kv=True,
    )
    je.param_dtype = jnp.float32
    te = LlavaEngine(
        cfg=tiny_config(torch_config), params=LlavaParams(dense.vision, dense.projector, lm_t),
        gen=torch_config.GenerationConfig(**kw), max_len=64, seed=SEED, ensemble=ensemble,
        int8_kv=True, uniform=jax_uniform(SEED),
    )
    ref = je.generate(INPUT_IDS, pixels)
    got = te.generate(INPUT_IDS, pixels)
    assert got.tokens.shape == (1, 8)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.num_tokens, ref.num_tokens)
    state = te.prefill(INPUT_IDS, pixels)
    assert state.cache.k["q"].dtype == torch.int8


def test_synthetic_int4_lm_and_engine_run():
    """The full-width card path at a narrow size on the CPU: synthetic bf16
    vision and projector, ``synthetic_int4_lm`` and an int8 cache through
    ``LlavaEngine.generate`` in exact K=3 mode."""
    from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
    from dropoutdecoding_tpu_torch.models.llava import LlavaParams
    from dropoutdecoding_tpu_torch.utils.convert import synthetic_int4_lm, synthetic_llava_params

    base = tiny_config(torch_config)
    text = torch_config.LlamaConfig(
        vocab_size=64, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=64,
    )
    cfg = torch_config.LlavaConfig(text=text, vision=base.vision, image_token_index=32)
    lm = synthetic_int4_lm(text, "cpu", seed=1)
    assert set(lm["layers"]) == {
        "input_ln", "post_attn_ln", "o_proj", "down_proj", "qkv_proj", "gate_up_proj"
    }
    qkv, down = lm["layers"]["qkv_proj"], lm["layers"]["down_proj"]
    assert qkv["q4"].shape == (2, 128, 512) and qkv["q4"].dtype == torch.int8
    assert qkv["s4"].shape == (2, 2, 512) and qkv["s4"].dtype == torch.float32
    assert down["q4"].shape == (2, 256, 256) and down["s4"].shape == (2, 4, 256)
    assert lm["layers"]["gate_up_proj"]["q4"].shape == (2, 128, 1024)
    assert lm["lm_head"]["q"].shape == (256, 64) and lm["lm_head"]["q"].dtype == torch.int8
    assert torch.all(qkv["s4"] == torch.tensor(0.02 / 4.6))
    lo, hi = tq.unpack_int4(down["q4"])
    assert lo.min() == hi.min() == -8 and lo.max() == hi.max() == 7  # -8 is there
    assert 4.0 < lo.float().std() < 5.2
    again = synthetic_int4_lm(text, "cpu", seed=1)
    assert torch.equal(again["layers"]["down_proj"]["q4"], down["q4"])
    with pytest.raises(ValueError, match="not divisible"):
        synthetic_int4_lm(base.text, "cpu")  # 48 wide: no group of 128

    dense = synthetic_llava_params(cfg, "cpu", torch.bfloat16, seed=2)
    eng = LlavaEngine(
        cfg=cfg, params=LlavaParams(dense.vision, dense.projector, lm), max_len=64, int8_kv=True,
        gen=torch_config.GenerationConfig(max_new_tokens=6, eos_token_id=-1, pad_token_id=0),
    )
    pixels = np.random.default_rng(2).normal(size=(1, 3, 28, 28)).astype(np.float32)
    state = eng.prefill(INPUT_IDS, pixels)
    for v in state.uncertainty.values():
        assert torch.isfinite(v).all()
    tokens = eng.generate(INPUT_IDS, pixels).tokens
    assert tokens.shape == (1, 6) and ((tokens >= 0) & (tokens < 64)).all()
