"""Port ops against their JAX counterparts on the same numpy inputs.

fp32 comparisons use rtol = atol = 1e-5: both sides compute in fp32 and
differ only in summation order and libm rounding.  The bf16 comparison with
the TPU kernel run in interpret mode uses atol 2e-2: that kernel rounds the
probabilities to bf16 before PV and normalises after, the twin normalises
first; outputs are O(1) and bf16 keeps 8 bits.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dropoutdecoding_tpu.ops import attention as jattn
from dropoutdecoding_tpu.ops import basic as jbasic
from dropoutdecoding_tpu_torch.ops import attention as tattn
from dropoutdecoding_tpu_torch.ops import basic as tbasic
from dropoutdecoding_tpu_torch.ops.cuda_decode_attention import (
    ensemble_decode_attention_fused,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, ref, **tol):
    np.testing.assert_allclose(
        np.asarray(got.float() if isinstance(got, torch.Tensor) else got),
        np.asarray(ref, dtype=np.float32),
        **(tol or TOL),
    )


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_norms(rng):
    x, w, b = _f32(rng, 3, 5, 48), _f32(rng, 48), _f32(rng, 48)
    t = torch.from_numpy
    _close(tbasic.rms_norm(t(x), t(w), 1e-5), jbasic.rms_norm(x, w, 1e-5))
    _close(tbasic.layer_norm(t(x), t(w), t(b), 1e-5), jbasic.layer_norm(x, w, b, 1e-5))


@pytest.mark.parametrize(
    "name", ["gelu", "gelu_new", "gelu_pytorch_tanh", "quick_gelu", "silu", "relu"]
)
def test_activations(rng, name):
    x = 3 * _f32(rng, 4, 64)
    _close(tbasic.act_fn(name)(torch.from_numpy(x)), jbasic.act_fn(name)(x))


def test_rope(rng):
    pos = rng.integers(0, 40, size=(2, 7))
    cos_t, sin_t = tbasic.rotary_embedding(torch.from_numpy(pos), 12, 10000.0)
    cos_j, sin_j = jbasic.rotary_embedding(jnp.asarray(pos), 12, 10000.0)
    _close(cos_t, cos_j)
    _close(sin_t, sin_j)
    x = _f32(rng, 2, 7, 4, 12)
    got = tbasic.apply_rope(torch.from_numpy(x), cos_t[:, :, None], sin_t[:, :, None])
    _close(got, jbasic.apply_rope(x, cos_j[:, :, None], sin_j[:, :, None]))


@pytest.mark.parametrize("G", [1, 2])
def test_prefill_attention(rng, G):
    B, S, KH, D = 2, 9, 2, 16
    q, k, v = _f32(rng, B, S, KH * G, D), _f32(rng, B, S, KH, D), _f32(rng, B, S, KH, D)
    mask = rng.random((B, S)) > 0.2
    mask[:, 0] = True
    t = torch.from_numpy
    for km in (None, mask):
        got = tattn.prefill_attention(
            t(q), t(k), t(v), causal=True, key_mask=None if km is None else t(km)
        )
        ref = jattn.prefill_attention(q, k, v, causal=True, key_mask=km)
        _close(got, ref)


def _decode_inputs(rng, B, M, KH, G, D, S, fill=None):
    H = KH * G
    q, kn, vn = _f32(rng, B, M, H, D), _f32(rng, B, M, KH, D), _f32(rng, B, M, KH, D)
    kc, vc = _f32(rng, B, S, KH, D), _f32(rng, B, S, KH, D)
    fill = np.asarray([S - 5] * B if fill is None else fill)  # a row's filled slots
    mask = np.arange(S)[None, None, :] < fill[:, None, None]  # slots past the fill
    mask = mask & (rng.random((B, M, S)) > 0.4)  # holes inside the prefix
    mask[0, M - 1] = False  # a member that attends only its own token
    return q, kc, vc, kn, vn, mask


@pytest.mark.parametrize("G", [1, 2])
def test_decode_attention_twin_matches_jax(rng, G):
    args = _decode_inputs(rng, B=2, M=3, KH=2, G=G, D=16, S=40)
    # CPU tensors: the K1 wrapper computes its plain twin
    got = ensemble_decode_attention_fused(*map(torch.from_numpy, args))
    ref = jattn.ensemble_decode_attention(*map(jnp.asarray, args))
    _close(got, ref)


@pytest.mark.parametrize("G", [1, 2])
def test_decode_attention_twin_bf16_matches_tpu_kernel(rng, G, monkeypatch):
    from jax.experimental import pallas as pl

    from dropoutdecoding_tpu.ops.pallas_decode_attention import (
        ensemble_decode_attention_fused as tpu_kernel,
    )

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    args = _decode_inputs(rng, B=1, M=3, KH=2, G=G, D=32, S=40)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args[:5]] + [jnp.asarray(args[5])]
    ref = np.asarray(tpu_kernel(*jargs).astype(jnp.float32))
    targs = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16() for a in jargs[:5]]
    got = ensemble_decode_attention_fused(*targs, torch.from_numpy(args[5]))
    assert got.dtype == torch.bfloat16
    _close(got, ref, rtol=0, atol=2e-2)


# (label, B, M, KH, G, D, S, filled slots a row): the query rows of a kv group fill
# one 16-row tensor-core tile, or take two; batch rows with their own fills
DECODE_GEOMETRIES = [
    ("16 rows a group", 1, 4, 2, 4, 16, 70, None),
    ("24 rows a group", 1, 6, 2, 4, 16, 70, None),
    ("two rows, fills 3 and 64", 2, 3, 2, 2, 16, 70, [3, 64]),
    ("two rows, one with no filled slot", 2, 3, 2, 2, 8, 65, [0, 65]),
]


@pytest.mark.parametrize(
    "B,M,KH,G,D,S,fill", [c[1:] for c in DECODE_GEOMETRIES], ids=[c[0] for c in DECODE_GEOMETRIES]
)
def test_decode_attention_twin_geometries_match_jax(rng, B, M, KH, G, D, S, fill):
    args = _decode_inputs(rng, B, M, KH, G, D, S, fill)
    got = ensemble_decode_attention_fused(*map(torch.from_numpy, args))
    ref = jattn.ensemble_decode_attention(*map(jnp.asarray, args))
    _close(got, ref)


@pytest.mark.parametrize(
    "B,M,KH,G,D,S,fill", [c[1:] for c in DECODE_GEOMETRIES], ids=[c[0] for c in DECODE_GEOMETRIES]
)
def test_decode_attention_twin_bf16_geometries_match_tpu_kernel(
    rng, B, M, KH, G, D, S, fill, monkeypatch
):
    from jax.experimental import pallas as pl

    from dropoutdecoding_tpu.ops.pallas_decode_attention import (
        ensemble_decode_attention_fused as tpu_kernel,
    )

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    args = _decode_inputs(rng, B, M, KH, G, D, S, fill)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args[:5]] + [jnp.asarray(args[5])]
    ref = np.asarray(tpu_kernel(*jargs).astype(jnp.float32))
    targs = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16() for a in jargs[:5]]
    got = ensemble_decode_attention_fused(*targs, torch.from_numpy(args[5]))
    _close(got, ref, rtol=0, atol=2e-2)


@pytest.mark.parametrize("S,fill,per_block", [(70, [65, 3], 1), (200, [195, 64], 2),
                                              (1152, [620, 768], 3), (130, [0, 129], 1)])
def test_decode_attention_pieces_merged_in_split_order_equal_the_twin(rng, S, fill, per_block):
    """The arithmetic of the card's kernel, in numpy: each block's run of
    64-slot tiles leaves the partial softmax (max, sum, unnormalised PV) of
    the slots its member attends; the pieces are merged in split order with
    the member's own token, a piece with no attended slot taking no part.
    Equal to the twin to fp32 rounding, for any cut of the slots."""
    from dropoutdecoding_tpu_torch.ops.cuda_decode_attention import TILE

    B, M, KH, G, D = 2, 3, 2, 2, 16
    q, kc, vc, kn, vn, mask = _decode_inputs(rng, B, M, KH, G, D, S, fill)
    ref = ensemble_decode_attention_fused(*map(torch.from_numpy, (q, kc, vc, kn, vn, mask))).numpy()
    run = per_block * TILE
    got = np.zeros_like(ref)
    for b in range(B):
        for m in range(M):
            for h in range(KH * G):
                g = h // G
                scores = kc[b, :, g] @ q[b, m, h] / np.sqrt(D)
                own = kn[b, m, g] @ q[b, m, h] / np.sqrt(D)
                pieces = []
                for s0 in range(0, S, run):
                    on = mask[b, m, s0:s0 + run]
                    if not on.any():
                        pieces.append((-np.inf, 0.0, np.zeros(D, np.float32)))
                        continue
                    sc = scores[s0:s0 + run][on]
                    e = np.exp(sc - sc.max())
                    pieces.append((sc.max(), e.sum(), e @ vc[b, s0:s0 + run, g][on]))
                top = max([own] + [mx for mx, total, _ in pieces if total > 0])
                denom = sum(total * np.exp(mx - top) for mx, total, _ in pieces if total > 0)
                denom += np.exp(own - top)
                out = np.zeros(D, np.float32)
                for mx, total, acc in pieces:  # split order
                    if total > 0:
                        out += np.exp(mx - top) / denom * acc
                got[b, m, h] = out + np.exp(own - top) / denom * vn[b, m, g]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_decode_attention_wrapper_never_falls_back(rng):
    args = _decode_inputs(rng, B=1, M=2, KH=2, G=1, D=8, S=8)
    meta = [torch.empty(a.shape, device="meta") for a in args[:5]]
    with pytest.raises(ValueError, match="no kernel"):
        ensemble_decode_attention_fused(*meta, torch.from_numpy(args[5]).to("meta"))


def test_build_names_library_by_source_hash():
    from dropoutdecoding_tpu_torch.ops import _build

    path = _build.library_path()
    assert path == _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert {p.name for p in _build.sources()} == {
        "cache_append.cu", "decode_attention.cu", "flash_prefill.cu", "int4_matmul.cu",
        "moe_grouped.cu", "uncertainty.cu",
    }
    # the header the wgmma kernels share names the library too
    assert {p.name for p in _build.headers()} == {"hopper.cuh"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS

