"""K1 and K3: the Hopper ensemble-decode attention
(``csrc/decode_attention.cu``), over a dense cache (K1) or an int8 cache
with per-(token, head) scales (K3).

K1 replaces the TPU kernel ``ensemble_decode_attention_fused``
(``dropoutdecoding_tpu/ops/pallas_decode_attention.py:166``) and its
layered twin (``:533``); K3 replaces ``ensemble_decode_attention_int8kv_fused``
(``:234``) and its layered twin (``:457``).  On the TPU those kernels were
gated to GQA (``H // KH > 1``), bf16 activations and, for the layered int8
kernel, ``S % 32 == 0``; here one kernel serves every group size G >= 1,
bf16 and fp32, and any S, so the MHA LLaVA-1.5 decode runs them too.

For CPU tensors each wrapper computes its plain twin in
``ops.attention``.  For CUDA tensors it launches the kernel or raises; it
never falls back.  ``launches`` counts kernel launches (one per call: the
partial pass and its combine).
"""
from __future__ import annotations

import math

import torch

from . import _build
from .attention import ensemble_decode_attention, ensemble_decode_attention_int8kv

CHUNK = 64  # cache slots per block; S / CHUNK blocks per (row, kv group)
MAX_HEAD_DIM = 256
MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _smem_bytes(R: int, D: int, elem: int) -> int:
    """Shared memory of the partial pass (``Smem`` in the CUDA source):
    q [R, D] and scores [R, CHUNK] in fp32, the tile's key and value scales
    [CHUNK] in fp32, the K and V tiles [CHUNK, D] of ``elem``-byte values."""

    def a16(x):
        return -(-x // 16) * 16

    p = a16(R * D * 4)
    ks = a16(p + R * CHUNK * 4)
    vs = a16(ks + CHUNK * 4)
    k = a16(vs + CHUNK * 4)
    v = a16(k + CHUNK * D * elem)
    return a16(v + CHUNK * D * elem)


def _check(q, k_cache, v_cache, k_new, v_new, key_mask, cache_dtype, scales=()):
    """Raise unless the operands are what the kernel takes; returns
    (B, M, H, KH, S, D)."""
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, M, H, D = q.shape
    _, S, KH, _ = k_cache.shape
    tensors = (q, k_cache, v_cache, k_new, v_new, key_mask, *scales)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if (
        q.dtype not in _DTYPES
        or any(t.dtype != q.dtype for t in (k_new, v_new))
        or any(t.dtype != cache_dtype for t in (k_cache, v_cache))
        or any(t.dtype != torch.float32 for t in scales)
    ):
        raise TypeError(
            f"q / new K/V must share a dtype in {list(_DTYPES)}, the cache must be "
            f"{cache_dtype} and scales float32; got {[t.dtype for t in tensors]}"
        )
    if key_mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"key_mask must be bool or uint8, got {key_mask.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if (
        v_cache.shape != k_cache.shape
        or k_cache.shape[0] != B
        or k_cache.shape[3] != D
        or k_new.shape != (B, M, KH, D)
        or v_new.shape != k_new.shape
        or key_mask.shape != (B, M, S)
        or any(t.shape != (B, KH, S) for t in scales)
    ):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
            f"new {tuple(k_new.shape)}, mask {tuple(key_mask.shape)}, "
            f"scales {[tuple(t.shape) for t in scales]}"
        )
    R = M * (H // KH) if KH and H % KH == 0 else 0
    elem = k_cache.element_size()
    if not R or D > MAX_HEAD_DIM or S < 1 or _smem_bytes(R, D, elem) > MAX_SMEM:
        raise ValueError(
            f"unsupported geometry H={H} KH={KH} M={M} D={D} S={S}: needs KH | H, "
            f"D <= {MAX_HEAD_DIM} and the M*H/KH query rows' tiles in {MAX_SMEM} B "
            "of shared memory"
        )
    return B, M, H, KH, S, D


def _partials(q, B, KH, S, M, H, D):
    """The fp32 scratch of the partial pass: (max, sum, acc) per tile and row."""
    n = B * KH * -(-S // CHUNK) * M * (H // KH)
    part_m = torch.empty(n, dtype=torch.float32, device=q.device)
    return part_m, torch.empty_like(part_m), torch.empty(n * D, dtype=torch.float32, device=q.device)


def ensemble_decode_attention_fused(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    key_mask: torch.Tensor,
) -> torch.Tensor:
    """K1.  Same contract as ``ops.attention.ensemble_decode_attention``.

    Args:
      q: [B, M, H, D]; k_cache, v_cache: [B, S, KH, D] (a layer's view of
      the [L, B, S, KH, D] cache); k_new, v_new: [B, M, KH, D];
      key_mask: [B, M, S] bool or uint8.  All contiguous, on one device,
      q / cache / new K/V in one dtype (bf16 or fp32).
    Returns:
      [B, M, H, D] in q's dtype.
    """
    if q.device.type == "cpu":
        return ensemble_decode_attention(q, k_cache, v_cache, k_new, v_new, key_mask)
    B, M, H, KH, S, D = _check(q, k_cache, v_cache, k_new, v_new, key_mask, q.dtype)
    out = torch.empty_like(q)
    part_m, part_l, part_acc = _partials(q, B, KH, S, M, H, D)
    err = _build.library().dd_ensemble_decode_attention(
        _DTYPES[q.dtype],
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), key_mask.data_ptr(), out.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        B, M, H, KH, S, D, CHUNK, 1.0 / math.sqrt(D),
        _build.stream_of(q),
    )
    _build.check(err, "ensemble_decode_attention kernel")
    ensemble_decode_attention_fused.launches += 1
    return out


ensemble_decode_attention_fused.launches = 0


def ensemble_decode_attention_int8kv_fused(
    q: torch.Tensor,
    kq: torch.Tensor,
    ks: torch.Tensor,
    vq: torch.Tensor,
    vs: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    key_mask: torch.Tensor,
) -> torch.Tensor:
    """K3.  Same contract as ``ops.attention.ensemble_decode_attention_int8kv``.

    Args:
      q: [B, M, H, D]; kq, vq: [B, S, KH, D] int8 (a layer's view of the
      cache's [L, B, S, KH*D] q leaves); ks, vs: [B, KH, S] float32 (a
      layer's view of the [L, B, KH, S] scales); k_new, v_new: [B, M, KH, D];
      key_mask: [B, M, S] bool or uint8.  All contiguous, on one device, q
      and new K/V in one dtype (bf16 or fp32).
    Returns:
      [B, M, H, D] in q's dtype.
    """
    if q.device.type == "cpu":
        return ensemble_decode_attention_int8kv(q, kq, ks, vq, vs, k_new, v_new, key_mask)
    B, M, H, KH, S, D = _check(q, kq, vq, k_new, v_new, key_mask, torch.int8, (ks, vs))
    out = torch.empty_like(q)
    part_m, part_l, part_acc = _partials(q, B, KH, S, M, H, D)
    err = _build.library().dd_ensemble_decode_attention_int8kv(
        _DTYPES[q.dtype],
        q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), key_mask.data_ptr(), out.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        B, M, H, KH, S, D, CHUNK, 1.0 / math.sqrt(D),
        _build.stream_of(q),
    )
    _build.check(err, "ensemble_decode_attention_int8kv kernel")
    ensemble_decode_attention_int8kv_fused.launches += 1
    return out


ensemble_decode_attention_int8kv_fused.launches = 0
