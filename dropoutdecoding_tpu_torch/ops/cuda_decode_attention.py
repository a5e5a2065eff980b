"""K1: the Hopper ensemble-decode attention (``csrc/decode_attention.cu``).

Replaces the TPU kernel ``ensemble_decode_attention_fused``
(``dropoutdecoding_tpu/ops/pallas_decode_attention.py:166``) and its
layered twin (``:533``).  On the TPU that kernel only ran under GQA
(``H // KH > 1``); here one kernel serves every group size G >= 1, so the
MHA LLaVA-1.5 decode runs it too.

For CPU tensors the wrapper computes the plain twin,
``ops.attention.ensemble_decode_attention``.  For CUDA tensors it launches
the kernel or raises; it never falls back.  ``launches`` counts kernel
launches (one per call: the partial pass and its combine).
"""
from __future__ import annotations

import math

import torch

from . import _build
from .attention import ensemble_decode_attention

CHUNK = 64  # cache slots per block; S / CHUNK blocks per (row, kv group)
MAX_HEAD_DIM = 256
MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _smem_bytes(R: int, D: int, elem: int) -> int:
    """Shared memory of the partial pass (``Smem`` in the CUDA source):
    q [R, D] and scores [R, CHUNK] in fp32, the K and V tiles [CHUNK, D]."""

    def a16(x):
        return -(-x // 16) * 16

    p = a16(R * D * 4)
    k = a16(p + R * CHUNK * 4)
    v = a16(k + CHUNK * D * elem)
    return a16(v + CHUNK * D * elem)


def ensemble_decode_attention_fused(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    key_mask: torch.Tensor,
) -> torch.Tensor:
    """Same contract as ``ops.attention.ensemble_decode_attention``.

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
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, M, H, D = q.shape
    _, S, KH, _ = k_cache.shape
    tensors = (q, k_cache, v_cache, k_new, v_new, key_mask)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if q.dtype not in _DTYPES or any(
        t.dtype != q.dtype for t in (k_cache, v_cache, k_new, v_new)
    ):
        raise TypeError(
            f"q/cache/new K/V must share a dtype in {list(_DTYPES)}; got "
            f"{[t.dtype for t in tensors[:5]]}"
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
    ):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
            f"new {tuple(k_new.shape)}, mask {tuple(key_mask.shape)}"
        )
    R = M * (H // KH) if KH and H % KH == 0 else 0
    if not R or D > MAX_HEAD_DIM or S < 1 or _smem_bytes(R, D, q.element_size()) > MAX_SMEM:
        raise ValueError(
            f"unsupported geometry H={H} KH={KH} M={M} D={D} S={S}: needs KH | H, "
            f"D <= {MAX_HEAD_DIM} and the M*H/KH query rows' tiles in {MAX_SMEM} B "
            "of shared memory"
        )
    nsplit = -(-S // CHUNK)
    out = torch.empty_like(q)
    part_m = torch.empty(B * KH * nsplit * R, dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(part_m.numel() * D, dtype=torch.float32, device=q.device)
    lib = _build.library()
    err = lib.dd_ensemble_decode_attention(
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
