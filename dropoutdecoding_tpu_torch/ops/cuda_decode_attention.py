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

A call is one launch.  A block walks a run of 64-slot tiles of one (batch
row, kv group) and leaves its partial softmax in scratch; the block of the
group that arrives last merges the pieces in split order with the member's
own token and writes the output (``decode_plan`` cuts the slots; scratch and
the arrival counters are kept between calls by ``decode_scratch``).  bf16
activations at D = 128 run both products on the tensor cores, the
probabilities rounded to bf16 for PV as the TPU kernel rounds them; fp32
activations, and other head dims, run fp32 FMAs, so that the card agrees
with the CPU to summation order.

For CPU tensors each wrapper computes its plain twin in
``ops.attention``.  For CUDA tensors it launches the kernel or raises; it
never falls back.  ``launches`` counts kernel launches (one per call).
"""
from __future__ import annotations

import math

import torch

from . import _build
from .attention import ensemble_decode_attention, ensemble_decode_attention_int8kv

TILE = 64  # cache slots per tile; a block walks whole tiles
MMA_ROWS = 16  # query rows per block of the tensor-core kernel
MAX_HEAD_DIM = 256
MAX_SPLITS = 64  # blocks per (batch row, kv group): the merge keeps their weights two a lane
_SMS = 132
_BLOCKS_PER_SM = 3  # what the plan aims at over the cache's whole capacity
_FMA_BLOCKS_PER_SM = 8  # the same for the fp32 FMA kernel, whose blocks are slower by the tile
MMA_HEAD_DIM = 128  # head dim of the tensor-core kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_plan(B: int, KH: int, S: int, tensor_cores: bool = True) -> tuple[int, int]:
    """(tiles a block walks, blocks per (batch row, kv group)).  The grid
    covers the cache's capacity S, whatever its fill, so that a captured
    graph stays valid: B * KH * splits blocks, about ``_BLOCKS_PER_SM`` an
    SM (``_FMA_BLOCKS_PER_SM`` for the fp32 FMA kernel), each a contiguous
    run of tiles; at most ``MAX_SPLITS`` splits."""
    tiles = -(-S // TILE)
    aim = (_BLOCKS_PER_SM if tensor_cores else _FMA_BLOCKS_PER_SM) * _SMS
    per_block = max(1, -(-B * KH * tiles // aim), -(-tiles // MAX_SPLITS))
    return per_block, -(-tiles // per_block)


_scratch: dict[tuple, tuple[torch.Tensor, ...]] = {}


def decode_scratch(device, stream: int, B: int, KH: int, R: int, D: int, splits: int):
    """(part_m, part_l [B * KH, splits, R], part_acc [B * KH, splits, R, D]
    fp32, counters [B * KH, ceil(R / 16)] int32) for one geometry on one
    stream of one device: made at the geometry's first call and kept, since
    the kernel leaves the counters zero.  Two geometries, or two streams,
    never share a buffer, so calls in flight together cannot meet in one."""
    key = (str(device), stream, B, KH, R, D, splits)
    if key not in _scratch:
        n = B * KH * splits * R
        _scratch[key] = (
            torch.empty(n, dtype=torch.float32, device=device),
            torch.empty(n, dtype=torch.float32, device=device),
            torch.empty(n * D, dtype=torch.float32, device=device),
            torch.zeros(B * KH * -(-R // MMA_ROWS), dtype=torch.int32, device=device),
        )
    return _scratch[key]


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
    if not KH or H % KH or D > MAX_HEAD_DIM or S < 1:
        raise ValueError(
            f"unsupported geometry H={H} KH={KH} M={M} D={D} S={S}: needs KH | H and "
            f"D <= {MAX_HEAD_DIM}"
        )
    return B, M, H, KH, S, D


def _launch(entry: str, q, operands, B, M, H, KH, S, D) -> torch.Tensor:
    """One launch of the C entry ``entry`` on q's stream; ``operands`` are
    the tensors between q and the output in the entry's order."""
    out = torch.empty_like(q)
    per_block, splits = decode_plan(
        B, KH, S, tensor_cores=q.dtype == torch.bfloat16 and D == MMA_HEAD_DIM
    )
    stream = _build.stream_of(q)
    scratch = decode_scratch(q.device, stream, B, KH, M * (H // KH), D, splits)
    err = getattr(_build.library(), entry)(
        _DTYPES[q.dtype], q.data_ptr(), *(t.data_ptr() for t in operands), out.data_ptr(),
        *(t.data_ptr() for t in scratch), B, M, H, KH, S, D, per_block, splits,
        1.0 / math.sqrt(D), stream,
    )
    _build.check(err, f"{entry[3:]} kernel")
    return out


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
    out = _launch(
        "dd_ensemble_decode_attention", q, (k_cache, v_cache, k_new, v_new, key_mask),
        B, M, H, KH, S, D,
    )
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
    out = _launch(
        "dd_ensemble_decode_attention_int8kv", q, (kq, ks, vq, vs, k_new, v_new, key_mask),
        B, M, H, KH, S, D,
    )
    ensemble_decode_attention_int8kv_fused.launches += 1
    return out


ensemble_decode_attention_int8kv_fused.launches = 0
