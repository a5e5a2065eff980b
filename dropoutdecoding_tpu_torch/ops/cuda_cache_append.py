"""K4: the Hopper int8 KV-cache append (``csrc/cache_append.cu``).

Replaces the TPU kernel ``cache_append_rows_int8``
(``dropoutdecoding_tpu/ops/pallas_decode_attention.py:605``) and the XLA
``quantize_kv`` and scale select around it
(``dropoutdecoding_tpu/models/llama.py:209-239``): one launch per decode
step quantizes the winner's K and V rows and writes the int8 values and the
scales at each row's ``cur_len``, for every layer, in place.

Two routes, picked by ``append_route``: "row128" (head dim 128: a lane
holds its four values from one load, one trip to memory) and "scalar" (any
other head dim, or operands off the kernel's alignment).

``cache_append_int8_twin`` is the plain twin (``quantize_kv`` and indexed
assignment).  The wrapper uses it for CPU tensors; for CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches,
``route_launches`` the same by route.  ``cache_append_floor`` launches the
kernel's grid with nothing to do but read ``cur_len`` and write a word a
warp: the time a launch of this shape cannot go below.
"""
from __future__ import annotations

import torch

from ..utils.quantize import quantize_kv
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROW_HEAD_DIM = 128  # kRowD in csrc/cache_append.cu
_ROUTES = {"row128": 0, "scalar": 1}


def append_route(D: int, aligned: bool = True) -> str:
    """The kernel an append of head dim ``D`` takes.  ``aligned``: the new
    rows start on a 16-byte and the int8 leaves on a 4-byte boundary."""
    return "row128" if D == ROW_HEAD_DIM and aligned else "scalar"


def cache_append_int8_twin(kq, ks, vq, vs, cur_len, k_new, v_new) -> None:
    """Quantize ``k_new`` / ``v_new`` [L, B, KH, D] per (layer, row, head)
    and write them at slot ``cur_len[b]`` of the q leaves [L, B, S, KH*D]
    and the scale leaves [L, B, KH, S], in place; a row whose slot lies
    outside [0, S) is not written, as the kernel and an XLA scatter do."""
    L, B, KH, D = k_new.shape
    S = kq.shape[2]
    rows = torch.arange(B, device=cur_len.device)
    at = cur_len.clamp(0, S - 1)  # a row outside keeps its slot's old values: no
    inside = (cur_len >= 0) & (cur_len < S)  # data-dependent shape, so a graph can hold it
    for q_leaf, s_leaf, new in ((kq, ks, k_new), (vq, vs, v_new)):
        d = quantize_kv(new)
        q = d["q"].reshape(L, B, KH * D)
        q_leaf[:, rows, at] = torch.where(inside[None, :, None], q, q_leaf[:, rows, at])
        # the advanced indices (rows, at) are split by a slice, so the
        # indexed view is [B, L, KH]
        s = d["s"][..., 0].transpose(0, 1)
        s_leaf[:, rows, :, at] = torch.where(inside[:, None, None], s, s_leaf[:, rows, :, at])


def cache_append_int8(kq, ks, vq, vs, cur_len, k_new, v_new) -> None:
    """Same contract as ``cache_append_int8_twin``.

    Args:
      kq, vq: [L, B, S, KH*D] int8; ks, vs: [L, B, KH, S] float32;
      cur_len: [B] int64, the slot each row writes (rows outside [0, S) are
      not written); k_new, v_new: [L, B, KH, D] bf16 or fp32.  All
      contiguous, on one device.
    """
    if kq.device.type == "cpu":
        return cache_append_int8_twin(kq, ks, vq, vs, cur_len, k_new, v_new)
    if kq.device.type != "cuda":
        raise ValueError(f"no kernel for device {kq.device}")
    L, B, KH, D = k_new.shape
    S = kq.shape[2]
    tensors = (kq, ks, vq, vs, cur_len, k_new, v_new)
    if any(t.device != kq.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if (
        kq.dtype != torch.int8 or vq.dtype != torch.int8
        or ks.dtype != torch.float32 or vs.dtype != torch.float32
        or cur_len.dtype != torch.int64
        or k_new.dtype not in _DTYPES or v_new.dtype != k_new.dtype
    ):
        raise TypeError(f"unsupported dtypes {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if (
        kq.shape != (L, B, S, KH * D) or vq.shape != kq.shape
        or ks.shape != (L, B, KH, S) or vs.shape != ks.shape
        or v_new.shape != k_new.shape or cur_len.shape != (B,)
    ):
        raise ValueError(
            f"shape mismatch: q {tuple(kq.shape)}, s {tuple(ks.shape)}, "
            f"new {tuple(k_new.shape)}, cur_len {tuple(cur_len.shape)}"
        )
    aligned = not (k_new.data_ptr() % 16 or v_new.data_ptr() % 16
                   or kq.data_ptr() % 4 or vq.data_ptr() % 4)
    route = append_route(D, aligned)
    err = _build.library().dd_cache_append_int8(
        _DTYPES[k_new.dtype], k_new.data_ptr(), v_new.data_ptr(),
        kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(), cur_len.data_ptr(),
        L, B, KH, S, D, _ROUTES[route], _build.stream_of(kq),
    )
    _build.check(err, f"cache_append_int8 kernel ({route})")
    cache_append_int8.launches += 1
    cache_append_int8.route_launches[route] += 1


cache_append_int8.launches = 0
cache_append_int8.route_launches = dict.fromkeys(_ROUTES, 0)


def cache_append_floor(cur_len: torch.Tensor, L: int, KH: int) -> torch.Tensor:
    """The launch floor of the "row128" route for ``cur_len`` [B] on the
    card: the same grid, ``cur_len`` read, one word a warp written and
    returned ([2 * L * B * KH] int32, each row's ``cur_len``)."""
    if cur_len.device.type != "cuda" or cur_len.dtype != torch.int64:
        raise ValueError("cur_len must be an int64 tensor on the card")
    B = cur_len.shape[0]
    out = torch.empty(2 * L * B * KH, dtype=torch.int32, device=cur_len.device)
    err = _build.library().dd_cache_append_floor(
        cur_len.data_ptr(), out.data_ptr(), L, B, KH, _build.stream_of(cur_len)
    )
    _build.check(err, "cache_append floor kernel")
    return out
