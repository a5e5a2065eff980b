"""K4: the Hopper int8 KV-cache append (``csrc/cache_append.cu``).

Replaces the TPU kernel ``cache_append_rows_int8``
(``dropoutdecoding_tpu/ops/pallas_decode_attention.py:605``) and the XLA
``quantize_kv`` and scale select around it
(``dropoutdecoding_tpu/models/llama.py:209-239``): one launch per decode
step quantizes the winner's K and V rows and writes the int8 values and the
scales at each row's ``cur_len``, for every layer, in place.

``cache_append_int8_twin`` is the plain twin (``quantize_kv`` and indexed
assignment).  The wrapper uses it for CPU tensors; for CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from ..utils.quantize import quantize_kv
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def cache_append_int8_twin(kq, ks, vq, vs, cur_len, k_new, v_new) -> None:
    """Quantize ``k_new`` / ``v_new`` [L, B, KH, D] per (layer, row, head)
    and write them at slot ``cur_len[b]`` of the q leaves [L, B, S, KH*D]
    and the scale leaves [L, B, KH, S], in place."""
    L, B, KH, D = k_new.shape
    rows = torch.arange(B, device=cur_len.device)
    for q_leaf, s_leaf, new in ((kq, ks, k_new), (vq, vs, v_new)):
        d = quantize_kv(new)
        q_leaf[:, rows, cur_len] = d["q"].reshape(L, B, KH * D)
        # the advanced indices (rows, cur_len) are split by a slice, so the
        # indexed view is [B, L, KH]
        s_leaf[:, rows, :, cur_len] = d["s"][..., 0].transpose(0, 1)


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
    err = _build.library().dd_cache_append_int8(
        _DTYPES[k_new.dtype], k_new.data_ptr(), v_new.data_ptr(),
        kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(), cur_len.data_ptr(),
        L, B, KH, S, D, _build.stream_of(kq),
    )
    _build.check(err, "cache_append_int8 kernel")
    cache_append_int8.launches += 1


cache_append_int8.launches = 0
