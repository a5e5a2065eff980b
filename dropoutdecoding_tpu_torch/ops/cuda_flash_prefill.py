"""K5: the Hopper causal flash prefill attention (``csrc/flash_prefill.cu``).

Replaces the TPU kernel ``flash_prefill_attention``
(``dropoutdecoding_tpu/ops/pallas_attention.py:66``), which the JAX package
runs for prefills of S >= 1024 (LLaVA-NeXT's ~2.9k-token merged prompt).
The port's Llama prefill runs it at every S: LLaVA-1.5's ~600 tokens and
InstructBLIP's ~50 as well.
Query heads read their KV group in place (no ``repeat_kv`` copy); head dims
16, 32, 64 and 128.  Three kernels, picked here from the call's shape
(``prefill_route``) and named to the C entry: bf16 at D = 128 runs the
``wgmma`` kernel (TMA tile ring, 128 x 128 tiles), bf16 at the other head
dims the ``mma.sync`` kernel, fp32 a scalar kernel of the same walk.

For CPU tensors the wrapper computes its plain twin,
``ops.attention.chunked_prefill_attention``.  For CUDA tensors it launches
the kernel or raises; it never falls back.  ``launches`` counts kernel
launches, ``route_launches`` the same by route, and each launch adds one to
the program counter ``prefill.k5_layers`` (the Llama prefill launches K5
once a layer; the twin counts nothing).
"""
from __future__ import annotations

import math

import torch

from ..engine import trace
from . import _build
from .attention import chunked_prefill_attention

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"scalar": 0, "mma": 0, "wgmma": 1}  # as the C entry numbers them
WGMMA_HEAD_DIM = 128
WGMMA_MAX_S = 512 * 128  # the wgmma kernel keeps flags for 512 key tiles of 128


def prefill_route(dtype: torch.dtype, S: int, D: int) -> str:
    """The kernel a call takes: "wgmma" for bf16 at D = 128 (S up to
    ``WGMMA_MAX_S``), "mma" for bf16 otherwise, "scalar" for fp32."""
    if dtype != torch.bfloat16:
        return "scalar"
    return "wgmma" if D == WGMMA_HEAD_DIM and S <= WGMMA_MAX_S else "mma"


def _check(q, k, v, key_mask):
    """Raise unless the operands are what the kernel takes."""
    B, S, H, D = q.shape
    tensors = (q, k, v) + (() if key_mask is None else (key_mask,))
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q, k, v must share a dtype in {list(_DTYPES)}; got {[t.dtype for t in (q, k, v)]}"
        )
    if key_mask is not None and key_mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"key_mask must be bool or uint8, got {key_mask.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries")
    KH = k.shape[2] if k.dim() == 4 else 0
    if (
        k.shape != (B, S, KH, D)
        or v.shape != k.shape
        or (key_mask is not None and key_mask.shape != (B, S))
    ):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"key_mask {None if key_mask is None else tuple(key_mask.shape)}"
        )
    if D not in HEAD_DIMS or not KH or H % KH or S < 1:
        raise ValueError(f"unsupported geometry H={H} KH={KH} D={D} S={S}: needs KH | H "
                         f"and D in {HEAD_DIMS}")


def flash_prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor | None = None,
    causal: bool = True,
) -> torch.Tensor:
    """K5.  Same contract as ``ops.attention.chunked_prefill_attention``.

    Args:
      q: [B, S, H, D]; k, v: [B, S, KH, D] (KH divides H); all contiguous,
        on one device, in one dtype (bf16 or fp32).
      key_mask: optional [B, S] bool or uint8 (1 = attend).
      causal: must be True on the card (the only mode the prefill uses).
    Returns:
      [B, S, H, D] in q's dtype.
    """
    if q.device.type == "cpu":
        return chunked_prefill_attention(q, k, v, key_mask, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if not causal:
        raise NotImplementedError("the flash prefill kernel is causal only")
    _check(q, k, v, key_mask)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    route = prefill_route(q.dtype, S, D)
    err = _build.library().dd_flash_prefill_attention(
        _DTYPES[q.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if key_mask is None else key_mask.data_ptr(), out.data_ptr(),
        B, S, H, k.shape[2], D, 1.0 / math.sqrt(D), _ROUTES[route],
        _build.stream_of(q),
    )
    _build.check(err, f"flash_prefill_attention kernel ({route})")
    flash_prefill_attention.launches += 1
    flash_prefill_attention.route_launches[route] += 1
    trace.count("prefill.k5_layers")
    return out


flash_prefill_attention.launches = 0
flash_prefill_attention.route_launches = dict.fromkeys(_ROUTES, 0)
