"""K7: the Hopper grouped-expert SwiGLU product (``csrc/moe_grouped.cu``).

Replaces no TPU kernel (the JAX package has no mixture of experts): the
routed experts of the MLA + MoE decoder's decode forwards
(``models/mla_moe.py``).  The rows come sorted by expert and the group
bounds ``offsets`` stay on the device, so a launch has a fixed grid and
reads nothing back: a CUDA graph holds it (``engine/decode_graphs.py``).

``moe_experts_twin`` is the plain twin, a loop over the experts that reads
the bounds on the host, with the kernel's arithmetic (fp32 sums, ``h``
rounded to the operands' dtype once).  The wrapper uses it for CPU tensors;
for CUDA tensors it launches the kernel or raises.  ``launches`` counts
calls of the kernel's entry (two launches each: gated, then down).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

TILE = 64  # kTileN and kKC in csrc/moe_grouped.cu: D and I must be multiples


def moe_experts_twin(xs, offsets, w_gate, w_up, w_down) -> torch.Tensor:
    """``y[a] = (silu(xs[a] Wg[e]) * (xs[a] Wu[e])) Wd[e]`` for each row a of
    expert e's group ``offsets[e] .. offsets[e + 1] - 1``: fp32 [A, D]."""
    A, D = xs.shape
    y = torch.zeros((A, w_down.shape[-1]), dtype=torch.float32, device=xs.device)
    bounds = offsets.tolist()
    for e in range(len(bounds) - 1):
        lo, hi = bounds[e], bounds[e + 1]
        if hi <= lo:
            continue
        x = xs[lo:hi].float()
        h = (F.silu(x @ w_gate[e].float()) * (x @ w_up[e].float())).to(xs.dtype)
        y[lo:hi] = h.float() @ w_down[e].float()
    return y


def moe_experts(xs, offsets, w_gate, w_up, w_down) -> torch.Tensor:
    """Same contract as ``moe_experts_twin``.

    Args:
      xs: [A, D] bf16, the routing's rows sorted by expert; contiguous.
      offsets: [E + 1] int32 on the same device, offsets[E] = A.
      w_gate, w_up: [E, D, I]; w_down: [E, I, D]; bf16, contiguous.
    Returns:
      [A, D] fp32.
    """
    if xs.device.type == "cpu":
        return moe_experts_twin(xs, offsets, w_gate, w_up, w_down)
    if xs.device.type != "cuda":
        raise ValueError(f"no kernel for device {xs.device}")
    A, D = xs.shape
    E, _, I = w_gate.shape
    tensors = (xs, offsets, w_gate, w_up, w_down)
    if any(t.device != xs.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if any(t.dtype != torch.bfloat16 for t in (xs, w_gate, w_up, w_down)) or offsets.dtype != torch.int32:
        raise TypeError(f"K7 takes bf16 rows and weights and int32 offsets; got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if (w_gate.shape != (E, D, I) or w_up.shape != w_gate.shape or w_down.shape != (E, I, D)
            or offsets.shape != (E + 1,)):
        raise ValueError(f"shape mismatch: xs {tuple(xs.shape)}, gate {tuple(w_gate.shape)}, "
                         f"down {tuple(w_down.shape)}, offsets {tuple(offsets.shape)}")
    if D % TILE or I % TILE:
        raise ValueError(f"K7 needs widths that are multiples of {TILE}; got D={D}, I={I}")
    if any(t.data_ptr() % 16 for t in (xs, w_gate, w_up, w_down)):
        raise ValueError("K7 needs 16-byte aligned operands")
    h = torch.empty((A, I), dtype=torch.bfloat16, device=xs.device)
    y = torch.empty((A, D), dtype=torch.float32, device=xs.device)
    err = _build.library().dd_moe_grouped(
        xs.data_ptr(), offsets.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        h.data_ptr(), y.data_ptr(), A, D, I, E,
        _build.stream_of(xs),
    )
    _build.check(err, "moe_grouped kernel")
    moe_experts.launches += 1
    return y


moe_experts.launches = 0
