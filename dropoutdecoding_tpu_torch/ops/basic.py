"""Elementary numerical ops shared by all towers (port of
``dropoutdecoding_tpu/ops/basic.py``).

Norm statistics accumulate in fp32 whatever the activation dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Llama RMSNorm: normalise in fp32, cast back, then scale (HF
    LlamaRMSNorm order)."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return weight * (x32 * torch.rsqrt(var + eps)).to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y.to(x.dtype) * weight + bias).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def act_fn(name: str):
    # HF "gelu" is the exact erf form
    return {
        "gelu": lambda x: F.gelu(x, approximate="none"),
        "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "quick_gelu": quick_gelu,
        "silu": F.silu,
        "relu": F.relu,
    }[name]


def rotary_embedding(
    positions: torch.Tensor, head_dim: int, theta: float = 10000.0
) -> tuple:
    """RoPE cos/sin tables, angles in fp32 (HF Llama).

    Args:
      positions: [...] integer positions.
    Returns:
      (cos, sin): [..., head_dim] each (half-duplicated layout).
    """
    exponent = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim
    )
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exponent)
    angles = positions.float()[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Apply rotary embedding; ``cos``/``sin`` broadcast against ``x``
    (the caller inserts the head axis)."""
    return (x * cos + _rotate_half(x) * sin).to(x.dtype)
