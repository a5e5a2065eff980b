"""Weight-only int8 quantization for the Llama tower and the int8 KV-cache
quantizer; port of ``dropoutdecoding_tpu/utils/quantize.py``.

A quantized matrix is the dict {"q": int8 [.., D, E], "s": f32 [.., 1, E]}
(symmetric, one scale per output channel); ``models/llama._mm`` dispatches
on it, so quantized and dense params flow through the same tower code.

Outputs are bit-equal to the JAX package's: fp32 true division by the
scale, round half to even (``torch.round``, as ``jnp.round``), a clip to
+-127, and ``s = 1`` where a channel's amax is 0.

Not ported yet: the packed int4 tier and the w8a8 activation quantizer
(ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import torch

_QUANT_NAMES = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
)


def _quantize(x32: torch.Tensor, amax: torch.Tensor) -> dict:
    # a tensor divisor: for a Python-scalar divisor PyTorch's CUDA kernel
    # multiplies by its reciprocal, which is not the IEEE quotient
    s = torch.where(amax > 0, amax / amax.new_full((), 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_matrix(w: torch.Tensor) -> dict:
    """Symmetric per-output-channel int8: q = round(w / s), s = amax / 127,
    the amax taken over the contraction axis (-2)."""
    w32 = w.float()
    return _quantize(w32, w32.abs().amax(dim=-2, keepdim=True))


def dequantize_matrix(wq: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (wq["q"].float() * wq["s"].float()).to(dtype)


def quantize_kv(x: torch.Tensor) -> dict:
    """Per-(token, head) symmetric int8 for K/V cache entries: x [..., D] ->
    {"q": int8 [..., D], "s": f32 [..., 1]}."""
    x32 = x.float()
    return _quantize(x32, x32.abs().amax(dim=-1, keepdim=True))


def _concat_leaves(leaves):
    """Concatenate projection leaves along the output axis, keeping the
    leaf kind (dense, or every array of a quantized dict)."""
    if isinstance(leaves[0], dict):
        return {k: torch.cat([leaf[k] for leaf in leaves], dim=-1) for k in leaves[0]}
    return torch.cat(leaves, dim=-1)


def fuse_projections(params: dict) -> dict:
    """Fuse q/k/v into "qkv_proj" and gate/up into "gate_up_proj" along the
    output axis, the single-device layout the JAX CLI uses by default
    (``cli/chair_test.py:146-155``).  ``models/llama`` slices the fused
    output.  Returns ``params`` itself when already fused."""
    layers = dict(params["layers"])
    if "qkv_proj" in layers:
        return params
    layers["qkv_proj"] = _concat_leaves(
        [layers.pop("q_proj"), layers.pop("k_proj"), layers.pop("v_proj")]
    )
    layers["gate_up_proj"] = _concat_leaves([layers.pop("gate_proj"), layers.pop("up_proj")])
    return {**params, "layers": layers}


def quantize_llama_params(params: dict) -> dict:
    """Quantize the per-layer projections and ``lm_head`` of a Llama
    parameter dict, as the JAX CLI's ``--quantize int8`` does.  Norms and
    embeddings keep their dtype."""
    layers = dict(params["layers"])
    for name in _QUANT_NAMES:
        layers[name] = quantize_matrix(layers[name])
    return {**params, "layers": layers, "lm_head": quantize_matrix(params["lm_head"])}

