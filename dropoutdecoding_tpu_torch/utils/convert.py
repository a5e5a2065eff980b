"""Weights for the port: from the JAX package's parameter tree, or
synthetic on the device.

Both keep the JAX layout (``x @ W`` with W [in, out]; layers stacked on a
leading [L] axis), so conversion is a copy, never a transpose.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.llava import LlavaParams
from .config import LlavaConfig


def _to_torch(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype) for k, v in tree.items()}
    a = np.ascontiguousarray(np.asarray(tree, dtype=np.float32))
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def llava_params_from_numpy(
    tree, device: torch.device | str = "cpu", dtype: torch.dtype = torch.float32
) -> LlavaParams:
    """The JAX ``LlavaParams`` pytree (``models/llava.py:25``) as numpy
    arrays (``jax.tree.map(np.asarray, params)``) -> the port's params."""
    parts = tree._asdict() if hasattr(tree, "_asdict") else dict(tree)
    return LlavaParams(
        **{name: _to_torch(parts[name], device, dtype) for name in LlavaParams._fields}
    )


def synthetic_llava_params(
    cfg: LlavaConfig,
    device: torch.device | str,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
) -> LlavaParams:
    """Random weights made on ``device`` from a seeded ``torch.Generator``:
    normal with std 0.02, norm weights 1, biases 0 (the JAX package's
    ``init_params`` recipe).  At the LLaVA-1.5-7B defaults this is about
    14 GB in bf16."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def nrm(*shape):
        return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, 0.02, generator=gen)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    vc, tc = cfg.vision, cfg.text
    D, I, L, P = vc.hidden_size, vc.intermediate_size, vc.num_hidden_layers, vc.patch_size
    vision = {
        "class_embedding": nrm(D),
        "patch_embedding": nrm(3 * P * P, D),
        "position_embedding": nrm(vc.num_positions, D),
        "pre_ln_w": ones(D),
        "pre_ln_b": zeros(D),
        "layers": {
            "ln1_w": ones(L, D), "ln1_b": zeros(L, D),
            "ln2_w": ones(L, D), "ln2_b": zeros(L, D),
            "q_w": nrm(L, D, D), "q_b": zeros(L, D),
            "k_w": nrm(L, D, D), "k_b": zeros(L, D),
            "v_w": nrm(L, D, D), "v_b": zeros(L, D),
            "out_w": nrm(L, D, D), "out_b": zeros(L, D),
            "fc1_w": nrm(L, D, I), "fc1_b": zeros(L, I),
            "fc2_w": nrm(L, I, D), "fc2_b": zeros(L, D),
        },
    }
    E = tc.hidden_size
    projector = {
        "fc1_w": nrm(D, E), "fc1_b": zeros(E),
        "fc2_w": nrm(E, E), "fc2_b": zeros(E),
    }
    H, KH, Dh, L, I, V = (
        tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim,
        tc.num_hidden_layers, tc.intermediate_size, tc.vocab_size,
    )
    lm = {
        "embed_tokens": nrm(V, E),
        "layers": {
            "input_ln": ones(L, E),
            "post_attn_ln": ones(L, E),
            "q_proj": nrm(L, E, H * Dh),
            "k_proj": nrm(L, E, KH * Dh),
            "v_proj": nrm(L, E, KH * Dh),
            "o_proj": nrm(L, H * Dh, E),
            "gate_proj": nrm(L, E, I),
            "up_proj": nrm(L, E, I),
            "down_proj": nrm(L, I, E),
        },
        "norm": ones(E),
        "lm_head": nrm(E, V),
    }
    return LlavaParams(vision=vision, projector=projector, lm=lm)
