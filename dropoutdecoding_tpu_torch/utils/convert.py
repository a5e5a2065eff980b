"""Weights for the port: from the JAX package's parameter tree, or
synthetic on the device.

Both keep the JAX layout (``x @ W`` with W [in, out]; layers stacked on a
leading [L] axis), so conversion is a copy, never a transpose.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.llava import LlavaParams
from ..models.llavanext import LlavaNextParams
from .config import LlamaConfig, LlavaConfig, LlavaNextConfig
from .quantize import INT4_GROUP


def _to_torch(tree, device, dtype):
    """Float leaves go to ``dtype``; integer leaves keep their type, and a
    quantized leaf's scale ("s" of int8, "s4" of packed int4) stays fp32
    (``utils/quantize``)."""
    if isinstance(tree, dict):
        scale_dtype = torch.float32 if "q" in tree or "q4" in tree else dtype
        return {
            k: _to_torch(v, device, scale_dtype if k in ("s", "s4") else dtype)
            for k, v in tree.items()
        }
    a = np.asarray(tree)
    if a.dtype.kind in "iub":
        return torch.from_numpy(np.array(a)).to(device=device)
    a = np.ascontiguousarray(a, dtype=np.float32)
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
    cfg: LlavaConfig | LlavaNextConfig,
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


def llavanext_params_from_numpy(
    tree, device: torch.device | str = "cpu", dtype: torch.dtype = torch.float32
) -> LlavaNextParams:
    """The JAX ``LlavaNextParams`` pytree (``models/llavanext.py:30``) as
    numpy arrays -> the port's params, ``image_newline`` included."""
    parts = tree._asdict() if hasattr(tree, "_asdict") else dict(tree)
    return LlavaNextParams(
        **{name: _to_torch(parts[name], device, dtype) for name in LlavaNextParams._fields}
    )


def synthetic_llavanext_params(
    cfg: LlavaNextConfig,
    device: torch.device | str,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
) -> LlavaNextParams:
    """``synthetic_llava_params``' recipe at a LLaVA-NeXT config, plus an
    ``image_newline`` drawn normal(0, 0.02) from the same generator.  At the
    LLaVA-v1.6-Mistral-7B defaults this is about 15 GB in bf16."""
    vision, projector, lm = synthetic_llava_params(cfg, device, dtype, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    newline = torch.empty(cfg.text.hidden_size, dtype=dtype, device=device)
    newline.normal_(0.0, 0.02, generator=gen)
    return LlavaNextParams(vision=vision, projector=projector, image_newline=newline, lm=lm)


def synthetic_int8_lm(cfg: LlamaConfig, device: torch.device | str, seed: int = 0) -> dict:
    """Llama params with the projections and ``lm_head`` made directly in
    int8 on ``device`` ({"q", "s"}, ``utils/quantize`` layout), so a bf16
    tower never exists just to be quantized; counterpart of
    ``dropoutdecoding_tpu/utils/synthetic.py:12``.  Uniform int8 bytes (std
    about 73.9) with scale 0.02 / 73.9 give a dequantized std of about
    0.02; embeddings are normal(0, 0.02) and norms 1, in bf16.  The
    projections come fused, as ``qkv_proj`` / ``gate_up_proj``
    (``utils/quantize.fuse_projections`` layout, the JAX CLI's default on
    one device).  At the Vicuna-7B defaults the int8 tower is about 6.6 GB."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def qmat(*shape):
        q = torch.randint(-128, 128, shape, dtype=torch.int8, device=device, generator=gen)
        s = torch.full((*shape[:-2], 1, shape[-1]), 0.02 / 73.9, device=device)
        return {"q": q, "s": s}

    D, I, V, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_hidden_layers
    H, KH, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    layers = {
        "o_proj": qmat(L, H * Dh, D),
        "down_proj": qmat(L, I, D),
        "qkv_proj": qmat(L, D, (H + 2 * KH) * Dh),
        "gate_up_proj": qmat(L, D, 2 * I),
    }
    return _synthetic_lm(cfg, device, gen, layers, lambda: qmat(D, V))


def _synthetic_lm(cfg: LlamaConfig, device, gen, projections: dict, make_head) -> dict:
    """A synthetic quantized tower around its projections: norms 1 and
    embeddings normal(0, 0.02), in bf16; ``make_head()`` draws the
    ``lm_head`` leaf after the embeddings."""
    D, L = cfg.hidden_size, cfg.num_hidden_layers
    embed = torch.empty(cfg.vocab_size, D, device=device).normal_(0.0, 0.02, generator=gen)
    return {
        "embed_tokens": embed.to(torch.bfloat16),
        "layers": {
            "input_ln": torch.ones(L, D, dtype=torch.bfloat16, device=device),
            "post_attn_ln": torch.ones(L, D, dtype=torch.bfloat16, device=device),
            **projections,
        },
        "norm": torch.ones(D, dtype=torch.bfloat16, device=device),
        "lm_head": make_head(),
    }


def synthetic_int4_lm(cfg: LlamaConfig, device: torch.device | str, seed: int = 0) -> dict:
    """Llama params with the projections made directly in the packed int4
    layout on ``device`` ({"q4", "s4"}, ``utils/quantize.quantize_matrix_int4``)
    and an int8 ``lm_head``, the int4 deployment configuration; counterpart
    of ``dropoutdecoding_tpu/utils/synthetic.py:75``.  Uniform bytes, so the
    nibbles cover [-8, 7] (std about 4.6; the quantizer itself never emits
    -8), with scale 0.02 / 4.6 per (group of ``INT4_GROUP`` rows, channel).
    The projections come fused, as ``synthetic_int8_lm``'s.  At the
    Vicuna-7B defaults the tower is about 3.6 GB."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def qmat4(*shape):
        *lead, d, e = shape
        if d % (2 * INT4_GROUP):
            raise ValueError(f"in-dim {d} not divisible by 2*group ({2 * INT4_GROUP})")
        q4 = torch.randint(-128, 128, (*lead, d // 2, e), dtype=torch.int8, device=device,
                           generator=gen)
        s4 = torch.full((*lead, d // INT4_GROUP, e), 0.02 / 4.6, device=device)
        return {"q4": q4, "s4": s4}

    D, I, V, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_hidden_layers
    H, KH, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    projections = {
        "o_proj": qmat4(L, H * Dh, D),
        "down_proj": qmat4(L, I, D),
        "qkv_proj": qmat4(L, D, (H + 2 * KH) * Dh),
        "gate_up_proj": qmat4(L, D, 2 * I),
    }

    def head8():
        q = torch.randint(-128, 128, (D, V), dtype=torch.int8, device=device, generator=gen)
        return {"q": q, "s": torch.full((1, V), 0.02 / 73.9, device=device)}

    return _synthetic_lm(cfg, device, gen, projections, head8)
