"""Weights for the port: from the JAX package's parameter tree, or
synthetic on the device.

Both keep the JAX layout (``x @ W`` with W [in, out]; layers stacked on a
leading [L] axis), so conversion is a copy, never a transpose.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.instructblip import InstructBlipParams
from ..models.llava import LlavaParams
from ..models.llavanext import LlavaNextParams
from .config import InstructBlipConfig, LlamaConfig, LlavaConfig, LlavaNextConfig
from .quantize import INT4_GROUP, _fit_group, quantize_matrix, quantize_matrix_int4


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
    if isinstance(tree, (list, tuple)):  # the Q-Former's layers, one dict each
        return [_to_torch(v, device, dtype) for v in tree]
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
    return LlavaParams(vision=vision, projector=projector, lm=_synthetic_dense_lm(tc, nrm, ones))


def _synthetic_dense_lm(tc: LlamaConfig, nrm, ones) -> dict:
    """A dense Llama tower at ``tc`` from the callers' draws: ``nrm(*shape)``
    normal(0, 0.02), ``ones(*shape)``."""
    E = tc.hidden_size
    H, KH, Dh, L, I, V = (
        tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim,
        tc.num_hidden_layers, tc.intermediate_size, tc.vocab_size,
    )
    return {
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


def instructblip_params_from_numpy(
    tree, device: torch.device | str = "cpu", dtype: torch.dtype = torch.float32
) -> InstructBlipParams:
    """The JAX ``InstructBlipParams`` pytree (``models/instructblip.py:25``)
    as numpy arrays -> the port's params; the Q-Former's layers stay a list
    of dicts."""
    parts = tree._asdict() if hasattr(tree, "_asdict") else dict(tree)
    return InstructBlipParams(
        **{name: _to_torch(parts[name], device, dtype) for name in InstructBlipParams._fields}
    )


def synthetic_instructblip_params(
    cfg: InstructBlipConfig,
    device: torch.device | str,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
) -> InstructBlipParams:
    """Random InstructBLIP weights made on ``device`` from a seeded
    ``torch.Generator``, the JAX package's ``init_params`` recipe: normal with
    std 0.02, norm weights 1, biases 0; the ViT's fused qkv has biases on q
    and v only.  The LM is ``synthetic_llava_params``' Llama at ``cfg.text``.
    At the InstructBLIP-Vicuna-7B defaults this is about 7.9 B parameters,
    15.8 GB in bf16."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def nrm(*shape):
        return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, 0.02, generator=gen)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    vc, qc = cfg.vision, cfg.qformer
    D, I, L, P = vc.hidden_size, vc.intermediate_size, vc.num_hidden_layers, vc.patch_size
    vision = {
        "class_embedding": nrm(D),
        "patch_embedding": nrm(3 * P * P, D),
        "patch_bias": zeros(D),
        "position_embedding": nrm(vc.num_positions, D),
        "post_ln_w": ones(D),
        "post_ln_b": zeros(D),
        "layers": {
            "ln1_w": ones(L, D), "ln1_b": zeros(L, D),
            "ln2_w": ones(L, D), "ln2_b": zeros(L, D),
            "qkv_w": nrm(L, D, 3 * D), "q_b": zeros(L, D), "v_b": zeros(L, D),
            "proj_w": nrm(L, D, D), "proj_b": zeros(L, D),
            "fc1_w": nrm(L, D, I), "fc1_b": zeros(L, I),
            "fc2_w": nrm(L, I, D), "fc2_b": zeros(L, D),
        },
    }
    Dq, Iq, E = qc.hidden_size, qc.intermediate_size, qc.encoder_hidden_size

    def linear(name, d_in, d_out):
        return {f"{name}_w": nrm(d_in, d_out), f"{name}_b": zeros(d_out)}

    def norm(name):
        return {f"{name}_w": ones(Dq), f"{name}_b": zeros(Dq)}

    layers = []
    for i in range(qc.num_hidden_layers):
        lp = {**linear("self_q", Dq, Dq), **linear("self_k", Dq, Dq), **linear("self_v", Dq, Dq),
              **linear("self_out", Dq, Dq), **norm("self_ln"),
              **linear("interq", Dq, Iq), **linear("outq", Iq, Dq), **norm("outq_ln"),
              **linear("inter", Dq, Iq), **linear("out", Iq, Dq), **norm("out_ln")}
        if i % qc.cross_attention_frequency == 0:
            lp.update({**linear("cross_q", Dq, Dq), **linear("cross_k", E, Dq),
                       **linear("cross_v", E, Dq), **linear("cross_out", Dq, Dq),
                       **norm("cross_ln")})
        layers.append(lp)
    qformer = {
        "word_embeddings": nrm(qc.vocab_size, Dq),
        "position_embeddings": nrm(qc.max_position_embeddings, Dq),
        "emb_ln_w": ones(Dq),
        "emb_ln_b": zeros(Dq),
        "query_tokens": nrm(cfg.num_query_tokens, Dq),
        "layers": layers,
    }
    projection = {"w": nrm(Dq, cfg.text.hidden_size), "b": zeros(cfg.text.hidden_size)}
    return InstructBlipParams(vision=vision, qformer=qformer, projection=projection,
                              lm=_synthetic_dense_lm(cfg.text, nrm, ones))


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


def _dual_base(cfg: LlamaConfig, device, gen):
    """The bf16 base of ``synthetic_llava_dual_lm``, one matrix at a time:
    (fused leaf, layer, output column, w [D, E] fp32 holding bf16 values)
    for q, k, v, o, gate, up and down of every layer, normal(0, 0.02)."""
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    H, KH, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    parts = {  # fused leaf -> (in-dim, its projections' out-dims)
        "qkv_proj": (D, (H * Dh, KH * Dh, KH * Dh)),
        "o_proj": (H * Dh, (D,)),
        "gate_up_proj": (D, (I, I)),
        "down_proj": (I, (D,)),
    }
    for name, (d, widths) in parts.items():
        for layer in range(L):
            col = 0
            for e in widths:
                w = torch.empty(d, e, device=device).normal_(0.0, 0.02, generator=gen)
                yield name, layer, col, w.to(torch.bfloat16).float()
                col += e


def synthetic_llava_dual_lm(cfg: LlamaConfig, device: torch.device | str,
                            seed: int = 0) -> tuple[dict, dict]:
    """(int8 tower, int4 tower) quantized from one seeded bf16 base
    (counterpart of ``dropoutdecoding_tpu/utils/synthetic.py:186``): the
    speculative bench's target and its int4 self-draft.  The base is made
    one [D, E] matrix at a time on ``device`` and quantized at once by
    ``quantize_matrix`` and ``quantize_matrix_int4`` (group fitted as
    ``quantize_llama_params_int4`` fits it), so the bf16 tower (13.5 GB at
    Vicuna-7B) is never resident.  Projections come fused
    (``fuse_projections`` layout); the embeddings, norms and the int8
    ``lm_head`` are one set of tensors that both towers share.  At the
    Vicuna-7B defaults the towers are about 6.6 and 3.6 GB."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    H, KH, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    shapes = {"qkv_proj": (D, (H + 2 * KH) * Dh), "o_proj": (H * Dh, D),
              "gate_up_proj": (D, 2 * I), "down_proj": (I, D)}
    l8, l4 = {}, {}
    for name, (d, e) in shapes.items():
        g = _fit_group(d, INT4_GROUP)
        l8[name] = {"q": torch.empty(L, d, e, dtype=torch.int8, device=device),
                    "s": torch.empty(L, 1, e, device=device)}
        l4[name] = {"q4": torch.empty(L, d // 2, e, dtype=torch.int8, device=device),
                    "s4": torch.empty(L, d // g, e, device=device)}
    for name, layer, col, w in _dual_base(cfg, device, gen):
        cols = slice(col, col + w.shape[1])
        q8 = quantize_matrix(w)
        q4 = quantize_matrix_int4(w, _fit_group(w.shape[0], INT4_GROUP))
        for leaf, q in ((l8[name], q8), (l4[name], q4)):
            for k, v in q.items():
                leaf[k][layer, :, cols] = v

    def head8():
        w = torch.empty(D, cfg.vocab_size, device=device).normal_(0.0, 0.02, generator=gen)
        return quantize_matrix(w.to(torch.bfloat16).float())

    lm8 = _synthetic_lm(cfg, device, gen, l8, head8)
    return lm8, {**lm8, "layers": {**lm8["layers"], **l4}}


def _llava_shell(cfg: LlavaConfig, device, seed: int) -> tuple[dict, dict]:
    """(vision tower, projector) in bf16 at ``cfg``'s widths, made beside a
    one-layer LM that is dropped."""
    import dataclasses

    one = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=1))
    shell = synthetic_llava_params(one, device, torch.bfloat16, seed=seed)
    return shell.vision, shell.projector


def synthetic_llava_7b(device: torch.device | str, cfg: LlavaConfig | None = None,
                       seed: int = 0) -> tuple[LlavaConfig, LlavaParams]:
    """(cfg, params) of a synthetic LLaVA-1.5-7B (counterpart of
    ``dropoutdecoding_tpu/utils/synthetic.py:153``): the LM tower made
    directly in int8 (``synthetic_int8_lm``), the ViT-L/336 vision tower
    and the projector in bf16.  ``cfg``: ``LlavaConfig()`` when None; a
    narrower one for a rehearsal on the CPU."""
    cfg = LlavaConfig() if cfg is None else cfg
    lm = synthetic_int8_lm(cfg.text, device, seed=seed)
    return cfg, LlavaParams(*_llava_shell(cfg, device, seed + 1), lm)


def synthetic_llava_7b_dual(device: torch.device | str, cfg: LlavaConfig | None = None,
                            seed: int = 0) -> tuple[LlavaConfig, LlavaParams, LlavaParams]:
    """(cfg, int8 params, int4 params): both LM towers quantized from one
    seeded bf16 base (``synthetic_llava_dual_lm``; counterpart of
    ``dropoutdecoding_tpu/utils/synthetic.py:186``), sharing the bf16
    vision tower, projector, embeddings and int8 head: the paired arms of a
    drift study between the two weight tiers.  ``cfg`` as
    ``synthetic_llava_7b``'s."""
    cfg = LlavaConfig() if cfg is None else cfg
    lm8, lm4 = synthetic_llava_dual_lm(cfg.text, device, seed=seed)
    vision, projector = _llava_shell(cfg, device, seed + 1)
    return cfg, LlavaParams(vision, projector, lm8), LlavaParams(vision, projector, lm4)
