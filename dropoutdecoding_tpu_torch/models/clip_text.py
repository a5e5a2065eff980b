"""CLIP text tower, the text side of the zero-shot classifier behind the
CHAIR CLI's ``--consistency-im clip``; port of
``dropoutdecoding_tpu/models/clip_text.py``.

HF ``CLIPTextModel``'s graph: token and position embeddings, a causal
pre-LN transformer (the vision tower's block), the final layer norm, the
hidden state at each row's EOS, and ``text_projection``.  Weights are in
the JAX layout ([in, out], layers stacked on a leading axis) and come from
a full CLIP checkpoint (``params_from_hf``): LLaVA checkpoints carry the
vision encoder alone.
"""
from __future__ import annotations

import torch

from ..ops.attention import prefill_attention
from ..ops.basic import act_fn, layer_norm
from ..utils.config import ClipTextConfig
from ..utils.hf_io import hf_leaf, hf_stacked

_LAYER_LEAVES = (  # (leaf, HF name in encoder.layers.{i}, an HF linear weight)
    ("ln1_w", "layer_norm1.weight", False), ("ln1_b", "layer_norm1.bias", False),
    ("ln2_w", "layer_norm2.weight", False), ("ln2_b", "layer_norm2.bias", False),
    ("q_w", "self_attn.q_proj.weight", True), ("q_b", "self_attn.q_proj.bias", False),
    ("k_w", "self_attn.k_proj.weight", True), ("k_b", "self_attn.k_proj.bias", False),
    ("v_w", "self_attn.v_proj.weight", True), ("v_b", "self_attn.v_proj.bias", False),
    ("out_w", "self_attn.out_proj.weight", True), ("out_b", "self_attn.out_proj.bias", False),
    ("fc1_w", "mlp.fc1.weight", True), ("fc1_b", "mlp.fc1.bias", False),
    ("fc2_w", "mlp.fc2.weight", True), ("fc2_b", "mlp.fc2.bias", False),
)


def init_params(
    cfg: ClipTextConfig,
    device: torch.device | str,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
) -> dict:
    """Random weights on ``device`` from a seeded ``torch.Generator``:
    normal with std 0.02, layer-norm weights 1, biases 0 (the JAX
    ``init_params`` recipe; the values are torch's)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers

    def nrm(*shape):
        return torch.empty(shape, device=device).normal_(0.0, 0.02, generator=gen).to(dtype)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    layers = {}
    for name, _, linear in _LAYER_LEAVES:
        if linear:
            d_in, d_out = {"fc1_w": (D, I), "fc2_w": (I, D)}.get(name, (D, D))
            layers[name] = nrm(L, d_in, d_out)
        else:
            width = I if name == "fc1_b" else D
            layers[name] = const(1.0 if name.startswith("ln") and name.endswith("_w") else 0.0,
                                 L, width)
    return {
        "token_embedding": nrm(cfg.vocab_size, D),
        "position_embedding": nrm(cfg.max_position_embeddings, D),
        "final_ln_w": const(1.0, D),
        "final_ln_b": const(0.0, D),
        "text_projection": nrm(D, cfg.projection_dim),
        "layers": layers,
    }


def params_from_hf(
    cfg: ClipTextConfig,
    sd: dict,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
) -> dict:
    """A full CLIP checkpoint's state dict (HF ``CLIPModel`` names:
    ``text_model.*`` and the top-level ``text_projection.weight``) -> the
    tower's params on ``device`` in ``dtype`` (JAX
    ``models/clip_text.py:71``): linear weights [out, in] -> [in, out],
    layers stacked."""
    p = "text_model."
    layers = {
        name: hf_stacked(
            sd, [f"{p}encoder.layers.{i}.{hf}" for i in range(cfg.num_hidden_layers)],
            dtype, device, linear,
        )
        for name, hf, linear in _LAYER_LEAVES
    }
    return {
        "token_embedding": hf_leaf(sd, p + "embeddings.token_embedding.weight", dtype, device),
        "position_embedding": hf_leaf(sd, p + "embeddings.position_embedding.weight", dtype,
                                      device),
        "final_ln_w": hf_leaf(sd, p + "final_layer_norm.weight", dtype, device),
        "final_ln_b": hf_leaf(sd, p + "final_layer_norm.bias", dtype, device),
        "text_projection": hf_leaf(sd, "text_projection.weight", dtype, device, transpose=True),
        "layers": layers,
    }


def apply(
    cfg: ClipTextConfig,
    params: dict,
    input_ids: torch.Tensor,
    eos_positions: torch.Tensor,
) -> torch.Tensor:
    """[B, S] token ids -> [B, projection_dim] projected pooled embeddings,
    pooled at each row's EOS index ``eos_positions`` [B] (HF pools the
    final-norm hidden state there)."""
    B, S = input_ids.shape
    D, H = cfg.hidden_size, cfg.num_attention_heads
    Dh = D // H
    act = act_fn(cfg.hidden_act)
    x = params["token_embedding"][input_ids] + params["position_embedding"][None, :S]
    for i in range(cfg.num_hidden_layers):
        lp = {k: v[i] for k, v in params["layers"].items()}
        r = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_eps)
        q = (r @ lp["q_w"] + lp["q_b"]).reshape(B, S, H, Dh)
        k = (r @ lp["k_w"] + lp["k_b"]).reshape(B, S, H, Dh)
        v = (r @ lp["v_w"] + lp["v_b"]).reshape(B, S, H, Dh)
        attn = prefill_attention(q, k, v, causal=True)
        x = x + attn.reshape(B, S, D) @ lp["out_w"] + lp["out_b"]
        r = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.layer_norm_eps)
        x = x + act(r @ lp["fc1_w"] + lp["fc1_b"]) @ lp["fc2_w"] + lp["fc2_b"]
    x = layer_norm(x, params["final_ln_w"], params["final_ln_b"], cfg.layer_norm_eps)
    pooled = x[torch.arange(B, device=x.device), torch.as_tensor(eos_positions, device=x.device)]
    return pooled @ params["text_projection"]
