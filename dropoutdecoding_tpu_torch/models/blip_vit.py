"""InstructBLIP's vision tower, EVA ViT-g/14 as HF ``InstructBlipVisionModel``
ships it; port of ``dropoutdecoding_tpu/models/blip_vit.py``.

patchify -> class token and learned positions -> pre-norm layers -> a final
post-layernorm; the output is the whole tower's last hidden state [B, 1 +
num_patches, D], which the Q-Former reads.  Each layer's q, k and v come
from one fused ``qkv_w`` [D, 3D] with biases on q and v only (HF's
``InstructBlipAttention`` has none on k), kept as ``q_b`` and ``v_b``.
The attention is plain torch (``ops/attention.prefill_attention``, not
causal): at 257 tokens and head dim 88 it never takes the LM's K5 switch.
Weights are in the JAX layout ([in, out], layers stacked on a leading
axis); the JAX tower scans over the stack, this one loops over it.
"""
from __future__ import annotations

import torch

from ..ops.attention import prefill_attention
from ..ops.basic import act_fn, layer_norm
from ..utils.config import BlipVisionConfig
from ..utils.hf_io import hf_leaf, hf_stacked
from .clip_vit import patchify


def params_from_hf(
    cfg: BlipVisionConfig,
    sd: dict,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
    prefix: str = "vision_model.",
) -> dict:
    """An HF InstructBlipVisionModel state dict -> the tower's params on
    ``device`` in ``dtype`` (JAX ``models/blip_vit.py:51``): linear weights
    [out, in] -> [in, out], layers stacked, the patch conv [D, 3, P, P] as
    the [3*P*P, D] matrix ``patchify`` multiplies, and the fused qkv bias
    split into its q and v thirds (its k third is not a parameter of the
    model)."""
    D, L = cfg.hidden_size, cfg.num_hidden_layers

    def leaf(name, transpose=False):
        return hf_leaf(sd, prefix + name, dtype, device, transpose)

    def stack(fmt, transpose=False):
        return hf_stacked(sd, [prefix + fmt.format(i) for i in range(L)], dtype, device, transpose)

    conv = torch.as_tensor(sd[prefix + "embeddings.patch_embedding.weight"]).to(device)
    qkv_b = stack("encoder.layers.{}.self_attn.qkv.bias")  # [L, 3D]
    layer = "encoder.layers.{}."
    return {
        "class_embedding": leaf("embeddings.class_embedding").reshape(-1),
        "patch_embedding": conv.reshape(conv.shape[0], -1).t().to(dtype).contiguous(),
        "patch_bias": leaf("embeddings.patch_embedding.bias"),
        "position_embedding": leaf("embeddings.position_embedding").reshape(cfg.num_positions, D),
        "post_ln_w": leaf("post_layernorm.weight"),
        "post_ln_b": leaf("post_layernorm.bias"),
        "layers": {
            "ln1_w": stack(layer + "layer_norm1.weight"),
            "ln1_b": stack(layer + "layer_norm1.bias"),
            "ln2_w": stack(layer + "layer_norm2.weight"),
            "ln2_b": stack(layer + "layer_norm2.bias"),
            "qkv_w": stack(layer + "self_attn.qkv.weight", True),
            "q_b": qkv_b[:, :D].contiguous(),
            "v_b": qkv_b[:, 2 * D :].contiguous(),
            "proj_w": stack(layer + "self_attn.projection.weight", True),
            "proj_b": stack(layer + "self_attn.projection.bias"),
            "fc1_w": stack(layer + "mlp.fc1.weight", True),
            "fc1_b": stack(layer + "mlp.fc1.bias"),
            "fc2_w": stack(layer + "mlp.fc2.weight", True),
            "fc2_b": stack(layer + "mlp.fc2.bias"),
        },
    }


def apply(cfg: BlipVisionConfig, params: dict, pixel_values: torch.Tensor) -> torch.Tensor:
    """The whole tower -> its post-layernormed last hidden state [B, 1 + P, D]
    (JAX ``models/blip_vit.py:105``)."""
    dtype = params["patch_embedding"].dtype
    B = pixel_values.shape[0]
    D, H = cfg.hidden_size, cfg.num_attention_heads
    Dh = D // H
    x = patchify(pixel_values.to(dtype), cfg.patch_size) @ params["patch_embedding"]
    x = x + params["patch_bias"]
    cls = params["class_embedding"].reshape(1, 1, D).expand(B, 1, D)
    x = torch.cat([cls, x], dim=1)
    x = x + params["position_embedding"][None, : x.shape[1]]
    act = act_fn(cfg.hidden_act)  # "gelu": the exact erf form
    eps = cfg.layer_norm_eps
    layers = params["layers"]
    for i in range(cfg.num_hidden_layers):
        lp = {k: v[i] for k, v in layers.items()}
        S = x.shape[1]
        r = layer_norm(x, lp["ln1_w"], lp["ln1_b"], eps)
        qkv = r @ lp["qkv_w"]  # [B, S, 3D]
        q = (qkv[..., :D] + lp["q_b"]).reshape(B, S, H, Dh)
        k = qkv[..., D : 2 * D].reshape(B, S, H, Dh)
        v = (qkv[..., 2 * D :] + lp["v_b"]).reshape(B, S, H, Dh)
        attn = prefill_attention(q, k, v, causal=False).reshape(B, S, D)
        x = x + attn @ lp["proj_w"] + lp["proj_b"]
        r = layer_norm(x, lp["ln2_w"], lp["ln2_b"], eps)
        r = act(r @ lp["fc1_w"] + lp["fc1_b"])
        x = x + r @ lp["fc2_w"] + lp["fc2_b"]
    return layer_norm(x, params["post_ln_w"], params["post_ln_b"], eps)
