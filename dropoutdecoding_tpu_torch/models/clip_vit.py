"""CLIP ViT vision tower (LLaVA's ViT-L/14-336); port of
``dropoutdecoding_tpu/models/clip_vit.py``.

patchify -> pre-layernorm -> transformer layers, returning the hidden state
at ``vision_feature_layer`` (default -2: the output of layer N-1), CLS
first.  The stride-P patch conv is a reshape plus one matmul.  Weights are
in the JAX layout ([in, out], layers stacked on a leading axis).
"""
from __future__ import annotations

import torch

from ..ops.attention import prefill_attention
from ..ops.basic import act_fn, layer_norm
from ..utils.config import ClipVisionConfig


def patchify(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, 3, H, W] -> [B, (H/P)*(W/P), 3*P*P] in the conv weight's
    (channel, py, px) order."""
    B, C, H, W = pixel_values.shape
    P = patch_size
    x = pixel_values.reshape(B, C, H // P, P, W // P, P).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, (H // P) * (W // P), C * P * P)


def apply(
    cfg: ClipVisionConfig,
    params: dict,
    pixel_values: torch.Tensor,
    feature_layer: int = -2,
) -> torch.Tensor:
    """Run the tower up to ``feature_layer`` (HF hidden_states indexing:
    0 is the pre-layernorm embedding, i the output of layer i).

    Returns:
      [B, 1 + num_patches, D] hidden states (CLS first).
    """
    dtype = params["patch_embedding"].dtype
    B = pixel_values.shape[0]
    D = cfg.hidden_size
    x = patchify(pixel_values.to(dtype), cfg.patch_size) @ params["patch_embedding"]
    cls = params["class_embedding"].reshape(1, 1, D).expand(B, 1, D)
    x = torch.cat([cls, x], dim=1)
    x = x + params["position_embedding"][None, : x.shape[1]]
    x = layer_norm(x, params["pre_ln_w"], params["pre_ln_b"], cfg.layer_norm_eps)

    n_run = (
        cfg.num_hidden_layers + 1 + feature_layer if feature_layer < 0 else feature_layer
    )
    H = cfg.num_attention_heads
    Dh = D // H
    act = act_fn(cfg.hidden_act)
    layers = params["layers"]
    for i in range(n_run):
        lp = {k: v[i] for k, v in layers.items()}
        S = x.shape[1]
        r = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_eps)
        q = (r @ lp["q_w"] + lp["q_b"]).reshape(B, S, H, Dh)
        k = (r @ lp["k_w"] + lp["k_b"]).reshape(B, S, H, Dh)
        v = (r @ lp["v_w"] + lp["v_b"]).reshape(B, S, H, Dh)
        attn = prefill_attention(q, k, v, causal=False)
        x = x + attn.reshape(B, S, D) @ lp["out_w"] + lp["out_b"]
        r = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.layer_norm_eps)
        r = act(r @ lp["fc1_w"] + lp["fc1_b"])
        x = x + r @ lp["fc2_w"] + lp["fc2_b"]
    return x
