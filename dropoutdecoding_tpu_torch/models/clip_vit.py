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
from ..parallel.mesh import all_reduce, mesh_of
from ..utils.config import ClipVisionConfig
from ..utils.hf_io import hf_leaf, hf_stacked


def params_from_hf(
    cfg: ClipVisionConfig,
    sd: dict,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
    prefix: str = "vision_model.",
) -> dict:
    """An HF CLIPVisionModel state dict -> the tower's params on ``device``
    in ``dtype`` (JAX ``models/clip_vit.py:57``): linear weights [out, in]
    -> [in, out], layers stacked, and the patch conv [D, 3, P, P] as the
    [3*P*P, D] matrix ``patchify`` multiplies."""

    def leaf(name, transpose=False):
        return hf_leaf(sd, prefix + name, dtype, device, transpose)

    def stack(fmt, transpose=False):
        names = [prefix + fmt.format(i) for i in range(cfg.num_hidden_layers)]
        return hf_stacked(sd, names, dtype, device, transpose)

    conv = torch.as_tensor(sd[prefix + "embeddings.patch_embedding.weight"]).to(device)
    patch_w = conv.reshape(conv.shape[0], -1).t().to(dtype).contiguous()
    attn, mlp = "encoder.layers.{}.self_attn.", "encoder.layers.{}.mlp."
    return {
        "class_embedding": leaf("embeddings.class_embedding"),
        "patch_embedding": patch_w,
        "position_embedding": leaf("embeddings.position_embedding.weight"),
        "pre_ln_w": leaf("pre_layrnorm.weight"),
        "pre_ln_b": leaf("pre_layrnorm.bias"),
        "layers": {
            "ln1_w": stack("encoder.layers.{}.layer_norm1.weight"),
            "ln1_b": stack("encoder.layers.{}.layer_norm1.bias"),
            "ln2_w": stack("encoder.layers.{}.layer_norm2.weight"),
            "ln2_b": stack("encoder.layers.{}.layer_norm2.bias"),
            "q_w": stack(attn + "q_proj.weight", True),
            "q_b": stack(attn + "q_proj.bias"),
            "k_w": stack(attn + "k_proj.weight", True),
            "k_b": stack(attn + "k_proj.bias"),
            "v_w": stack(attn + "v_proj.weight", True),
            "v_b": stack(attn + "v_proj.bias"),
            "out_w": stack(attn + "out_proj.weight", True),
            "out_b": stack(attn + "out_proj.bias"),
            "fc1_w": stack(mlp + "fc1.weight", True),
            "fc1_b": stack(mlp + "fc1.bias"),
            "fc2_w": stack(mlp + "fc2.weight", True),
            "fc2_b": stack(mlp + "fc2.bias"),
        },
    }


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

    Under tensor parallelism (params cut by ``parallel/mesh.py``) each
    rank runs its heads and its fc1 columns; out_w and fc2_w are
    row-parallel, each product all-reduced before its whole bias is added.

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
    mesh = mesh_of(params)
    H = cfg.num_attention_heads
    Dh = D // H
    if mesh is not None:
        if H % mesh.n_model:
            raise ValueError(f"{H} heads do not split over {mesh.n_model} model ranks")
        H //= mesh.n_model
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
        x = x + all_reduce(attn.reshape(B, S, H * Dh) @ lp["out_w"], mesh) + lp["out_b"]
        r = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.layer_norm_eps)
        r = act(r @ lp["fc1_w"] + lp["fc1_b"])
        x = x + all_reduce(r @ lp["fc2_w"], mesh) + lp["fc2_b"]
    return x
