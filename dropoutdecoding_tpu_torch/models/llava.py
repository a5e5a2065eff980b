"""LLaVA-1.5 composition: CLIP tower + MLP projector + Llama LM, the
image/text merge, and the loading of an HF checkpoint (port of
``dropoutdecoding_tpu/models/llava.py``)."""
from __future__ import annotations

import json
import os
from typing import NamedTuple

import torch

from . import clip_vit, llama, projector
from ..utils.config import LlavaConfig


class LlavaParams(NamedTuple):
    vision: dict
    projector: dict
    lm: dict


def _normalize_hf_keys(sd: dict) -> dict:
    """Accept both pre-4.52 ('language_model.model.*') and post-4.52
    ('model.language_model.*') HF llava key layouts."""
    out = {}
    for k, v in sd.items():
        if k.startswith("model.language_model."):
            k = "language_model.model." + k[len("model.language_model.") :]
        elif k.startswith("model.vision_tower."):
            k = "vision_tower." + k[len("model.vision_tower.") :]
        elif k.startswith("model.multi_modal_projector."):
            k = "multi_modal_projector." + k[len("model.multi_modal_projector.") :]
        elif k == "lm_head.weight":
            k = "language_model.lm_head.weight"
        out[k] = v
    return out


def params_from_hf(
    cfg: LlavaConfig,
    sd: dict,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
) -> LlavaParams:
    """An HF LlavaForConditionalGeneration state dict (either key layout)
    -> LlavaParams on ``device`` in ``dtype``, built leaf by leaf (JAX
    ``models/llava.py:59``)."""
    sd = _normalize_hf_keys(sd)
    return LlavaParams(
        vision=clip_vit.params_from_hf(
            cfg.vision, sd, dtype, device, prefix="vision_tower.vision_model."
        ),
        projector=projector.params_from_hf(sd, dtype, device),
        lm=llama.params_from_hf(cfg.text, sd, dtype, device, prefix="language_model."),
    )


def load(
    model_dir: str,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
    cache: bool = True,
):
    """Config and weights of an HF checkpoint directory -> (LlavaConfig,
    LlavaParams on ``device``), through the converted-params cache
    (``utils/cache.py``) unless ``cache`` is off."""
    return load_checkpoint(
        model_dir, LlavaConfig, params_from_hf, LlavaParams, dtype, device, cache
    )


def load_checkpoint(model_dir, config_cls, from_hf, params_cls, dtype, device, cache):
    """``load`` of either family: ``config_cls.from_hf_dict`` of the
    directory's config.json, and ``from_hf`` of its state dict as a
    ``params_cls``."""
    from ..utils.cache import load_or_convert
    from ..utils.hf_io import load_state_dict

    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = config_cls.from_hf_dict(json.load(f))

    def convert():
        return from_hf(cfg, load_state_dict(model_dir), dtype, device)._asdict()

    tree = load_or_convert(model_dir, convert, dtype, device, enable=cache)
    return cfg, params_cls(**tree)


def image_features(
    cfg: LlavaConfig, params: LlavaParams, pixel_values: torch.Tensor
) -> torch.Tensor:
    """Vision tower at ``vision_feature_layer``, CLS dropped, projected to
    the LM width.  Returns [B, N_img, D_lm]."""
    hidden = clip_vit.apply(
        cfg.vision, params.vision, pixel_values, cfg.vision_feature_layer
    )
    if cfg.vision_feature_select_strategy == "default":
        hidden = hidden[:, 1:]
    return projector.apply(params.projector, hidden, cfg.projector_hidden_act)


def merge_image_features(
    inputs_embeds: torch.Tensor, image_feats: torch.Tensor, image_pos: torch.Tensor
) -> torch.Tensor:
    """Replace each row's single <image> placeholder with its N features.

    Args:
      inputs_embeds: [B, S, D]; image_feats: [B, N, D]; image_pos: [B].
    Returns:
      [B, S + N - 1, D].
    """
    B, S, D = inputs_embeds.shape
    N = image_feats.shape[1]
    S_out = S + N - 1
    j = torch.arange(S_out, device=inputs_embeds.device)[None, :]
    p = image_pos[:, None]
    is_img = (j >= p) & (j < p + N)
    text_idx = torch.where(j < p, j, (j - N + 1).clamp(0, S - 1))
    img_idx = (j - p).clamp(0, N - 1)
    text_part = inputs_embeds.gather(1, text_idx[..., None].expand(B, S_out, D))
    img_part = image_feats.gather(1, img_idx[..., None].expand(B, S_out, D))
    return torch.where(is_img[..., None], img_part, text_part)


def find_image_pos(input_ids: torch.Tensor, image_token_index: int) -> torch.Tensor:
    """[B, S] -> [B] index of the (single) image token per row."""
    return (input_ids == image_token_index).to(torch.int32).argmax(dim=-1)
