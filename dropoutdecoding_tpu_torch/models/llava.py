"""LLaVA-1.5 composition: CLIP tower + MLP projector + Llama LM, and the
image/text merge (port of ``dropoutdecoding_tpu/models/llava.py``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import clip_vit, projector
from ..utils.config import LlavaConfig


class LlavaParams(NamedTuple):
    vision: dict
    projector: dict
    lm: dict


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
