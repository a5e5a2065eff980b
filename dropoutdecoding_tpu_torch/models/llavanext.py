"""LLaVA-NeXT (v1.6): multi-tile anyres visual tokens over a Mistral-7B LM
(port of ``dropoutdecoding_tpu/models/llavanext.py``).

- Host-side geometry (pure Python, the JAX module's verbatim): the tile
  grid, the unpad crop and the token count follow from the original image
  size, so device shapes depend only on the tile count and the padded
  visual-token maximum ``max_image_tokens``.
- ``packing_indices`` turns HF's spatial_unpad packing into a gather plan
  (numpy); ``pack_image_features*`` gather the projected tile features and
  the ``image_newline`` row by it.
- ``merge_with_text*`` put the packed span at the <image> position with the
  visual padding at the end of the merged sequence, and return the key
  mask and each row's real length.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .llava import image_features
from ..utils.config import LlavaNextConfig


class LlavaNextParams(NamedTuple):
    vision: dict
    projector: dict
    image_newline: torch.Tensor  # [D]
    lm: dict


# ---------------------------------------------------------------------------
# host-side anyres geometry (HF semantics)
# ---------------------------------------------------------------------------


def select_best_resolution(original_size, possible_resolutions):
    """Max effective resolution, then min waste (HF
    image_processing_utils.select_best_resolution)."""
    oh, ow = original_size
    best, max_eff, min_waste = None, 0, float("inf")
    for h, w in possible_resolutions:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = w * h - eff
        if eff > max_eff or (eff == max_eff and waste < min_waste):
            max_eff, min_waste, best = eff, waste, (h, w)
    return best


def anyres_grid_shape(original_size, grid_pinpoints, tile_size):
    h, w = select_best_resolution(original_size, grid_pinpoints)
    return h // tile_size, w // tile_size  # (grid_h, grid_w) in tiles


def unpad_bounds(original_size, grid_cells_hw):
    """Crop offsets and sizes in feature cells (HF unpad_image semantics)."""
    oh, ow = original_size
    ch, cw = grid_cells_hw
    if ow / oh > cw / ch:
        new_h = int(round(oh * (cw / ow), 7))
        pad = (ch - new_h) // 2
        return pad, 0, ch - 2 * pad, cw
    else:
        new_w = int(round(ow * (ch / oh), 7))
        pad = (cw - new_w) // 2
        return 0, pad, ch, cw - 2 * pad


def image_geometry(original_size, cfg: LlavaNextConfig):
    """All static geometry for one image: n_tiles, grid (h, w) in tiles,
    crop (top, left, uh, uw) in cells, and n_tokens."""
    cells = cfg.vision.image_size // cfg.vision.patch_size
    gh, gw = anyres_grid_shape(
        original_size, cfg.image_grid_pinpoints, cfg.vision.image_size
    )
    top, left, uh, uw = unpad_bounds(original_size, (gh * cells, gw * cells))
    n_tokens = cfg.vision.num_patches + uh * (uw + 1)  # base + unpadded + newline
    return {
        "n_tiles": gh * gw + 1,
        "grid": (gh, gw),
        "crop": (top, left, uh, uw),
        "n_tokens": n_tokens,
    }


def max_image_tokens(cfg: LlavaNextConfig) -> int:
    """Upper bound over all pinpoint grids and aspect ratios (2928 at the
    LLaVA-v1.6 defaults: the 672 x 672 grid, 576 + 48 * 49)."""
    cells = cfg.vision.image_size // cfg.vision.patch_size
    best = 0
    for h, w in cfg.image_grid_pinpoints:
        gh, gw = h // cfg.vision.image_size, w // cfg.vision.image_size
        best = max(best, cfg.vision.num_patches + (gh * cells) * (gw * cells + 1))
    return best


def packing_indices(
    cfg: LlavaNextConfig, geometry: dict, out_len: int, pad_tiles: int | None = None
):
    """Host-side gather plan for spatial_unpad packing.

    Returns (gather_idx [out_len] int32, valid [out_len] bool): gather_idx
    indexes a flat source of n_tiles * num_patches projected tile features,
    with index ``n_tiles * num_patches`` (``pad_tiles * num_patches`` when
    a batch pads every row's tiles to ``pad_tiles``) for ``image_newline``.
    The order is HF pack_image_features': the base tile's features, then
    the unpadded spatial grid row-major with a newline after each row.
    """
    gh, gw = geometry["grid"]
    top, left, uh, uw = geometry["crop"]
    cells = cfg.vision.image_size // cfg.vision.patch_size
    n_base = cfg.vision.num_patches
    n_tiles = geometry["n_tiles"]
    newline_idx = (pad_tiles if pad_tiles is not None else n_tiles) * n_base

    idx = list(range(n_base))  # base tile features (tile 0)
    for r in range(top, top + uh):
        g_row, cell_row = divmod(r, cells)
        for c in range(left, left + uw):
            g_col, cell_col = divmod(c, cells)
            tile = 1 + g_row * gw + g_col
            idx.append(tile * n_base + cell_row * cells + cell_col)
        idx.append(newline_idx)
    n_tokens = len(idx)
    assert n_tokens == geometry["n_tokens"], (n_tokens, geometry)
    gather = np.full(out_len, newline_idx, np.int32)
    gather[:n_tokens] = np.asarray(idx, np.int32)
    valid = np.arange(out_len) < n_tokens
    return gather, valid


# ---------------------------------------------------------------------------
# device-side packing and merge
# ---------------------------------------------------------------------------


def pack_image_features(
    cfg: LlavaNextConfig,
    params: LlavaNextParams,
    tile_pixels: torch.Tensor,
    gather_idx: torch.Tensor,
) -> torch.Tensor:
    """One image's tiles [n_tiles, 3, T, T] (base tile first) and gather
    plan [out_len] -> packed visual-token features [out_len, D]."""
    return pack_image_features_batched(cfg, params, tile_pixels[None], gather_idx[None])[0]


def pack_image_features_batched(
    cfg: LlavaNextConfig,
    params: LlavaNextParams,
    tile_pixels: torch.Tensor,
    gather_idx: torch.Tensor,
) -> torch.Tensor:
    """Batched tiles [B, T_pad, 3, T, T] (each row's tiles padded to a
    common T_pad; padded tiles are never gathered) and gather plans [B, N]
    (``packing_indices(..., pad_tiles=T_pad)``) -> packed features
    [B, N, D]."""
    B, T = tile_pixels.shape[:2]
    feats = image_features(cfg, params, tile_pixels.reshape(B * T, *tile_pixels.shape[2:]))
    D = feats.shape[-1]
    feats = feats.reshape(B, T * feats.shape[1], D)  # [B, T*P, D]
    newline = params.image_newline.to(feats.dtype)[None, None].expand(B, 1, D)
    flat = torch.cat([feats, newline], dim=1)  # [B, T*P + 1, D]
    idx = gather_idx.long()
    return flat.gather(1, idx[..., None].expand(*idx.shape, D))


def merge_with_text_batched(
    inputs_embeds: torch.Tensor,
    packed_features: torch.Tensor,
    valid: torch.Tensor,
    image_pos: torch.Tensor,
    text_lens: torch.Tensor | None = None,
):
    """Insert each row's packed span at its <image> position.

    Args:
      inputs_embeds: [B, S_text, D]; packed_features: [B, N_max, D];
      valid: [B, N_max] bool; image_pos: [B].
      text_lens: optional [B] real text length of right-padded rows; their
        pad positions land past real_len and are zeroed and masked like the
        visual padding.
    Returns:
      (merged [B, S_text - 1 + N_max, D], key_mask [B, S_out] bool,
      real_len [B]).  Row layout: [pre | packed valid | post | pad ...].
    """
    B, S_text, D = inputs_embeds.shape
    N_max = packed_features.shape[1]
    dev = inputs_embeds.device
    n_img = valid.long().sum(dim=1)  # [B]
    S_out = S_text - 1 + N_max
    t_len = S_text if text_lens is None else torch.as_tensor(text_lens, device=dev).long()
    real_len = t_len - 1 + n_img  # [B]

    j = torch.arange(S_out, device=dev)[None, :]
    ip = image_pos.long()[:, None]
    ni = n_img[:, None]
    in_img = (j >= ip) & (j < ip + ni)
    beyond = j >= real_len[:, None]
    text_idx = torch.where(j < ip, j, j - ni + 1).clamp(0, S_text - 1)
    text_part = inputs_embeds.gather(1, text_idx[..., None].expand(B, S_out, D))
    img_idx = (j - ip).clamp(0, N_max - 1)
    img_part = packed_features.to(inputs_embeds.dtype).gather(
        1, img_idx[..., None].expand(B, S_out, D)
    )
    out = torch.where(in_img[..., None], img_part, text_part)
    out = out.masked_fill(beyond[..., None], 0.0)
    return out, ~beyond, real_len


def merge_with_text(
    inputs_embeds: torch.Tensor,
    packed_features: torch.Tensor,
    valid: torch.Tensor,
    image_pos: int,
):
    """``merge_with_text_batched`` for one row: inputs_embeds [S_text, D],
    packed_features [N_max, D], valid [N_max], image_pos an int.  Returns
    (merged [S_out, D], key_mask [S_out], real_len [])."""
    pos = torch.tensor([image_pos], device=inputs_embeds.device)
    merged, key_mask, real_len = merge_with_text_batched(
        inputs_embeds[None], packed_features[None], valid[None], pos
    )
    return merged[0], key_mask[0], real_len[0]
