"""LLaVA-NeXT's anyres geometry, as HF's ``LlavaNextForConditionalGeneration``
defines it: the grid pinpoint that keeps most of the image, the crop of the
padding the resize left, and the order the packed features take (the base
crop's patches, then the unpadded grid row by row, a newline after each)."""
from __future__ import annotations


def best_resolution(size, pinpoints):
    """The pinpoint (h, w) of the largest effective resolution, then the
    least waste (HF ``select_best_resolution``)."""
    oh, ow = size
    best, best_eff, best_waste = None, 0, float("inf")
    for h, w in pinpoints:
        scale = min(w / ow, h / oh)
        eff = min(int(ow * scale) * int(oh * scale), ow * oh)
        waste = w * h - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best, best_eff, best_waste = (h, w), eff, waste
    return best


def image_geometry(size, config: dict) -> dict:
    """n_tiles, the grid in tiles (gh, gw), the crop (top, left, rows, cols)
    in feature cells, and the number of packed tokens of an image of ``size``
    (h, w)."""
    v = config["vision_config"]
    s, cells = v["image_size"], v["image_size"] // v["patch_size"]
    h, w = best_resolution(size, config["image_grid_pinpoints"])
    gh, gw = h // s, w // s
    ch, cw = gh * cells, gw * cells
    oh, ow = size
    if ow / oh > cw / ch:  # wider than the grid: rows of padding
        rows = int(round(oh * (cw / ow), 7))
        top = (ch - rows) // 2
        crop = (top, 0, ch - 2 * top, cw)
    else:
        cols = int(round(ow * (ch / oh), 7))
        left = (cw - cols) // 2
        crop = (0, left, ch, cw - 2 * left)
    n = cells * cells + crop[2] * (crop[3] + 1)
    return {"n_tiles": gh * gw + 1, "grid": (gh, gw), "crop": crop, "n_tokens": n}


def max_tokens(config: dict) -> int:
    """The most packed tokens any pinpoint grid gives: the program's padded
    visual span, whose length its mask draws take."""
    v = config["vision_config"]
    s, cells = v["image_size"], v["image_size"] // v["patch_size"]
    return max(cells * cells + (h // s * cells) * (w // s * cells + 1)
               for h, w in config["image_grid_pinpoints"])


def pack(features, newline, geometry: dict, config: dict):
    """[tiles, cells², D] projected crop features -> [n_tokens, D] packed."""
    import torch

    v = config["vision_config"]
    cells = v["image_size"] // v["patch_size"]
    gh, gw = geometry["grid"]
    top, left, rows, cols = geometry["crop"]
    D = features.shape[-1]
    grid = features[1:].reshape(gh, gw, cells, cells, D).permute(0, 2, 1, 3, 4)
    grid = grid.reshape(gh * cells, gw * cells, D)[top:top + rows, left:left + cols]
    nl = newline.reshape(1, 1, D).expand(rows, 1, D)
    spatial = torch.cat([grid, nl.to(grid.dtype)], dim=1).reshape(rows * (cols + 1), D)
    return torch.cat([features[0], spatial], dim=0)
