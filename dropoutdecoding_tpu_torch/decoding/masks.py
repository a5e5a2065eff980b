"""Dropout-mask policies over the visual-token span (port of
``dropoutdecoding_tpu/decoding/masks.py``).

Functions return a boolean *drop* mask over the N visual tokens (True =
mask this token out of the member's attention) and work on any leading
batch shape.  Each takes its uniform draws as an argument, so tests can
feed in the JAX package's own draws and production can draw from torch
Philox (``utils/prng.py``).

Ported policies: "epis" (the stochastic uncertainty-scaled mask with
overlap restore; LLaVA-1.5 accumulates it across members, LLaVA-NeXT does
not), "epis_no_overlap" (the same without the overlap restore, LLaVA-NeXT's
``use_random``), "random_image" and "none".  The rest raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch

PORTED_POLICIES = ("epis", "epis_no_overlap", "random_image", "none")
_LATER_POLICIES = (
    "epis_quantile", "epis_kl", "keep_overlap", "vqa", "aggressive", "all_image",
)


def epis_mask_probs(
    epis: torch.Tensor,
    prob_cap: float,
    floor: float = 0.1,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Linear map of epistemic uncertainty to mask probability over the
    last axis:  p_i = floor + (cap - floor) * (epis_i - min) / (max - min).
    All-equal epis gives probability 0.  ``valid`` restricts min / max to
    the real tokens."""
    if valid is not None:
        lo = torch.where(valid, epis, torch.inf).amin(dim=-1, keepdim=True)
        hi = torch.where(valid, epis, -torch.inf).amax(dim=-1, keepdim=True)
    else:
        lo = epis.amin(dim=-1, keepdim=True)
        hi = epis.amax(dim=-1, keepdim=True)
    denom = hi - lo
    pos = denom > 0
    scaled = torch.where(pos, (epis - lo) / torch.where(pos, denom, 1.0), 0.0)
    scaled = scaled.clamp(0.0, 1.0)
    return torch.where(pos, floor + (prob_cap - floor) * scaled, 0.0)


def overlap_keep_mask(argmax_id: torch.Tensor, topk_ids: torch.Tensor) -> torch.Tensor:
    """Visual tokens whose top-k text projection holds the step's unmasked
    argmax token.

    Args:
      argmax_id: [...] token ids.
      topk_ids: [..., N, k] per-visual-token projected ids.
    Returns:
      [..., N] bool, True = keep (never mask).
    """
    return (topk_ids == argmax_id[..., None, None]).any(dim=-1)


def check_policy(policy: str) -> None:
    """Raise unless ``policy`` is one the port implements."""
    if policy in PORTED_POLICIES:
        return
    if policy in _LATER_POLICIES:
        raise NotImplementedError(
            f"mask policy {policy!r} is not ported yet (ROADMAP Queue 1); "
            f"ported: {PORTED_POLICIES}"
        )
    raise ValueError(f"unknown mask policy: {policy}")


def build_member_drop_mask(
    uniform: torch.Tensor,
    policy: str,
    epis: torch.Tensor,
    prob_cap: float,
    overlap_keep: torch.Tensor,
    prev_drop: torch.Tensor,
    accumulate: bool,
    floor: float = 0.1,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Drop mask of one ensemble member.

    Args:
      uniform: [..., N] uniform draws in [0, 1) for this (step, member).
      epis: [..., N] per-visual-token epistemic uncertainty.
      prob_cap: this member's mask-probability cap.
      overlap_keep: [..., N] keep-set from the unmasked argmax.
      prev_drop: [..., N] the previous member's drop mask (all False for
        the first member).
      accumulate: drops accumulate across members (LLaVA-1.5).
      valid: optional [..., N] real visual tokens; epis's min / max run
        over them only (LLaVA-NeXT's padded span).
    Returns:
      [..., N] bool drop mask.
    """
    check_policy(policy)
    if policy in ("epis", "epis_no_overlap"):
        drop = uniform < epis_mask_probs(epis, prob_cap, floor, valid)
        if accumulate:
            drop = drop | prev_drop
        return drop & ~overlap_keep if policy == "epis" else drop
    if policy == "random_image":
        drop = uniform < prob_cap
        return drop | prev_drop if accumulate else drop
    return torch.zeros_like(overlap_keep)  # "none"
