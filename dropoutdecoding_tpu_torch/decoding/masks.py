"""Dropout-mask policies over the visual-token span (port of
``dropoutdecoding_tpu/decoding/masks.py``).

Functions return a boolean *drop* mask over the N visual tokens (True =
mask this token out of the member's attention) and work on any leading
batch shape.  Each takes its uniform draws as an argument, so tests can
feed in the JAX package's own draws and production can draw from torch
Philox (``utils/prng.py``).

Policies: "epis" (the stochastic uncertainty-scaled mask with overlap
restore; LLaVA-1.5 accumulates it across members, LLaVA-NeXT does not),
"epis_no_overlap" (the same without the restore, LLaVA-NeXT's
``use_random``), "epis_quantile" (InstructBLIP's deterministic top-share
mask), "epis_kl" (the epis draw, restored by the lowest-KL keep set),
"random_image", "keep_overlap" and "vqa" (a uniform draw with the overlap
set kept; "vqa" builds that set from the prompt's probe ids),
"aggressive" (a fixed-count random subset), "all_image" and "none".
"""
from __future__ import annotations

import torch

POLICIES = (
    "epis", "epis_no_overlap", "epis_quantile", "epis_kl", "random_image",
    "keep_overlap", "vqa", "aggressive", "all_image", "none",
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


def overlap_keep_mask_multi(probe_ids: torch.Tensor, topk_ids: torch.Tensor) -> torch.Tensor:
    """Union of the keep sets of several probe token ids (the "vqa"
    policy's overlap set).

    Args:
      probe_ids: [..., P] token ids, -1 = padding.
      topk_ids: [..., N, k].
    Returns:
      [..., N] bool keep mask.
    """
    hits = (topk_ids[..., :, None, :] == probe_ids[..., None, :, None]).any(dim=-1)  # [..., N, P]
    return (hits & (probe_ids >= 0)[..., None, :]).any(dim=-1)


def epis_quantile_threshold(
    epis: torch.Tensor, prob_cap: float, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """The (1 - cap) quantile of epis over the last axis, [..., 1], by
    linear interpolation as ``jnp.quantile``; with ``valid`` over the real
    tokens only (``jnp.nanquantile`` over the rest set to NaN)."""
    q = 1.0 - prob_cap
    if valid is None:
        return torch.quantile(epis, q, dim=-1, keepdim=True)
    nan = torch.full_like(epis, torch.nan)
    return torch.nanquantile(torch.where(valid, epis, nan), q, dim=-1, keepdim=True)


def check_policy(policy: str) -> None:
    """Raise ``ValueError`` unless ``policy`` is a mask policy's name."""
    if policy not in POLICIES:
        raise ValueError(f"unknown mask policy: {policy}")


def build_member_drop_mask(
    uniform: torch.Tensor,
    policy: str,
    epis: torch.Tensor,
    prob_cap: float,
    overlap_keep: torch.Tensor,
    prev_drop: torch.Tensor,
    accumulate: bool,
    kl_keep: torch.Tensor | None = None,
    floor: float = 0.1,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Drop mask of one ensemble member.

    Args:
      uniform: [..., N] uniform draws in [0, 1) for this (step, member).
      epis: [..., N] per-visual-token epistemic uncertainty.
      prob_cap: this member's mask-probability cap.
      overlap_keep: [..., N] keep-set from the unmasked argmax (for "vqa",
        from the probe ids).
      prev_drop: [..., N] the previous member's drop mask (all False for
        the first member).
      accumulate: drops accumulate across members (LLaVA-1.5).
      kl_keep: [..., N] lowest-KL keep set ("epis_kl" only).
      valid: optional [..., N] real visual tokens; epis's min / max and
        quantile run over them only (LLaVA-NeXT's padded span).
    Returns:
      [..., N] bool drop mask.
    """
    check_policy(policy)
    if policy in ("epis", "epis_no_overlap"):
        drop = uniform < epis_mask_probs(epis, prob_cap, floor, valid)
        if accumulate:
            drop = drop | prev_drop
        return drop & ~overlap_keep if policy == "epis" else drop
    if policy == "epis_quantile":
        return (epis >= epis_quantile_threshold(epis, prob_cap, valid)) & ~overlap_keep
    if policy == "epis_kl":
        drop = uniform < epis_mask_probs(epis, prob_cap, floor, valid)
        return drop & ~kl_keep if kl_keep is not None else drop
    if policy == "random_image":
        drop = uniform < prob_cap
        return drop | prev_drop if accumulate else drop
    if policy in ("keep_overlap", "vqa"):
        return (uniform < prob_cap) & ~overlap_keep
    if policy == "aggressive":
        # the int(cap * (N - 1)) tokens of lowest draw, redrawn every step
        num = int(prob_cap * (epis.shape[-1] - 1))
        order = torch.argsort(uniform, dim=-1, stable=True)
        return torch.argsort(order, dim=-1, stable=True) < num
    if policy == "all_image":
        return torch.ones_like(overlap_keep)
    return torch.zeros_like(overlap_keep)  # "none"
