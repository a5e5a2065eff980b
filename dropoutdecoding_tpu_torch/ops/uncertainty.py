"""Visual-token uncertainty quantification (port of
``dropoutdecoding_tpu/ops/uncertainty.py``).

For visual-token logits [B, L, V] with p_i = softmax(logits_i): aleatoric
H(p_i), epistemic KL(p_i || mean_i p_i), the Bessel variance of p_i, and
their image means.  ``vision_uncertainty`` is the reference formula
(log(p + 1e-10) in both logs); ``vision_uncertainty_auto`` is what the
engine calls, and goes through the K2 wrapper (exact entropy).
"""
from __future__ import annotations

import math

import torch

from .cuda_uncertainty import exact_top_k_ids, vision_uncertainty_fused  # noqa: F401

_EPS = 1e-10  # the reference's log(p + 1e-10)


def vision_uncertainty(logits: torch.Tensor, valid: torch.Tensor | None = None) -> dict:
    """Reference implementation (fp32), materialising the probabilities.

    Args:
      logits: [B, L, V]; valid: optional [B, L] bool of real visual tokens.
    Returns:
      dict of per-token [B, L] and image-level [B] fields.
    """
    probs = torch.softmax(logits.float(), dim=-1)
    variance_per_token = probs.var(dim=-1, unbiased=True)
    if valid is None:
        p_avg = probs.mean(dim=1)

        def mean_rows(x):
            return x.mean(dim=-1)

    else:
        w = valid.float()
        n = w.sum(dim=1).clamp_min(1.0)
        p_avg = torch.einsum("bl,blv->bv", w, probs) / n[:, None]

        def mean_rows(x):
            return (x * w).sum(dim=-1) / n

    log_p = torch.log(probs + _EPS)
    epi = (probs * (log_p - torch.log(p_avg[:, None, :] + _EPS))).sum(dim=-1)
    alea = -(probs * log_p).sum(dim=-1)
    return {
        "variance_per_token": variance_per_token,
        "epis_uncert_per_token": epi,
        "alea_uncert_per_token": alea,
        "variance": mean_rows(variance_per_token),
        "epis_uncert": mean_rows(epi),
        "alea_uncert": mean_rows(alea),
    }


def vision_uncertainty_auto(
    logits: torch.Tensor, valid: torch.Tensor | None = None, top_k: int | None = None
) -> dict:
    """The engine's uncertainty: K2 on the card, its plain twin on the CPU;
    with ``top_k`` the same call gives the projection table ``"topk_ids"``."""
    return vision_uncertainty_fused(logits.float().contiguous(), valid, top_k)


def entropy_varentropy(logits: torch.Tensor) -> tuple:
    """Entropy (base 2) and varentropy over the last axis, exact
    log-softmax (no eps)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    probs = torch.exp(log_probs)
    ln2 = math.log(2.0)
    entropy = -(probs * log_probs).sum(dim=-1) / ln2
    varentropy = (probs * (log_probs / ln2 + entropy[..., None]) ** 2).sum(dim=-1)
    return entropy, varentropy


def topk_token_ids(logits: torch.Tensor, k: int) -> tuple:
    """Top-k text-token projection table per visual token: (values [B, L,
    k], ids [B, L, k] int32), descending, the lower index first among ties
    (``jax.lax.top_k``'s order)."""
    ids = exact_top_k_ids(logits, k)
    return logits.gather(-1, ids.long()), ids


def kl_to_current(image_logits: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Per-visual-token KL(softmax(current step logits) || softmax(image
    token logits)).

    Args:
      image_logits: [..., L, V] visual-token logits (prefill projection).
      logits: [..., V] current-step logits.
    Returns:
      [..., L] KL divergences; terms with p = 0 count as 0.
    """
    log_q = torch.log_softmax(image_logits.float(), dim=-1)
    p = torch.softmax(logits.float(), dim=-1)[..., None, :]
    terms = torch.where(p > 0, p * (torch.log(p) - log_q), torch.zeros_like(log_q))
    return terms.sum(dim=-1)


def lowest_percent_kl_indices_mask(
    image_logits: torch.Tensor, logits: torch.Tensor, percent: float = 0.1
) -> torch.Tensor:
    """Boolean [..., L] mask of the lowest-``percent`` KL visual tokens (the
    ``epis_kl`` policy's keep set); the lower index first among equal KLs.
    ``image_logits`` [..., L, V], ``logits`` [..., V]."""
    kl = kl_to_current(image_logits, logits)
    num = int(percent * kl.shape[-1])
    mask = torch.zeros(kl.shape, dtype=torch.bool, device=kl.device)
    if num == 0:
        return mask
    lowest = torch.sort(kl, dim=-1, stable=True).indices[..., :num]  # ties in index order
    return mask.scatter_(-1, lowest, True)
