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

from .cuda_uncertainty import vision_uncertainty_fused

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
    logits: torch.Tensor, valid: torch.Tensor | None = None
) -> dict:
    """The engine's uncertainty: K2 on the card, its plain twin on the CPU."""
    return vision_uncertainty_fused(logits.float().contiguous(), valid)


def exact_top_k_ids(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, in descending
    order with ties broken toward the lower index (argmax's rule, and
    ``jax.lax.top_k``'s order).  k argmax passes rather than
    ``torch.topk``, which promises no order among ties.
    """
    x = logits.clone()
    ids = []
    for _ in range(k):
        idx = x.argmax(dim=-1)
        ids.append(idx)
        x.scatter_(-1, idx[..., None], -math.inf)
    return torch.stack(ids, dim=-1).to(torch.int32)


def entropy_varentropy(logits: torch.Tensor) -> tuple:
    """Entropy (base 2) and varentropy over the last axis, exact
    log-softmax (no eps)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    probs = torch.exp(log_probs)
    ln2 = math.log(2.0)
    entropy = -(probs * log_probs).sum(dim=-1) / ln2
    varentropy = (probs * (log_probs / ln2 + entropy[..., None]) ** 2).sum(dim=-1)
    return entropy, varentropy
