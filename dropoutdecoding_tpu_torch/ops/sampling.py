"""HF-semantics logits warping and the categorical draw (port of
``dropoutdecoding_tpu/ops/sampling.py``).

``warp_logits`` applies HF's warpers in their order (temperature, top-k,
top-p; ``transformers`` ``TemperatureLogitsWarper`` / ``TopKLogitsWarper``
/ ``TopPLogitsWarper`` with ``min_tokens_to_keep=1``).  ``sample_token``
takes the draw's Gumbel noise as an argument: ``argmax(logits + gumbel)``
is what ``jax.random.categorical`` computes, so a test injects
``jax.random.gumbel(key, (V,), jnp.float32)`` and gets the JAX engine's
token, and production passes noise made from torch Philox
(``utils/prng.py``).  Plain torch on the logits' device: no kernel.
"""
from __future__ import annotations

import torch

_FILTER = -float("inf")


def warp_logits(
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float = 1.0,
) -> torch.Tensor:
    """HF's temperature, top-k and top-p warpers, in that order, over the
    last axis of ``logits`` [..., V].

    top-k keeps the k largest logits and every logit tied with the k-th;
    top-p drops the smallest-probability tokens whose ascending cumulative
    probability stays <= 1 - top_p, always keeping the largest.
    """
    V = logits.shape[-1]
    if temperature != 1.0:
        logits = logits / temperature
    if top_k is not None and 0 < top_k < V:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, _FILTER)
    if top_p < 1.0:
        sorted_logits, order = torch.sort(logits, dim=-1, stable=True)  # ascending, as HF
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        remove_sorted = cum <= 1.0 - top_p
        remove_sorted[..., -1] = False  # the most likely token always survives
        remove = torch.empty_like(remove_sorted).scatter_(-1, order, remove_sorted)
        logits = logits.masked_fill(remove, _FILTER)
    return logits


def sample_token(logits: torch.Tensor, gumbel: torch.Tensor, gen) -> torch.Tensor:
    """Tokens [...] drawn from ``logits`` [..., V] warped by ``gen``'s
    temperature, top-k and top-p, with the Gumbel noise ``gumbel``
    [..., V]: the argmax of the two's sum."""
    warped = warp_logits(logits, gen.temperature, gen.top_k, gen.top_p)
    return (warped + gumbel).argmax(dim=-1)
