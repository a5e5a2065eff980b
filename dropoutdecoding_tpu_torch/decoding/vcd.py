"""Visual Contrastive Decoding (VCD) math (port of
``dropoutdecoding_tpu/decoding/vcd.py``).

``diffusion_noise`` is the reference's forward-diffusion sample at a noise
step (``vcd_add_noise.py:3-28``; the harness uses step 500) and takes the
Gaussian noise as an argument, as the masks take their uniforms: tests
inject the JAX package's noised pixels through the engine's ``cd_noise``,
and production draws the noise from torch Philox (``utils/prng.py``
``PhiloxNormal``).  ``contrastive_logits`` is the reference's contrastive
combination with the adaptive plausibility cutoff (``vcd_sample.py:150-153``).
Plain torch: no kernel.
"""
from __future__ import annotations

import math

import torch

NUM_STEPS = 1000


def noise_coefficients(noise_step: int) -> tuple[float, float]:
    """(sqrt(alphas_prod[t]), sqrt(1 - alphas_prod[t])) of the reference's
    schedule in fp32: betas = sigmoid(linspace(-6, 6, 1000)) * (0.5e-2 -
    1e-5) + 1e-5, alphas_prod = cumprod(1 - betas)."""
    betas = torch.sigmoid(torch.linspace(-6.0, 6.0, NUM_STEPS)) * (0.5e-2 - 1e-5) + 1e-5
    alphas_prod = torch.cumprod(1.0 - betas, dim=0)
    a = alphas_prod[noise_step]
    return float(torch.sqrt(a)), float(torch.sqrt(1.0 - a))


def diffusion_noise(
    noise: torch.Tensor, pixel_values: torch.Tensor, noise_step: int
) -> torch.Tensor:
    """q(x_t | x_0) at step ``noise_step``: ``a_t * x + sqrt(1 - a_t^2) * noise``
    with ``noise`` standard Gaussian of ``pixel_values``' shape."""
    a_t, om_t = noise_coefficients(noise_step)
    return a_t * pixel_values + om_t * noise


def contrastive_logits(
    logits: torch.Tensor, logits_cd: torch.Tensor, alpha: float = 0.5, beta: float = 0.1
) -> torch.Tensor:
    """``(1 + alpha) * l - alpha * l_cd`` with the tokens below the cutoff
    ``log(beta) + max(l)`` removed (-inf).

    Args:
      logits: [..., V] clean-context next-token logits (fp32).
      logits_cd: [..., V] noised-context logits.
    """
    cutoff = math.log(beta) + logits.amax(dim=-1, keepdim=True)
    diffs = (1.0 + alpha) * logits - alpha * logits_cd
    return diffs.masked_fill(logits < cutoff, -float("inf"))
