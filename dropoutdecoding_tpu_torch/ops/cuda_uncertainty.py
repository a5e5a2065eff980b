"""K2: the Hopper visual-token uncertainty (``csrc/uncertainty.cu``).

Replaces the TPU kernel ``vision_uncertainty_fused``
(``dropoutdecoding_tpu/ops/pallas_uncertainty.py:101``).  The kernel's three
passes give per row the online statistics (m, Z, A, B) and the cross term
C = sum_v p log(p_avg + 1e-10); ``_finish`` turns them into

    alea = log Z + m - A / Z            (exact entropy)
    var  = (B / Z^2 - 1/V) / (V - 1)    (Bessel, as torch.var)
    epis = -alea - C                    (KL(p || p_avg), eps inside log p_avg)

and the valid-weighted image means, in plain torch on the [B, L] results,
as the TPU wrapper does outside Pallas.

``vision_uncertainty_twin`` is the plain twin: the same formulas in torch.
The wrapper uses it for CPU tensors; for CUDA tensors it launches the
kernel or raises.  ``launches`` counts wrapper calls that launched it.
"""
from __future__ import annotations

import torch

from . import _build

_EPS = 1e-10
ROWS_PER_BLOCK = 32  # kRowsPerBlock in csrc/uncertainty.cu


def _row_weights(logits: torch.Tensor, valid: torch.Tensor | None):
    """(w [B, L], n_valid [B]): w = 1/n_valid on rows in the mean, else 0;
    n_valid is clamped at 1 so an image with no valid row stays finite."""
    B, L, _ = logits.shape
    if valid is None:
        n = torch.full((B,), float(L), dtype=torch.float32, device=logits.device)
        w = torch.full((B, L), 1.0 / L, dtype=torch.float32, device=logits.device)
        return w, n
    vf = valid.to(torch.float32)
    n = vf.sum(dim=1).clamp_min(1.0)
    return vf / n[:, None], n


def _finish(m, z, a, b, c, w, n, V: int) -> dict:
    alea = torch.log(z) + m - a / z
    var = (b / (z * z) - 1.0 / V) / (V - 1)
    epis = -alea - c
    wrow = w * n[:, None]  # 1 on rows in the mean, 0 elsewhere

    def mean(x):
        return (x * wrow).sum(dim=1) / n

    return {
        "variance_per_token": var,
        "epis_uncert_per_token": epis,
        "alea_uncert_per_token": alea,
        "variance": mean(var),
        "epis_uncert": mean(epis),
        "alea_uncert": mean(alea),
    }


def vision_uncertainty_twin(logits: torch.Tensor, valid: torch.Tensor | None = None) -> dict:
    """Plain-torch twin of the kernel (same statistics, same formulas)."""
    x = logits.float()
    V = x.shape[-1]
    w, n = _row_weights(x, valid)
    m = x.amax(dim=-1)
    e = torch.exp(x - m[..., None])
    z = e.sum(dim=-1)
    a = (e * x).sum(dim=-1)
    b = (e * e).sum(dim=-1)
    p = e / z[..., None]
    pavg = torch.einsum("bl,blv->bv", w, p)
    c = (p * torch.log(pavg + _EPS)[:, None, :]).sum(dim=-1)
    return _finish(m, z, a, b, c, w, n, V)


def vision_uncertainty_fused(
    logits: torch.Tensor, valid: torch.Tensor | None = None
) -> dict:
    """Kernel-backed ``vision_uncertainty`` (exact-entropy form).

    Args:
      logits: [B, L, V] visual-token logits (fp32 on the card).
      valid: optional [B, L] bool; p_avg and the image means run over the
        valid rows only.
    Returns:
      the reference's dict of per-token [B, L] and image-level [B] fields.
    """
    if logits.device.type == "cpu":
        return vision_uncertainty_twin(logits, valid)
    if logits.device.type != "cuda":
        raise ValueError(f"no kernel for device {logits.device}")
    if logits.dtype != torch.float32 or not logits.is_contiguous() or logits.dim() != 3:
        raise TypeError(
            f"logits must be contiguous fp32 [B, L, V]; got {logits.dtype} "
            f"{tuple(logits.shape)} contiguous={logits.is_contiguous()}"
        )
    B, L, V = logits.shape
    if valid is not None and (valid.shape != (B, L) or valid.device != logits.device):
        raise ValueError(f"valid must be [B, L] = {(B, L)} on {logits.device}")
    w, n = _row_weights(logits, valid)
    w = w.contiguous()
    stats = torch.empty((5, B, L), dtype=torch.float32, device=logits.device)
    m, z, a, b, c = stats
    # pass B's per-row-block partial sums, then log(p_avg + 1e-10)
    blocks = -(-L // ROWS_PER_BLOCK)
    scratch = torch.empty((B, blocks + 1, V), dtype=torch.float32, device=logits.device)
    lib = _build.library()
    err = lib.dd_vision_uncertainty(
        logits.data_ptr(), w.data_ptr(), m.data_ptr(), z.data_ptr(),
        a.data_ptr(), b.data_ptr(), scratch.data_ptr(), c.data_ptr(),
        B, L, V, _build.stream_of(logits),
    )
    _build.check(err, "vision_uncertainty kernel")
    vision_uncertainty_fused.launches += 1
    return _finish(m, z, a, b, c, w, n, V)


vision_uncertainty_fused.launches = 0
