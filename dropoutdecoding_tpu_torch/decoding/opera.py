"""OPERA's math: the over-trust penalty and the retrospection trigger (port
of ``dropoutdecoding_tpu/decoding/opera.py``, which documents the method).

At generated step t a candidate's attention row over the generated window
is scaled by ``scale_factor`` and logged; the penalty is the largest column
product ``phi = max_c prod_{i=c+1..t} (scale * w[i, c])``, and its argmax
column is the candidate's summary-token location.  When the committed
location stays put for ``threshold`` steps, decoding rolls back to just
after it (``engine/opera.py``).  Pure functions on fixed-shape tensors.
"""
from __future__ import annotations

import torch


def attn_log_row(
    attn_row: torch.Tensor, scale: float, step: int, eps: float = 1e-20
) -> torch.Tensor:
    """``log(scale * w)`` over the generated window's columns [..., T_win]
    (the caller slices the window out of the cache row), 0 at columns
    ``>= step``: the additive identity of the column sums."""
    col = torch.arange(attn_row.shape[-1], device=attn_row.device)
    logw = torch.log(torch.clamp(attn_row * scale, min=eps))
    return torch.where(col < step, logw, 0.0)


def overtrust_phi(attn_log: torch.Tensor, step: int):
    """(phi, loc): the largest column product over columns [0, step - 1] of
    ``attn_log`` [T, T] (``attn_log[i, c]`` = log(scale * w) of generated
    row i over column c; rows 0..step written, 0 elsewhere), as
    exp(sum over rows c + 1..step), and its first argmax column.  No
    column at step 0: phi = 0, loc = 0."""
    T = attn_log.shape[0]
    rows = torch.arange(T, device=attn_log.device)[:, None]
    cols = torch.arange(T, device=attn_log.device)[None, :]
    in_range = (rows > cols) & (rows <= step)
    colsum = torch.where(in_range, attn_log, 0.0).sum(dim=0)
    colsum = torch.where(cols[0] < step, colsum, -float("inf"))
    loc = colsum.argmax()
    phi = torch.exp(colsum[loc]) if step > 0 else attn_log.new_zeros(())
    return phi, loc


def rollback_trigger(loc_hist: torch.Tensor, step: int, threshold: int):
    """(trigger, loc): whether the last ``threshold`` committed summary
    locations (``loc_hist`` [T] at steps step - threshold + 1 .. step) are
    all equal, and that location."""
    idx = torch.arange(loc_hist.shape[0], device=loc_hist.device)
    recent = (idx > step - threshold) & (idx <= step)
    cur = loc_hist[max(step, 0)]
    all_equal = bool(torch.where(recent, loc_hist == cur, True).all())
    return all_equal and step >= threshold - 1, int(cur)
