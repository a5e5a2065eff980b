"""K2: the Hopper visual-token uncertainty with the top-k projection table
(``csrc/uncertainty.cu``).

Replaces the TPU kernel ``vision_uncertainty_fused``
(``dropoutdecoding_tpu/ops/pallas_uncertainty.py:101``) and, with ``top_k``,
the table the JAX engine builds beside it
(``dropoutdecoding_tpu/engine/generate.py:334``).  The kernel gives per row
the online statistics (m, Z, A, B), the cross term C = sum_v p log(p_avg +
1e-10) and the k columns with the largest logits; ``_finish`` turns the
statistics into

    alea = log Z + m - A / Z            (exact entropy)
    var  = (B / Z^2 - 1/V) / (V - 1)    (Bessel, as torch.var)
    epis = -alea - C                    (KL(p || p_avg), eps inside log p_avg)

and the valid-weighted image means, in plain torch on the [B, L] results,
as the TPU wrapper does outside Pallas; the kernel's last launch does the
same on the card.

Two routes, picked by ``uncertainty_route`` from the shape alone: "resident"
(a row fits the kernel's shared-memory ring: the logits are read twice) and
"stream" (longer rows, or a tensor off the 16-byte grid: three reads).
``row_plan`` gives the blocks an image of the resident route, block g
walking rows g, g + G, ...; it never looks at the card, so two cards give
the same bits.

``vision_uncertainty_twin`` is the plain twin: the same formulas in torch,
the ids by ``exact_top_k_ids``.  The wrapper uses it for CPU tensors; for
CUDA tensors it launches the kernel or raises.  ``launches`` counts wrapper
calls that launched it, ``route_launches`` the same by route.  Logits are
finite by contract: a -inf poisons A in kernel and twin alike, and among
-inf logits the kernel lists each index once, lower first
(``jax.lax.top_k``'s answer) where ``exact_top_k_ids`` repeats one.
"""
from __future__ import annotations

import math

import torch

from . import _build

_EPS = 1e-10
ROWS_PER_BLOCK = 32  # kRowsPerBlock in csrc/uncertainty.cu (streaming route)
RES_MAX_SPAN = 32768  # kResMaxSpan: floats of a row and its alignment slack
RES_BLOCKS = 132  # blocks of the resident route over all images: a constant, not the card's
C_PIECES = 16  # kPieces: pieces of a row's C
MAX_TOP_K = 16  # kMaxTopK
_ROUTES = {"resident": 0, "stream": 1}


def uncertainty_route(L: int, V: int, k: int = 0, aligned: bool = True) -> str:
    """The route of a [., L, V] call with a top-``k`` table.  ``aligned``: the
    tensor starts on a 16-byte boundary.  Rows that start off that grid (V
    not a multiple of 4) are copied as the aligned span around them, which
    is up to 4 floats longer."""
    if not 0 <= k <= min(MAX_TOP_K, V):
        raise ValueError(f"top_k must lie in [0, {min(MAX_TOP_K, V)}]; got {k}")
    span = -(-V // 4) * 4 + (4 if V % 4 else 0)
    return "resident" if aligned and span <= RES_MAX_SPAN else "stream"


def row_plan(B: int, L: int) -> int:
    """G, the blocks an image of the resident route: block g of an image
    walks its rows g, g + G, ... (``block_rows``)."""
    return max(1, min(L, RES_BLOCKS // B))


def block_rows(g: int, G: int, L: int) -> range:
    return range(g, L, G)


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


def vision_uncertainty_twin(
    logits: torch.Tensor, valid: torch.Tensor | None = None, top_k: int | None = None
) -> dict:
    """Plain-torch twin of the kernel (same statistics, same formulas; with
    ``top_k`` also ``"topk_ids"`` [B, L, k] int32)."""
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
    out = _finish(m, z, a, b, c, w, n, V)
    if top_k is not None:
        out["topk_ids"] = exact_top_k_ids(x, top_k)
    return out


def _launch(logits, valid, top_k, phases: int):
    """Checks the operands, launches the phases of ``dd_vision_uncertainty``
    that ``phases`` names (15: all of them) and returns (tok [3, B, L], img
    [3, B], ids [B, L, k], route)."""
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
    k = 0 if top_k is None else int(top_k)
    route = uncertainty_route(L, V, k, aligned=logits.data_ptr() % 16 == 0)
    # without ``valid`` the kernel takes w = 1 / L and n = L itself
    w, n = (None, None) if valid is None else _row_weights(logits, valid)
    w = None if w is None else w.contiguous()
    dev = logits.device
    stats = torch.empty((5, B, L), dtype=torch.float32, device=dev)  # m, Z, A, B, C
    tok = torch.empty((3, B, L), dtype=torch.float32, device=dev)  # var, epis, alea
    img = torch.empty((3, B), dtype=torch.float32, device=dev)
    ids = torch.empty((B, L, k), dtype=torch.int32, device=dev)
    if route == "resident":
        # the blocks' partial column sums, log(p_avg + 1e-10), the pieces of C
        G = row_plan(B, L)
        floats = B * (G + 1) * (-(-V // 4) * 4) + B * L * C_PIECES
    else:
        # pass B's per-row-block partial sums, then log(p_avg + 1e-10)
        G = 0
        floats = B * (-(-L // ROWS_PER_BLOCK) + 1) * V
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    err = _build.library().dd_vision_uncertainty(
        logits.data_ptr(), None if w is None else w.data_ptr(),
        None if n is None else n.data_ptr(), stats.data_ptr(), scratch.data_ptr(),
        tok.data_ptr(), img.data_ptr(), ids.data_ptr(),
        B, L, V, k, _ROUTES[route], G, phases, _build.stream_of(logits),
    )
    _build.check(err, f"vision_uncertainty kernel ({route})")
    return tok, img, ids, route


def vision_uncertainty_fused(
    logits: torch.Tensor, valid: torch.Tensor | None = None, top_k: int | None = None
) -> dict:
    """Kernel-backed ``vision_uncertainty`` (exact-entropy form).

    Args:
      logits: [B, L, V] visual-token logits (fp32 on the card, finite).
      valid: optional [B, L] bool; p_avg and the image means run over the
        valid rows only.
      top_k: with it, the dict also holds ``"topk_ids"`` [B, L, k] int32,
        the k largest logits of each row, ties toward the lower index.
    Returns:
      the reference's dict of per-token [B, L] and image-level [B] fields.
    """
    if logits.device.type == "cpu":
        return vision_uncertainty_twin(logits, valid, top_k)
    tok, img, ids, route = _launch(logits, valid, top_k, 15)
    vision_uncertainty_fused.launches += 1
    vision_uncertainty_fused.route_launches[route] += 1
    out = {
        "variance_per_token": tok[0],
        "epis_uncert_per_token": tok[1],
        "alea_uncert_per_token": tok[2],
        "variance": img[0],
        "epis_uncert": img[1],
        "alea_uncert": img[2],
    }
    if top_k is not None:
        out["topk_ids"] = ids
    return out


def launch_phases(logits, valid=None, top_k=None, *, ab=False, merge=False, cross=False) -> None:
    """For timers: launches only the named launches of the kernel on a CUDA
    tensor (``ab``: passes A and B with the table, ``merge``: the sum of the
    p_avg lines, ``cross``: pass C) and returns nothing; no result of such a
    call is a result of the function, and no count moves."""
    _launch(logits, valid, top_k, ab * 1 + merge * 2 + cross * 4)


vision_uncertainty_fused.launches = 0
vision_uncertainty_fused.route_launches = dict.fromkeys(_ROUTES, 0)
