"""The paper's Dropout Decoding step, written from its description.

- Uncertainty: for the visual tokens' logits with p_i = softmax(logits_i),
  the epistemic part is KL(p_i || mean_j p_j) (``log(p + 1e-10)`` in both
  logs), the mean over the image's real tokens.
- The projection table: each visual token's top-k text ids.
- A member's drop mask ("epis"): token i is dropped when a uniform draw
  lies under floor + (cap - floor) · (epis_i - min) / (max - min); drops
  accumulate from member to member where the configuration says so; tokens
  whose table holds the unmasked step's argmax are never dropped.
- The vote: the token most members put first; the first such member wins.

The uniform draws are a frozen copy of the program's key tree: each leaf
(seed, step, row, member) seeds its own Philox stream (splitmix64 over the
path), and a draw is ``torch.rand(n)`` from it on the run's device, so the
same seed gives the same masks here as in the program.
"""
from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1
EPS = 1e-10


def _mix64(z: int) -> int:
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def leaf_seed(seed: int, *path: int) -> int:
    key = _mix64(seed & _MASK64)
    for data in path:
        key = _mix64((key ^ _mix64((data + 0x9E3779B97F4A7C15) & _MASK64)) & _MASK64)
    return key >> 1


def member_draws(seed: int, step: int, row: int, member: int, n: int, device) -> torch.Tensor:
    g = torch.Generator(device=torch.device(device)).manual_seed(leaf_seed(seed, step, row, member))
    return torch.rand(n, generator=g, device=device)


def epistemic(logits: torch.Tensor) -> torch.Tensor:
    """[N, V] real visual tokens' logits -> [N] epistemic uncertainty."""
    p = torch.softmax(logits.double(), dim=-1)
    logp = torch.log(p + EPS)
    return (p * (logp - torch.log(p.mean(dim=0) + EPS))).sum(-1).float()


def top_ids(logits: torch.Tensor, k: int) -> torch.Tensor:
    """[N, V] -> [N, k] the k largest logits' ids, the lower id first among
    equal logits."""
    return torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]


def drop_masks(epis: torch.Tensor, table: torch.Tensor, argmax: int, draws: list,
               caps, accumulate: bool, floor: float) -> torch.Tensor:
    """[K, N] drop masks of the K members over the N real visual tokens.

    ``draws``: each member's [>= N] uniforms (the first N are read)."""
    N = epis.shape[0]
    lo, hi = epis.min(), epis.max()
    scaled = (epis - lo) / (hi - lo) if hi > lo else torch.zeros_like(epis)
    keep = (table == argmax).any(dim=-1)
    out, prev = [], torch.zeros(N, dtype=torch.bool, device=epis.device)
    for u, cap in zip(draws, caps):
        prob = floor + (cap - floor) * scaled if hi > lo else torch.zeros_like(epis)
        drop = u[:N] < prob
        if accumulate:
            drop = drop | prev
        drop = drop & ~keep
        out.append(drop)
        prev = drop
    return torch.stack(out)


def vote_ids(ids: list) -> tuple:
    """The members' first tokens -> (winner, token): the token most members
    put first, and the first member that put it first."""
    counts = [ids.count(i) for i in ids]
    w = counts.index(max(counts))
    return w, ids[w]


def vote(member_logits: torch.Tensor) -> tuple:
    """[K, V] -> (winner, token)."""
    return vote_ids(member_logits.argmax(dim=-1).tolist())
