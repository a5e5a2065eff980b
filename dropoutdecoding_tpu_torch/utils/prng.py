"""The mask draws' key tree: seed -> step -> rng_id (row) -> member.

The JAX engine folds ``jax.random`` keys along this tree
(``engine/generate.py:541,547,564-566``).  The port keeps the tree and
draws each leaf from its own torch Philox stream, seeded by a 64-bit
mix of the path, so a row's draws do not depend on the batch it sits in.
The two frameworks give different bits from one seed; tests inject the
JAX package's own draws through the same ``uniform(step, row, member, n)``
interface that ``PhiloxUniform`` implements.
"""
from __future__ import annotations

from typing import Callable

import torch

UniformSource = Callable[[int, int, int, int], torch.Tensor]

_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64's finaliser: a bijective avalanche on 64 bits."""
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(key: int, data: int) -> int:
    """A child key of ``key`` for the integer ``data``."""
    return _mix64((key ^ _mix64((data + 0x9E3779B97F4A7C15) & _MASK64)) & _MASK64)


def leaf_seed(seed: int, step: int, row: int, member: int) -> int:
    """The torch seed (63 bits) of one (step, row, member) draw."""
    return fold_in(fold_in(fold_in(_mix64(seed & _MASK64), step), row), member) >> 1


class PhiloxUniform:
    """Production draws: ``uniform(step, row, member, n)`` -> [n] fp32 in
    [0, 1) on ``device``, from a torch Philox generator seeded at the leaf.
    Seeding is a host-side operation; no device sync."""

    def __init__(self, seed: int, device: torch.device | str):
        self.seed = seed
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device)

    def __call__(self, step: int, row: int, member: int, n: int) -> torch.Tensor:
        self._gen.manual_seed(leaf_seed(self.seed, step, row, member))
        return torch.rand(n, generator=self._gen, device=self.device)
