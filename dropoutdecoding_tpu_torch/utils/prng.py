"""The draws' key trees, one per stream.

The JAX engine folds ``jax.random`` keys along three trees
(``engine/generate.py``): the members' mask draws seed -> step -> rng_id
-> member (``:541,547,564-566``), the text-mask draws seed -> step -> 7919
-> rng_id (``:592-597``), and the sampling draws seed -> 104729 -> step ->
rng_id (``:621-624``).  The port keeps a tree per stream and draws each
leaf from its own torch Philox stream, seeded by a 64-bit mix of the path,
so a row's draws depend on its rng_id and never on the batch it sits in.
The two new streams hang under a negative tag (``TEXT_STREAM``,
``SAMPLE_STREAM``) where the mask tree has a step, which is never
negative, so no leaf of one stream is a leaf of another.

The two frameworks give different bits from one seed; tests inject the
JAX package's own draws through the same interfaces: ``uniform(step, row,
member, n)`` for the masks, ``text_uniform(step, row, n)`` and
``gumbel(step, row, n)``, which ``PhiloxUniform``, ``PhiloxTextUniform``
and ``PhiloxGumbel`` implement.
"""
from __future__ import annotations

from typing import Callable

import torch

UniformSource = Callable[[int, int, int, int], torch.Tensor]  # (step, row, member, n)
RowSource = Callable[[int, int, int], torch.Tensor]  # (step, row, n)

_MASK64 = (1 << 64) - 1
TEXT_STREAM = -7919
SAMPLE_STREAM = -104729


def _mix64(z: int) -> int:
    """splitmix64's finaliser: a bijective avalanche on 64 bits."""
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(key: int, data: int) -> int:
    """A child key of ``key`` for the integer ``data``."""
    return _mix64((key ^ _mix64((data + 0x9E3779B97F4A7C15) & _MASK64)) & _MASK64)


def leaf_seed(seed: int, *path: int) -> int:
    """The torch seed (63 bits) of the leaf at ``path`` under ``seed``:
    (step, row, member) for a mask draw, (stream, step, row) for the
    others."""
    key = _mix64(seed & _MASK64)
    for data in path:
        key = fold_in(key, data)
    return key >> 1


class _Philox:
    def __init__(self, seed: int, device: torch.device | str):
        self.seed = seed
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device)

    def _rand(self, n: int, *path: int) -> torch.Tensor:
        """[n] fp32 in [0, 1) from the leaf at ``path``; seeding is a
        host-side operation, no device sync."""
        self._gen.manual_seed(leaf_seed(self.seed, *path))
        return torch.rand(n, generator=self._gen, device=self.device)


class PhiloxUniform(_Philox):
    """Production mask draws: ``uniform(step, row, member, n)`` -> [n] fp32
    in [0, 1) on ``device``."""

    def __call__(self, step: int, row: int, member: int, n: int) -> torch.Tensor:
        return self._rand(n, step, row, member)


class PhiloxTextUniform(_Philox):
    """Production text-mask draws: ``text_uniform(step, row, n)`` -> [n]
    fp32 in [0, 1) on ``device``."""

    def __call__(self, step: int, row: int, n: int) -> torch.Tensor:
        return self._rand(n, TEXT_STREAM, step, row)


class PhiloxGumbel(_Philox):
    """Production sampling noise: ``gumbel(step, row, n)`` -> [n] fp32
    standard Gumbel on ``device``, ``-log(-log(u))`` with ``u`` in [tiny,
    1), as ``jax.random.gumbel`` makes it."""

    def __call__(self, step: int, row: int, n: int) -> torch.Tensor:
        u = self._rand(n, SAMPLE_STREAM, step, row).clamp_(min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))
