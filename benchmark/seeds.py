"""Seeds of the benchmark's inputs, weights and samples, all from ``--seed``.

Each use mixes the run's seed with a path of small integers (splitmix64),
so that batch 7's images do not depend on how many batches ran before.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK64 = (1 << 64) - 1

WEIGHTS, PROMPT, IMAGES, OBJECTS, CHECK = 1, 2, 3, 4, 5


def _mix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def mix(seed: int, *path: int) -> int:
    """A 63-bit seed for ``path`` under ``seed`` (any Python int)."""
    key = _mix64(seed & _MASK64)
    for p in path:
        key = _mix64(key ^ (p & _MASK64))
    return key >> 1


def generator(device, seed: int, *path: int) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(mix(seed, *path))


def rng(seed: int, *path: int) -> np.random.Generator:
    return np.random.default_rng(mix(seed, *path))
