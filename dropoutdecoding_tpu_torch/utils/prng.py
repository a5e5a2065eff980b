"""The draws' key trees, one per stream.

The JAX engine folds ``jax.random`` keys along three trees
(``engine/generate.py``): the members' mask draws seed -> step -> rng_id
-> member (``:541,547,564-566``), the text-mask draws seed -> step -> 7919
-> rng_id (``:592-597``), and the sampling draws seed -> 104729 -> step ->
rng_id (``:621-624``).  The port keeps a tree per stream and draws each
leaf from its own torch Philox stream, seeded by a 64-bit mix of the path,
so a row's draws depend on its rng_id and never on the batch it sits in.
The other streams hang under a negative tag (``TEXT_STREAM``,
``SAMPLE_STREAM``, ``VCD_STREAM``) where the mask tree has a step, which is
never negative, so no leaf of one stream is a leaf of another.

VCD (``engine/baselines.py``) has a tree of its own under ``VCD_STREAM``,
as JAX's ``vcd_generate`` splits ``key(seed)`` into a noise key and a
sampling key (``engine/baselines.py:59-60``): the noise leaf (``VCD_STREAM``,
0) and the sampling leaves (``VCD_STREAM``, 1, 0) for the first token and
(``VCD_STREAM``, 1, 1, step) after it depend on the seed and the step only,
never on a row, so every image of a batch gets the draws a B = 1 call gets
(JAX's per-row ``vmap`` with a shared key), and a step makes one draw for
all rows.

The two frameworks give different bits from one seed; tests inject the
JAX package's own draws through the same interfaces: ``uniform(step, row,
member, n)`` for the masks, ``text_uniform(step, row, n)``,
``gumbel(step, row, n)`` and VCD's ``cd_gumbel(step, n)``, which
``PhiloxUniform``, ``PhiloxTextUniform``, ``PhiloxGumbel`` and
``PhiloxVcdGumbel`` implement; VCD's noised pixels come in whole
(``engine/baselines.py`` ``noised_pixels``), ``PhiloxNormal`` being the
noise of production.
"""
from __future__ import annotations

from typing import Callable

import torch

UniformSource = Callable[[int, int, int, int], torch.Tensor]  # (step, row, member, n)
RowSource = Callable[[int, int, int], torch.Tensor]  # (step, row, n)
StepSource = Callable[[int, int], torch.Tensor]  # (step, n): one draw for every row

_MASK64 = (1 << 64) - 1
TEXT_STREAM = -7919
SAMPLE_STREAM = -104729
VCD_STREAM = -15485863


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

    def _gumbel(self, n: int, *path: int) -> torch.Tensor:
        """[n] fp32 standard Gumbel from the leaf at ``path``: ``-log(-log(u))``
        with ``u`` in [tiny, 1), as ``jax.random.gumbel`` makes it."""
        u = self._rand(n, *path).clamp_(min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))


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
    standard Gumbel on ``device``."""

    def __call__(self, step: int, row: int, n: int) -> torch.Tensor:
        return self._gumbel(n, SAMPLE_STREAM, step, row)


class PhiloxVcdGumbel(_Philox):
    """Production VCD sampling noise: ``cd_gumbel(step, n)`` -> [n] fp32
    standard Gumbel, shared by every row; step 0 is the first token's."""

    def __call__(self, step: int, n: int) -> torch.Tensor:
        path = (1, 0) if step == 0 else (1, 1, step)
        return self._gumbel(n, VCD_STREAM, *path)


class PhiloxNormal(_Philox):
    """Production VCD pixel noise: ``noise(shape)`` -> standard Gaussian fp32
    of ``shape``, the same for every call at one seed and shape."""

    def __call__(self, shape) -> torch.Tensor:
        self._gen.manual_seed(leaf_seed(self.seed, VCD_STREAM, 0))
        return torch.randn(tuple(shape), generator=self._gen, device=self.device)
