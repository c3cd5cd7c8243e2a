"""Whole-table sample grids and the stateful ``Sampler``
(``flux_tpu/samplers/grids.py``; the reference's samplers/src/lib.rs:22-90,
184-191).

Every generator returns a ``(root², 2)`` float32 tensor of unit-square
points, bit-equal to ``flux_tpu.samplers.grids``'. The tables are pure
functions of an explicit uint32 pattern id, so the ``sampler-debug`` plots
are deterministic. The renderer never builds tables; it calls the
per-index functions of :mod:`flux_tpu_torch.samplers.patterns`.
"""

import torch

from . import patterns
from .hash import hash_combine

__all__ = [
    "grid_regular",
    "grid_jittered",
    "grid_multi_jittered",
    "grid_correlated_multi_jittered",
    "Sampler",
]


def _table(kind: str, root: int, pattern, device) -> torch.Tensor:
    from ..render import resolve_device

    s = torch.arange(root * root, dtype=torch.int64, device=resolve_device(device))
    x, y = patterns.point(kind, s, root, pattern)
    return torch.stack([x, y], dim=-1)


def grid_regular(root: int, device=None) -> torch.Tensor:
    """(root², 2) cell-center grid (lib.rs:184-191), on ``device`` (the
    CUDA card unless the caller names the CPU)."""
    return _table("regular", root, 0, device)


def grid_jittered(root: int, pattern=0, device=None) -> torch.Tensor:
    """(root², 2) jittered grid (lib.rs:35-44)."""
    return _table("jittered", root, pattern, device)


def grid_multi_jittered(root: int, pattern=0, device=None) -> torch.Tensor:
    """(root², 2) multi-jittered grid (lib.rs:46-73)."""
    return _table("mj", root, pattern, device)


def grid_correlated_multi_jittered(root: int, pattern=0, device=None) -> torch.Tensor:
    """(root², 2) correlated multi-jittered grid (lib.rs:75-90)."""
    return _table("cmj", root, pattern, device)


class Sampler:
    """Deterministic stand-in for the reference's ``Sampler`` (lib.rs:22-33):
    each call draws a fresh pattern id from a counter mixed with the seed,
    so successive tables differ while the sequence is reproducible from
    ``seed``. Tables land on ``device``."""

    def __init__(self, seed: int = 0, device=None):
        self.seed = int(seed)
        self.device = device
        self._counter = 0

    def _next_pattern(self):
        p = hash_combine(self.seed, self._counter)
        self._counter += 1
        return p

    def grid_jittered(self, root: int) -> torch.Tensor:
        return grid_jittered(root, self._next_pattern(), self.device)

    def grid_multi_jittered(self, root: int) -> torch.Tensor:
        return grid_multi_jittered(root, self._next_pattern(), self.device)

    def grid_correlated_multi_jittered(self, root: int) -> torch.Tensor:
        return grid_correlated_multi_jittered(root, self._next_pattern(), self.device)
