"""Axis-aligned bounding-box slab test (``flux_tpu/ops/aabb.py``).

The counterpart of the reference's ``BoundingBox::hit``
(fluxcore/src/shapes.rs:98-133): slab intervals per axis from the inverse
direction, hit iff ``t0 < t1 and t1 > T_MIN`` (no far bound: the reference
accepts boxes behind other geometry). A zero direction component gives ±inf
slabs, which IEEE ``min``/``max`` order as intended. The sweep does not use
it; it is the building block of the block skip of the scan and triangle
kernels (``csrc/scene_megakernel.cu``), whose per-block boxes
:func:`flux_tpu_torch.ops.intersect.scan_layout` builds from
:func:`sphere_bounds`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import T_MIN
from ..vec import Vec3

__all__ = ["aabb_hit", "sphere_bounds"]

_T_MIN = float(np.float32(T_MIN))


def aabb_hit(corner0: Vec3, corner1: Vec3, o: Vec3, d: Vec3) -> torch.Tensor:
    """Slab test of rays (o, d) against one box (corner0 <= corner1); box
    corners are scalars or tensors that broadcast against the lanes."""

    def axis(c0, c1, ox, dx):
        a = 1.0 / dx
        lo = (c0 - ox) * a
        hi = (c1 - ox) * a
        return torch.minimum(lo, hi), torch.maximum(lo, hi)

    tx0, tx1 = axis(corner0.x, corner1.x, o.x, d.x)
    ty0, ty1 = axis(corner0.y, corner1.y, o.y, d.y)
    tz0, tz1 = axis(corner0.z, corner1.z, o.z, d.z)
    t0 = torch.maximum(tx0, torch.maximum(ty0, tz0))
    t1 = torch.minimum(tx1, torch.minimum(ty1, tz1))
    return (t0 < t1) & (t1 > _T_MIN)


def sphere_bounds(center, radius):
    """(corner0, corner1) of a sphere's box (shapes.rs:154-168)."""
    cx, cy, cz = center
    return (
        Vec3(cx - radius, cy - radius, cz - radius),
        Vec3(cx + radius, cy + radius, cz + radius),
    )
