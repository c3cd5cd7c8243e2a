"""Struct-of-arrays 3-vectors over tensors.

``Vec3`` keeps three full-shape component tensors, the layout of
``flux_tpu/vec.py``, so the renderer's arithmetic is written once per
component in the same order as the JAX package's and rounds the same way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Vec3", "dot", "cross", "normalize", "where", "reflect", "frame_about", "div", "pow32"]


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s):
        """Scalar (tensor) multiply."""
        return Vec3(self.x * s, self.y * s, self.z * s)

    def hadamard(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)

    @staticmethod
    def splat(v):
        """From a length-3 tensor or sequence of scalars."""
        return Vec3(v[0], v[1], v[2])


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def normalize(a: Vec3) -> Vec3:
    inv = torch.rsqrt(dot(a, a))
    return Vec3(a.x * inv, a.y * inv, a.z * inv)


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def reflect(d: Vec3, n: Vec3) -> Vec3:
    """Mirror d about n (brdf.rs:40-41): d - 2 (n·d) n."""
    k = 2.0 * dot(n, d)
    return Vec3(d.x - k * n.x, d.y - k * n.y, d.z - k * n.z)


def frame_about(w: Vec3, eps: Vec3):
    """Orthonormal tangent pair about axis ``w`` by the reference's
    epsilon-vector construction (brdf.rs:23,57): c = normalize(eps × w),
    c2 = c × w."""
    c = normalize(cross(eps, w))
    return c, cross(c, w)


def div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` for a Python-number divisor, correctly rounded on every
    device. PyTorch's CUDA division by a host scalar multiplies by its
    reciprocal instead (one rounding more); dividing by a 0-dim tensor on
    ``a``'s device keeps the IEEE quotient that the sample points need to
    match the JAX package and the CUDA kernel bit for bit."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def pow32(a: torch.Tensor, b) -> torch.Tensor:
    """float32 ``a ** b``, computed in float64 and rounded once. PyTorch's
    float32 ``pow`` on the CPU takes one routine inside a vectorized run and
    another for the run's last elements, which differ in the last ulp; so a
    lane's bits would depend on where it falls in its tensor, i.e. on the
    launch's shape. The float64 routines agree after the rounding, which
    keeps a row band and its row shards (``parallel/shard.py``) bit-equal."""
    b = b.to(torch.float64) if isinstance(b, torch.Tensor) else float(b)
    return torch.pow(a.to(torch.float64), b).to(torch.float32)
