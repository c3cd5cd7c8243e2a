"""Warps from the unit square to the hemisphere and the disc
(``flux_tpu/samplers/warps.py``; reference samplers/src/lib.rs:129-182).

The operations are those of the JAX package in the same order, including
its sign-of-sin construction: ``sin`` is taken as ``±sqrt(1 - cos²)``
with the sign read from the angle's range, one transcendental instead of
two. ``cos`` and ``pow`` come from another math library than XLA's, so
results agree with the JAX package to a few ulp, not bit for bit; ``pow``
is :func:`flux_tpu_torch.vec.pow32`, whose bits do not depend on the
tensor's shape.
"""

import numpy as np
import torch

from .vec import pow32

__all__ = ["to_unit_hemi", "to_hemisphere", "to_poisson_disc"]

_TWO_PI = float(np.float32(2.0 * np.pi))
_QUARTER_PI = float(np.float32(np.pi / 4.0))


def to_unit_hemi(x, y, e):
    """Map a unit-square point to a cos^e-weighted hemisphere direction
    (lib.rs:133-142). Returns the local-frame ``(u, v, w)`` with
    ``w = cos(theta) = (1-y)^(1/(e+1))``; ``e`` is a tensor of per-lane
    exponents."""
    phi = _TWO_PI * x
    cos_phi = torch.cos(phi)
    sin_phi = torch.where(x < 0.5, 1.0, -1.0) * torch.sqrt(
        torch.clamp_min(1.0 - cos_phi * cos_phi, 0.0)
    )
    cos_theta = pow32(torch.clamp_min(1.0 - y, 0.0), 1.0 / (e + 1.0))
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    return sin_theta * cos_phi, sin_theta * sin_phi, cos_theta


def to_hemisphere(points: torch.Tensor, e) -> torch.Tensor:
    """Batch form: ``(N, 2)`` unit-square points to ``(N, 3)`` hemisphere
    directions (lib.rs:129-131)."""
    u, v, w = to_unit_hemi(points[..., 0], points[..., 1], e)
    return torch.stack([u, v, w], dim=-1)


def to_poisson_disc(x, y):
    """Shirley-Chiu concentric map of unit-square points onto the unit disc
    (lib.rs:144-182), branch-free."""
    spx = 2.0 * x - 1.0
    spy = 2.0 * y - 1.0

    def safe_div(a, b):
        return a / torch.where(b == 0.0, 1.0, b)

    c1 = spx > -spy
    c2 = spx > spy
    c3 = spx < spy
    r = torch.where(c1, torch.where(c2, spx, spy), torch.where(c3, -spx, -spy))
    phi = torch.where(
        c1,
        torch.where(c2, safe_div(spy, spx), 2.0 - safe_div(spx, spy)),
        torch.where(
            c3,
            4.0 + safe_div(spy, spx),
            torch.where(spy != 0.0, 6.0 - safe_div(spx, spy), 0.0),
        ),
    )
    # phi (pre-scale) lies in [-1, 8), i.e. [-π/4, 2π): sin >= 0 exactly on
    # pre-scale [0, 4).
    sin_sign = torch.where((phi >= 0.0) & (phi < 4.0), 1.0, -1.0)
    phi = phi * _QUARTER_PI
    cos_phi = torch.cos(phi)
    sin_phi = sin_sign * torch.sqrt(torch.clamp_min(1.0 - cos_phi * cos_phi, 0.0))
    return r * cos_phi, r * sin_phi

