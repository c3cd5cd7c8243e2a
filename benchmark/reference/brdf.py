"""Branchless wavefront BRDF direction sampling (``flux_tpu/ops/brdf.py``).

For every reference material the estimator's ``f · cos / pdf`` cancels to
the material's color × amount, so only the direction distributions differ
per material (see the JAX module's docstring):

* matte: frame v = normalize((0.0034,1,0.0071) × n), u = v × n, e = 0
  (brdf.rs:22-27);
* glossy: frame about the mirror direction r, u = normalize((0.00424,1,
  0.00764) × r), v = u × r, cos^e warp, below-horizon flip (brdf.rs:56-71);
* perfect mirror: wi = reflect(d, n) (brdf.rs:40-43).

Under ``physical`` transport matte lanes warp with e = 1 (cosine-weighted,
true Lambertian) instead of the reference's e = 0; the cancellation to
color × amount then holds exactly, so only the direction moves.
"""

from __future__ import annotations

import numpy as np
import torch

from .warps import to_unit_hemi
from .scene import MaterialKind
from .vec import Vec3, dot, frame_about, reflect
from .vec import where as vwhere

__all__ = ["sample_directions"]

# Frame-epsilon vectors (brdf.rs:23 and brdf.rs:57), as float32.
_EM = tuple(float(v) for v in np.array([0.0034, 1.0, 0.0071], np.float32))
_EG = tuple(float(v) for v in np.array([0.00424, 1.0, 0.00764], np.float32))


def sample_directions(kind, exponent, normal: Vec3, d: Vec3, sx, sy, physical: bool = False) -> Vec3:
    """Sample the bounce direction for every lane of a wavefront (matte
    lanes warp with e = 0, or e = 1 under ``physical`` transport).

    ``kind`` holds int32 material kinds, ``exponent`` float32 Phong
    exponents, ``normal`` the hit normals, ``d`` the unit incoming
    directions and ``sx``/``sy`` this bounce's stratified sample. Returns
    the unit outgoing directions ``wi``."""
    r = reflect(d, normal)
    is_glossy = kind == MaterialKind.GLOSSY
    is_perfect = kind == MaterialKind.REFLECTIVE

    e = torch.where(is_glossy, exponent, 1.0 if physical else 0.0)
    hx, hy, hz = to_unit_hemi(sx, sy, e)

    # wi = x·f1 + y·f2 + z·w, with the frame picked per lane.
    w = vwhere(is_glossy, r, normal)
    full = lambda v: torch.full_like(sx, v)  # noqa: E731
    eps = vwhere(
        is_glossy,
        Vec3(full(_EG[0]), full(_EG[1]), full(_EG[2])),
        Vec3(full(_EM[0]), full(_EM[1]), full(_EM[2])),
    )
    c, c2 = frame_about(w, eps)  # matte (v, u=v×w) / glossy (u, v=u×w)
    f1 = vwhere(is_glossy, c, c2)
    f2 = vwhere(is_glossy, c2, c)

    tangential = Vec3(
        hx * f1.x + hy * f2.x,
        hx * f1.y + hy * f2.y,
        hx * f1.z + hy * f2.z,
    )
    axial = w * hz

    # Glossy below-horizon flip (brdf.rs:66-71): negate the tangential part.
    below = (dot(normal, tangential + axial) < 0.0) & is_glossy
    sign = torch.where(below, -1.0, 1.0)
    wi = tangential * sign + axial
    return vwhere(is_perfect, r, wi)
