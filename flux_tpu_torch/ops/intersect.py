"""Ray–scene intersection by sweep: every sphere and plane against the whole
wavefront (``flux_tpu/ops/intersect.py``, sweep form).

The math is the reference's (shapes.rs:136-151,176-211): the sphere
quadratic with the near root preferred and the far root taken when the near
one is behind ``T_MIN``, normals scaled by the ``invert`` sign, and the
unbounded plane test. Ties go to the lowest shape index (a strict ``<`` in
index order). The winner's material comes with the hit, with the material
kind packed into the low two mantissa bits of the Phong exponent as the JAX
package packs it, so glossy exponents round the same way there and here.

No finite-math assumption is allowed: a plane with ``d·n == 0`` gives ±inf
or NaN for ``t``, and only IEEE comparisons reject it.

:func:`occluded_sweep` is the any-hit form for NEE shadow rays: one OR per
shape instead of the nearest-hit winner fold, exposed beside
:func:`intersect` as ``intersect.occluded``, the way ``flux_tpu``'s
``Intersector`` exposes ``occluded``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import T_MIN
from ..scene import SceneTensors
from ..vec import Vec3
from ..vec import where as vwhere

__all__ = ["Hit", "sphere_t", "quad_a", "intersect", "fold_occluded_block", "occluded_sweep"]

_T_MIN = float(np.float32(T_MIN))


class Hit(NamedTuple):
    """Wavefront hit record, fused with the winning shape's material row."""

    mask: torch.Tensor  # (B,) bool: anything hit
    t: torch.Tensor  # (B,) f32 distance (inf on miss)
    shape: torch.Tensor  # (B,) i32 winning shape index (spheres, then planes)
    point: Vec3  # hit point
    normal: Vec3  # unit for spheres; planes as authored
    kind: torch.Tensor  # (B,) i32 material kind of the winning shape
    albedo: Vec3  # material color × scalar weight
    exponent: torch.Tensor  # (B,) f32 Phong exponent (glossy lanes)


def sphere_t(o: Vec3, d: Vec3, a, inv_a, cx, cy, cz, radius, on_self=None):
    """The reference's ray-sphere quadratic (shapes.rs:176-211). Returns
    ``(t, valid)``.

    ``a is None`` takes the unit-direction form (``a == d·d == 1``).
    ``on_self`` marks lanes whose ray origin lies on this very sphere; there
    ``c`` is set to its exact value 0, which rejects the false grazing
    self-hits that float32 noise in ``c`` would make (see
    ``flux_tpu.ops.intersect.sphere_t``)."""
    ocx, ocy, ocz = o.x - cx, o.y - cy, o.z - cz
    b_half = ocx * d.x + ocy * d.y + ocz * d.z
    c = ocx * ocx + ocy * ocy + ocz * ocz - radius * radius
    if on_self is not None:
        c = torch.where(on_self, 0.0, c)
    if a is None:
        disc = b_half * b_half - c
        e = torch.sqrt(torch.clamp_min(disc, 0.0))
        t_near = -b_half - e
        t = torch.where(t_near > _T_MIN, t_near, -b_half + e)
    else:
        disc = b_half * b_half - a * c
        e = torch.sqrt(torch.clamp_min(disc, 0.0))
        t_near = (-b_half - e) * inv_a
        t = torch.where(t_near > _T_MIN, t_near, (-b_half + e) * inv_a)
    return t, (disc >= 0.0) & (t > _T_MIN)


def quad_a(scene: SceneTensors, d: Vec3):
    """``(a, inv_a)`` for :func:`sphere_t`: ``(None, None)`` when the scene
    keeps ray directions unit, else ``a = d·d`` and its reciprocal."""
    if scene.unit_d:
        return None, None
    a = d.x * d.x + d.y * d.y + d.z * d.z
    return a, 1.0 / a


def _packed_kind_exponent(scene: SceneTensors) -> torch.Tensor:
    """Per-shape float32 exponent whose low two mantissa bits hold the
    material kind (``flux_tpu/ops/intersect.py:330-337``)."""
    bits = (scene.mat_exp.view(torch.int32) & -4) | scene.mat_kind.to(torch.int32)
    return bits.view(torch.float32)


def intersect(scene: SceneTensors, o: Vec3, d: Vec3, prev=None) -> Hit:
    """Nearest hit of the wavefront (o, d) against every shape.

    ``prev`` (optional int32 lanes) is the shape index each lane's ray
    originates on (-1 for camera rays): that sphere's quadratic takes
    ``c = 0`` and that plane is skipped."""
    ns = scene.num_spheres
    npl = scene.num_planes
    zeros = torch.zeros_like(o.x)

    alb = scene.mat_color * scene.mat_param[:, None]  # (N, 3)
    pe = _packed_kind_exponent(scene)
    a, inv_a = quad_a(scene, d)

    best_t = torch.full_like(o.x, float("inf"))
    best_idx = torch.zeros(o.x.shape, dtype=torch.int32, device=o.x.device)
    best_pe = zeros
    best_alb = Vec3(zeros, zeros, zeros)
    best_ctr = Vec3(zeros, zeros, zeros)  # sphere center (sphere normals)
    best_inv_r = zeros  # invert / radius; 0 for planes
    best_pn = Vec3(zeros, zeros, zeros)  # authored plane normal

    def take(cond, i, ctr_i, inv_r_i, pn_i):
        nonlocal best_idx, best_pe, best_alb, best_ctr, best_inv_r, best_pn
        best_idx = torch.where(cond, i, best_idx)
        best_pe = torch.where(cond, pe[i], best_pe)
        best_alb = vwhere(cond, Vec3(alb[i, 0], alb[i, 1], alb[i, 2]), best_alb)
        best_ctr = vwhere(cond, ctr_i, best_ctr)
        best_inv_r = torch.where(cond, inv_r_i, best_inv_r)
        best_pn = vwhere(cond, pn_i, best_pn)

    for i in range(ns):
        cx, cy, cz = (scene.sphere_center[i, k] for k in range(3))
        radius = scene.sphere_radius[i]
        inv_r = scene.sphere_invert[i] / radius
        t, valid = sphere_t(
            o, d, a, inv_a, cx, cy, cz, radius,
            on_self=None if prev is None else prev == i,
        )
        cond = valid & (t < best_t)
        best_t = torch.where(cond, t, best_t)
        take(cond, i, Vec3(cx, cy, cz), inv_r, best_pn)

    for j in range(npl):
        i = ns + j
        px, py, pz = (scene.plane_point[j, k] for k in range(3))
        nx, ny, nz = (scene.plane_normal[j, k] for k in range(3))
        num = (px - o.x) * nx + (py - o.y) * ny + (pz - o.z) * nz
        den = d.x * nx + d.y * ny + d.z * nz
        t = num / den  # den == 0 gives ±inf or NaN; both are rejected below
        valid = t > _T_MIN
        if prev is not None:
            valid &= prev != i
        cond = valid & (t < best_t)
        best_t = torch.where(cond, t, best_t)
        take(cond, i, best_ctr, zeros, Vec3(nx, ny, nz))

    pe_bits = best_pe.view(torch.int32)
    best_kind = pe_bits & 3
    best_exp = (pe_bits & -4).view(torch.float32)

    mask = torch.isfinite(best_t)
    t_safe = torch.where(mask, best_t, 0.0)
    point = Vec3(o.x + t_safe * d.x, o.y + t_safe * d.y, o.z + t_safe * d.z)
    # Sphere normal (point - c) * invert / r; plane lanes (inv_r == 0) take
    # the authored plane normal.
    n_sph = (point - best_ctr) * best_inv_r
    normal = vwhere(best_inv_r == 0.0, best_pn, n_sph)
    return Hit(
        mask=mask,
        t=best_t,
        shape=best_idx,
        point=point,
        normal=normal,
        kind=best_kind,
        albedo=best_alb,
        exponent=best_exp,
    )


def _plane_occluded(scene: SceneTensors, o: Vec3, d: Vec3, t_max, exclude_idx, occ, origin_idx=None):
    """Fold the planes into an any-hit occlusion mask. ``origin_idx``
    excludes the shadow ray's own origin plane."""
    ns = scene.num_spheres
    for j in range(scene.num_planes):
        px, py, pz = (scene.plane_point[j, k] for k in range(3))
        nx, ny, nz = (scene.plane_normal[j, k] for k in range(3))
        num = (px - o.x) * nx + (py - o.y) * ny + (pz - o.z) * nz
        den = d.x * nx + d.y * ny + d.z * nz
        t = num / den
        blocks = (t > _T_MIN) & (t < t_max) & (exclude_idx != ns + j)
        if origin_idx is not None:
            blocks &= origin_idx != ns + j
        occ = occ | blocks
    return occ


def fold_occluded_block(o, d, a, inv_a, occ, ctr, rad, t_max, exclude_idx, idx, origin_idx=None):
    """Fold spheres ``ctr`` (K, 3) / ``rad`` (K,) whose shape indices are
    ``idx`` into an any-hit occlusion mask: one OR per sphere, no winner.
    The sphere the shadow ray originates on (``origin_idx``) takes its exact
    ``c = 0``, so a genuine self-occlusion through its interior still
    counts."""
    for k, i in enumerate(idx):
        t, valid = sphere_t(
            o, d, a, inv_a, ctr[k, 0], ctr[k, 1], ctr[k, 2], rad[k],
            on_self=None if origin_idx is None else origin_idx == i,
        )
        occ = occ | (valid & (t < t_max) & (exclude_idx != i))
    return occ


def occluded_sweep(scene: SceneTensors, o: Vec3, d: Vec3, t_max, exclude_idx, origin_idx=None):
    """Any-hit shadow test: does any shape other than ``exclude_idx`` cross
    (o, d) at T_MIN < t < t_max? ``origin_idx`` is the shape the shadow ray
    starts on (its sphere quadratic takes ``c = 0``, its plane is skipped)."""
    a, inv_a = quad_a(scene, d)
    occ = torch.zeros(o.x.shape, dtype=torch.bool, device=o.x.device)
    occ = fold_occluded_block(
        o, d, a, inv_a, occ, scene.sphere_center, scene.sphere_radius, t_max, exclude_idx,
        range(scene.num_spheres), origin_idx=origin_idx,
    )
    return _plane_occluded(scene, o, d, t_max, exclude_idx, occ, origin_idx=origin_idx)


# The any-hit primitive beside the nearest-hit one, as flux_tpu's
# Intersector exposes it (``isect.occluded``); the port has the sweep only.
intersect.occluded = occluded_sweep
