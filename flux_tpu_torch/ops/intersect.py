"""Ray–scene intersection (``flux_tpu/ops/intersect.py``): the sweep over
every sphere and plane, the blocked scan over a Morton-sorted sphere table,
and the triangle folds.

The math is the reference's (shapes.rs:136-151,176-211): the sphere
quadratic with the near root preferred and the far root taken when the near
one is behind ``T_MIN``, normals scaled by the ``invert`` sign, and the
unbounded plane test. Triangles (an extension of the schema) take
Möller–Trumbore. Ties go to the lowest shape index: a strict ``<`` in index
order in the sweep, an explicit index compare in the folds that visit
shapes in Morton order; planes beat spheres, and triangles beat both, only
at strictly smaller t.

In the sweep the winner's material comes with the hit, with the material
kind packed into the low two mantissa bits of the Phong exponent as the JAX
package packs it, so glossy exponents round the same way there and here.

No finite-math assumption is allowed: a plane with ``d·n == 0`` or a
degenerate triangle gives ±inf or NaN, padding entries of the block tables
are NaN, and only IEEE comparisons reject them.

The scan (:func:`intersect_scan`, :func:`occluded_scan`) and the carried
folds (:func:`fold_sphere_block`, :func:`fold_tri_block` and their any-hit
forms) are the plain versions of what ``csrc/scene_megakernel.cu`` runs on
the card; :class:`ScanLayout` and :class:`TriLayout` are the tables that
kernel reads. :class:`Intersector` is the strategy object the renderer
builds once (modes ``sweep`` and ``scan``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import T_MIN
from ..scene import SceneTensors
from ..vec import Vec3
from ..vec import where as vwhere

__all__ = [
    "Hit",
    "Intersector",
    "ScanLayout",
    "scan_layout",
    "scan_layout_from_numpy",
    "TriLayout",
    "tri_layout",
    "tri_layout_from_numpy",
    "morton_order",
    "sphere_t",
    "quad_a",
    "intersect",
    "intersect_scan",
    "occluded_sweep",
    "occluded_scan",
    "triangle_t",
    "triangle_nearest",
    "triangle_occluded",
    "scan_carry_init",
    "fold_sphere_block",
    "finish_scan_carry",
    "fold_occluded_block",
    "tri_carry_init",
    "fold_tri_block",
    "fold_tri_occluded_block",
    "merge_tri_hit",
    "SCAN_BLOCK",
    "TRI_SCAN_BLOCK",
    "SCAN_FIELDS",
    "TRI_LAYOUT_FIELDS",
]

_T_MIN = float(np.float32(T_MIN))


class Hit(NamedTuple):
    """Wavefront hit record, fused with the winning shape's material row."""

    mask: torch.Tensor  # (B,) bool: anything hit
    t: torch.Tensor  # (B,) f32 distance (inf on miss)
    shape: torch.Tensor  # (B,) i32 winning shape index (spheres, planes, triangles)
    point: Vec3  # hit point
    normal: Vec3  # unit for spheres and triangles; planes as authored
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


# ---- triangles -------------------------------------------------------------


def triangle_t(o: Vec3, d: Vec3, v0, e1, e2):
    """Möller–Trumbore ray–triangle test of one triangle against the
    wavefront; ``v0``/``e1``/``e2`` are length-3 sequences of scalars.
    Returns ``(t, valid)``.

    No epsilon guard on the determinant: a degenerate one makes ``inv`` huge
    or ±inf, and every acceptance then fails arithmetically (inf fails
    ``u + v <= 1``; 0·inf = NaN fails every comparison). Triangles are
    double-sided, like the reference's planes; shading sees the authored
    (winding) normal either way."""
    px = d.y * e2[2] - d.z * e2[1]
    py = d.z * e2[0] - d.x * e2[2]
    pz = d.x * e2[1] - d.y * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    inv = 1.0 / det
    sx, sy, sz = o.x - v0[0], o.y - v0[1], o.z - v0[2]
    u = (sx * px + sy * py + sz * pz) * inv
    qx = sy * e1[2] - sz * e1[1]
    qy = sz * e1[0] - sx * e1[2]
    qz = sx * e1[1] - sy * e1[0]
    v = (d.x * qx + d.y * qy + d.z * qz) * inv
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv
    valid = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > _T_MIN)
    return t, valid


def _row3(a, k):
    return a[k, 0], a[k, 1], a[k, 2]


def triangle_nearest(scene: SceneTensors, o: Vec3, d: Vec3, prev_tri=None):
    """Nearest triangle of every lane: ``(t, k)``, with ``t = inf`` and
    ``k = 0`` on a miss; a strict ``<`` in index order, so the lowest index
    wins equal t (``flux_tpu`` unrolls so below 65 triangles and visits
    blocks with an index tie-break above: the same winners). ``prev_tri``
    (optional int32 lanes) is the triangle the lane's ray starts on,
    excluded outright: a flat triangle cannot be hit again from its own
    surface."""
    nt = scene.num_triangles
    best_t = torch.full_like(o.x, float("inf"))
    best_k = torch.zeros(o.x.shape, dtype=torch.int32, device=o.x.device)
    for k in range(nt):
        t, valid = triangle_t(o, d, _row3(scene.tri_v0, k), _row3(scene.tri_e1, k), _row3(scene.tri_e2, k))
        cond = valid & (t < best_t)
        if prev_tri is not None:
            cond = cond & (prev_tri != k)
        best_t = torch.where(cond, t, best_t)
        best_k = torch.where(cond, k, best_k)
    return best_t, best_k


def triangle_occluded(scene: SceneTensors, o: Vec3, d: Vec3, t_max, exclude_idx, occ, origin_idx=None):
    """Fold the triangles into an any-hit occlusion mask. ``exclude_idx``
    and ``origin_idx`` are full shape indices; triangles occupy
    ``[Ns + Np, Ns + Np + Nt)``. The shadow ray's own origin triangle is
    excluded outright."""
    base = scene.num_spheres + scene.num_planes
    for k in range(scene.num_triangles):
        t, valid = triangle_t(o, d, _row3(scene.tri_v0, k), _row3(scene.tri_e1, k), _row3(scene.tri_e2, k))
        blocks = valid & (t < t_max) & (exclude_idx != base + k)
        if origin_idx is not None:
            blocks = blocks & (origin_idx != base + k)
        occ = occ | blocks
    return occ


def _fold_triangles(scene: SceneTensors, o: Vec3, d: Vec3, t, shape_idx, kind, alb, exp, prev=None):
    """The triangle winner folded into an assembled (t, shape, kind, albedo,
    exponent) record; also ``(use_tri, tri_normal)`` so the caller can fold
    the normal after the hit point. Ties keep the incumbent: spheres and
    planes come first in shape order."""
    if scene.num_triangles == 0:
        return t, shape_idx, kind, alb, exp, None, None
    base = scene.num_spheres + scene.num_planes
    tr_t, tr_k = triangle_nearest(scene, o, d, prev_tri=None if prev is None else prev - base)
    use_tri = tr_t < t
    t = torch.minimum(t, tr_t)
    tr_k = tr_k.long()
    mrow = base + tr_k
    shape_idx = torch.where(use_tri, mrow.to(torch.int32), shape_idx)
    tn = scene.tri_n[tr_k]
    kind = torch.where(use_tri, scene.mat_kind[mrow], kind)
    exp = torch.where(use_tri, scene.mat_exp[mrow], exp)
    ta = (scene.mat_color * scene.mat_param[:, None])[mrow]
    alb = vwhere(use_tri, Vec3(ta[..., 0], ta[..., 1], ta[..., 2]), alb)
    return t, shape_idx, kind, alb, exp, use_tri, Vec3(tn[..., 0], tn[..., 1], tn[..., 2])


# ---- the sweep -------------------------------------------------------------


def _packed_kind_exponent(scene: SceneTensors) -> torch.Tensor:
    """Per-shape float32 exponent whose low two mantissa bits hold the
    material kind (``flux_tpu/ops/intersect.py:330-337``)."""
    bits = (scene.mat_exp.view(torch.int32) & -4) | scene.mat_kind.to(torch.int32)
    return bits.view(torch.float32)


def intersect(scene: SceneTensors, o: Vec3, d: Vec3, prev=None) -> Hit:
    """Nearest hit of the wavefront (o, d) against every shape.

    ``prev`` (optional int32 lanes) is the shape index each lane's ray
    originates on (-1 for camera rays): that sphere's quadratic takes
    ``c = 0`` and that plane or triangle is skipped."""
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

    best_t, best_idx, best_kind, best_alb, best_exp, use_tri, tri_n = _fold_triangles(
        scene, o, d, best_t, best_idx, best_kind, best_alb, best_exp, prev=prev
    )

    mask = torch.isfinite(best_t)
    t_safe = torch.where(mask, best_t, 0.0)
    point = Vec3(o.x + t_safe * d.x, o.y + t_safe * d.y, o.z + t_safe * d.z)
    # Sphere normal (point - c) * invert / r; plane lanes (inv_r == 0) take
    # the authored plane normal.
    n_sph = (point - best_ctr) * best_inv_r
    normal = vwhere(best_inv_r == 0.0, best_pn, n_sph)
    if use_tri is not None:
        normal = vwhere(use_tri, tri_n, normal)
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


def _plane_sweep(scene: SceneTensors, o: Vec3, d: Vec3, prev=None):
    """The nearest plane of every lane, ``(t, j, normal)``; ``prev``
    excludes the plane the ray starts on."""
    zeros = torch.zeros_like(o.x)
    ns = scene.num_spheres
    pl_t = torch.full_like(o.x, float("inf"))
    pl_j = torch.zeros(o.x.shape, dtype=torch.int32, device=o.x.device)
    pl_n = Vec3(zeros, zeros, zeros)
    for j in range(scene.num_planes):
        px, py, pz = (scene.plane_point[j, k] for k in range(3))
        nx, ny, nz = (scene.plane_normal[j, k] for k in range(3))
        num = (px - o.x) * nx + (py - o.y) * ny + (pz - o.z) * nz
        den = d.x * nx + d.y * ny + d.z * nz
        t = num / den
        cond = (t > _T_MIN) & (t < pl_t)
        if prev is not None:
            cond = cond & (prev != ns + j)
        pl_t = torch.where(cond, t, pl_t)
        pl_j = torch.where(cond, j, pl_j)
        pl_n = vwhere(cond, Vec3(nx, ny, nz), pl_n)
    return pl_t, pl_j, pl_n


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
    ``idx`` (a sequence of ints, or an int tensor of a Morton-sorted block)
    into an any-hit occlusion mask: one OR per sphere, no winner. The sphere
    the shadow ray originates on (``origin_idx``) takes its exact ``c = 0``,
    so a genuine self-occlusion through its interior still counts."""
    for k in range(len(idx)):
        i = idx[k]
        t, valid = sphere_t(
            o, d, a, inv_a, ctr[k, 0], ctr[k, 1], ctr[k, 2], rad[k],
            on_self=None if origin_idx is None else origin_idx == i,
        )
        occ = occ | (valid & (t < t_max) & (exclude_idx != i))
    return occ


def occluded_sweep(scene: SceneTensors, o: Vec3, d: Vec3, t_max, exclude_idx, origin_idx=None):
    """Any-hit shadow test: does any shape other than ``exclude_idx`` cross
    (o, d) at T_MIN < t < t_max? ``origin_idx`` is the shape the shadow ray
    starts on (its sphere quadratic takes ``c = 0``, its plane or triangle
    is skipped)."""
    a, inv_a = quad_a(scene, d)
    occ = torch.zeros(o.x.shape, dtype=torch.bool, device=o.x.device)
    occ = fold_occluded_block(
        o, d, a, inv_a, occ, scene.sphere_center, scene.sphere_radius, t_max, exclude_idx,
        range(scene.num_spheres), origin_idx=origin_idx,
    )
    occ = _plane_occluded(scene, o, d, t_max, exclude_idx, occ, origin_idx=origin_idx)
    return triangle_occluded(scene, o, d, t_max, exclude_idx, occ, origin_idx=origin_idx)


# ---- the Morton-sorted block tables ---------------------------------------

# Spheres per scan block and triangles per fold block: the units of the
# kernels' AABB skip (``flux_tpu`` has the same sizes, so the tables of the
# two packages are equal arrays).
SCAN_BLOCK = 32
TRI_SCAN_BLOCK = 16

# The array fields of the JAX package's ScanLayout and TriLayout, in the
# order scan_layout_from_numpy and tri_layout_from_numpy take them.
SCAN_FIELDS = ("ctr", "rad", "inv_r", "kind", "exp", "alb", "idx", "bmin", "bmax")
TRI_LAYOUT_FIELDS = ("v0", "e1", "e2", "n", "kind", "exp", "alb", "idx", "bmin", "bmax")
_INT_FIELDS = ("kind", "idx")


class ScanLayout(NamedTuple):
    """Spatially sorted, ``SCAN_BLOCK``-padded sphere table. Sorting along a
    Morton curve puts neighbours into one block, so the per-block boxes are
    tight and a ray skips most blocks. Pad entries have NaN centers (they
    never test valid) and original index -1; an all-pad block has a NaN box.
    ``host`` keeps the numpy arrays for the kernel's upload."""

    ctr: torch.Tensor  # (n_blocks, SCAN_BLOCK, 3) f32
    rad: torch.Tensor  # (n_blocks, SCAN_BLOCK) f32
    inv_r: torch.Tensor  # (n_blocks, SCAN_BLOCK) f32  invert / radius
    kind: torch.Tensor  # (n_blocks, SCAN_BLOCK) i32
    exp: torch.Tensor  # (n_blocks, SCAN_BLOCK) f32
    alb: torch.Tensor  # (n_blocks, SCAN_BLOCK, 3) f32  color × param
    idx: torch.Tensor  # (n_blocks, SCAN_BLOCK) i32 original sphere index
    bmin: torch.Tensor  # (n_blocks, 3) f32 per-block box
    bmax: torch.Tensor  # (n_blocks, 3) f32
    host: dict = None

    @property
    def n_blocks(self) -> int:
        return self.ctr.shape[0]


class TriLayout(NamedTuple):
    """Spatially sorted (by centroid), ``TRI_SCAN_BLOCK``-padded triangle
    table, the sibling of :class:`ScanLayout`. Pad entries have NaN ``v0``
    (Möller–Trumbore then rejects them) and index -1."""

    v0: torch.Tensor  # (n_blocks, TRI_SCAN_BLOCK, 3) f32
    e1: torch.Tensor  # (n_blocks, TRI_SCAN_BLOCK, 3) f32
    e2: torch.Tensor  # (n_blocks, TRI_SCAN_BLOCK, 3) f32
    n: torch.Tensor  # (n_blocks, TRI_SCAN_BLOCK, 3) f32 unit geometric normal
    kind: torch.Tensor  # (n_blocks, TRI_SCAN_BLOCK) i32
    exp: torch.Tensor  # (n_blocks, TRI_SCAN_BLOCK) f32
    alb: torch.Tensor  # (n_blocks, TRI_SCAN_BLOCK, 3) f32  color × param
    idx: torch.Tensor  # (n_blocks, TRI_SCAN_BLOCK) i32 original triangle index
    bmin: torch.Tensor  # (n_blocks, 3) f32 per-block box
    bmax: torch.Tensor  # (n_blocks, 3) f32
    host: dict = None

    @property
    def n_blocks(self) -> int:
        return self.v0.shape[0]


def _layout_from_numpy(cls, fields, arrays: dict, device):
    host = {
        k: np.ascontiguousarray(np.asarray(arrays[k], np.int32 if k in _INT_FIELDS else np.float32))
        for k in fields
    }
    tensors = {k: torch.from_numpy(v.copy()).to(device) for k, v in host.items()}
    return cls(host=host, **tensors)


def scan_layout_from_numpy(arrays: dict, device) -> ScanLayout:
    """A ScanLayout from the JAX package's ``ScanLayout`` fields as numpy
    arrays (``SCAN_FIELDS``)."""
    return _layout_from_numpy(ScanLayout, SCAN_FIELDS, arrays, device)


def tri_layout_from_numpy(arrays: dict, device) -> TriLayout:
    """A TriLayout from the JAX package's ``TriLayout`` fields as numpy
    arrays (``TRI_LAYOUT_FIELDS``)."""
    return _layout_from_numpy(TriLayout, TRI_LAYOUT_FIELDS, arrays, device)


def morton_order(centers: np.ndarray) -> np.ndarray:
    """(N, 3) float32 → (N,) int32 permutation that sorts the points along
    a Morton curve (10 bits an axis). Runs on the host in float32 with IEEE
    division and a stable sort, so it gives the permutation of
    ``flux_tpu.ops.intersect.morton_order`` for the same points."""
    centers = np.asarray(centers, np.float32).reshape(-1, 3)
    if centers.shape[0] == 0:
        return np.zeros((0,), np.int32)
    lo = centers.min(axis=0)
    hi = centers.max(axis=0)
    q = np.clip(
        (centers - lo) / np.maximum(hi - lo, np.float32(1e-12)) * np.float32(1023.0),
        np.float32(0.0), np.float32(1023.0),
    ).astype(np.uint32)

    def spread(x):  # space the bits 3 apart
        x = (x | (x << np.uint32(16))) & np.uint32(0x030000FF)
        x = (x | (x << np.uint32(8))) & np.uint32(0x0300F00F)
        x = (x | (x << np.uint32(4))) & np.uint32(0x030C30C3)
        x = (x | (x << np.uint32(2))) & np.uint32(0x09249249)
        return x

    code = (spread(q[:, 0]) << np.uint32(2)) | (spread(q[:, 1]) << np.uint32(1)) | spread(q[:, 2])
    return np.argsort(code, kind="stable").astype(np.int32)


def _pad_blocks(a: np.ndarray, fill, n_blocks: int, block: int) -> np.ndarray:
    padn = n_blocks * block - a.shape[0]
    tail = a.shape[1:]
    return np.concatenate([a, np.full((padn,) + tail, fill, a.dtype)]).reshape((n_blocks, block) + tail)


def _block_boxes(lo_pts: np.ndarray, hi_pts: np.ndarray, real: np.ndarray):
    """Per-block boxes over the real entries of (n_blocks, K, 3) lower and
    upper points; NaN for a block with none (a ±inf box would pass the slab
    test, a NaN box fails every comparison)."""
    with np.errstate(invalid="ignore"):
        bmin = np.where(real, lo_pts, np.float32(np.inf)).min(axis=1).astype(np.float32)
        bmax = np.where(real, hi_pts, np.float32(-np.inf)).max(axis=1).astype(np.float32)
    empty = ~real.any(axis=1)
    return np.where(empty, np.float32(np.nan), bmin), np.where(empty, np.float32(np.nan), bmax)


def scan_layout(scene: SceneTensors) -> ScanLayout:
    """The sorted, padded sphere block table of a scene, built on the host
    from its float32 arrays (once per renderer). Equal, array for array, to
    ``flux_tpu.ops.intersect.scan_layout`` up to that function's floor of
    three blocks (an all-pad block changes no result)."""
    h = scene.host
    ns = scene.num_spheres
    order = morton_order(h["sphere_center"])
    n_blocks = max(1, -(-ns // SCAN_BLOCK))
    alb_tab = (h["mat_color"] * h["mat_param"][:, None])[:ns]

    def blocks(a, fill):
        return _pad_blocks(a[order], fill, n_blocks, SCAN_BLOCK)

    ctr = blocks(h["sphere_center"], np.float32(np.nan))
    rad = blocks(h["sphere_radius"], np.float32(1.0))
    idx = _pad_blocks(order, np.int32(-1), n_blocks, SCAN_BLOCK)
    real = (idx >= 0)[..., None]
    r3 = rad[..., None]
    bmin, bmax = _block_boxes(ctr - r3, ctr + r3, real)
    return scan_layout_from_numpy(
        {
            "ctr": ctr,
            "rad": rad,
            "inv_r": blocks(h["sphere_invert"] / h["sphere_radius"], np.float32(1.0)),
            "kind": blocks(h["mat_kind"][:ns], np.int32(0)),
            "exp": blocks(h["mat_exp"][:ns], np.float32(0.0)),
            "alb": blocks(alb_tab, np.float32(0.0)),
            "idx": idx,
            "bmin": bmin,
            "bmax": bmax,
        },
        scene.device,
    )


def tri_layout(scene: SceneTensors) -> TriLayout:
    """The sorted, padded triangle block table of a scene, with the material
    rows gathered from the flat table as :func:`_fold_triangles` gathers
    them. Equal, array for array, to ``flux_tpu.ops.intersect.tri_layout``."""
    h = scene.host
    nt = scene.num_triangles
    base = scene.num_spheres + scene.num_planes
    centroid = h["tri_v0"] + (h["tri_e1"] + h["tri_e2"]) * np.float32(1.0 / 3.0)
    order = morton_order(centroid)
    n_blocks = max(1, -(-nt // TRI_SCAN_BLOCK))
    alb_tab = (h["mat_color"] * h["mat_param"][:, None])[base:]

    def blocks(a, fill):
        return _pad_blocks(a[order], fill, n_blocks, TRI_SCAN_BLOCK)

    v0 = blocks(h["tri_v0"], np.float32(np.nan))
    e1 = blocks(h["tri_e1"], np.float32(0.0))
    e2 = blocks(h["tri_e2"], np.float32(0.0))
    idx = _pad_blocks(order, np.int32(-1), n_blocks, TRI_SCAN_BLOCK)
    real = (idx >= 0)[..., None]
    verts = np.stack([v0, v0 + e1, v0 + e2], axis=2)  # (nb, TB, 3 vertices, 3)
    bmin, bmax = _block_boxes(verts.min(axis=2), verts.max(axis=2), real)
    return tri_layout_from_numpy(
        {
            "v0": v0,
            "e1": e1,
            "e2": e2,
            "n": blocks(h["tri_n"], np.float32(0.0)),
            "kind": blocks(h["mat_kind"][base:], np.int32(0)),
            "exp": blocks(h["mat_exp"][base:], np.float32(0.0)),
            "alb": blocks(alb_tab, np.float32(0.0)),
            "idx": idx,
            "bmin": bmin,
            "bmax": bmax,
        },
        scene.device,
    )


# ---- the carried folds (the kernels' plain form) ---------------------------


def scan_carry_init(like: torch.Tensor):
    """The initial (best_t, index, kind, exp, albedo, center, inv_r) sphere
    winner carry, shaped like ``like``."""
    zf = torch.zeros_like(like)
    zi = torch.zeros(like.shape, dtype=torch.int32, device=like.device)
    return (torch.full_like(like, float("inf")), zi, zi, zf, Vec3(zf, zf, zf), Vec3(zf, zf, zf), zf)


def fold_sphere_block(o, d, a, inv_a, carry, ctr, rad, inv_r_b, kind, exp, alb, idx, prev=None):
    """Fold one ``SCAN_BLOCK`` of spheres into the winner carry. ``ctr`` and
    ``alb`` are (SCAN_BLOCK, 3), the rest (SCAN_BLOCK,); ``idx`` is each
    entry's original sphere index. Equal-t ties keep the lowest original
    index, whatever the visit order. ``prev`` is the sphere the ray starts
    on (its exact ``c = 0``)."""
    best_t, best_i, b_kind, b_exp, b_alb, b_ctr, b_inv_r = carry
    for k in range(ctr.shape[0]):
        cx, cy, cz = ctr[k, 0], ctr[k, 1], ctr[k, 2]
        t, valid = sphere_t(
            o, d, a, inv_a, cx, cy, cz, rad[k],
            on_self=None if prev is None else prev == idx[k],
        )
        cond = valid & ((t < best_t) | ((t == best_t) & (idx[k] < best_i)))
        best_t = torch.where(cond, t, best_t)
        best_i = torch.where(cond, idx[k], best_i)
        b_kind = torch.where(cond, kind[k], b_kind)
        b_exp = torch.where(cond, exp[k], b_exp)
        b_alb = vwhere(cond, Vec3(alb[k, 0], alb[k, 1], alb[k, 2]), b_alb)
        b_ctr = vwhere(cond, Vec3(cx, cy, cz), b_ctr)
        b_inv_r = torch.where(cond, inv_r_b[k], b_inv_r)
    return (best_t, best_i, b_kind, b_exp, b_alb, b_ctr, b_inv_r)


def finish_scan_carry(scene: SceneTensors, o: Vec3, d: Vec3, carry, prev=None) -> Hit:
    """Fold the planes (strictly nearer only) and the triangles into a
    sphere winner carry and build the Hit."""
    ns = scene.num_spheres
    best_t, best_i, b_kind, b_exp, b_alb, b_ctr, b_inv_r = carry
    alb_tab = scene.mat_color * scene.mat_param[:, None]

    pl_t, pl_j, pl_n = _plane_sweep(scene, o, d, prev=prev)
    use_plane = pl_t < best_t
    t = torch.minimum(best_t, pl_t)
    shape_idx = torch.where(use_plane, ns + pl_j, best_i)
    for j in range(scene.num_planes):
        sel = use_plane & (pl_j == j)
        i = ns + j
        b_kind = torch.where(sel, scene.mat_kind[i], b_kind)
        b_exp = torch.where(sel, scene.mat_exp[i], b_exp)
        b_alb = vwhere(sel, Vec3(alb_tab[i, 0], alb_tab[i, 1], alb_tab[i, 2]), b_alb)
        b_inv_r = torch.where(sel, 0.0, b_inv_r)

    t, shape_idx, b_kind, b_alb, b_exp, use_tri, tri_n = _fold_triangles(
        scene, o, d, t, shape_idx, b_kind, b_alb, b_exp, prev=prev
    )

    mask = torch.isfinite(t)
    t_safe = torch.where(mask, t, 0.0)
    point = Vec3(o.x + t_safe * d.x, o.y + t_safe * d.y, o.z + t_safe * d.z)
    n_sph = (point - b_ctr) * b_inv_r
    normal = vwhere(use_plane, pl_n, n_sph)
    if use_tri is not None:
        normal = vwhere(use_tri, tri_n, normal)
    return Hit(mask=mask, t=t, shape=shape_idx, point=point, normal=normal, kind=b_kind, albedo=b_alb,
               exponent=b_exp)


def intersect_scan(scene: SceneTensors, o: Vec3, d: Vec3, layout: Optional[ScanLayout] = None, prev=None) -> Hit:
    """Nearest hit by a loop over the sphere blocks of ``layout``, then the
    planes and triangles: the scaling form of :func:`intersect`, and the
    plain version of the kernel's scan. It gives the sweep's hit bit for bit
    (the same quadratic, the same ``invert / radius`` and ``color × param``
    float32 values, ties to the lowest original index)."""
    a, inv_a = quad_a(scene, d)
    L = layout if layout is not None else scan_layout(scene)
    carry = scan_carry_init(o.x)
    for b in range(L.n_blocks):
        carry = fold_sphere_block(
            o, d, a, inv_a, carry, L.ctr[b], L.rad[b], L.inv_r[b], L.kind[b], L.exp[b], L.alb[b],
            L.idx[b], prev=prev,
        )
    return finish_scan_carry(scene, o, d, carry, prev=prev)


def occluded_scan(scene: SceneTensors, o: Vec3, d: Vec3, t_max, exclude_idx,
                  layout: Optional[ScanLayout] = None, origin_idx=None):
    """Any-hit shadow test by a loop over the sphere blocks: the scaling
    form of :func:`occluded_sweep`."""
    a, inv_a = quad_a(scene, d)
    L = layout if layout is not None else scan_layout(scene)
    occ = torch.zeros(o.x.shape, dtype=torch.bool, device=o.x.device)
    for b in range(L.n_blocks):
        occ = fold_occluded_block(
            o, d, a, inv_a, occ, L.ctr[b], L.rad[b], t_max, exclude_idx, L.idx[b], origin_idx=origin_idx
        )
    occ = _plane_occluded(scene, o, d, t_max, exclude_idx, occ, origin_idx=origin_idx)
    return triangle_occluded(scene, o, d, t_max, exclude_idx, occ, origin_idx=origin_idx)


def tri_carry_init(like: torch.Tensor):
    """The initial (t, index, kind, exp, albedo, normal) triangle winner
    carry, shaped like ``like``."""
    zf = torch.zeros_like(like)
    zi = torch.zeros(like.shape, dtype=torch.int32, device=like.device)
    return (torch.full_like(like, float("inf")), zi, zi, zf, Vec3(zf, zf, zf), Vec3(zf, zf, zf))


def fold_tri_block(o, d, carry, v0, e1, e2, n3, kind, exp, alb, idx, prev_tri=None):
    """Fold one ``TRI_SCAN_BLOCK`` of triangles into the winner carry.
    ``idx`` is each entry's original triangle index; equal-t ties keep the
    lowest, so winners do not depend on the visit order. ``prev_tri``
    (triangle-relative index) excludes the triangle the ray starts on."""
    bt, bi, b_kind, b_exp, b_alb, b_n = carry
    for k in range(v0.shape[0]):
        t, valid = triangle_t(o, d, _row3(v0, k), _row3(e1, k), _row3(e2, k))
        cond = valid & ((t < bt) | ((t == bt) & (idx[k] < bi)))
        if prev_tri is not None:
            cond = cond & (prev_tri != idx[k])
        bt = torch.where(cond, t, bt)
        bi = torch.where(cond, idx[k], bi)
        b_kind = torch.where(cond, kind[k], b_kind)
        b_exp = torch.where(cond, exp[k], b_exp)
        b_alb = vwhere(cond, Vec3(alb[k, 0], alb[k, 1], alb[k, 2]), b_alb)
        b_n = vwhere(cond, Vec3(n3[k, 0], n3[k, 1], n3[k, 2]), b_n)
    return (bt, bi, b_kind, b_exp, b_alb, b_n)


def fold_tri_occluded_block(o, d, occ, v0, e1, e2, t_max, exclude_idx, idx, base, origin_idx=None):
    """Fold one ``TRI_SCAN_BLOCK`` of triangles into an any-hit occlusion
    mask. ``base`` is the triangles' shape-index base (Ns + Np);
    ``origin_idx`` excludes the shadow ray's own origin triangle."""
    for k in range(v0.shape[0]):
        t, valid = triangle_t(o, d, _row3(v0, k), _row3(e1, k), _row3(e2, k))
        blocks = valid & (t < t_max) & (exclude_idx != base + idx[k])
        if origin_idx is not None:
            blocks = blocks & (origin_idx != base + idx[k])
        occ = occ | blocks
    return occ


def merge_tri_hit(hit: Hit, o: Vec3, d: Vec3, tri_winner, base: int) -> Hit:
    """Merge a triangle winner carry into a sphere/plane Hit: the triangle
    wins only at strictly smaller t. The hit point is recomputed from the
    combined t with the same arithmetic, so other lanes keep their bits."""
    tr_t, tr_i, tr_kind, tr_exp, tr_alb, tr_n = tri_winner
    use_tri = tr_t < hit.t
    t = torch.minimum(hit.t, tr_t)
    shape = torch.where(use_tri, base + tr_i, hit.shape)
    kind = torch.where(use_tri, tr_kind, hit.kind)
    exp = torch.where(use_tri, tr_exp, hit.exponent)
    alb = vwhere(use_tri, tr_alb, hit.albedo)
    mask = torch.isfinite(t)
    t_safe = torch.where(mask, t, 0.0)
    point = Vec3(o.x + t_safe * d.x, o.y + t_safe * d.y, o.z + t_safe * d.z)
    normal = vwhere(use_tri, tr_n, hit.normal)
    return Hit(mask=mask, t=t, shape=shape, point=point, normal=normal, kind=kind, albedo=alb, exponent=exp)


@dataclass(frozen=True)
class Intersector:
    """The chosen intersection strategy, built once by the renderer and
    called as ``isect(scene, o, d, prev=...)``: the sweep, or the scan over
    a prebuilt :class:`ScanLayout`. ``tri_layout`` rides along for the
    kernel (the plain folds read the scene's triangle arrays)."""

    layout: Optional[ScanLayout] = None
    mode: str = "sweep"  # 'sweep' | 'scan'
    tri_layout: Optional[TriLayout] = None

    def __post_init__(self):
        if self.mode not in ("sweep", "scan"):
            raise ValueError(f"unknown intersection mode {self.mode!r}")

    def __call__(self, scene: SceneTensors, o: Vec3, d: Vec3, prev=None) -> Hit:
        if self.mode == "scan":
            return intersect_scan(scene, o, d, layout=self.layout, prev=prev)
        return intersect(scene, o, d, prev=prev)

    def occluded(self, scene: SceneTensors, o: Vec3, d: Vec3, t_max, exclude_idx, origin_idx=None):
        """Any-hit shadow test (see :func:`occluded_sweep`); callers pass
        the light's own ray-t as ``t_max``."""
        if self.mode == "scan":
            return occluded_scan(scene, o, d, t_max, exclude_idx, layout=self.layout, origin_idx=origin_idx)
        return occluded_sweep(scene, o, d, t_max, exclude_idx, origin_idx=origin_idx)
