"""Next-event estimation over sphere and triangle lights
(``flux_tpu/ops/nee.py``).

At a diffuse vertex (and, under physical transport, a glossy one) one light
is picked with probability ∝ luminance × area/(4π) (power-proportional
selection; r² for a sphere), and a shadow ray decides whether its emission
arrives. A sphere light is sampled by a direction drawn uniformly inside
the cone it subtends, a triangle light by a point drawn uniformly on its
area, with the exact conversion to solid angle pick·r²/(A·cosθ_l); a
triangle seen from behind weighs zero. For sphere lights the azimuth is
drawn only
from the arc of each cone ring that lies above the surface horizon
(partial-cone clipping), with the arc's fraction in the weight; the MIS
reverse density (:func:`nee_pdf_toward` with ``normal``) rebuilds the same
frame and arc from the previous vertex's normal, so the balance weights of
the two strategies sum to one.

Every function here is the JAX package's float32 arithmetic in the same
order, and the CUDA megakernels (``csrc/flux_trace.cuh``) repeat it.
The arc half-angle comes from the Abramowitz–Stegun polynomial of
:func:`_acos_conservative`, never from ``acos``: the arc must over-cover the
visible one, and the float64 oracle (``flux_tpu/oracle.py``) uses the same
polynomial.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from .scene import MaterialKind, PlaneData, SceneData, SphereData, TriangleData
from .vec import Vec3, dot, frame_about
from .vec import where as vwhere
from .brdf import _EM

__all__ = [
    "LightTensors",
    "LightSample",
    "extract_lights",
    "lights_from_numpy",
    "sample_light_dirs",
    "light_emission",
    "nee_pdf_toward",
    "LIGHT_FIELDS",
    "TRI_LIGHT_FIELDS",
]

_TWO_PI = float(np.float32(2.0 * np.pi))
_PI = float(np.float32(np.pi))
_INV_PI = float(np.float32(1.0 / np.pi))
# Abramowitz–Stegun 4.4.45 (|err| <= 6.8e-5 rad), as float32.
_AS = tuple(float(np.float32(c)) for c in (1.5707288, -0.2121144, 0.0742610, -0.0187293))
_ACOS_PAD = float(np.float32(1e-4))

# The fields of the JAX package's LightArrays, in the order
# lights_from_numpy takes them: those every light set fills, and those a set
# with a triangle light adds (None for a sphere-only set).
LIGHT_FIELDS = ("center", "radius", "emit", "shape_idx", "pick", "cdf")
TRI_LIGHT_FIELDS = ("is_tri", "tri_v0", "tri_e1", "tri_e2", "tri_n", "tri_area")


def _acos_conservative(x: torch.Tensor) -> torch.Tensor:
    """arccos(x) plus a hair, in [0, π], never below the true value: the
    A&S polynomial for arccos(|x|), reflected for x < 0, plus 1e-4."""
    ax = torch.abs(x)
    poly = _AS[0] + ax * (_AS[1] + ax * (_AS[2] + ax * _AS[3]))
    a = torch.sqrt(torch.clamp_min(1.0 - ax, 0.0)) * poly
    a = torch.where(x < 0.0, _PI - a, a)
    return torch.clamp(a + _ACOS_PAD, 0.0, _PI)


def _cone_frame(w: Vec3):
    """The cone frame about ``w``, seeded by the matte epsilon vector of the
    BRDF warps (``ops/brdf._EM``): the sampler and the reverse density must
    build the same frame."""
    return frame_about(w, Vec3(*(torch.full_like(w.x, c) for c in _EM)))


def _ring_decompose(normal: Vec3, u: Vec3, v: Vec3, w: Vec3):
    """(n_u, n_v, n_w, ρ): the surface normal in the cone frame, and the
    magnitude of its in-plane part."""
    n_u = normal.x * u.x + normal.y * u.y + normal.z * u.z
    n_v = normal.x * v.x + normal.y * v.y + normal.z * v.z
    n_w = normal.x * w.x + normal.y * w.y + normal.z * w.z
    rho = torch.sqrt(n_u * n_u + n_v * n_v)
    return n_u, n_v, n_w, rho


def _clip_arc_halfangle(rho, n_w, cos_a, sin_a):
    """Half-angle of the above-horizon azimuth arc on the cone ring at polar
    angle (cos_a, sin_a); one definition for the sampler and the reverse
    density."""
    c = -(cos_a * n_w) / torch.clamp_min(sin_a * rho, 1e-12)
    return _acos_conservative(torch.clamp(c, -1.0, 1.0))


@dataclass(frozen=True, eq=False)
class LightTensors:
    """The area lights of a scene, the twin of
    ``flux_tpu.ops.nee.LightArrays``: its non-inverted emissive spheres and
    its emissive triangles, under one pick/cdf so that a vertex draws one
    light per sample. ``pick[k]`` is the probability of picking light k,
    ``cdf[k]`` the exclusive prefix sum of ``pick``. The triangle fields are
    None for a sphere-only set; on a sphere row they are zero, and a
    triangle row has its centroid as ``center`` and radius 0. ``kinds`` says
    'sphere' or 'tri' per light (empty: all spheres). ``host`` keeps the
    float32/int32 numpy arrays, so the kernels' uploads read no device
    memory back."""

    center: torch.Tensor  # (L, 3) f32
    radius: torch.Tensor  # (L,) f32
    emit: torch.Tensor  # (L, 3) f32 color × power
    shape_idx: torch.Tensor  # (L,) i32 shape index (spheres, planes, triangles)
    pick: torch.Tensor  # (L,) f32
    cdf: torch.Tensor  # (L,) f32
    is_tri: torch.Tensor = None  # (L,) f32 0/1
    tri_v0: torch.Tensor = None  # (L, 3) f32
    tri_e1: torch.Tensor = None  # (L, 3) f32 v1 - v0
    tri_e2: torch.Tensor = None  # (L, 3) f32 v2 - v0
    tri_n: torch.Tensor = None  # (L, 3) f32 unit authored normal
    tri_area: torch.Tensor = None  # (L,) f32
    kinds: tuple = ()
    host: dict = field(default=None, repr=False)

    @property
    def num_lights(self) -> int:
        return self.center.shape[0]

    @property
    def has_tris(self) -> bool:
        return self.tri_v0 is not None


def lights_from_numpy(arrays: dict, device) -> LightTensors:
    """LightTensors from the JAX package's ``LightArrays`` fields as numpy
    arrays (``LIGHT_FIELDS``, and ``TRI_LIGHT_FIELDS`` where the set has a
    triangle light), so both packages sample the same float32 light set."""
    fields = LIGHT_FIELDS
    if arrays.get("tri_v0") is not None:
        fields = LIGHT_FIELDS + TRI_LIGHT_FIELDS
    host = {
        k: np.ascontiguousarray(np.asarray(arrays[k], np.int32 if k == "shape_idx" else np.float32))
        for k in fields
    }
    n = host["center"].reshape(-1, 3).shape[0]
    vec = ("center", "emit", "tri_v0", "tri_e1", "tri_e2", "tri_n")
    host = {k: v.reshape((n, 3) if k in vec else (n,)) for k, v in host.items()}
    tensors = {k: torch.from_numpy(v.copy()).to(device) for k, v in host.items()}
    kinds = ()
    if "is_tri" in host:
        kinds = tuple("tri" if f > 0.5 else "sphere" for f in host["is_tri"].tolist())
    return LightTensors(host=host, kinds=kinds, **tensors)


def extract_lights(sd: SceneData, device) -> Optional[LightTensors]:
    """The NEE light set of a scene: its non-inverted emissive spheres and
    its emissive triangles, or None when it has neither. Shape indices keep
    the numbering of the intersection paths (spheres, planes, triangles)."""
    tri_base = sum(isinstance(s, (SphereData, PlaneData)) for s in sd.shapes)
    # Per light: (kind, center, radius, emit, shape_idx, v0, e1, e2, unit
    # normal, area, selection area), zero geometry of the kind it is not.
    recs = []
    sphere_i = tri_i = 0
    z3 = (0.0, 0.0, 0.0)
    for s in sd.shapes:
        if isinstance(s, SphereData):
            m = s.material
            if m.kind == MaterialKind.EMISSIVE and not s.invert:
                emit = tuple(c * m.param for c in m.color)
                recs.append(("sphere", s.center, s.radius, emit, sphere_i, z3, z3, z3, z3, 0.0,
                             float(s.radius) ** 2))
            sphere_i += 1
        elif isinstance(s, TriangleData):
            m = s.material
            if m.kind == MaterialKind.EMISSIVE:
                emit = tuple(c * m.param for c in m.color)
                v0 = np.asarray(s.v0, np.float64)
                e1 = np.asarray(s.v1, np.float64) - v0
                e2 = np.asarray(s.v2, np.float64) - v0
                cr = np.cross(e1, e2)
                area = 0.5 * float(np.linalg.norm(cr))
                nrm = cr / max(np.linalg.norm(cr), 1e-30)
                ctr = v0 + (e1 + e2) / 3.0
                recs.append(("tri", tuple(ctr), 0.0, emit, tri_base + tri_i, tuple(v0), tuple(e1), tuple(e2),
                             tuple(nrm), area, area / (4.0 * np.pi)))
            tri_i += 1
    if not recs:
        return None
    n = len(recs)
    emits = np.asarray([r[3] for r in recs], np.float32).reshape(n, 3)
    # Selection weights ∝ luminance(color × power) × area/(4π) (r² for a
    # sphere); all-zero weights (black "lights") fall back to uniform
    # (flux_tpu/ops/nee.py:247-254).
    lum = 0.2126 * emits[:, 0] + 0.7152 * emits[:, 1] + 0.0722 * emits[:, 2]
    w = lum * np.asarray([r[10] for r in recs], np.float32)
    total = float(w.sum())
    pick = w / total if total > 0 else np.full(n, 1.0 / n, np.float32)
    cdf = np.concatenate([[0.0], np.cumsum(pick)[:-1]]).astype(np.float32)
    arrays = {
        "center": [r[1] for r in recs],
        "radius": [r[2] for r in recs],
        "emit": emits,
        "shape_idx": [r[4] for r in recs],
        "pick": pick,
        "cdf": cdf,
    }
    if any(r[0] == "tri" for r in recs):
        arrays.update(
            is_tri=[1.0 if r[0] == "tri" else 0.0 for r in recs],
            tri_v0=[r[5] for r in recs],
            tri_e1=[r[6] for r in recs],
            tri_e2=[r[7] for r in recs],
            tri_n=[r[8] for r in recs],
            tri_area=[r[9] for r in recs],
        )
    return lights_from_numpy(arrays, device)


class LightSample(NamedTuple):
    """One light sample per lane (the return of :func:`sample_light_dirs`)."""

    d: Vec3  # unit direction toward the sampled light point
    weight: Vec3  # L_e / (pick · pdf); 0 when unsampleable
    sidx: torch.Tensor  # i32 shape index of the picked light
    pdf: torch.Tensor  # f32 solid-angle density of this strategy
    center: Vec3  # the picked light's center (for its exact ray-t)
    radius: torch.Tensor  # the picked light's radius (0 on triangle rows)
    tri_t: Optional[torch.Tensor] = None  # ray-t of the sampled triangle point
    tri_mask: Optional[torch.Tensor] = None  # bool: the lane picked a triangle light


def sample_light_dirs(lights: LightTensors, p: Vec3, ux, uy, upick, normal: Optional[Vec3] = None) -> LightSample:
    """Pick a light by ``upick`` against ``lights.cdf`` (the last k with
    ``upick >= cdf[k]`` wins) and draw a direction from ``p``: uniformly in
    a sphere light's cone, or toward a uniform point of a triangle light
    (the barycentric fold of the same ``(ux, uy)``). With ``normal`` the
    cone's azimuth is drawn from the above-horizon arc of the cone ring
    only, and the weight scales by the arc's fraction."""
    li = torch.zeros(upick.shape, dtype=torch.int64, device=upick.device)
    for k in range(1, lights.num_lights):
        li = torch.where(upick >= lights.cdf[k], k, li)
    cx, cy, cz = (lights.center[:, c][li] for c in range(3))
    rad = lights.radius[li]
    emit = tuple(lights.emit[:, c][li] for c in range(3))
    pk = lights.pick[li]
    sidx = lights.shape_idx[li]

    dc = Vec3(cx - p.x, cy - p.y, cz - p.z)
    dist2 = dot(dc, dc)
    dist = torch.sqrt(dist2)
    inside = dist2 <= rad * rad
    sin2_max = torch.clamp(rad * rad / torch.clamp_min(dist2, 1e-12), 0.0, 1.0)
    cos_max = torch.sqrt(torch.clamp_min(1.0 - sin2_max, 0.0))

    w = dc * (1.0 / torch.clamp_min(dist, 1e-12))
    cos_a = 1.0 - ux * (1.0 - cos_max)
    sin_a = torch.sqrt(torch.clamp_min(1.0 - cos_a * cos_a, 0.0))
    u, v = _cone_frame(w)

    arc_frac = None
    if normal is None:
        phi = _TWO_PI * uy
        cp, sp = torch.cos(phi), torch.sin(phi)
    else:
        n_u, n_v, n_w, rho = _ring_decompose(normal, u, v, w)
        phi_lim = _clip_arc_halfangle(rho, n_w, cos_a, sin_a)
        arc_frac = phi_lim * _INV_PI
        safe = rho > float(np.float32(1e-6))
        inv_rho = 1.0 / torch.clamp_min(rho, 1e-12)
        c0 = torch.where(safe, n_u * inv_rho, 1.0)
        s0 = torch.where(safe, n_v * inv_rho, 0.0)
        delta = (2.0 * uy - 1.0) * phi_lim
        cd, sd = torch.cos(delta), torch.sin(delta)
        cp = c0 * cd - s0 * sd
        sp = s0 * cd + c0 * sd

    d = Vec3(
        sin_a * (cp * u.x + sp * v.x) + cos_a * w.x,
        sin_a * (cp * u.y + sp * v.y) + cos_a * w.y,
        sin_a * (cp * u.z + sp * v.z) + cos_a * w.z,
    )
    # weight = L_e / (pick · pdf_cone), pdf_cone = 1 / (2π (1 − cos_max)).
    wgt = _TWO_PI * (1.0 - cos_max) / torch.clamp_min(pk, 1e-12)
    wgt = torch.where(inside, 0.0, wgt)
    if arc_frac is not None:
        wgt = wgt * arc_frac

    tri_t = tri_mask = None
    if lights.has_tris:
        tv, t1, t2, tn = (
            tuple(a[:, c][li] for c in range(3))
            for a in (lights.tri_v0, lights.tri_e1, lights.tri_e2, lights.tri_n)
        )
        tarea = lights.tri_area[li]
        flip = ux + uy > 1.0
        uu = torch.where(flip, 1.0 - ux, ux)
        vv = torch.where(flip, 1.0 - uy, uy)
        qx = tv[0] + uu * t1[0] + vv * t2[0]
        qy = tv[1] + uu * t1[1] + vv * t2[1]
        qz = tv[2] + uu * t1[2] + vv * t2[2]
        dvx, dvy, dvz = qx - p.x, qy - p.y, qz - p.z
        r2 = torch.clamp_min(dvx * dvx + dvy * dvy + dvz * dvz, 1e-12)
        r = torch.sqrt(r2)
        inv_r = 1.0 / r
        td = Vec3(dvx * inv_r, dvy * inv_r, dvz * inv_r)
        # cos θ_l: the authored normal against the incoming shadow ray, the
        # facing test of an emissive hit.
        cos_l = -(tn[0] * td.x + tn[1] * td.y + tn[2] * td.z)
        wgt_tri = tarea * torch.clamp_min(cos_l, 0.0) / (torch.clamp_min(pk, 1e-12) * r2)
        tri_mask = lights.is_tri[li] > 0.5
        d = vwhere(tri_mask, td, d)
        wgt = torch.where(tri_mask, wgt_tri, wgt)
        tri_t = r

    weight = Vec3(emit[0] * wgt, emit[1] * wgt, emit[2] * wgt)
    pdf = 1.0 / torch.clamp_min(wgt, 1e-20)
    if lights.has_tris:
        # The forward density in the clamped form nee_pdf_toward uses, so
        # the MIS weights see matching forward and reverse densities.
        pdf_tri = torch.where(cos_l > 0.0, pk * r2 / torch.clamp_min(tarea * cos_l, 1e-12), 0.0)
        pdf = torch.where(tri_mask, pdf_tri, pdf)
    return LightSample(d=d, weight=weight, sidx=sidx, pdf=pdf, center=Vec3(cx, cy, cz), radius=rad,
                       tri_t=tri_t, tri_mask=tri_mask)


def light_emission(lights: LightTensors, shape_idx: torch.Tensor) -> torch.Tensor:
    """True where ``shape_idx`` is one of the NEE lights."""
    m = torch.zeros(shape_idx.shape, dtype=torch.bool, device=shape_idx.device)
    for k in range(lights.num_lights):
        m |= shape_idx == lights.shape_idx[k]
    return m


def nee_pdf_toward(lights: LightTensors, p: Vec3, shape_idx, d: Optional[Vec3] = None, t=None,
                   normal: Optional[Vec3] = None) -> torch.Tensor:
    """Solid-angle density with which NEE at ``p`` would have sampled a
    direction toward the light ``shape_idx`` (0 for other shapes): the
    balance-heuristic counterweight of a BSDF hit of a light. ``normal``
    (the normal at ``p``) selects the clipped density of
    ``sample_light_dirs(..., normal=...)`` on the ring of ``d``. Triangle
    lights read the hit ray's unit direction ``d`` and distance ``t``:
    their density is pick·t²/(A·cosθ_l), 0 from behind."""
    pdf = torch.zeros(shape_idx.shape, dtype=torch.float32, device=shape_idx.device)
    kinds = lights.kinds or ("sphere",) * lights.num_lights
    for k in range(lights.num_lights):
        sel = shape_idx == lights.shape_idx[k]
        if kinds[k] == "tri":
            if d is None or t is None:
                raise ValueError("nee_pdf_toward needs d and t for triangle lights")
            cos_l = -(lights.tri_n[k, 0] * d.x + lights.tri_n[k, 1] * d.y + lights.tri_n[k, 2] * d.z)
            pdf_k = lights.pick[k] * t * t / torch.clamp_min(lights.tri_area[k] * cos_l, 1e-12)
            pdf = torch.where(sel, torch.where(cos_l > 0.0, pdf_k, 0.0), pdf)
            continue
        dcx = lights.center[k, 0] - p.x
        dcy = lights.center[k, 1] - p.y
        dcz = lights.center[k, 2] - p.z
        dist2 = dcx * dcx + dcy * dcy + dcz * dcz
        r = lights.radius[k]
        sin2 = torch.clamp(r * r / torch.clamp_min(dist2, 1e-12), 0.0, 1.0)
        cos_max = torch.sqrt(torch.clamp_min(1.0 - sin2, 0.0))
        omega = _TWO_PI * (1.0 - cos_max)
        pdf_k = lights.pick[k] / torch.clamp_min(omega, 1e-20)
        if normal is not None:
            dist = torch.sqrt(torch.clamp_min(dist2, 1e-12))
            inv = 1.0 / dist
            w = Vec3(dcx * inv, dcy * inv, dcz * inv)
            u, v = _cone_frame(w)
            cos_a = w.x * d.x + w.y * d.y + w.z * d.z
            sin_a = torch.sqrt(torch.clamp_min(1.0 - cos_a * cos_a, 0.0))
            _, _, n_w, rho = _ring_decompose(normal, u, v, w)
            phi_lim = _clip_arc_halfangle(rho, n_w, cos_a, sin_a)
            pdf_k = pdf_k * _PI / torch.clamp_min(phi_lim, 1e-9)
        pdf_k = torch.where(dist2 <= r * r, 0.0, pdf_k)
        pdf = torch.where(sel, pdf_k, pdf)
    return pdf
