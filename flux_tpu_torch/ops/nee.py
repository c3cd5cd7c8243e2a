"""Next-event estimation over sphere lights (``flux_tpu/ops/nee.py``, the
sphere-light part).

At a diffuse vertex (and, under physical transport, a glossy one) one light
is picked with probability ∝ luminance × r² (power-proportional selection),
a direction is drawn uniformly inside the cone the light subtends, and a
shadow ray decides whether its emission arrives. The azimuth is drawn only
from the arc of each cone ring that lies above the surface horizon
(partial-cone clipping), with the arc's fraction in the weight; the MIS
reverse density (:func:`nee_pdf_toward` with ``normal``) rebuilds the same
frame and arc from the previous vertex's normal, so the balance weights of
the two strategies sum to one.

Every function here is the JAX package's float32 arithmetic in the same
order, and the CUDA megakernel (``csrc/sweep_megakernel.cu``) repeats it.
The arc half-angle comes from the Abramowitz–Stegun polynomial of
:func:`_acos_conservative`, never from ``acos``: the arc must over-cover the
visible one, and the float64 oracle (``flux_tpu/oracle.py``) uses the same
polynomial. Triangle lights (K7 in ROADMAP.md) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..scene import MaterialKind, SceneData, SphereData, TriangleData
from ..vec import Vec3, dot, frame_about
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
]

_TWO_PI = float(np.float32(2.0 * np.pi))
_PI = float(np.float32(np.pi))
_INV_PI = float(np.float32(1.0 / np.pi))
# Abramowitz–Stegun 4.4.45 (|err| <= 6.8e-5 rad), as float32.
_AS = tuple(float(np.float32(c)) for c in (1.5707288, -0.2121144, 0.0742610, -0.0187293))
_ACOS_PAD = float(np.float32(1e-4))

# The fields of the JAX package's LightArrays that a sphere-only light set
# fills, in the order lights_from_numpy takes them.
LIGHT_FIELDS = ("center", "radius", "emit", "shape_idx", "pick", "cdf")


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
    """The sphere lights of a scene: the twin of the sphere fields of
    ``flux_tpu.ops.nee.LightArrays``. ``pick[k]`` is the probability of
    picking light k, ``cdf[k]`` the exclusive prefix sum of ``pick``.
    ``host`` keeps the float32/int32 numpy arrays, so the kernel's constant
    upload reads no device memory back."""

    center: torch.Tensor  # (L, 3) f32
    radius: torch.Tensor  # (L,) f32
    emit: torch.Tensor  # (L, 3) f32 color × power
    shape_idx: torch.Tensor  # (L,) i32 shape index (spheres, then planes)
    pick: torch.Tensor  # (L,) f32
    cdf: torch.Tensor  # (L,) f32
    host: dict = field(default=None, repr=False)

    @property
    def num_lights(self) -> int:
        return self.center.shape[0]


def lights_from_numpy(arrays: dict, device) -> LightTensors:
    """LightTensors from the JAX package's ``LightArrays`` fields as numpy
    arrays (``LIGHT_FIELDS``), so both packages sample the same float32
    light set. Triangle-light fields, if present, must be None."""
    if any(arrays.get(k) is not None for k in ("is_tri", "tri_v0", "tri_e1", "tri_e2", "tri_n")):
        raise NotImplementedError("triangle lights are not ported yet (ROADMAP.md, queue B: K7)")
    host = {
        k: np.ascontiguousarray(np.asarray(arrays[k], np.int32 if k == "shape_idx" else np.float32))
        for k in LIGHT_FIELDS
    }
    n = host["center"].reshape(-1, 3).shape[0]
    shapes = {"center": (n, 3), "radius": (n,), "emit": (n, 3), "shape_idx": (n,), "pick": (n,), "cdf": (n,)}
    host = {k: v.reshape(shapes[k]) for k, v in host.items()}
    tensors = {k: torch.from_numpy(v.copy()).to(device) for k, v in host.items()}
    return LightTensors(host=host, **tensors)


def extract_lights(sd: SceneData, device) -> Optional[LightTensors]:
    """The NEE light set of a scene: its non-inverted emissive spheres, or
    None when it has none. Emissive triangles raise (K7 is not ported)."""
    recs = []
    sphere_i = 0
    for s in sd.shapes:
        if isinstance(s, SphereData):
            m = s.material
            if m.kind == MaterialKind.EMISSIVE and not s.invert:
                emit = tuple(c * m.param for c in m.color)
                recs.append((s.center, s.radius, emit, sphere_i, float(s.radius) ** 2))
            sphere_i += 1
        elif isinstance(s, TriangleData) and s.material.kind == MaterialKind.EMISSIVE:
            raise NotImplementedError("triangle lights are not ported yet (ROADMAP.md, queue B: K7)")
    if not recs:
        return None
    n = len(recs)
    emits = np.asarray([r[2] for r in recs], np.float32).reshape(n, 3)
    # Selection weights ∝ luminance(color × power) × r²; all-zero weights
    # (black "lights") fall back to uniform (flux_tpu/ops/nee.py:247-254).
    lum = 0.2126 * emits[:, 0] + 0.7152 * emits[:, 1] + 0.0722 * emits[:, 2]
    w = lum * np.asarray([r[4] for r in recs], np.float32)
    total = float(w.sum())
    pick = w / total if total > 0 else np.full(n, 1.0 / n, np.float32)
    cdf = np.concatenate([[0.0], np.cumsum(pick)[:-1]]).astype(np.float32)
    return lights_from_numpy(
        {
            "center": [r[0] for r in recs],
            "radius": [r[1] for r in recs],
            "emit": emits,
            "shape_idx": [r[3] for r in recs],
            "pick": pick,
            "cdf": cdf,
        },
        device,
    )


class LightSample(NamedTuple):
    """One light sample per lane (the return of :func:`sample_light_dirs`)."""

    d: Vec3  # unit direction toward the sampled light point
    weight: Vec3  # L_e / (pick · pdf); 0 when unsampleable
    sidx: torch.Tensor  # i32 shape index of the picked light
    pdf: torch.Tensor  # f32 solid-angle density of this strategy
    center: Vec3  # the picked light's center (for its exact ray-t)
    radius: torch.Tensor  # the picked light's radius


def sample_light_dirs(lights: LightTensors, p: Vec3, ux, uy, upick, normal: Optional[Vec3] = None) -> LightSample:
    """Pick a light by ``upick`` against ``lights.cdf`` (the last k with
    ``upick >= cdf[k]`` wins) and draw a direction from ``p`` uniformly in
    its cone. With ``normal`` the azimuth is drawn from the above-horizon
    arc of the cone ring only, and the weight scales by the arc's fraction."""
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
    weight = Vec3(emit[0] * wgt, emit[1] * wgt, emit[2] * wgt)
    pdf = 1.0 / torch.clamp_min(wgt, 1e-20)
    return LightSample(d=d, weight=weight, sidx=sidx, pdf=pdf, center=Vec3(cx, cy, cz), radius=rad)


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
    ``sample_light_dirs(..., normal=...)`` on the ring of ``d``. ``t`` is
    read by triangle lights only, which are not ported."""
    pdf = torch.zeros(shape_idx.shape, dtype=torch.float32, device=shape_idx.device)
    for k in range(lights.num_lights):
        sel = shape_idx == lights.shape_idx[k]
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
