"""The float64 oracle renderer on PyTorch, and the precision audit
(``flux_tpu/oracle.py``).

An independent float64 implementation of the estimator that the float32
path and the CUDA kernels compute, function for function the NumPy oracle
of the JAX package, on tensors on an explicit device: the card by default
(where the kernels run, and where the JAX package cannot be imported), the
CPU when the caller asks. It is the judge, so it shares no code with what it
judges: it imports the port's ``constants`` and ``scene`` only, keeps its own
uint32 hashing and sample points, and reads the frame-epsilon literals of
``ops/brdf.py`` from that file's source instead of importing it (importing
``flux_tpu_torch.ops`` loads the float32 intersection, shading and NEE).

1. **Bitwise-identical sample streams.** Every uniform is the same uint32
   counter hash as the float32 path's (``samplers/hash.py``), carried here
   as int64 masked to 32 bits after every operation that can leave that
   range; the float64 value of each uniform equals the float32 one, so any
   output difference is arithmetic precision, not another Monte Carlo
   estimate.
2. **float64 everywhere downstream**, in the operation order of the NumPy
   oracle: each elementwise tensor operation rounds as its NumPy
   counterpart does, so on the CPU the two agree to the last few ulp of the
   transcendental functions. A division by a Python number divides by a
   0-dim tensor on the device (:func:`_div`): PyTorch's CUDA division by a
   host scalar multiplies by its reciprocal, one rounding more.
3. **Obviously equivalent, not fast.** Loops over shapes and lights stay
   Python loops of whole-band tensor operations; ``rows_per_band`` sets the
   band, and a whole frame in one band keeps the card busy.

The same two estimator-definition carry-overs as the NumPy oracle: the
clipped arc's half-angle is the production Abramowitz–Stegun polynomial
arccos with its 1e-4 pad, and triangle-light shadow rays stop at
t·(1−1e-4).

:func:`adjudicate` is the per-sample gate of ``tests/test_scan_parity.py``
(``_oracle_adjudicate``) over two float32 renders of the same samples, with
a tolerance scaled by the sample's magnitude and non-finite samples counted
as off.

Usage::

    from flux_tpu_torch.oracle import oracle_render, precision_audit
    img64 = oracle_render(scene_data, sample_root=8, max_depth=5, seed=0)
    report = precision_audit(scene_data, sample_root=8, max_depth=5, seed=0)

``python -m flux_tpu_torch.f64_audit`` wraps the audit as a CLI.
"""

from __future__ import annotations

import ast
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from .constants import SALT_AA, SALT_BOUNCE, SALT_LENS, SALT_NEE, SALT_NEEPICK, T_MIN
from .scene import MaterialKind, PlaneData, SceneData, SphereData, TriangleData

__all__ = ["oracle_render", "precision_audit", "adjudicate", "off_oracle"]

F64 = torch.float64
_INF = math.inf


def _device(device=None) -> torch.device:
    """The oracle's device: the CUDA card unless the caller names another.
    Raises when the card is asked for (or implied) and absent. The rule of
    ``render.resolve_device``, kept here: the judge imports no renderer."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
            "to run the float64 oracle on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` for a Python-number divisor, correctly rounded on every
    device (a 0-dim divisor on ``a``'s device)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def _over(a: float, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` for a Python-number dividend: PyTorch's ``a / b`` takes
    ``b``'s reciprocal times ``a``, one rounding more than NumPy."""
    return torch.full((), a, dtype=b.dtype, device=b.device) / b


# ---------------------------------------------------------------------------
# uint32 counter hashing, bit-identical to flux_tpu_torch/samplers/hash.py
# (an int64 tensor or Python int in [0, 2**32); a product of two uint32
# values may wrap past 2**63, its low 32 bits, which the mask keeps, exact).
# ---------------------------------------------------------------------------

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _u32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return int(x) & _MASK


def _mix(x):
    """murmur3-style avalanche finalizer (hash.py)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _MASK
    return x ^ (x >> 16)


def _hash_combine(*vals):
    acc = _GOLDEN
    for v in vals:
        acc = _mix(acc ^ ((_u32(v) + _GOLDEN + ((acc << 6) & _MASK) + (acc >> 2)) & _MASK))
    return acc


def _randfloat(i, p):
    """Top 24 bits of one avalanche round, scaled to [0, 1): the float32
    path's value, exactly representable in float64."""
    v = _mix(_u32(i) ^ _u32(p))
    return (v >> 8).to(F64) * (1.0 / (1 << 24))


def _permute_pow2(i, l: int, p):
    """Kensler permutation network (hash.py), bit for bit."""
    assert l & (l - 1) == 0 and l > 0
    w = l - 1
    i = _u32(i)
    p = _u32(p)
    i = i ^ p
    i = (i * 0xE170893D) & _MASK
    i = i ^ (p >> 16)
    i = i ^ ((i & w) >> 4)
    i = i ^ (p >> 8)
    i = (i * 0x0929EB3F) & _MASK
    i = i ^ (p >> 23)
    i = i ^ ((i & w) >> 1)
    i = (i * (1 | (p >> 27))) & _MASK
    i = (i * 0x6935FA69) & _MASK
    i = i ^ ((i & w) >> 11)
    i = (i * 0x74DCCA23) & _MASK
    i = i ^ (p >> 2)
    i = (i * 0x9E501CC3) & _MASK
    i = i ^ ((i & w) >> 2)
    i = (i * 0xC860A3DF) & _MASK
    i = i & w
    i = i ^ (i >> 5)
    return ((i + p) & _MASK) & w


# Pattern salts (patterns.py).
_SALT_JX = 0x16A3D5C7
_SALT_JY = 0x2C9F1B4F
_SALT_PX = 0x51633E2D
_SALT_PY = 0x68BC21EB


def _jittered_point(s, root: int, pattern):
    """patterns.py jittered_point, divisions in float64."""
    s = _u32(s)
    i = (s % root).to(F64)
    j = (s // root).to(F64)
    jx = _randfloat(s, _hash_combine(pattern, _SALT_JX))
    jy = _randfloat(s, _hash_combine(pattern, _SALT_JY))
    return _div(i + jx, root), _div(j + jy, root)


def _multi_jitter(s, root: int, pattern, correlated: bool):
    """patterns.py multi-jitter, divisions in float64."""
    s = _u32(s)
    i = s % root
    j = s // root
    if root > 0 and (root & (root - 1)) == 0:
        if correlated:
            px = _hash_combine(pattern, _SALT_PX)
            py = _hash_combine(pattern, _SALT_PY)
        else:
            px = _hash_combine(pattern, _SALT_PX, i)
            py = _hash_combine(pattern, _SALT_PY, j)
        fine_x = _permute_pow2(j, root, px).to(F64)
        fine_y = _permute_pow2(i, root, py).to(F64)
    else:
        fine_x = j.to(F64)
        fine_y = ((root - 1) - i).to(F64)
    jx = _randfloat(s, _hash_combine(pattern, _SALT_JX))
    jy = _randfloat(s, _hash_combine(pattern, _SALT_JY))
    x = _div(i.to(F64) + _div(fine_x + jx, root), root)
    y = _div(j.to(F64) + _div(fine_y + jy, root), root)
    return x, y


def _cmj_point(s, root, pattern):
    return _multi_jitter(s, root, pattern, correlated=True)


def _bounce_point(s, root, pattern, depth):
    """patterns.py bounce_point: MJ at depth 1, jittered beyond."""
    if depth <= 1:
        return _multi_jitter(s, root, pattern, correlated=False)
    return _jittered_point(s, root, pattern)


# ---------------------------------------------------------------------------
# float64 geometry and warp helpers.
# ---------------------------------------------------------------------------


class _V(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        return _V(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return _V(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s):
        return _V(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def had(self, o):
        return _V(self.x * o.x, self.y * o.y, self.z * o.z)


def _dot(a, b):
    return a.x * b.x + a.y * b.y + a.z * b.z


def _cross(a, b):
    return _V(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x)


def _normalize(a):
    # IEEE semantics (dead lanes normalize zero vectors; their inf/nan
    # results are masked out downstream).
    inv = 1.0 / torch.sqrt(_dot(a, a))
    return _V(a.x * inv, a.y * inv, a.z * inv)


def _vwhere(m, a, b):
    return _V(torch.where(m, a.x, b.x), torch.where(m, a.y, b.y), torch.where(m, a.z, b.z))


def _reflect(d, n):
    k = 2.0 * _dot(n, d)
    return _V(d.x - k * n.x, d.y - k * n.y, d.z - k * n.z)


def _frame_about(w, eps):
    """c = normalize(eps × w), c2 = c × w."""
    c = _normalize(_cross(eps, w))
    return c, _cross(c, w)


def _to_unit_hemi(x, y, e):
    """warps.py to_unit_hemi in float64 (the transcendental form)."""
    phi = 2.0 * math.pi * x
    cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)
    cos_theta = torch.clamp_min(1.0 - y, 0.0) ** (1.0 / (e + 1.0))
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    return sin_theta * cos_phi, sin_theta * sin_phi, cos_theta


def _to_poisson_disc(x, y):
    """warps.py to_poisson_disc (Shirley–Chiu concentric map) in float64."""
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
    phi = phi * (math.pi / 4.0)
    return r * torch.cos(phi), r * torch.sin(phi)


# Frame-epsilon vectors (brdf.rs:23,57). The oracle keeps the exact decimal
# literals; the float32 path rounds them. The literals themselves must never
# desynchronize (the cone frame is part of the estimator's definition), so
# they are pinned at import against ops/brdf.py's, read from its source.
_EM = (0.0034, 1.0, 0.0071)
_EG = (0.00424, 1.0, 0.00764)


def _pin_frame_eps():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ops", "brdf.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    found = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and [getattr(t, "id", None) for t in node.targets] in (["_EM"], ["_EG"]):
            lists = [n for n in ast.walk(node.value) if isinstance(n, ast.List)]
            found[node.targets[0].id] = tuple(float(v) for v in ast.literal_eval(lists[0]))
    assert found == {"_EM": _EM, "_EG": _EG}, f"ops/brdf.py's frame epsilons {found} moved"


_pin_frame_eps()


# ---------------------------------------------------------------------------
# The renderer.
# ---------------------------------------------------------------------------


class _Scene(NamedTuple):
    """float64 scene: host arrays (per-shape scalars of the loops) and the
    same arrays as tensors on the device (``t``, gathered by shape index)."""

    ctr: np.ndarray  # (Ns, 3)
    rad: np.ndarray  # (Ns,)
    inv: np.ndarray  # (Ns,)  ±1
    ppt: np.ndarray  # (Np, 3)
    pnm: np.ndarray  # (Np, 3)
    tv0: np.ndarray  # (Nt, 3)
    te1: np.ndarray  # (Nt, 3)  v1 - v0
    te2: np.ndarray  # (Nt, 3)  v2 - v0
    tnm: np.ndarray  # (Nt, 3)  unit winding normal
    kind: np.ndarray  # (Ns+Np+Nt,) int32
    alb: np.ndarray  # (Ns+Np+Nt, 3)  color × param
    exp: np.ndarray  # (Ns+Np+Nt,)
    bg: np.ndarray  # (3,)
    t: dict


def _on(arrays: dict, dev) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in arrays.items()}


def _compile(sd: SceneData, dev) -> _Scene:
    sph = [s for s in sd.shapes if isinstance(s, SphereData)]
    pln = [p for p in sd.shapes if isinstance(p, PlaneData)]
    tri = [t for t in sd.shapes if isinstance(t, TriangleData)]
    mats = [s.material for s in sph] + [p.material for p in pln] + [t.material for t in tri]
    f64 = lambda v, shape: np.asarray(v, np.float64).reshape(shape)  # noqa: E731
    n, m, q = len(sph), len(pln), len(tri)
    v0 = f64([t.v0 for t in tri], (q, 3))
    e1 = f64([t.v1 for t in tri], (q, 3)) - v0
    e2 = f64([t.v2 for t in tri], (q, 3)) - v0
    tn = np.cross(e1, e2)
    tn = tn / np.maximum(np.linalg.norm(tn, axis=1, keepdims=True), 1e-300)
    arrays = dict(
        ctr=f64([s.center for s in sph], (n, 3)),
        rad=f64([s.radius for s in sph], (n,)),
        inv=f64([-1.0 if s.invert else 1.0 for s in sph], (n,)),
        ppt=f64([p.point for p in pln], (m, 3)),
        pnm=f64([p.normal for p in pln], (m, 3)),
        tv0=v0,
        te1=e1,
        te2=e2,
        tnm=tn,
        kind=np.asarray([mt.kind for mt in mats], np.int64),
        alb=f64([mt.color for mt in mats], (n + m + q, 3)) * f64([mt.param for mt in mats], (n + m + q,))[:, None],
        exp=f64([mt.exponent for mt in mats], (n + m + q,)),
        bg=f64(sd.background, (3,)),
    )
    return _Scene(**arrays, t=_on(arrays, dev))


def _gather3(table: torch.Tensor, idx: torch.Tensor) -> _V:
    return _V(*(table[idx, k] for k in range(3)))


def _intersect(sc: _Scene, o: _V, d: _V, margin=None, alive=None):
    """Nearest-hit sweep in float64: the reference's full quadratic with the
    hoisted a = d·d, planes, and Möller–Trumbore triangles (the merge rule:
    ties keep spheres and planes; among triangles the lowest index).

    ``margin`` (optional, updated in place, per lane): the running minimum
    relative margin of every path-determining branch this sweep evaluates
    (``oracle_render``'s ``branch_margins``): nearest-competition |t − best|
    between viable hits, the tangency boundary |disc|, the T_MIN acceptance
    boundary and the barycentric edges, each normalized by its operand
    scale, and only on ``alive`` lanes where the losing branch would change
    the path."""
    dev = o.x.device
    a = _dot(d, d)
    inv_a = 1.0 / a
    best_t = torch.full(o.x.shape, _INF, dtype=F64, device=dev)
    best_i = torch.zeros(o.x.shape, dtype=torch.int64, device=dev)

    def note(m):
        if margin is not None:
            torch.minimum(margin, torch.where(alive, m, _INF), out=margin)

    for i in range(sc.ctr.shape[0]):
        cx, cy, cz = (float(v) for v in sc.ctr[i])
        r = sc.rad[i]
        oc = _V(o.x - cx, o.y - cy, o.z - cz)
        b_half = _dot(oc, d)
        c = _dot(oc, oc) - float(r * r)
        disc = b_half * b_half - a * c
        e = torch.sqrt(torch.clamp_min(disc, 0.0))
        t_near = (-b_half - e) * inv_a
        t = torch.where(t_near > T_MIN, t_near, (-b_half + e) * inv_a)
        valid = (disc >= 0.0) & (t > T_MIN)
        cond = valid & (t < best_t)
        if margin is not None:
            # Tangency: |disc| against its operand scale, where a grazing hit
            # would take the lead (t at the tangency point in the window).
            t_tan = -b_half * inv_a
            disc_rel = disc.abs() / torch.clamp_min(torch.maximum(b_half * b_half, (a * c).abs()), 1e-300)
            note(torch.where((t_tan > T_MIN) & (t_tan < best_t), disc_rel, _INF))
            # Nearest competition: |t − best| where this sphere is a genuine
            # competitor, against the winning distance's scale.
            note(torch.where(valid & torch.isfinite(best_t),
                             (t - best_t).abs() / torch.clamp_min(best_t, T_MIN), _INF))
            # T_MIN acceptance of either root.
            for tr in (t_near, t):
                note(torch.where(disc >= 0.0, _div((tr - T_MIN).abs(), max(T_MIN, 1e-300)), _INF))
        best_t = torch.where(cond, t, best_t)
        best_i = torch.where(cond, i, best_i)
    ns = sc.ctr.shape[0]
    for j in range(sc.ppt.shape[0]):
        nx, ny, nz = (float(v) for v in sc.pnm[j])
        px, py, pz = (float(v) for v in sc.ppt[j])
        num = (px - o.x) * nx + (py - o.y) * ny + (pz - o.z) * nz
        t = num / (d.x * nx + d.y * ny + d.z * nz)
        if margin is not None:
            note(torch.where(torch.isfinite(t) & (t > T_MIN) & torch.isfinite(best_t),
                             (t - best_t).abs() / torch.clamp_min(best_t, T_MIN), _INF))
            note(torch.where(torch.isfinite(t), _div((t - T_MIN).abs(), T_MIN), _INF))
        cond = (t > T_MIN) & (t < best_t)
        best_t = torch.where(cond, t, best_t)
        best_i = torch.where(cond, ns + j, best_i)

    npl = sc.ppt.shape[0]
    for k in range(sc.tv0.shape[0]):
        e1 = [float(v) for v in sc.te1[k]]
        e2 = [float(v) for v in sc.te2[k]]
        v0 = [float(v) for v in sc.tv0[k]]
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
        valid = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN)
        if margin is not None:
            viable = torch.isfinite(t) & (t > T_MIN) & (t < best_t)
            # Barycentric edge margins (u, v, 1−u−v against 0), where the
            # triangle would take the lead.
            for edge in (u, v, 1.0 - u - v):
                note(torch.where(viable, edge.abs(), _INF))
            note(torch.where(valid & torch.isfinite(best_t),
                             (t - best_t).abs() / torch.clamp_min(best_t, T_MIN), _INF))
        cond = valid & (t < best_t)
        best_t = torch.where(cond, t, best_t)
        best_i = torch.where(cond, ns + npl + k, best_i)

    mask = torch.isfinite(best_t)
    t_safe = torch.where(mask, best_t, 0.0)
    point = _V(o.x + t_safe * d.x, o.y + t_safe * d.y, o.z + t_safe * d.z)
    is_plane = (best_i >= ns) & (best_i < ns + npl)
    is_tri = best_i >= ns + npl
    si = torch.where(is_plane | is_tri, 0, best_i)
    # Sphere normal (point − c)·invert/r; plane and triangle lanes take the
    # authored one.
    if ns:
        ctr = _gather3(sc.t["ctr"], si)
        inv_r = sc.t["inv"][si] / sc.t["rad"][si]
        n_sph = (point - ctr) * inv_r
    else:
        n_sph = _V(t_safe * 0.0, t_safe * 0.0, t_safe * 0.0)
    pj = torch.where(is_plane, best_i - ns, 0)
    n_pl = _gather3(sc.t["pnm"], pj) if npl else n_sph
    normal = _vwhere(is_plane, n_pl, n_sph)
    if sc.tv0.shape[0]:
        tk = torch.where(is_tri, best_i - ns - npl, 0)
        normal = _vwhere(is_tri, _gather3(sc.t["tnm"], tk), normal)
    return mask, best_i, point, normal, best_t


def _splat(like: torch.Tensor, v) -> _V:
    return _V(like + v[0], like + v[1], like + v[2])


def _sample_directions(kind, exponent, normal, d, sx, sy, physical, margin=None, margin_mask=None):
    """ops/brdf.py sample_directions in float64. ``margin``/``margin_mask``
    record the glossy below-horizon flip's branch margin |n·(tang+axial)|."""
    r = _reflect(d, normal)
    is_glossy = kind == MaterialKind.GLOSSY
    is_perfect = kind == MaterialKind.REFLECTIVE
    e = torch.where(is_glossy, exponent, 1.0 if physical else 0.0)
    hx, hy, hz = _to_unit_hemi(sx, sy, e)
    w = _vwhere(is_glossy, r, normal)
    sh = 0.0 * w.x
    eps = _vwhere(is_glossy, _splat(sh, _EG), _splat(sh, _EM))
    c, c2 = _frame_about(w, eps)
    f1 = _vwhere(is_glossy, c, c2)
    f2 = _vwhere(is_glossy, c2, c)
    tang = _V(hx * f1.x + hy * f2.x, hx * f1.y + hy * f2.y, hx * f1.z + hy * f2.z)
    axial = w * hz
    horizon = _dot(normal, tang + axial)
    below = (horizon < 0.0) & is_glossy
    if margin is not None:
        torch.minimum(margin, torch.where(margin_mask & is_glossy, horizon.abs(), _INF), out=margin)
    wi = tang * torch.where(below, -1.0, 1.0) + axial
    return _vwhere(is_perfect, r, wi)


# ---------------------------------------------------------------------------
# NEE and MIS in float64 (ops/nee.py and the NEE arms of ops/shade.py).
# ---------------------------------------------------------------------------


class _Lights(NamedTuple):
    """float64 light set: host arrays and their device tensors (``t``)."""

    kinds: tuple  # 'sphere' | 'tri' per light
    ctr: np.ndarray  # (L, 3) sphere center / triangle centroid
    rad: np.ndarray  # (L,)
    emit: np.ndarray  # (L, 3) color × power
    sidx: np.ndarray  # (L,) full shape index
    pick: np.ndarray  # (L,)
    cdf: np.ndarray  # (L,) exclusive prefix sum
    tv0: np.ndarray  # (L, 3)
    te1: np.ndarray  # (L, 3)
    te2: np.ndarray  # (L, 3)
    tn: np.ndarray  # (L, 3)
    area: np.ndarray  # (L,)
    t: dict


def _extract_lights(sd: SceneData, dev):
    """ops/nee.py extract_lights in float64 (None when the scene has no NEE
    light); selection weights by the same luminance · area/(4π) rule."""
    recs = []
    n_sph = sum(isinstance(s, SphereData) for s in sd.shapes)
    n_pln = sum(isinstance(s, PlaneData) for s in sd.shapes)
    si = ti = 0
    z3 = np.zeros(3)
    for s in sd.shapes:
        if isinstance(s, SphereData):
            m = s.material
            if m.kind == MaterialKind.EMISSIVE and not s.invert:
                emit = np.asarray(m.color, np.float64) * m.param
                recs.append(("sphere", np.asarray(s.center, np.float64), float(s.radius), emit, si,
                             z3, z3, z3, z3, 0.0, float(s.radius) ** 2))
            si += 1
        elif isinstance(s, TriangleData):
            m = s.material
            if m.kind == MaterialKind.EMISSIVE:
                emit = np.asarray(m.color, np.float64) * m.param
                v0 = np.asarray(s.v0, np.float64)
                e1 = np.asarray(s.v1, np.float64) - v0
                e2 = np.asarray(s.v2, np.float64) - v0
                cr = np.cross(e1, e2)
                area = 0.5 * float(np.linalg.norm(cr))
                nrm = cr / max(np.linalg.norm(cr), 1e-300)
                ctr = v0 + (e1 + e2) / 3.0
                recs.append(("tri", ctr, 0.0, emit, n_sph + n_pln + ti, v0, e1, e2, nrm, area,
                             area / (4.0 * np.pi)))
            ti += 1
    if not recs:
        return None
    n = len(recs)
    emits = np.asarray([r[3] for r in recs], np.float64).reshape(n, 3)
    lum = 0.2126 * emits[:, 0] + 0.7152 * emits[:, 1] + 0.0722 * emits[:, 2]
    w = lum * np.asarray([r[10] for r in recs], np.float64)
    total = float(w.sum())
    pick = w / total if total > 0 else np.full(n, 1.0 / n)
    cdf = np.concatenate([[0.0], np.cumsum(pick)[:-1]])
    arr = lambda k: np.asarray([r[k] for r in recs], np.float64).reshape(  # noqa: E731
        (n, 3) if np.ndim(recs[0][k]) else (n,))
    arrays = dict(ctr=arr(1), rad=arr(2), emit=emits, sidx=np.asarray([r[4] for r in recs], np.int64),
                  pick=pick, cdf=cdf, tv0=arr(5), te1=arr(6), te2=arr(7), tn=arr(8), area=arr(9))
    kinds = tuple(r[0] for r in recs)
    t = _on({**arrays, "is_tri": np.asarray([k == "tri" for k in kinds])}, dev)
    return _Lights(kinds=kinds, **arrays, t=t)


def _acos_conservative(x):
    """ops/nee.py _acos_conservative in float64: the same Abramowitz–Stegun
    4.4.45 polynomial and 1e-4 pad, not the true arccos (the sampled arc and
    its density are defined by this formula)."""
    ax = x.abs()
    poly = 1.5707288 + ax * (-0.2121144 + ax * (0.0742610 + ax * -0.0187293))
    a = torch.sqrt(torch.clamp_min(1.0 - ax, 0.0)) * poly
    a = torch.where(x < 0.0, math.pi - a, a)
    return torch.clamp(a + 1e-4, 0.0, math.pi)


def _sample_light_dirs(lt: _Lights, p: _V, ux, uy, upick, normal=None):
    """ops/nee.py sample_light_dirs in float64. Returns (d, emit, weight,
    sidx, pdf, center, radius, tri_t, tri_mask)."""
    shape = np.broadcast_shapes(ux.shape, p.x.shape)
    dev = ux.device
    li = torch.zeros(shape, dtype=torch.int64, device=dev)
    for k in range(1, len(lt.kinds)):
        li = torch.where(upick >= float(lt.cdf[k]), k, li)
    cx, cy, cz = _gather3(lt.t["ctr"], li)
    rad = lt.t["rad"][li]
    pk = lt.t["pick"][li]
    sidx = lt.t["sidx"][li]
    emit = _gather3(lt.t["emit"], li)

    dc = _V(cx - p.x, cy - p.y, cz - p.z)
    dist2 = _dot(dc, dc)
    dist = torch.sqrt(dist2)
    inside = dist2 <= rad * rad
    sin2_max = torch.clamp(rad * rad / torch.clamp_min(dist2, 1e-12), 0.0, 1.0)
    cos_max = torch.sqrt(torch.clamp_min(1.0 - sin2_max, 0.0))
    w = dc * (1.0 / torch.clamp_min(dist, 1e-12))
    cos_a = 1.0 - ux * (1.0 - cos_max)
    sin_a = torch.sqrt(torch.clamp_min(1.0 - cos_a * cos_a, 0.0))
    sh = torch.zeros(shape, dtype=F64, device=dev)
    u, v = _frame_about(w, _splat(sh, _EM))

    arc_frac = None
    if normal is None:
        phi = 2.0 * math.pi * uy
        cp, sp = torch.cos(phi), torch.sin(phi)
    else:
        # Partial-cone horizon clipping (reference transport).
        n_u = _dot(normal, u)
        n_v = _dot(normal, v)
        n_w = _dot(normal, w)
        rho = torch.sqrt(n_u * n_u + n_v * n_v)
        c = -(cos_a * n_w) / torch.clamp_min(sin_a * rho, 1e-12)
        phi_lim = _acos_conservative(torch.clamp(c, -1.0, 1.0))
        arc_frac = phi_lim * (1.0 / math.pi)
        safe = rho > 1e-6
        inv_rho = 1.0 / torch.clamp_min(rho, 1e-12)
        c0 = torch.where(safe, n_u * inv_rho, 1.0)
        s0 = torch.where(safe, n_v * inv_rho, 0.0)
        delta = (2.0 * uy - 1.0) * phi_lim
        cd, sd_ = torch.cos(delta), torch.sin(delta)
        cp = c0 * cd - s0 * sd_
        sp = s0 * cd + c0 * sd_

    d = _V(
        sin_a * (cp * u.x + sp * v.x) + cos_a * w.x,
        sin_a * (cp * u.y + sp * v.y) + cos_a * w.y,
        sin_a * (cp * u.z + sp * v.z) + cos_a * w.z,
    )
    wgt = 2.0 * math.pi * (1.0 - cos_max) / torch.clamp_min(pk, 1e-12)
    wgt = torch.where(inside, 0.0, wgt)
    if arc_frac is not None:
        wgt = wgt * arc_frac

    tri_t = tri_mask = None
    cos_l = None
    if "tri" in lt.kinds:
        tri_mask = lt.t["is_tri"][li]
        uu = ux.expand(shape).clone()
        vv = uy.expand(shape).clone()
        flip = uu + vv > 1.0
        uu = torch.where(flip, 1.0 - uu, uu)
        vv = torch.where(flip, 1.0 - vv, vv)
        q = _V(*(lt.t["tv0"][li, c] + uu * lt.t["te1"][li, c] + vv * lt.t["te2"][li, c] for c in range(3)))
        dv = q - p
        r2 = torch.clamp_min(_dot(dv, dv), 1e-12)
        r = torch.sqrt(r2)
        td = dv * (1.0 / r)
        tn = _gather3(lt.t["tn"], li)
        cos_l = -_dot(tn, td)
        area = lt.t["area"][li]
        wgt_tri = area * torch.clamp_min(cos_l, 0.0) / (torch.clamp_min(pk, 1e-12) * r2)
        d = _vwhere(tri_mask, td, d)
        wgt = torch.where(tri_mask, wgt_tri, wgt)
        tri_t = r
    pdf = 1.0 / torch.clamp_min(wgt, 1e-20)
    if cos_l is not None:
        pdf_tri = torch.where(cos_l > 0.0, pk * r2 / torch.clamp_min(lt.t["area"][li] * cos_l, 1e-12), 0.0)
        pdf = torch.where(tri_mask, pdf_tri, pdf)
    return d, emit, wgt, sidx, pdf, _V(cx, cy, cz), rad, tri_t, tri_mask


def _light_emission(lt: _Lights, shape_idx):
    m = torch.zeros(shape_idx.shape, dtype=torch.bool, device=shape_idx.device)
    for k in range(len(lt.kinds)):
        m |= shape_idx == int(lt.sidx[k])
    return m


def _nee_pdf_toward(lt: _Lights, p: _V, shape_idx, d: _V, t, normal=None):
    """ops/nee.py nee_pdf_toward in float64 (the MIS reverse density; with
    ``normal``, the previous vertex's, the partial-cone clipped density)."""
    pdf = torch.zeros(shape_idx.shape, dtype=F64, device=shape_idx.device)
    for k, kind in enumerate(lt.kinds):
        sel = shape_idx == int(lt.sidx[k])
        pick = float(lt.pick[k])
        if kind == "tri":
            tn = [float(v) for v in lt.tn[k]]
            cos_l = -(tn[0] * d.x + tn[1] * d.y + tn[2] * d.z)
            pdf_k = pick * t * t / torch.clamp_min(float(lt.area[k]) * cos_l, 1e-12)
            pdf_k = torch.where(cos_l > 0.0, pdf_k, 0.0)
        else:
            cx, cy, cz = (float(v) for v in lt.ctr[k])
            dc = _V(cx - p.x, cy - p.y, cz - p.z)
            dist2 = _dot(dc, dc)
            r = float(lt.rad[k])
            sin2 = torch.clamp(_over(r * r, torch.clamp_min(dist2, 1e-12)), 0.0, 1.0)
            cos_max = torch.sqrt(torch.clamp_min(1.0 - sin2, 0.0))
            omega = 2.0 * math.pi * (1.0 - cos_max)
            pdf_k = _over(pick, torch.clamp_min(omega, 1e-20))
            if normal is not None:
                dist = torch.sqrt(torch.clamp_min(dist2, 1e-12))
                w = dc * (1.0 / dist)
                sh = torch.zeros(p.x.shape, dtype=F64, device=dist.device)
                u, v = _frame_about(w, _splat(sh, _EM))
                cos_a = _dot(w, d)
                sin_a = torch.sqrt(torch.clamp_min(1.0 - cos_a * cos_a, 0.0))
                n_u = _dot(normal, u)
                n_v = _dot(normal, v)
                n_w = _dot(normal, w)
                rho = torch.sqrt(n_u * n_u + n_v * n_v)
                c = -(cos_a * n_w) / torch.clamp_min(sin_a * rho, 1e-12)
                phi_lim = _acos_conservative(torch.clamp(c, -1.0, 1.0))
                pdf_k = pdf_k * math.pi / torch.clamp_min(phi_lim, 1e-9)
            pdf_k = torch.where(dist2 <= r * r, 0.0, pdf_k)
        pdf = torch.where(sel, pdf_k, pdf)
    return pdf


def _occluded(sc: _Scene, o: _V, d: _V, t_max, exclude_idx):
    """Any-hit shadow sweep in float64. No origin-shape exclusion: the float32
    path's exists to kill float32 noise roots above T_MIN, and in float64
    that noise sits far below T_MIN."""
    a = _dot(d, d)
    occ = torch.zeros(o.x.shape, dtype=torch.bool, device=o.x.device)
    for i in range(sc.ctr.shape[0]):
        cx, cy, cz = (float(v) for v in sc.ctr[i])
        r = sc.rad[i]
        oc = _V(o.x - cx, o.y - cy, o.z - cz)
        b_half = _dot(oc, d)
        c = _dot(oc, oc) - float(r * r)
        disc = b_half * b_half - a * c
        e = torch.sqrt(torch.clamp_min(disc, 0.0))
        t_near = (-b_half - e) / a
        t = torch.where(t_near > T_MIN, t_near, (-b_half + e) / a)
        valid = (disc >= 0.0) & (t > T_MIN)
        occ |= valid & (t < t_max) & (exclude_idx != i)
    ns = sc.ctr.shape[0]
    for j in range(sc.ppt.shape[0]):
        nx, ny, nz = (float(v) for v in sc.pnm[j])
        px, py, pz = (float(v) for v in sc.ppt[j])
        num = (px - o.x) * nx + (py - o.y) * ny + (pz - o.z) * nz
        t = num / (d.x * nx + d.y * ny + d.z * nz)
        occ |= (t > T_MIN) & (t < t_max) & (exclude_idx != ns + j)
    npl = sc.ppt.shape[0]
    for k in range(sc.tv0.shape[0]):
        e1 = [float(v) for v in sc.te1[k]]
        e2 = [float(v) for v in sc.te2[k]]
        v0 = [float(v) for v in sc.tv0[k]]
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
        valid = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN)
        occ |= valid & (t < t_max) & (exclude_idx != ns + npl + k)
    return occ


# Triangle-light shadow shrink: the float32 constant the float32 path folds,
# as float64.
_TRI_SHRINK = float(np.float32(1.0 - 1e-4))


def oracle_render(
    sd: SceneData,
    sample_root: int,
    max_depth: int,
    seed: int = 0,
    physical: bool = False,
    rows_per_band: int = 8,
    nee: bool = False,
    raw_samples: bool = False,
    branch_margins: bool = False,
    device=None,
) -> torch.Tensor:
    """Render the scene's frame entirely in float64 on ``device`` (the card
    unless the caller names the CPU). Returns an (H, W, 3) float64 tensor.

    Semantics mirror ``Renderer(accel="sweep")`` sample for sample,
    including, with ``nee=True``, the NEE estimator (reference transport:
    hard split and partial-cone horizon clipping) and, with ``nee=True,
    physical=True``, the MIS balance-heuristic estimator.

    ``raw_samples=True`` returns the per-sample radiance (spp, H, W, 3)
    before averaging and tone mapping: what :func:`adjudicate` holds two
    float32 renders against.

    ``branch_margins=True`` (implies per-sample output) returns
    ``(radiance, margins)``, ``margins`` (spp, H, W) float64: each sample's
    minimum relative branch margin over every path-determining comparison
    its walk evaluated (nearest-hit competition, tangency, T_MIN acceptance,
    barycentric edges, emissive facing, glossy below-horizon flip).

    ``rows_per_band`` rows render at once: on the card, a whole frame in one
    band keeps it busy (about 480 bytes a lane at the peak)."""
    dev = _device(device)
    sc = _compile(sd, dev)
    lights = _extract_lights(sd, dev) if nee else None
    W = sd.output_settings.image_width
    H = sd.output_settings.image_height
    root = int(sample_root)
    seed = int(seed) & _MASK

    # Camera constants in float64 (camera.py; basis per scene.rs:22-35).
    s, cdta = sd.camera_settings, sd.camera_data
    eye = np.asarray(s.eye, np.float64)
    w_ax = eye - np.asarray(s.look_at, np.float64)
    w_ax /= np.linalg.norm(w_ax)
    u_ax = np.cross(np.asarray(s.up, np.float64), w_ax)
    u_ax /= np.linalg.norm(u_ax)
    v_ax = np.cross(w_ax, u_ax)
    eye, w_ax, u_ax, v_ax = ([float(c) for c in a] for a in (eye, w_ax, u_ax, v_ax))
    vp_factor = cdta.focal_distance / cdta.view_plane_distance
    adj_ps = sd.output_settings.pixel_size / cdta.zoom_factor
    fd = cdta.focal_distance

    spp = root * root
    raw_samples = raw_samples or branch_margins
    out = torch.zeros((spp, H, W, 3) if raw_samples else (H, W, 3), dtype=F64, device=dev)
    margins_out = torch.full((spp, H, W), _INF, dtype=F64, device=dev) if branch_margins else None
    s_idx = torch.arange(spp, dtype=torch.int64, device=dev)[:, None, None]
    for row0 in range(0, H, rows_per_band):
        n_rows = min(rows_per_band, H - row0)
        row = torch.arange(row0, row0 + n_rows, dtype=torch.int64, device=dev)[None, :, None]
        col = torch.arange(W, dtype=torch.int64, device=dev)[None, None, :]
        pixel_base = _hash_combine(seed, row, col)

        ax, ay = _cmj_point(s_idx, root, _hash_combine(pixel_base, SALT_AA))
        ux, uy = _cmj_point(s_idx, root, _hash_combine(pixel_base, SALT_LENS))
        lx, ly = _to_poisson_disc(ux, uy)

        # Primary rays (camera.py, with the img_h − row flip).
        px = adj_ps * (col.to(F64) - W * 0.5 + ax)
        py = adj_ps * ((H - row.to(F64)) - H * 0.5 + ay)
        lpx = lx * cdta.lens_radius
        lpy = ly * cdta.lens_radius
        dx = px * vp_factor - lpx
        dy = py * vp_factor - lpy
        d = _normalize(_V(*(dx * u_ax[k] + dy * v_ax[k] - fd * w_ax[k] for k in range(3))))
        shape = (spp, n_rows, W)
        o = _V(*((eye[k] + lpx * u_ax[k] + lpy * v_ax[k]).expand(shape).clone() for k in range(3)))
        d = _V(*(c.expand(shape).clone() for c in d))

        ones = torch.ones(shape, dtype=F64, device=dev)
        zeros = lambda: torch.zeros(shape, dtype=F64, device=dev)  # noqa: E731
        tput = _V(ones, ones, ones)
        radx, rady, radz = zeros(), zeros(), zeros()
        alive = torch.ones(shape, dtype=torch.bool, device=dev)
        suppress = torch.zeros(shape, dtype=torch.bool, device=dev)
        prev_pdf = zeros()
        # MIS only: the previous vertex's normal for the clipped reverse
        # light density (never read while prev_pdf == 0).
        prev_n = _V(zeros(), zeros(), zeros())
        band_margin = torch.full(shape, _INF, dtype=F64, device=dev) if branch_margins else None

        for depth in range(1, max_depth + 1):
            # One bounce (ops/shade.py, NEE and MIS arms included).
            pat = _hash_combine(pixel_base, SALT_BOUNCE, depth)
            sx, sy = _bounce_point(s_idx, root, pat, depth)
            sx = sx.expand(shape)
            sy = sy.expand(shape)

            mask, sidx, point, normal, hit_t = _intersect(sc, o, d, margin=band_margin, alive=alive)
            if sc.kind.size:
                kind = sc.t["kind"][sidx]
                albv = _gather3(sc.t["alb"], sidx)
                expo = sc.t["exp"][sidx]
            else:  # shapeless scene: every lane misses to the background
                kind = torch.full(shape, -1, dtype=torch.int64, device=dev)
                albv = _V(zeros(), zeros(), zeros())
                expo = zeros()

            miss = alive & ~mask
            is_em = kind == MaterialKind.EMISSIVE
            facing = _dot(normal, d)
            emit = alive & mask & is_em & (facing < 0.0)
            scatter = alive & mask & ~is_em
            if band_margin is not None:
                # Emissive facing: (−n)·d crossing 0 keeps or drops the
                # whole emission.
                torch.minimum(band_margin, torch.where(alive & mask & is_em, facing.abs(), _INF), out=band_margin)

            emit_w = None
            if lights is not None and physical:
                # MIS emission weight: a BSDF hit of an NEE light carries
                # pdf_b / (pdf_b + pdf_nee).
                is_l = _light_emission(lights, sidx)
                pdf_nee_prev = _nee_pdf_toward(lights, o, sidx, d, torch.where(mask, hit_t, 0.0), normal=prev_n)
                w_b = prev_pdf / torch.clamp_min(prev_pdf + pdf_nee_prev, 1e-20)
                emit_w = torch.where(emit, torch.where(is_l & (prev_pdf > 0.0), w_b, 1.0), 0.0)
            elif lights is not None:
                # Reference transport: the hard split.
                emit = emit & ~(suppress & _light_emission(lights, sidx))

            radx = radx + torch.where(miss, tput.x * float(sc.bg[0]), 0.0)
            rady = rady + torch.where(miss, tput.y * float(sc.bg[1]), 0.0)
            radz = radz + torch.where(miss, tput.z * float(sc.bg[2]), 0.0)
            if emit_w is not None:
                radx = radx + tput.x * albv.x * emit_w
                rady = rady + tput.y * albv.y * emit_w
                radz = radz + tput.z * albv.z * emit_w
            else:
                radx = radx + torch.where(emit, tput.x * albv.x, 0.0)
                rady = rady + torch.where(emit, tput.y * albv.y, 0.0)
                radz = radz + torch.where(emit, tput.z * albv.z, 0.0)

            diffuse = scatter & (kind == MaterialKind.MATTE)
            glossy = scatter & (kind == MaterialKind.GLOSSY)
            mirror = _reflect(d, normal)

            def glossy_lobe(wd):
                """(phong, pdf, dup) of the glossy strategy at wd."""
                rw = torch.clamp_min(_dot(mirror, wd), 0.0)
                phong = rw**expo
                flipped = _V(2.0 * rw * mirror.x - wd.x, 2.0 * rw * mirror.y - wd.y, 2.0 * rw * mirror.z - wd.z)
                dup = torch.where(_dot(normal, flipped) < 0.0, 1.0, 0.0)
                pdf = (expo + 1.0) * (0.5 / math.pi) * phong * (1.0 + dup)
                return phong, pdf, dup

            if lights is not None:
                # NEE direct-light arm.
                nux, nuy = _bounce_point(s_idx, root, _hash_combine(pixel_base, SALT_NEE, depth), depth)
                nux = nux.expand(shape)
                nuy = nuy.expand(shape)
                upick = _randfloat(s_idx, _hash_combine(pixel_base, SALT_NEEPICK, depth)).expand(shape)
                ldir, lemit, lwgt, lidx, pdf_nee, lctr, lrad, tri_t, tri_mask = _sample_light_dirs(
                    lights, point, nux, nuy, upick, normal=normal)
                cos_s = _dot(normal, ldir)
                # The light's own ray t (float64 quadratic; triangle rows
                # carry theirs).
                a_sh = _dot(ldir, ldir)
                oc = point - lctr
                b_half = _dot(oc, ldir)
                cq = _dot(oc, oc) - lrad * lrad
                disc = b_half * b_half - a_sh * cq
                e_ = torch.sqrt(torch.clamp_min(disc, 0.0))
                t_near = (-b_half - e_) / a_sh
                t_l = torch.where(t_near > T_MIN, t_near, (-b_half + e_) / a_sh)
                l_valid = (disc >= 0.0) & (t_l > T_MIN)
                if tri_mask is not None:
                    t_l = torch.where(tri_mask, tri_t, t_l)
                    l_valid = torch.where(tri_mask, tri_t > T_MIN, l_valid)
                    t_sh = torch.where(tri_mask, t_l * _TRI_SHRINK, t_l)
                else:
                    t_sh = t_l
                lit = l_valid & ~_occluded(sc, point, ldir, t_sh, lidx)
                lit = lit & (cos_s > 0.0)
                if depth >= max_depth:  # the final-depth gate
                    lit = torch.zeros_like(lit)
                if physical:
                    phong_l, pdf_g, _ = glossy_lobe(ldir)
                    pdf_b = torch.where(glossy, pdf_g, cos_s * (1.0 / math.pi))
                    f_fac = torch.where(glossy, (expo + 2.0) * (0.5 / math.pi) * phong_l, 1.0 / math.pi)
                    w_nee = pdf_nee / torch.clamp_min(pdf_nee + pdf_b, 1e-20)
                    fac = f_fac * cos_s * w_nee
                    lit = lit & (diffuse | glossy)
                else:
                    fac = 1.0 / (2.0 * math.pi)
                    lit = lit & diffuse
                cw = lwgt * fac
                radx = radx + torch.where(lit, tput.x * albv.x * lemit.x * cw, 0.0)
                rady = rady + torch.where(lit, tput.y * albv.y * lemit.y * cw, 0.0)
                radz = radz + torch.where(lit, tput.z * albv.z * lemit.z * cw, 0.0)
                suppress = diffuse

            wi = _sample_directions(kind, expo, normal, d, sx, sy, physical, margin=band_margin,
                                    margin_mask=scatter)
            new_tput = tput.had(albv)
            if physical:
                # Physical glossy walk weight.
                phong_i, pdf_gi, dup_i = glossy_lobe(wi)
                cos_i = torch.clamp_min(_dot(normal, wi), 0.0)
                fac = torch.where(kind == MaterialKind.GLOSSY, (expo + 2.0) / (expo + 1.0) * cos_i / (1.0 + dup_i), 1.0)
                new_tput = new_tput * fac
                if lights is not None:
                    prev_pdf = torch.where(glossy, pdf_gi, torch.where(diffuse, cos_i * (1.0 / math.pi), 0.0))
                    prev_n = _vwhere(scatter, normal, prev_n)
            tput = _vwhere(scatter, new_tput, tput)
            o = _vwhere(scatter, point, o)
            d = _vwhere(scatter, wi, d)
            alive = scatter

        if raw_samples:
            out[:, row0:row0 + n_rows] = torch.stack([radx, rady, radz], dim=-1)
            if branch_margins:
                margins_out[:, row0:row0 + n_rows] = band_margin
            continue
        acc = torch.stack([radx.sum(dim=0), rady.sum(dim=0), radz.sum(dim=0)], dim=-1)
        img = _div(acc, spp)
        m = img.amax(dim=-1, keepdim=True)
        out[row0:row0 + n_rows] = img * torch.where(m > 1.0, 1.0 / m, 1.0)
    if branch_margins:
        return out, margins_out
    return out


def precision_audit(
    sd: SceneData,
    sample_root: int,
    max_depth: int,
    seed: int = 0,
    physical: bool = False,
    renderer=None,
    nee: bool = False,
    device=None,
) -> dict:
    """Render with the port's float32 path and with the float64 oracle, and
    report the difference.

    The renderer is ``Renderer(accel="sweep")`` on ``device`` (the card by
    default: its kernels) unless ``renderer`` is given; the oracle runs on
    the same device. The sample streams are bit-identical, so the difference
    measures arithmetic precision, plus the samples whose branch decisions
    flip near float32 comparison boundaries. ``nee=True`` audits the NEE
    estimator (with ``physical``, the MIS weights)."""
    if renderer is None:
        from .render import Renderer

        renderer = Renderer(sd, sample_root, max_depth, seed=seed, physical=physical, accel="sweep",
                            nee=nee, device=device)
    dev = _device(renderer.device if device is None else device)
    img32 = torch.from_numpy(renderer.render_image()).to(dev, F64)
    img64 = oracle_render(sd, sample_root, max_depth, seed=seed, physical=physical, nee=nee, device=dev)
    diff = (img32 - img64).abs()
    return {
        "mean_abs_diff": float(diff.mean()),
        # torch.quantile takes at most 2**24 values (an 800x600 frame has
        # 1.44 M) and interpolates linearly, as np.quantile does by default.
        "p99_abs_diff": float(torch.quantile(diff.flatten(), 0.99)),
        "max_abs_diff": float(diff.max()),
        "f64_mean": float(img64.mean()),
        "f32_mean": float(img32.mean()),
    }


def off_oracle(x, oracle, tol: float = 1e-3) -> torch.Tensor:
    """Per sample (the last axis holds its channels): True where ``x`` is
    off the oracle by more than ``tol·max(1, |oracle|)`` on some channel,
    or is not finite."""
    x = torch.as_tensor(x).to(F64)
    oracle = torch.as_tensor(oracle).to(x.device, F64)
    bound = tol * oracle.abs().amax(dim=-1).clamp_min(1.0)
    return ~((x - oracle).abs().amax(dim=-1) <= bound)


def adjudicate(a, b, oracle, tol: float = 1e-3) -> dict:
    """The per-sample gate of two float32 renders ``a`` and ``b`` of the same
    samples (``(..., 3)``), adjudicated by the float64 ``oracle``'s samples
    (``oracle_render(..., raw_samples=True)``): ``tests/test_scan_parity.py``'s
    rule, which ``chip_smoke.py`` and the tests share.

    A flip is a sample where the two differ by more than 1e-5 (or either is
    not finite); each must match the oracle on one side (a whole-path flip
    lands on a legitimate alternate path), else it is unadjudicated. Each
    side may be off the oracle on at most 1% of its samples (the budget).
    Two changes to the JAX package's helper:

    * a side's tolerance is ``tol·max(1, |oracle|)``, the sample's largest
      channel: float32 rounding grows with the value, and samples that see
      a light directly reach tens;
    * a sample that is not finite counts as off the oracle (written as
      ``> tol``, a NaN passed), and the NaNs of each side are reported
      apart.
    """
    a = torch.as_tensor(a).to(F64)
    b = torch.as_tensor(b).to(a.device, F64)
    oracle = torch.as_tensor(oracle).to(a.device, F64)
    bad_a = off_oracle(a, oracle, tol)
    bad_b = off_oracle(b, oracle, tol)
    flips = ~((a - b).abs().amax(dim=-1) <= 1e-5)
    budget = int(0.01 * bad_a.numel())
    res = {
        "samples": bad_a.numel(),
        "flips": int(flips.sum()),
        "unadjudicated": int((flips & bad_a & bad_b).sum()),
        "bad_a": int(bad_a.sum()),
        "bad_b": int(bad_b.sum()),
        "nan_a": int((~torch.isfinite(a)).any(dim=-1).sum()),
        "nan_b": int((~torch.isfinite(b)).any(dim=-1).sum()),
        "budget": budget,
    }
    res["ok"] = res["unadjudicated"] == 0 and res["bad_a"] <= budget and res["bad_b"] <= budget
    return res
