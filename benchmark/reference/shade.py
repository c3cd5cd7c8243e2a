"""One wavefront bounce: intersect, emit or terminate, sample a light,
scatter (``flux_tpu/ops/shade.py``).

Termination follows the reference (scene.rs:162-172, materials.rs):

* miss         → radiance += throughput × background (scene.rs:168);
* emissive hit → radiance += throughput × color×power if the (possibly
                 inverted) normal faces the ray, else nothing; the path
                 ends either way (materials.rs:42-50);
* other hit    → throughput ×= albedo, and the ray moves to the hit point
                 with a sampled direction (materials.rs:24-32,62-70);
* depth cap    → the caller runs exactly ``max_depth`` bounces; paths still
                 alive then add nothing (scene.rs:164-165).

With ``lights`` (``ops/nee.py``) a diffuse vertex also samples one light
through a shadow ray. Under reference transport the light's emission is
then suppressed on the next hit (the hard split); under ``physical``
transport NEE runs at glossy vertices too and both strategies carry
balance-heuristic weights (MIS), from the direction's sampling density kept
in ``prev_pdf`` and the previous vertex's normal in ``prev_normal``.
``physical`` alone samples matte lanes by the cosine and weights glossy
lanes by normalized Phong over the flip-corrected lobe density.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .constants import T_MIN
from .scene import MaterialKind, SceneTensors
from .vec import Vec3, dot, pow32, reflect
from .vec import where as vwhere
from .brdf import sample_directions
from .intersect import Intersector, sphere_t

__all__ = ["PathState", "bounce"]

_HALF_INV_PI = float(np.float32(0.5 / np.pi))
_INV_PI = float(np.float32(1.0 / np.pi))
_INV_TWO_PI = float(np.float32(1.0 / (2.0 * np.pi)))
_T_MIN = float(np.float32(T_MIN))
# A triangle light's shadow ray stops this hair short of the light.
_TRI_SHADOW_SHRINK = float(np.float32(1.0 - 1e-4))
_SWEEP = Intersector()


class PathState(NamedTuple):
    o: Vec3  # ray origin
    d: Vec3  # ray direction (unit)
    throughput: Vec3
    radiance: Vec3  # accumulated
    alive: torch.Tensor  # (B,) bool
    # Shape index the ray originates on (the previous bounce's hit; -1 for
    # camera rays), for the exact self-hit exclusion of ops/intersect.py.
    # Dead lanes keep a stale index; they never intersect again.
    prev_shape: torch.Tensor  # (B,) i32
    # NEE only: the previous vertex was a diffuse NEE vertex, so the next
    # hit of an NEE light adds no emission (reference transport).
    suppress: Optional[torch.Tensor] = None  # (B,) bool
    # NEE + physical (MIS) only: the solid-angle density with which the
    # previous vertex sampled this ray (0 after the camera or a mirror).
    prev_pdf: Optional[torch.Tensor] = None  # (B,) f32
    # NEE + physical only: the previous vertex's normal, for the clipped
    # reverse light density.
    prev_normal: Optional[Vec3] = None


def bounce(
    scene: SceneTensors,
    state: PathState,
    sx,
    sy,
    isect: Optional[Intersector] = None,
    first_bounce: bool = False,
    lights=None,
    nee_samples=None,
    physical: bool = False,
) -> PathState:
    """Advance every alive path by one bounce. ``sx``/``sy`` is this
    bounce's stratified unit-square sample. ``isect`` is the intersection
    strategy (:class:`~flux_tpu_torch.ops.intersect.Intersector`; the sweep
    by default). ``first_bounce`` drops the self-hit exclusion, since
    camera rays originate on no shape.
    ``lights`` with ``nee_samples`` = (ux, uy, upick, active) turns on
    next-event estimation; ``active`` is False at the final depth, where the
    BSDF walk could no longer collect the light."""
    o, d, tput, rad, alive, prev_shape, suppress, prev_pdf, prev_normal = state
    do_intersect = isect if isect is not None else _SWEEP
    hit = do_intersect(scene, o, d) if first_bounce else do_intersect(scene, o, d, prev=prev_shape)

    miss = alive & ~hit.mask
    is_emissive = hit.kind == MaterialKind.EMISSIVE
    emit_hit = alive & hit.mask & is_emissive
    scatter = alive & hit.mask & ~is_emissive

    bg = Vec3(scene.background[0], scene.background[1], scene.background[2])
    # Emissive surfaces emit only toward rays they face: (-n)·d > 0.
    emit_mask = emit_hit & (dot(hit.normal, d) < 0.0)
    emit_w = None  # MIS emission weight (physical + NEE)
    if lights is not None:
        from .nee import light_emission, nee_pdf_toward

        is_l = light_emission(lights, hit.shape)
        if physical:
            pdf_nee_prev = nee_pdf_toward(lights, o, hit.shape, d=d, t=hit.t, normal=prev_normal)
            w_b = prev_pdf / torch.clamp_min(prev_pdf + pdf_nee_prev, 1e-20)
            emit_w = torch.where(emit_mask, torch.where(is_l & (prev_pdf > 0.0), w_b, 1.0), 0.0)
        else:
            emit_mask = emit_mask & ~(suppress & is_l)

    if emit_w is not None:
        emis = tput.hadamard(hit.albedo)
        rad = Vec3(*(
            r + torch.where(miss, t * b, 0.0) + e * emit_w
            for r, t, b, e in zip(rad, tput, bg, emis)
        ))
    else:
        va, vb = tput.hadamard(bg), tput.hadamard(hit.albedo)
        rad = Vec3(*(
            r + torch.where(miss, a, 0.0) + torch.where(emit_mask, b, 0.0)
            for r, a, b in zip(rad, va, vb)
        ))

    diffuse = scatter & (hit.kind == MaterialKind.MATTE)
    glossy = scatter & (hit.kind == MaterialKind.GLOSSY)
    mirror = reflect(d, hit.normal) if physical else None

    def glossy_lobe(wd: Vec3):
        """(phong, pdf, dup) of the glossy strategy at direction ``wd``:
        max(r·wd, 0)^e, the lobe's density corrected for the below-horizon
        flip, and 1.0 where the flipped twin lies below the horizon."""
        rw = torch.clamp_min(mirror.x * wd.x + mirror.y * wd.y + mirror.z * wd.z, 0.0)
        phong = pow32(rw, hit.exponent)
        flipped = Vec3(2.0 * rw * mirror.x - wd.x, 2.0 * rw * mirror.y - wd.y, 2.0 * rw * mirror.z - wd.z)
        dup = torch.where(dot(hit.normal, flipped) < 0.0, 1.0, 0.0)
        pdf = (hit.exponent + 1.0) * _HALF_INV_PI * phong * (1.0 + dup)
        return phong, pdf, dup

    if lights is not None:
        from .nee import sample_light_dirs

        ux, uy, upick, nee_active = nee_samples
        ls = sample_light_dirs(lights, hit.point, ux, uy, upick, normal=hit.normal)
        cos_s = dot(hit.normal, ls.d)
        # The light's own ray-t by the sweep's sphere rule (a triangle light
        # carries its sampled point's t), then an any-hit fold over every
        # other shape; the shadow ray starts on hit.shape.
        if scene.unit_d:
            a_sh = inv_a_sh = None
        else:
            a_sh = dot(ls.d, ls.d)
            inv_a_sh = 1.0 / a_sh
        t_l, l_valid = sphere_t(hit.point, ls.d, a_sh, inv_a_sh, ls.center.x, ls.center.y, ls.center.z, ls.radius)
        t_sh = t_l
        if ls.tri_mask is not None:
            t_l = torch.where(ls.tri_mask, ls.tri_t, t_l)
            l_valid = torch.where(ls.tri_mask, ls.tri_t > _T_MIN, l_valid)
            # On triangle lanes only, the shadow ray stops a hair short: a
            # point on the shared edge of a two-triangle light could else be
            # shadowed by the neighbouring coplanar light triangle. Sphere
            # lanes keep the exact t_l (a relative shrink there would open a
            # light leak that grows with distance).
            t_sh = torch.where(ls.tri_mask, t_l * _TRI_SHADOW_SHRINK, t_l)
        lit = l_valid & ~do_intersect.occluded(scene, hit.point, ls.d, t_sh, ls.sidx, origin_idx=hit.shape)
        lit = lit & (cos_s > 0.0) & nee_active
        if physical:
            phong_l, pdf_g, _ = glossy_lobe(ls.d)
            pdf_b = torch.where(glossy, pdf_g, cos_s * _INV_PI)
            f_fac = torch.where(glossy, (hit.exponent + 2.0) * _HALF_INV_PI * phong_l, _INV_PI)
            w_nee = ls.pdf / torch.clamp_min(ls.pdf + pdf_b, 1e-20)
            fac = f_fac * cos_s * w_nee
            lit = lit & (diffuse | glossy)
        else:
            fac = _INV_TWO_PI
            lit = lit & diffuse
        contrib = tput.hadamard(hit.albedo).hadamard(ls.weight) * fac
        rad = Vec3(*(r + torch.where(lit, c, 0.0) for r, c in zip(rad, contrib)))
        suppress = diffuse

    wi = sample_directions(hit.kind, hit.exponent, hit.normal, d, sx, sy, physical=physical)
    new_tput = tput.hadamard(hit.albedo)
    if physical:
        # Glossy walk weight f·cos/pdf: (e+2)/(e+1) · cos / (1 + dup).
        _, pdf_gi, dup_i = glossy_lobe(wi)
        cos_i = torch.clamp_min(dot(hit.normal, wi), 0.0)
        tput_fac = torch.where(glossy, (hit.exponent + 2.0) / (hit.exponent + 1.0) * cos_i / (1.0 + dup_i), 1.0)
        new_tput = new_tput * tput_fac
        if lights is not None:
            prev_pdf = torch.where(glossy, pdf_gi, torch.where(diffuse, cos_i * _INV_PI, 0.0))
    tput = vwhere(scatter, new_tput, tput)
    o = vwhere(scatter, hit.point, o)
    d = vwhere(scatter, wi, d)
    prev_shape = torch.where(scatter, hit.shape, prev_shape)
    if prev_normal is not None:
        prev_normal = vwhere(scatter, hit.normal, prev_normal)
    return PathState(
        o=o, d=d, throughput=tput, radiance=rad, alive=scatter, prev_shape=prev_shape,
        suppress=suppress, prev_pdf=prev_pdf, prev_normal=prev_normal,
    )
