"""The NaN that MIS sums into a few pixels, traced to its first non-finite
term and held to the same value in both packages.

Both packages sum a handful of MIS pixels to NaN: 10 of 19200 pixels of
``sphere_field(40)`` (160x120, root 4, depth 5, seed 1) and one pixel of
demo2 with a ring of 19 more planes (``genscene.plane_ring``). A sample's
path was followed through the port's plain bounce, and each case's lane is
replayed here from the state it reached, through one bounce of each
package on the CPU (``flux_tpu_torch.ops.shade.bounce`` and
``flux_tpu.ops.shade.bounce``, eagerly; no render program is compiled):

* sphere_field(40), pixel (row 22, col 29), sample 9: a grazing hit of a
  small mirror sphere (r 0.345, at t 33.8) has a normal of length² 1.0025
  (the float32 root near a tangent), so the reflected direction is of
  length² 1.0093. The field's directions count as unit (the a == 1
  quadratic), so the next hit, on a small glossy sphere (r 0.289, exponent
  50), lies off its surface: the normal's length² is 27.3, the mirror
  direction's 1837, ``rw`` about 42, and ``pow(rw, 50)`` is inf. Then
  ``f_fac`` and ``pdf_b`` are inf, ``w_nee = pdf / inf`` is 0, and the light
  sample's ``fac = f_fac · cos · w_nee`` is NaN in that same bounce.
* demo2 + 19 planes, pixel (row 297, col 136), sample 8: the ring's
  normals are of length √1.04 as authored, reflections off them leave
  directions of length² up to 1.04, and at demo2's glossy sphere
  (exponent 10000) ``rw`` = 1.0397: ``pow(rw, 10000)`` is inf, so the lane
  carries ``prev_pdf`` = inf, and at its next hit, the light,
  ``w_b = inf / (inf + pdf)`` is NaN. The replayed state is that last
  bounce's.

``rw`` is clamped from below only, in both packages; PERF.md names the
lines. The port keeps ``flux_tpu``'s value, NaN included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_tpu.ops import nee as jnee
from flux_tpu.ops.intersect import Intersector as JIntersector
from flux_tpu.ops.shade import PathState as JPathState
from flux_tpu.ops.shade import bounce as j_bounce
from flux_tpu.scene import SceneData as JSceneData
from flux_tpu.scene import compile_scene as j_compile_scene
from flux_tpu_torch import genscene
from flux_tpu_torch.ops.nee import extract_lights
from flux_tpu_torch.ops.shade import PathState, bounce
from flux_tpu_torch.scene import compile_scene, load_scene
from tests.test_torch_ops import jv, np_, tv

# Each lane's state at the bounce where its NaN appears, as the int32 bits
# of its float32 values: the ray, throughput, radiance so far, the shape it starts
# on, the MIS density and normal of its last vertex, the bounce sample
# (sx, sy) and the light sample (ux, uy, upick, whether NEE is still on).
LANES = {
    "sphere_field(40)": dict(
        o=(-1067888733, 1052984256, -1053675708), d=(1058666025, 1025039404, 1062062527),
        tput=(1057748943, 1041317505, 1044156210), rad=(0, 0, 0), prev_shape=16, prev_pdf=0,
        prev_normal=(1052414764, 1037600000, 1064121279), sx=1050302741, sy=1059219469,
        nee=(1051479580, 1060198411, 1057518007, True)),
    "demo2 + 19 planes": dict(
        o=(1058938272, 1073069408, 1072998560), d=(-1085079849, 1044068348, 1058170939),
        tput=(1026404141, 1019177021, 1021151548), rad=(1050488235, 1049996911, 1048748086), prev_shape=5,
        prev_pdf=2139095040, prev_normal=(-1094466368, 1064008384, -1112181248), sx=1017723336,
        sy=1057476097, nee=(1031920644, 1060746534, 1060300740, False)),
}


def _scene(case):
    if case == "sphere_field(40)":
        return genscene.sphere_field(40, seed=3, width=160, height=120)
    return genscene.plane_ring(load_scene("scenes/demo2.yml"), 19)


def _f(*bits):
    return np.array(bits, np.int64).astype(np.int32).view(np.float32)


@pytest.mark.parametrize("case", list(LANES))
def test_mis_nan_lane_matches_jax(case):
    sd = _scene(case)
    jsd = JSceneData.from_dict(sd.to_dict())
    sc, tl = compile_scene(sd, "cpu"), extract_lights(sd, "cpu")
    jsc, jl = j_compile_scene(jsd), jnee.extract_lights(jsd)
    s = LANES[case]
    o, d, tput, rad, nrm = (_f(*s[k])[:, None] for k in ("o", "d", "tput", "rad", "prev_normal"))
    prev, pdf = np.array([s["prev_shape"]], np.int32), _f(s["prev_pdf"])
    sx, sy = _f(s["sx"]), _f(s["sy"])
    ux, uy, up = _f(*s["nee"][:3])[:, None]
    active = s["nee"][3]
    # The lane's ray has drifted from unit length: where the NaN starts.
    assert abs(float((d * d).sum()) - 1.0) > 5e-3
    tstate = PathState(o=tv(*o), d=tv(*d), throughput=tv(*tput), radiance=tv(*rad),
                       alive=torch.ones(1, dtype=torch.bool), prev_shape=torch.from_numpy(prev),
                       suppress=torch.zeros(1, dtype=torch.bool), prev_pdf=torch.from_numpy(pdf), prev_normal=tv(*nrm))
    jstate = JPathState(o=jv(*o), d=jv(*d), throughput=jv(*tput), radiance=jv(*rad), alive=jnp.ones(1, bool),
                        prev_shape=jnp.asarray(prev), suppress=jnp.zeros(1, bool), prev_pdf=jnp.asarray(pdf),
                        prev_normal=jv(*nrm))
    tout = bounce(sc, tstate, torch.from_numpy(sx), torch.from_numpy(sy), lights=tl,
                  nee_samples=(torch.from_numpy(ux), torch.from_numpy(uy), torch.from_numpy(up), active), physical=True)
    jout = j_bounce(jsc, jstate, jnp.asarray(sx), jnp.asarray(sy), isect=JIntersector(mode="sweep"), lights=jl,
                    nee_samples=(jnp.asarray(ux), jnp.asarray(uy), jnp.asarray(up), active), physical=True)
    got = np.stack([c.numpy() for c in tout.radiance])
    want = np.stack([np_(c) for c in jout.radiance])
    assert np.isnan(got).all() and np.isnan(want).all()
    if case == "sphere_field(40)":
        # The glossy lobe overflowed: the density this lane carries on is inf
        # in both, and its throughput finite.
        assert np.isposinf(tout.prev_pdf.numpy()).all() and np.isposinf(np_(jout.prev_pdf)).all()
        assert np.isfinite(np.stack([c.numpy() for c in tout.throughput])).all()
        assert tout.prev_shape.numpy().tolist() == np_(jout.prev_shape).tolist()
    else:
        # The lane hit the light and ended there, in both.
        assert not tout.alive.numpy().any() and not np_(jout.alive).any()
