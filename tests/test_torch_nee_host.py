"""The sweep megakernel's fused sweep, compiled for the CPU with g++: the
scatter ray and a carried shadow ray in one loop over the shapes, against
the separate nearest and any-hit sweeps, bit for bit.

With NEE, csrc/flux_trace.cuh carries a light sample's shadow ray to the
next bounce, whose sweep takes it beside that bounce's ray from the same
point (``sweep_nearest_shadow``). The header compiles as host code against
the ``cuda_runtime.h`` stand-in in csrc/host/ (g++ -O2 -ffp-contract=off,
float32 arithmetic op by op as on the card); a small program loads a
scene record packed by :func:`flux_tpu_torch.ops.sweep_kernel.pack_scene`
and, for each ray, prints what ``sweep_nearest`` followed by
``sweep_occluded`` gives (the hit's t bits, its shape, the occluded flag)
and what the fused loop gives, which must be equal. The rays start on
demo2's and demo3's spheres and planes or off them, with the light's own
far end, shadow rays whose far end is exactly an occluder's t or the next
float beyond it, rays that graze a sphere or run along the plane they start
on, and a record with non-unit directions. The program also holds the
host's ``sincosf`` to its ``cosf`` and ``sinf`` over |δ| <= π, as the cone
sample calls it: that checks the host's libm only, and the card's own
``sincosf`` is held to its ``cosf`` and ``sinf`` by
tests/test_torch_cuda.py. Skips where g++ is missing.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from flux_tpu_torch.camera import camera_tensors
from flux_tpu_torch.ops.sweep_kernel import pack_scene
from flux_tpu_torch.scene import compile_scene, load_scene

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "flux_tpu_torch", "csrc")
SCENES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scenes")

# argv[1]: the packed scene record. stdin: one ray a line, "mode prev
# exclude" and the bits of o, d, ds; mode 0 no shadow ray, 1 the far end is
# the light sphere's own t (as the kernel's light sample sets it), 2 the
# shadow direction's nearest hit but the light's, 3 the next float beyond
# it. Prints "t b occ t' b' occ'" per ray. With no argument it reads float
# bits of δ and prints the bits of sincosf's and of cosf's and sinf's.
PROGRAM = r"""
#include <stdio.h>
#include "flux_trace.cuh"

static V3 v3(const unsigned* u) { return V3{__int_as_float((int)u[0]), __int_as_float((int)u[1]), __int_as_float((int)u[2])}; }

int main(int argc, char** argv) {
  if (argc < 2) {
    unsigned u;
    while (scanf("%u", &u) == 1) {
      const float x = __int_as_float((int)u);
      float s, c;
      sincosf(x, &s, &c);
      printf("%u %u %u %u\n", (unsigned)__float_as_int(c), (unsigned)__float_as_int(s),
             (unsigned)__float_as_int(cosf(x)), (unsigned)__float_as_int(sinf(x)));
    }
    return 0;
  }
  FILE* f = fopen(argv[1], "rb");
  if (f == nullptr || fread(&c_scene, sizeof(FluxScene), 1, f) != 1) return 2;
  fclose(f);
  int mode, prev, exclude;
  unsigned w[9];
  while (scanf("%d %d %d %u %u %u %u %u %u %u %u %u", &mode, &prev, &exclude, &w[0], &w[1], &w[2], &w[3], &w[4],
               &w[5], &w[6], &w[7], &w[8]) == 12) {
    const V3 o = v3(w), d = v3(w + 3), ds = v3(w + 6);
    float a = 1.0f, inv_a = 1.0f, as = 1.0f, inv_as = 1.0f;
    if (!c_scene.unit_d) {
      a = dot3(d, d);
      inv_a = 1.0f / a;
      as = dot3(ds, ds);
      inv_as = 1.0f / as;
    }
    float t_max = 0.0f;
    if (mode == 1) {
      sphere_t(o, ds, as, inv_as, c_scene.sph[exclude][0], c_scene.sph[exclude][1], c_scene.sph[exclude][2],
               c_scene.sph[exclude][3], false, &t_max);
    } else if (mode >= 2) {
      float t;
      int b;
      sweep_nearest(o, ds, as, inv_as, prev, &t, &b);
      t_max = mode == 2 ? t : nextafterf(t, __int_as_float(0x7f800000));
    }
    const bool shadow = mode != 0;
    float t1, t2;
    int b1, b2;
    bool occ2;
    sweep_nearest(o, d, a, inv_a, prev, &t1, &b1);
    const bool occ1 = shadow && sweep_occluded(o, ds, as, inv_as, t_max, exclude, prev);
    sweep_nearest_shadow(o, d, a, inv_a, prev, ds, as, inv_as, t_max, exclude, shadow, &t2, &b2, &occ2);
    printf("%u %d %d %u %d %d\n", (unsigned)__float_as_int(t1), b1, (int)occ1, (unsigned)__float_as_int(t2), b2,
           (int)occ2);
  }
  return 0;
}
"""


def _unit(v: np.ndarray) -> np.ndarray:
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _rays(h: dict, rng: np.random.Generator, n: int) -> list:
    """Rays from points on the scene's shapes (on prev) or off them, with a
    shadow ray of each mode toward a random sphere, a quarter of them
    grazing it, and some along the plane they start on."""
    c, r = h["sphere_center"].astype(np.float32), h["sphere_radius"].astype(np.float32)
    pp, pn = h["plane_point"].astype(np.float32), _unit(h["plane_normal"].astype(np.float64))
    ns, npl = len(r), len(pp)
    lines = []
    for k in range(n):
        prev = int(rng.integers(-1, ns + npl))
        if prev < 0:
            o = (c[int(rng.integers(1, ns))] + rng.normal(size=3) * 2.0).astype(np.float32)
        elif prev < ns:
            o = (c[prev] + _unit(rng.normal(size=3)) * r[prev]).astype(np.float32)
        else:
            j = prev - ns
            t = np.cross(pn[j], _unit(rng.normal(size=3)))
            # A hit point's rounding leaves it a hair off the plane.
            o = (pp[j] + t * rng.uniform(0.0, 6.0) + pn[j] * rng.normal() * 1e-6).astype(np.float32)
        d = _unit(rng.normal(size=3))
        mode = k % 4
        light = int(rng.integers(1, ns))
        exclude = light if k % 7 else ns + int(rng.integers(0, npl))  # sometimes a plane
        to_c = c[light].astype(np.float64) - o
        dist = np.linalg.norm(to_c)
        if k % 4 == 1 and dist > r[light] * 1.01:
            # Grazing: the cone's rim, tilted from the center line by asin(r / dist).
            axis = _unit(np.cross(to_c, rng.normal(size=3)))
            ang = np.arcsin(r[light] / dist) * (1.0 + rng.uniform(-1e-6, 1e-6))
            w = to_c / dist
            ds = _unit(w * np.cos(ang) + np.cross(axis, w) * np.sin(ang))
        else:
            ds = _unit(to_c + _unit(rng.normal(size=3)) * r[light] * rng.uniform(0.0, 1.0))
        if prev >= ns and k % 3 == 0:
            # Along the origin's plane, a hair off it: only the origin's
            # exclusion keeps the plane from stopping the shadow ray.
            j = prev - ns
            ds = _unit(np.cross(pn[j], _unit(rng.normal(size=3))) + pn[j] * rng.choice([-1e-4, 1e-4]))
        if mode == 1 and exclude >= ns:
            exclude = light  # the light's own t needs a sphere
        bits = np.concatenate([o, d, ds]).astype(np.float32).view(np.uint32)
        lines.append(" ".join(map(str, (mode, prev, exclude, *bits.tolist()))))
    return lines


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    tmp = tmp_path_factory.mktemp("nee_host")
    src = tmp / "nee.cpp"
    src.write_text(PROGRAM)
    exe = tmp / "nee"
    built = subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-I", os.path.join(CSRC, "host"),
                            "-I", CSRC, "-o", str(exe), str(src)], capture_output=True, text=True, timeout=120)
    assert built.returncode == 0, built.stderr
    return exe, tmp


@pytest.mark.parametrize("name, unit", [("demo2", True), ("demo3", True), ("demo3", False)])
def test_fused_sweep_matches_nearest_then_any_hit(program, name, unit):
    exe, tmp = program
    sd = load_scene(os.path.join(SCENES, f"{name}.yml"))
    sc = compile_scene(sd, "cpu")
    rec = pack_scene(sc, camera_tensors(sd.camera_settings, sd.camera_data, sd.output_settings.pixel_size, "cpu"))
    assert rec.unit_d == 1
    rec.unit_d = int(unit)  # 0: the a = d·d quadratic, on directions of length 1.5
    path = tmp / f"{name}-{int(unit)}.bin"
    path.write_bytes(bytes(rec))
    lines = _rays(sc.host, np.random.default_rng(5 if unit else 6), 1500)
    if not unit:
        scaled = []
        for ln in lines:
            f = ln.split()
            v = np.array(list(map(int, f[3:])), np.uint32).view(np.float32)
            v[3:] *= np.float32(1.5)
            scaled.append(" ".join(f[:3] + list(map(str, v.view(np.uint32).tolist()))))
        lines = scaled
    out = subprocess.run([str(exe), str(path)], input="\n".join(lines) + "\n", check=True, capture_output=True,
                         text=True, timeout=60).stdout
    got = np.array([list(map(int, ln.split())) for ln in out.splitlines()], np.int64)
    assert got.shape == (len(lines), 6)
    np.testing.assert_array_equal(got[:, 3:], got[:, :3])
    modes = np.array([int(ln.split()[0]) for ln in lines])
    hit = got[:, 0] != 0x7F800000
    occ = got[:, 2].astype(bool)
    # The cases are all there: hits and misses, occluded shadow rays and
    # clear ones, an occluder exactly at the far end (clear) and one float
    # before it (occluded), and no shadow ray without its flag.
    assert 0.2 < hit.mean() < 1.0
    assert not occ[modes == 0].any()
    assert occ[modes == 1].any() and not occ[modes == 1].all()
    assert occ[modes == 3].sum() > occ[modes == 2].sum()


def test_sincosf_matches_cosf_and_sinf(program):
    """The host's libm only: the card's sincosf is another function."""
    exe, _ = program
    x = np.linspace(-np.pi, np.pi, 20001, dtype=np.float64).astype(np.float32)
    pi = np.float32(np.pi)
    extra = np.array([0.0, -0.0, 1e-30, -1e-30, 1e-38, pi, -pi, np.nextafter(pi, np.float32(0)),
                      np.float32(np.pi / 2), np.float32(np.pi / 4)], np.float32)
    x = np.concatenate([x, extra])
    out = subprocess.run([str(exe)], input="\n".join(map(str, x.view(np.uint32).tolist())) + "\n", check=True,
                         capture_output=True, text=True, timeout=60).stdout
    got = np.array([list(map(int, ln.split())) for ln in out.splitlines()], np.int64)
    assert got.shape == (len(x), 4)
    np.testing.assert_array_equal(got[:, :2], got[:, 2:])
