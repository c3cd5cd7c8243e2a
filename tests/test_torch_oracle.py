"""The port's float64 oracle (``flux_tpu_torch/oracle.py``) against the JAX
package's NumPy oracle, and the adjudication rule both packages' tests and
``chip_smoke.py`` share.

Both oracles compute in float64 in the same operation order, so their
samples agree to the last few ulp of the transcendental functions: the
bound is 1e-9·max(1, |value|) on every value of ``raw_samples``. A sample
may go another way only where a branch of its walk sits within 1e-12 of its
boundary in both oracles (``branch_margins``): at most one per frame, named
by the test. Each package loads a scene with its own loader (or generator);
the in-code scenes of tests/test_oracle.py cross by ``to_dict``.
"""

import importlib
import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from flux_tpu import genscene as jgenscene
from flux_tpu import oracle as joracle
from flux_tpu.camera import camera_arrays as j_camera_arrays
from flux_tpu.ops.nee import extract_lights as j_extract_lights
from flux_tpu.render import render_block_impl
from flux_tpu.samplers import hash as jhash
from flux_tpu.scene import compile_scene as j_compile_scene
from flux_tpu.scene import load_scene as j_load_scene
from flux_tpu_torch import genscene, oracle
from flux_tpu_torch.ops import brdf
from flux_tpu_torch.render import Renderer, render_block
from flux_tpu_torch.samplers import hash as thash
from flux_tpu_torch.samplers.patterns import bounce_point, cmj_point
from flux_tpu_torch.scene import SceneData, load_scene
from tests import test_oracle as j_audits
from tests.test_render import make_scene
from tests.test_torch_nee import carry_lights
from tests.test_torch_ops import carry_camera, carry_scene

HERE = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(HERE, "..", "scenes")
ti = importlib.import_module("flux_tpu_torch.ops.intersect")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: several workers share the CPU's cores under the
    tier-1 command, and the oracle's operations on a few hundred lanes gain
    nothing from more; with two, PyTorch's float64 sqrt on them woke a
    thread team at each call and took a thousand times longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _resized(sd, w, h):
    osx = sd.output_settings
    return replace(sd, output_settings=replace(osx, image_width=w, image_height=h,
                                               pixel_size=osx.pixel_size * osx.image_width / w))


def _stock(name, w=16, h=12):
    """(JAX, port) SceneData of a stock scene at w×h, field of view kept."""
    path = os.path.join(SCENES, f"{name}.yml")
    return _resized(j_load_scene(path), w, h), _resized(load_scene(path), w, h)


# ---- sample streams ---------------------------------------------------------


def test_sample_streams_bit_identical():
    """The port oracle's uint32 hashes, permutations and uniforms equal the
    JAX oracle's and the port samplers' bit for bit; its CMJ and bounce
    points equal the JAX oracle's (both float64) bit for bit, and the port
    samplers' float32 points to their rounding."""
    idx = np.arange(4096, dtype=np.uint32)
    pats = np.arange(4096, dtype=np.uint32) * np.uint32(2654435761)
    ti_, tp = torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(pats.astype(np.int64))

    mine = oracle._hash_combine(ti_, 0x1234, tp).numpy()
    np.testing.assert_array_equal(mine, joracle._hash_combine(idx, 0x1234, pats))
    np.testing.assert_array_equal(mine, thash.hash_combine(ti_, 0x1234, tp).numpy())
    np.testing.assert_array_equal(mine, np.asarray(jhash.hash_combine(idx, 0x1234, pats)))
    mine = oracle._permute_pow2(ti_, 64, tp).numpy()
    np.testing.assert_array_equal(mine, joracle._permute_pow2(idx, 64, pats))
    np.testing.assert_array_equal(mine, thash.permute_pow2(ti_, 64, tp).numpy())
    mine = oracle._randfloat(ti_, tp).numpy()
    np.testing.assert_array_equal(mine, joracle._randfloat(idx, pats))
    np.testing.assert_array_equal(mine, thash.randfloat(ti_, tp).numpy().astype(np.float64))

    s = np.arange(256, dtype=np.uint32)
    ts = torch.from_numpy(s.astype(np.int64))
    for root, pat in ((16, 0xABCD), (3, 0x77)):
        got = [c.numpy() for c in oracle._cmj_point(ts, root, pat)]
        want = joracle._cmj_point(s, root, pat)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(got, cmj_point(ts, root, pat)):
            np.testing.assert_allclose(g, w.numpy(), atol=4e-7)
        for depth in (1, 2):
            got = [c.numpy() for c in oracle._bounce_point(ts, root, pat, depth)]
            want = joracle._bounce_point(s, root, pat, depth)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            for g, w in zip(got, bounce_point(ts, root, pat, depth)):
                np.testing.assert_allclose(g, w.numpy(), atol=4e-7)


def test_frame_epsilons_are_the_float32_paths():
    """The oracle's frame-epsilon decimals round to the float32 path's."""
    assert tuple(float(np.float32(v)) for v in oracle._EM) == brdf._EM
    assert tuple(float(np.float32(v)) for v in oracle._EG) == brdf._EG


# ---- oracle_render against flux_tpu.oracle ----------------------------------


def _background_only():
    jsd = make_scene([], background=(0.25, 0.5, 0.75))
    return jsd, SceneData.from_dict(jsd.to_dict())


def _field40():
    return (jgenscene.sphere_field(40, seed=3, width=16, height=12),
            genscene.sphere_field(40, seed=3, width=16, height=12))


CASES = {
    "background_only": (_background_only, {}),
    "demo1": (lambda: _stock("demo1"), {}),
    "demo2": (lambda: _stock("demo2"), {}),
    "demo3_physical": (lambda: _stock("demo3"), dict(physical=True)),
    "demo2_nee": (lambda: _stock("demo2"), dict(nee=True)),
    "demo3_nee_physical": (lambda: _stock("demo3"), dict(nee=True, physical=True)),
    "demo5_nee": (lambda: _stock("demo5"), dict(nee=True)),
    "mesh_ico": (lambda: _stock("mesh_ico"), {}),
    "sphere_field_40": (_field40, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_oracle_render_matches_jax(case):
    """16x12, root 2, depth 3: every value of every sample within
    1e-9·max(1, |value|) of the NumPy oracle's, but for at most one sample a
    frame whose walk has a branch within 1e-12 of its boundary in both; the
    branch margins have the same infinities and agree to rtol 1e-6."""
    make, kw = CASES[case]
    jsd, tsd = make()
    want, want_m = joracle.oracle_render(jsd, 2, 3, seed=0, branch_margins=True, **kw)
    got, got_m = oracle.oracle_render(tsd, 2, 3, seed=0, branch_margins=True, device="cpu", **kw)
    assert got.dtype == got_m.dtype == torch.float64 and got.device.type == "cpu"
    got, got_m = got.numpy(), got_m.numpy()
    assert got.shape == want.shape == (4, 12, 16, 3) and got_m.shape == want_m.shape
    if case == "background_only":
        np.testing.assert_array_equal(got, np.broadcast_to([0.25, 0.5, 0.75], got.shape))
    off = (np.abs(got - want) > 1e-9 * np.maximum(1.0, np.abs(want))).any(-1)
    borderline = off & (got_m < 1e-12) & (want_m < 1e-12)
    assert not (off & ~borderline).any(), np.argwhere(off & ~borderline)[:10]
    assert borderline.sum() <= 1, np.argwhere(borderline)
    np.testing.assert_array_equal(np.isinf(got_m), np.isinf(want_m))
    fin = np.isfinite(want_m)
    np.testing.assert_allclose(got_m[fin], want_m[fin], rtol=1e-6)
    assert np.isfinite(got).all() and got.max() > 0


def test_oracle_frame_matches_jax():
    """The averaged, tone-mapped frame of several bands (rows_per_band 5
    over 12 rows), against the NumPy oracle's."""
    jsd, tsd = _stock("demo3")
    want = joracle.oracle_render(jsd, 2, 3, seed=5, nee=True, rows_per_band=5)
    got = oracle.oracle_render(tsd, 2, 3, seed=5, nee=True, rows_per_band=5, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


# ---- the precision audit on the port's float32 path -------------------------


def _port_scene_of(test):
    """The scene a tests/test_oracle.py audit renders, as the port's
    SceneData, with the audit's arguments."""
    seen = {}

    def capture(sd, root=8, depth=5, seed=1, **kw):
        seen.update(sd=SceneData.from_dict(sd.to_dict()), root=root, depth=depth, seed=seed, kw=kw)
        return {"mean_abs_diff": 0.0, "f32_mean": 0.0, "f64_mean": 0.0}

    mp = pytest.MonkeyPatch()
    mp.setattr("tests.test_oracle._audit", capture)
    try:
        test()
    finally:
        mp.undo()
    return seen


@pytest.mark.parametrize("test", [j_audits.test_f32_matches_f64_oracle_core_scene,
                                  j_audits.test_extreme_exponent_no_f32_cliff,
                                  j_audits.test_deep_recursion_no_f32_drift], ids=lambda t: t.__name__[5:])
def test_precision_audit_on_the_ports_renderer(test):
    """tests/test_oracle.py's audits of the float32 path, on the port's CPU
    Renderer against the port's oracle, at that file's gates."""
    a = _port_scene_of(test)
    r = Renderer(a["sd"], a["root"], a["depth"], seed=a["seed"], device="cpu", accel="sweep", **a["kw"])
    rep = oracle.precision_audit(a["sd"], a["root"], a["depth"], seed=a["seed"], renderer=r, **a["kw"])
    assert set(rep) == {"mean_abs_diff", "p99_abs_diff", "max_abs_diff", "f64_mean", "f32_mean"}
    assert rep["mean_abs_diff"] < 5e-3, rep
    assert abs(rep["f32_mean"] - rep["f64_mean"]) < 2e-3, rep
    assert rep["p99_abs_diff"] <= rep["max_abs_diff"]


# ---- adjudication -----------------------------------------------------------


def _port_samples(sd, spp, **kw):
    """The port's plain per-sample radiance, (spp, H, W, 3), on the CPU."""
    r = Renderer(sd, int(spp ** 0.5), kw.pop("max_depth"), seed=0, device="cpu", **kw)
    return torch.stack([r.render_rows_sum_range(0, r.height, s, 1) for s in range(spp)]).numpy()


def test_adjudicate_port_against_jax_eager():
    """demo3 with NEE and MIS at 16x12, root 2, depth 3: the port's plain
    samples against the JAX package's (render_block_impl, eager), each
    flip adjudicated by the port's oracle, each side within the budget."""
    jsd, tsd = _stock("demo3")
    jsc = j_compile_scene(jsd)
    jcam = j_camera_arrays(jsd.camera_settings, jsd.camera_data, jsd.output_settings.pixel_size)
    jl = j_extract_lights(jsd)
    kw = dict(img_w=16, img_h=12, n_rows=12, n_samples=1, root=2, max_depth=3, lights=jl, physical=True)
    jax_s = np.stack([np.asarray(render_block_impl(jsc, jcam, np.int32(0), np.uint32(s), np.uint32(0), **kw))
                      for s in range(4)])
    kw["lights"] = carry_lights(jl)
    port_s = np.stack([render_block(carry_scene(jsc), carry_camera(jcam), 0, s, 0, **kw).numpy()
                       for s in range(4)])
    oz = oracle.oracle_render(tsd, 2, 3, seed=0, nee=True, physical=True, raw_samples=True, device="cpu")
    verdict = oracle.adjudicate(port_s, jax_s, oz)
    assert verdict["ok"], verdict
    assert verdict["samples"] == 4 * 12 * 16 and verdict["budget"] == 7
    assert verdict["nan_a"] == verdict["nan_b"] == 0
    assert port_s.max() > 1.0  # the lights are in view of some samples


def test_adjudication_rejects_an_injected_epsilon_bug(monkeypatch):
    """tests/test_scan_parity.py's meta-test on the port: the plain
    sphere_t with a disc >= 0.03·R² guard (hits within about 1.5% of every
    silhouette dropped: few whole-path flips, no drift) is rejected by the
    adjudication, and the patched side is the one blamed."""
    sd = genscene.sphere_field(70, 4, width=32, height=16)
    kw = dict(max_depth=3, accel="sweep")
    clean = _port_samples(sd, 4, **kw)

    orig = ti.sphere_t

    def bugged(o, d, a, inv_a, cx, cy, cz, radius, on_self=None):
        t, valid = orig(o, d, a, inv_a, cx, cy, cz, radius, on_self=on_self)
        ocx, ocy, ocz = o.x - cx, o.y - cy, o.z - cz
        b_half = ocx * d.x + ocy * d.y + ocz * d.z
        c = ocx * ocx + ocy * ocy + ocz * ocz - radius * radius
        if on_self is not None:
            c = torch.where(on_self, 0.0, c)
        disc = b_half * b_half - (c if a is None else a * c)
        thr = 0.03 * radius * radius * (1.0 if a is None else a)
        return t, valid & (disc >= thr)

    monkeypatch.setattr(ti, "sphere_t", bugged)
    buggy = _port_samples(sd, 4, **kw)
    monkeypatch.undo()

    assert (np.abs(clean - buggy).max(-1) > 1e-5).sum() > 0, "injection produced no flips"
    oz = oracle.oracle_render(sd, 2, 3, seed=0, raw_samples=True, device="cpu")
    verdict = oracle.adjudicate(clean, buggy, oz)
    assert not verdict["ok"], verdict
    assert verdict["bad_b"] > verdict["budget"] >= verdict["bad_a"], verdict


def test_a_nan_sample_counts_as_off():
    """A NaN sample is off the oracle, a flip, and counted apart; with a
    tolerance scaled by the sample's magnitude, float32 rounding of a
    bright sample is not off."""
    rng = np.random.default_rng(0)
    oz = rng.random((2, 3, 4, 3)) * 0.5
    oz[0, 0, 0] = (40.0, 30.0, 20.0)
    a = oz.astype(np.float32)
    b = a.copy()
    b[0, 0, 0] += np.float32(0.01)  # 2.5e-4 of the sample's largest channel
    b[1, 2, 3, 1] = np.nan
    v = oracle.adjudicate(a, b, oz)
    assert (v["flips"], v["unadjudicated"], v["bad_a"], v["bad_b"], v["nan_a"], v["nan_b"]) == (2, 0, 0, 1, 0, 1)
    assert v["budget"] == 0 and not v["ok"]
    off = oracle.off_oracle(b, oz)
    assert int(off.sum()) == 1 and bool(off[1, 2, 3])
    both = oracle.adjudicate(b, b, oz)
    assert both["unadjudicated"] == 1 and both["nan_a"] == both["nan_b"] == 1 and not both["ok"]


def test_f64_audit_cli_on_the_cpu(capsys):
    """``python -m flux_tpu_torch.f64_audit`` with tools/f64_audit.py's flags
    and ``--device cpu``: its JSON report, the float64 mean equal to the
    NumPy oracle's frame's (--width/--height keep the pixel size, as that
    tool does)."""
    from flux_tpu_torch import f64_audit

    path = os.path.join(SCENES, "demo2.yml")
    assert f64_audit.main([path, "--root", "1", "--depth", "2", "--seed", "3", "--width", "16", "--height",
                           "12", "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert set(rep) == {"mean_abs_diff", "p99_abs_diff", "max_abs_diff", "f64_mean", "f32_mean"}
    jsd = j_load_scene(path)
    jsd = replace(jsd, output_settings=replace(jsd.output_settings, image_width=16, image_height=12))
    want = joracle.oracle_render(jsd, 1, 2, seed=3)
    assert rep["f64_mean"] == pytest.approx(float(want.mean()), rel=1e-12)
    assert rep["mean_abs_diff"] < 1e-3 and rep["f32_mean"] > 0
