"""The port's progressive renderer, checkpoints and CLI flags against
flux_tpu's: equal fingerprints, checkpoints that pass between the two
packages in both directions, the same adaptive stop signal, and the CLI's
--progressive/--checkpoint/--resume/--adaptive path on the CPU.

Radiance sums of the two packages differ by a few ulp (see
tests/test_torch_nee.py), so sums are compared at rtol 1e-4; checkpoints
written and read within the port compare bit for bit.
"""

import functools
import os

import numpy as np
import pytest
import yaml

from flux_tpu import checkpoint as jcp
from flux_tpu.camera import camera_arrays as j_camera_arrays
from flux_tpu.ops.nee import extract_lights as j_extract_lights
from flux_tpu.render import render_block_impl
from flux_tpu.scene import compile_scene as j_compile_scene
from flux_tpu.scene import load_scene as j_load_scene
from flux_tpu_torch import checkpoint as cp
from flux_tpu_torch import cli
from flux_tpu_torch.scene import SceneData, load_scene

HERE = os.path.dirname(os.path.abspath(__file__))
SCENE_DIR = os.path.join(HERE, "..", "scenes")
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


@functools.lru_cache(maxsize=None)
def _loaded(name):
    path = os.path.join(SCENE_DIR, name)
    return j_load_scene(path), load_scene(path)


# Every stock scene: sweep scenes, the scan scene and the triangle scenes.
STOCK_SCENES = [name for name in sorted(os.listdir(SCENE_DIR)) if name.endswith(".yml")]


@pytest.mark.parametrize("nee, physical", FLAGS, ids=["ref", "nee", "physical", "mis"])
@pytest.mark.parametrize("name", STOCK_SCENES)
def test_fingerprint_equals_jax(name, nee, physical):
    jsd, sd = _loaded(name)
    assert cp._config_fingerprint(sd, 32, 5, 7, nee=nee, physical=physical) == jcp._config_fingerprint(
        jsd, 32, 5, 7, nee=nee, physical=physical)


@pytest.fixture(scope="module")
def tiny3(tmp_path_factory):
    """demo3 at 16x12 with its field of view kept, as a scene file."""
    doc = yaml.safe_load(open(os.path.join(SCENE_DIR, "demo3.yml")).read())
    doc["output_settings"].update(image_width=16, image_height=12, pixel_size=800 / 16)
    path = tmp_path_factory.mktemp("scenes") / "tiny3.yml"
    path.write_text(yaml.safe_dump(doc))
    return str(path)


ROOT, DEPTH, SEED = 2, 3, 5


def _mostly_close(got, want):
    """The cross-package gate on sums: 99% of values within rtol 1e-4 (a
    sample may take a borderline branch the other way)."""
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} values differ"


@functools.lru_cache(maxsize=None)
def _jax_sums(path, s0, n=2):
    """flux_tpu's eager NEE + physical sums with stats over the whole tiny
    frame, samples [s0, s0 + n) (one launch shape, compiled once)."""
    sd = j_load_scene(path)
    w, h = sd.output_settings.image_width, sd.output_settings.image_height
    cam = j_camera_arrays(sd.camera_settings, sd.camera_data, sd.output_settings.pixel_size)
    return np.asarray(render_block_impl(
        j_compile_scene(sd), cam, np.int32(0), np.uint32(s0), np.uint32(SEED), img_w=w, img_h=h,
        n_rows=h, n_samples=n, root=ROOT, max_depth=DEPTH, with_stats=True,
        lights=j_extract_lights(sd), physical=True,
    ))


def _port(path):
    return cp.ProgressiveRenderer(load_scene(path), ROOT, DEPTH, seed=SEED, device="cpu", nee=True,
                                  physical=True)


def test_jax_checkpoint_resumes_in_the_port(tiny3, tmp_path):
    """A checkpoint flux_tpu wrote from its sums over samples [0, 2)
    resumes in the port, which finishes [2, 4) to flux_tpu's full sums
    (its two passes added, as its ProgressiveRenderer adds them)."""
    path = tiny3
    first = _jax_sums(path, 0)
    ck = str(tmp_path / "jax.npz")
    fp = jcp._config_fingerprint(j_load_scene(path), ROOT, DEPTH, SEED, nee=True, physical=True)
    jcp.save_checkpoint(ck, first[..., :3], 2, fp, first[..., 3])
    pr = _port(path)
    assert pr.fingerprint == fp
    pr.resume(ck)
    assert pr.samples_done == 2 and not pr.complete
    assert pr.render_pass(8) == 2 and pr.complete
    full = first + _jax_sums(path, 2)
    _mostly_close(pr.acc, full[..., :3])
    _mostly_close(pr.lum_sq, full[..., 3])


def test_port_checkpoint_loads_in_jax(tiny3, tmp_path):
    path = tiny3
    pr = _port(path)
    pr.render_pass(2)
    ck = str(tmp_path / "port.npz")
    pr.save(ck)
    acc, done, fp, lum_sq, valid = jcp.load_checkpoint(ck)
    assert fp == jcp._config_fingerprint(j_load_scene(path), ROOT, DEPTH, SEED, nee=True, physical=True)
    assert done == 2 and valid
    np.testing.assert_array_equal(acc, pr.acc)
    np.testing.assert_array_equal(lum_sq, pr.lum_sq)
    _mostly_close(acc, _jax_sums(path, 0)[..., :3])


def test_checkpoints_interchange_on_a_triangle_scene(tmp_path):
    """mesh_ico at 12x9 (320 triangles under the sweep, the scene
    megakernel's route): a checkpoint the port wrote after one pass loads in
    flux_tpu under an equal fingerprint, and one flux_tpu wrote resumes in
    the port, which finishes it to the sums of an uninterrupted render."""
    doc = yaml.safe_load(open(os.path.join(SCENE_DIR, "mesh_ico.yml")).read())
    doc["output_settings"].update(image_width=12, image_height=9, pixel_size=800 / 12)
    path = str(tmp_path / "tinymesh.yml")
    open(path, "w").write(yaml.safe_dump(doc))
    fp = jcp._config_fingerprint(j_load_scene(path), ROOT, DEPTH, SEED, nee=True, physical=True)
    pr = _port(path)
    assert pr.fingerprint == fp and pr._r.scene.num_triangles == 320 and not pr._r.uses_sweep_kernel
    assert pr.render_pass(2) == 2
    ck = str(tmp_path / "port.npz")
    pr.save(ck)
    acc, done, got_fp, lum_sq, valid = jcp.load_checkpoint(ck)
    assert (done, got_fp, valid) == (2, fp, True)
    np.testing.assert_array_equal(acc, pr.acc)
    jck = str(tmp_path / "jax.npz")
    jcp.save_checkpoint(jck, acc, done, fp, lum_sq)  # as flux_tpu writes it
    resumed = _port(path)
    resumed.resume(jck)
    assert resumed.samples_done == 2 and resumed.render_pass(8) == 2 and resumed.complete
    whole = _port(path)
    whole.render_pass(2)
    whole.render_pass(2)
    np.testing.assert_array_equal(resumed.acc, whole.acc)
    np.testing.assert_array_equal(resumed.lum_sq, whole.lum_sq)
    assert np.isfinite(whole.acc).all() and whole.acc.max() > 0


@pytest.mark.parametrize("percentile", [50.0, 99.0])
def test_max_rel_stderr_equals_jax(tiny3, tmp_path, percentile):
    """The adaptive stop signal from the same accumulators, bit for bit."""
    path = tiny3
    rng = np.random.default_rng(int(percentile))
    acc = rng.gamma(2.0, 3.0, size=(12, 16, 3)).astype(np.float32)
    lum_sq = (acc.sum(-1) ** 2 * rng.uniform(0.05, 0.5, size=(12, 16))).astype(np.float32)
    ck = str(tmp_path / "stats.npz")
    fp = cp._config_fingerprint(load_scene(path), ROOT, DEPTH, SEED, nee=True, physical=True)
    cp.save_checkpoint(ck, acc, 3, fp, lum_sq)
    pr = _port(path)
    pr.resume(ck)
    jpr = jcp.ProgressiveRenderer(j_load_scene(path), ROOT, DEPTH, seed=SEED, nee=True, physical=True)
    jpr.resume(ck)
    assert pr.max_rel_stderr(percentile) == jpr.max_rel_stderr(percentile)
    np.testing.assert_array_equal(pr.peek(), np.asarray(jpr.peek()))


def test_resume_refuses_another_configuration(tiny3, tmp_path):
    path = tiny3
    pr = _port(path)
    pr.render_pass(1)
    ck = str(tmp_path / "a.npz")
    pr.save(ck)
    other = cp.ProgressiveRenderer(load_scene(path), ROOT, DEPTH, seed=SEED, device="cpu", nee=True)
    with pytest.raises(ValueError, match="different"):
        other.resume(ck)


def test_cli_progressive_checkpoint_resume_adaptive(tiny3, tmp_path, capsys):
    """The CLI's --nee --physical --progressive --checkpoint path on the
    CPU: its status lines; a run resumed from a 2-pass checkpoint ends on
    the accumulator of an uninterrupted run, bit for bit; --adaptive stops
    at the first pass whose p99 relative stderr is below the target."""
    path = tiny3
    base = [path, "-r", str(ROOT), "-d", str(DEPTH), "--seed", str(SEED), "--nee", "--physical",
            "--device", "cpu", "--output-dir", str(tmp_path / "out")]
    whole = str(tmp_path / "whole.npz")
    ran = cli.run(base + ["--progressive", "1", "--checkpoint", whole])
    out = capsys.readouterr().out
    assert out.count("pass done: ") == 4 and "pass done: 4/4 spp" in out and "p99 rel stderr" in out
    assert ran["spp_done"] == 4 and ran["samples"] == 16 * 12 * 4
    assert ran["out"].endswith("demo3.ppm") and os.path.exists(ran["out"])

    part = str(tmp_path / "part.npz")
    pr = _port(path)
    pr.render_pass(1)
    pr.render_pass(1)
    pr.save(part)
    resumed = cli.run(base + ["--progressive", "1", "--checkpoint", part, "--resume"])
    out = capsys.readouterr().out
    assert "resumed at 2/4 spp" in out and out.count("pass done: ") == 2
    assert resumed["samples"] == 16 * 12 * 2
    a, b = cp.load_checkpoint(whole), cp.load_checkpoint(part)
    assert a[1] == b[1] == 4 and a[2] == b[2]
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[3], b[3])

    stop = cli.run(base + ["--progressive", "1", "--adaptive", "1e9"])
    out = capsys.readouterr().out
    assert "adaptive stop: noise target 1000000000.0 reached at 2/4 spp" in out
    assert stop["spp_done"] == 2 and stop["p99_rel_stderr"] is not None


def test_scene_to_dict_keeps_jax_types():
    """The fingerprint hashes SceneData.to_dict() as JSON, so every value
    must have the JAX package's Python type (an int where JAX has a float
    changes the hash)."""
    jsd, sd = _loaded("demo3.yml")

    def types(x):
        if isinstance(x, dict):
            return {k: types(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [types(v) for v in x]
        return type(x).__name__

    assert types(SceneData.to_dict(sd)) == types(jsd.to_dict())
