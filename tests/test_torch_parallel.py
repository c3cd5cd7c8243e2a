"""The port's device mesh (``flux_tpu_torch.parallel``) on CPU shards,
against ``flux_tpu.parallel`` and the port's single-device ``Renderer``.

On the CPU every slot of a mesh is the CPU (``[cpu] * n``), the counterpart
of ``flux_tpu``'s eight virtual CPU devices. Rows-only meshes are held bit
for bit to the ``Renderer`` (radiance, Σ luminance², progressive passes,
adaptive stops and checkpoints both ways), meshes with sample shards at
atol 1e-5 (their partial sums associate differently: ``flux_tpu``'s gate,
tests/test_sharding.py), frames at the goldens' atol 5e-3, and a band
against ``flux_tpu``'s eager ``render_block_impl`` at the port's tolerance
(tests/test_torch_render.py). No JAX render program is compiled.
"""

import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import replace

import numpy as np
import pytest
import torch
import yaml

from flux_tpu.camera import camera_arrays as j_camera_arrays
from flux_tpu.parallel import mesh as j_mesh
from flux_tpu.render import render_block_impl
from flux_tpu.scene import MaterialData, MaterialKind, PlaneData, SphereData
from flux_tpu.scene import compile_scene as j_compile_scene
from flux_tpu.scene import load_scene as j_load_scene
from flux_tpu_torch import cli, genscene, node
from flux_tpu_torch.checkpoint import ProgressiveRenderer
from flux_tpu_torch.job import Job, JobConfiguration, JobID
from flux_tpu_torch.ops.sweep_kernel import launch_plan
from flux_tpu_torch.parallel import MeshRenderer, local_devices, make_mesh, pick_mesh_shape
from flux_tpu_torch.parallel import mesh as t_mesh
from flux_tpu_torch.render import Renderer
from flux_tpu_torch.scene import SceneData
from flux_tpu_torch.workers import LocalWorker, default_renderer_factory
from tests.test_render import env_sphere, make_scene
from tests.test_torch_job import REPO, WAIT, band_loop, run_job, tiny_doc, tiny_scene
from tests.test_torch_node import CFG, free_port, net_worker, serving
from tests.test_torch_ops import carry_camera, carry_scene

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs several workers on the CPU's cores, and PyTorch's
    intra-op threads in each spin against the others' on the scan's many
    small operations (the field96 frame took 155 s so under the tier-1
    command, 1 s alone). The renders' bits do not depend on the thread
    count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def cpus(n):
    return [CPU] * n


def port(jsd):
    return SceneData.from_dict(jsd.to_dict())


def glossy_scene():
    """tests/test_progressive_mesh.py's scene at 28x16 (a row is no whole
    number of vector lanes): a glossy ball (pow in every bounce) on a matte
    floor under an environment sphere."""
    floor = PlaneData(point=(0.0, 0.0, 0.0), normal=(0.0, 1.0, 0.0),
                      material=MaterialData(kind=MaterialKind.MATTE, color=(0.5, 0.5, 0.5), param=1.0))
    ball = SphereData(center=(0.0, 1.0, 0.0), radius=1.0, material=MaterialData(
        kind=MaterialKind.GLOSSY, color=(0.9, 1.0, 0.9), param=0.9, exponent=100.0))
    return port(make_scene([env_sphere(1.0), floor, ball], w=28, h=16))


def demo_small(name, w, h):
    """A stock scene at w x h with its field of view kept, as the JAX and
    the port's SceneData."""
    jsd = j_load_scene(os.path.join(HERE, "..", "scenes", f"{name}.yml"))
    jsd = replace(jsd, output_settings=replace(
        jsd.output_settings, image_width=w, image_height=h,
        pixel_size=jsd.output_settings.pixel_size * jsd.output_settings.image_width / w))
    return jsd, port(jsd)


def single(sd, root=4, depth=3, seed=11, **kw):
    return Renderer(sd, root, depth, seed=seed, device="cpu", target_lanes=1 << 12, **kw)


def meshed(sd, rows, spp, root=4, depth=3, seed=11, **kw):
    return MeshRenderer(sd, root, depth, seed=seed, mesh=make_mesh(cpus(rows * spp), rows_shards=rows,
                        spp_shards=spp), target_lanes=1 << 12, **kw)


def bits(t):
    return np.asarray(t).view(np.int32)


# ---- the mesh's shape ---------------------------------------------------------

HINTS = [(0, 0), (600, 800), (4 * j_mesh.ROWS_LANE_BUDGET // 800, 800), (2 * j_mesh.ROWS_LANE_BUDGET, 1),
         (16, 32)]


@pytest.mark.parametrize("n", range(1, 9))
def test_pick_mesh_shape_equals_jax(n):
    assert t_mesh.ROWS_LANE_BUDGET == j_mesh.ROWS_LANE_BUDGET
    for rows, cols in HINTS:
        assert pick_mesh_shape(n, rows, cols) == j_mesh.pick_mesh_shape(n, rows, cols)


MESH_ARGS = [dict(rows_shards=r, spp_shards=s) for r in (1, 2, 3, 4, 8, 16) for s in (None, 1, 2, 4, 8)] + [
    dict(rows_shards=None, n_rows_hint=h, n_cols_hint=w) for h, w in HINTS] + [
    dict(rows_shards=None, spp_shards=2, n_rows_hint=4 * j_mesh.ROWS_LANE_BUDGET // 800, n_cols_hint=800)]


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_equals_jax(devices8, n):
    """The same shapes, and the same ValueErrors, over 1-8 devices."""
    for kw in MESH_ARGS:
        try:
            want = dict(j_mesh.make_mesh(devices8[:n], **kw).shape)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                make_mesh(cpus(n), **kw)
            assert str(got.value) == str(e), kw
            continue
        m = make_mesh(cpus(n), **kw)
        assert m.shape == want, kw
        assert m.owned() == m.slots() and len(m.slots()) == m.size


def test_local_devices_on_the_cpu():
    assert local_devices("cpu") == [CPU]
    assert local_devices("cpu", 4) == cpus(4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            local_devices()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


# ---- rows-only meshes: the Renderer's bits --------------------------------------


@pytest.mark.parametrize("rows", [8, 4, 2])
def test_rows_mesh_bit_equal_to_the_renderer(rows):
    """Radiance and Σ luminance² of aligned and unaligned sample ranges,
    and a 13-row band (uneven over the shards: padding rows rendered, then
    cropped), equal the single device's bit for bit."""
    sd = glossy_scene()
    r1, rm = single(sd), meshed(sd, rows, 1)
    for row0, n_rows in [(0, 16), (2, 13)]:
        for s0, n in [(0, 5), (5, 11), (0, 16), (13, 3)]:
            a = r1.render_rows_sum_range(row0, n_rows, s0, n, with_stats=True)
            b = rm.render_rows_sum_range(row0, n_rows, s0, n, with_stats=True)
            assert b.shape == (n_rows, 28, 4)
            np.testing.assert_array_equal(bits(a), bits(b), err_msg=f"band {row0}+{n_rows}, range ({s0}, {n})")
    np.testing.assert_array_equal(r1.render_image(), rm.render_image())


def test_rows_mesh_keeps_the_bands_cut():
    """The split hazard: a row shard has fewer pixels than its band, so its
    own launch would be cut otherwise (the split on the card, the sample
    chunks here, both from the launch's shape). A shard takes its band's
    cut, and the bits stay the band's."""
    sd = glossy_scene()
    n_rows, rows, n = 13, 4, 17
    r1, rm = single(sd), meshed(sd, rows, 1)
    n_local = -(-n_rows // rows)
    assert r1._chunk_size(n_rows, n) != r1._chunk_size(n_local, n)
    # A band of demo2's width whose card launch plan is not its shards'.
    assert launch_plan(16 * 800, 17).split != launch_plan(4 * 800, 17).split
    a = r1.render_rows_sum_range(1, n_rows, 2, n, with_stats=True)
    b = rm.render_rows_sum_range(1, n_rows, 2, n, with_stats=True)
    np.testing.assert_array_equal(bits(a), bits(b))


def test_thirteen_rows_over_eight_shards():
    sd = glossy_scene()
    a = single(sd, root=2).render_rows(3, 13)
    b = meshed(sd, 8, 1, root=2).render_rows(3, 13)
    np.testing.assert_array_equal(a, b)


# ---- meshes with sample shards: float32 rounding --------------------------------


@pytest.mark.parametrize("rows, spp", [(1, 8), (2, 4), (4, 2)])
def test_spp_meshes_within_atol(rows, spp):
    sd = glossy_scene()
    r1, rm = single(sd), meshed(sd, rows, spp)
    np.testing.assert_allclose(rm.render_image(), r1.render_image(), rtol=0, atol=1e-5)
    for s0, n in [(0, 5), (5, 11)]:
        a = r1.render_rows_sum_range(0, 16, s0, n, with_stats=True).numpy()
        b = rm.render_rows_sum_range(0, 16, s0, n, with_stats=True).numpy()
        np.testing.assert_allclose(b, a, rtol=2e-6, atol=2e-6)


def test_root3_over_eight_spp_shards():
    """9 samples over 8 shards: 2 a shard, the fifth masked at 9, the last
    three wholly past it, which add exact zeros: the (1,8) mesh equals the
    (1,5) mesh bit for bit, and the single device to float32 rounding."""
    sd = glossy_scene()
    m8, m5 = meshed(sd, 1, 8, root=3), meshed(sd, 1, 5, root=3)
    a = m8.render_rows_sum(0, 16)
    np.testing.assert_array_equal(bits(a), bits(m5.render_rows_sum(0, 16)))
    np.testing.assert_allclose(a.numpy(), single(sd, root=3).render_rows_sum(0, 16).numpy(), rtol=2e-6, atol=2e-6)
    rows, px = m8.render_rows_local(0, 16)
    assert rows.tolist() == list(range(16))
    np.testing.assert_array_equal(px, m8.render_rows(0, 16))


def test_sample_ranges_stay_inside_uint32():
    """Sample indices and limits are uint32 in the kernels (the wrapper
    passes ``s_limit & 0xFFFFFFFF``): a range reaching 2^32 is refused, not
    wrapped to a limit of 0."""
    rm = meshed(glossy_scene(), 1, 2, root=2)
    with pytest.raises(ValueError, match="uint32"):
        rm.render_rows_sum_range(0, 4, (1 << 32) - 2, 2)
    assert rm.render_rows_sum_range(0, 4, (1 << 32) - 3, 2).shape == (4, 28, 3)


def test_render_rows_local_covers_the_band():
    """Each row shard's global rows (stride rows_shards), finalized by the
    numpy finalize, bit-equal to the frame's rows."""
    sd = glossy_scene()
    rm = meshed(sd, 4, 2, root=2)
    rows, px = rm.render_rows_local(1, 14)
    assert sorted(rows.tolist()) == list(range(1, 15))
    np.testing.assert_array_equal(px, rm.render_rows(1, 14)[rows - 1])


# ---- progressive, adaptive and checkpointed renders on a rows mesh ----------------


def test_progressive_on_a_rows_mesh_matches_one_device():
    """Passes, moments, the adaptive signal and the image bit for bit (the
    model: tests/test_progressive_mesh.py)."""
    sd = glossy_scene()
    p1 = ProgressiveRenderer.from_renderer(single(sd))
    pm = ProgressiveRenderer.from_renderer(meshed(sd, 8, 1))
    assert p1.fingerprint == pm.fingerprint
    while not p1.complete:
        assert p1.render_pass(5) == pm.render_pass(5)
        np.testing.assert_array_equal(p1.acc, pm.acc)
        np.testing.assert_array_equal(p1.lum_sq, pm.lum_sq)
        assert p1.max_rel_stderr() == pm.max_rel_stderr()
    assert pm.complete
    np.testing.assert_array_equal(p1.peek(), pm.peek())


@pytest.mark.parametrize("first", ["mesh", "single"])
def test_checkpoints_interchange_between_mesh_and_one_device(tmp_path, first):
    """A checkpoint written by one resumes in the other, and the finished
    accumulators equal an uninterrupted single-device render bit for bit."""
    sd = glossy_scene()
    make = {"mesh": lambda: meshed(sd, 4, 1), "single": lambda: single(sd)}
    second = "single" if first == "mesh" else "mesh"
    a = ProgressiveRenderer.from_renderer(make[first]())
    a.render_pass(6)
    ck = str(tmp_path / "ck.npz")
    a.save(ck)
    b = ProgressiveRenderer.from_renderer(make[second]())
    b.resume(ck)
    assert b.samples_done == 6
    while not b.complete:
        b.render_pass(6)
    whole = ProgressiveRenderer.from_renderer(single(sd))
    while not whole.complete:
        whole.render_pass(6)
    np.testing.assert_array_equal(b.acc, whole.acc)
    np.testing.assert_array_equal(b.lum_sq, whole.lum_sq)


def test_adaptive_stop_is_the_same_pass():
    sd = glossy_scene()
    stops = []
    for r in (single(sd, root=8), meshed(sd, 2, 1, root=8)):
        pr = ProgressiveRenderer.from_renderer(r)
        while not pr.complete:
            pr.render_pass(4)
            err = pr.max_rel_stderr()
            if err is not None and err < 0.35:
                break
        stops.append((pr.samples_done, err))
    assert stops[0] == stops[1] and stops[0][0] < 64


# ---- against flux_tpu: goldens, an eager band, flux_tpu's arrays -------------------


@pytest.mark.parametrize("name", ["demo1", "demo2", "field96"])
def test_mesh_frame_matches_the_golden(name):
    """A (2, 2) mesh at 80x60, root 4, depth 5, seed 42, held to the JAX
    package's goldens at tests/test_golden.py's gate: atol 5e-3, mean within
    1e-3. The 96-sphere field (the scan) takes tests/test_torch_scan.py's
    gate for the port's own frame there, 99.5% of values within 5e-3 (a
    grazing sample flips its path on an ulp; that test adjudicates each
    against the float64 oracle)."""
    if name == "field96":
        sd = genscene.sphere_field(96, seed=7, width=80, height=60)
        sd = replace(sd, output_settings=replace(sd.output_settings, pixel_size=10.0))
    else:
        sd = demo_small(name, 80, 60)[1]
    img = MeshRenderer(sd, 4, 5, seed=42, mesh=make_mesh(cpus(4), rows_shards=2, spp_shards=2)).render_image()
    golden = np.load(os.path.join(HERE, f"golden_{name}_80x60_r4_s42.npy"))
    assert img.shape == golden.shape and np.isfinite(img).all()
    assert abs(float(img.mean()) - float(golden.mean())) < 1e-3
    if name != "field96":
        np.testing.assert_allclose(img, golden, atol=5e-3)
        return
    d = np.abs(img - golden)
    assert (d <= 5e-3).mean() >= 0.995, f"{(d > 5e-3).sum()} of {d.size} values off by more than 5e-3"
    assert d.max() <= 2.0 / 16


def test_mesh_on_flux_tpus_arrays_matches_its_eager_render_block():
    """flux_tpu's compile_scene and camera arrays, carried into every slot's
    scene by ``scene_from_numpy``/``camera_from_numpy``; a (2, 2) mesh's
    16x12 band against flux_tpu's eager render_block_impl, at
    tests/test_torch_render.py's tolerance."""
    jsd, sd = demo_small("demo2", 16, 12)
    jsc = j_compile_scene(jsd)
    jcam = j_camera_arrays(jsd.camera_settings, jsd.camera_data, jsd.output_settings.pixel_size)
    rm = MeshRenderer(sd, 2, 3, seed=3, mesh=make_mesh(cpus(4), rows_shards=2, spp_shards=2))
    for r in rm._renderers.values():
        r.scene, r.cam = carry_scene(jsc), carry_camera(jcam)
    got = rm.render_rows_sum(0, 12).numpy()
    want = np.asarray(render_block_impl(jsc, jcam, np.int32(0), np.uint32(0), np.uint32(3), img_w=16, img_h=12,
                                        n_rows=12, n_samples=4, root=2, max_depth=3))
    assert got.shape == want.shape == (12, 16, 3)
    close = np.isclose(got, want, rtol=1e-5, atol=1e-6)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} values differ"


def test_mesh_with_nee_and_triangles_matches_the_renderer():
    """The scene kernel's path (the Cornell box's triangles and triangle
    light, MIS) on a rows mesh: the Renderer's bits."""
    sd = demo_small("demo5", 16, 13)[1]
    kw = dict(root=2, depth=3, seed=5, nee=True, physical=True)
    a = single(sd, **kw).render_rows_sum_range(0, 13, 1, 3, with_stats=True)
    b = meshed(sd, 4, 1, **kw).render_rows_sum_range(0, 13, 1, 3, with_stats=True)
    np.testing.assert_array_equal(bits(a), bits(b))


# ---- the CLI's -t and --rows-shards, the node's -t ---------------------------------


def _cli(tmp_path, scene_file, tag, *flags, root="2"):
    out = tmp_path / tag
    ran = cli.run([str(scene_file), "-r", root, "-d", "3", "-R", "5", "--seed", "2", "--device", "cpu",
                   "--output-dir", str(out), *flags])
    assert ran.get("error") is None
    return ran, (out / "demo2.ppm").read_bytes()


@pytest.fixture
def scene_file(tmp_path):
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(tiny_doc(w=20, h=13)))
    return path


def test_cli_rows_mesh_writes_the_single_devices_bytes(tmp_path, scene_file, capsys):
    """``--device cpu -t 4 --rows-shards 4``: a (4, 1) mesh behind the
    local worker, whose PPM is ``-t 1``'s byte for byte."""
    _, one = _cli(tmp_path, scene_file, "one", "-t", "1")
    ran, four = _cli(tmp_path, scene_file, "four", "-t", "4", "--rows-shards", "4")
    assert "Devices: 4 (cpu)" in capsys.readouterr().out
    assert ran["units_by_worker"] == {"local": 3}
    assert four == one


def test_cli_mesh_with_spp_shards(tmp_path, scene_file):
    """``-t 4 --rows-shards 2``: a (2, 2) mesh. At root 1 the second spp
    shard of each row lies past the one sample and adds exact zeros, so the
    bytes are ``-t 1``'s; at root 2 the two shards' partial sums associate
    otherwise than one device's sum (float32 rounding), so a 16-bit level
    may move by one."""
    for root in ("1", "2"):
        _, one = _cli(tmp_path, scene_file, f"one{root}", "-t", "1", root=root)
        _, mesh = _cli(tmp_path, scene_file, f"mesh{root}", "-t", "4", "--rows-shards", "2", root=root)
        if root == "1":
            assert mesh == one
        else:
            a, b = (np.array(p.split()[4:], np.int64) for p in (one, mesh))
            assert one[:20] == mesh[:20] and np.abs(a - b).max() <= 1


def test_cli_progressive_on_two_devices_writes_one_devices_bytes(tmp_path, scene_file, capsys):
    """``--progressive`` with ``-t 2`` defaults to rows-only sharding:
    the same passes, p99 and PPM as ``-t 1``, and a checkpoint that resumes
    on one device."""
    ck2, ck1 = str(tmp_path / "t2.ckpt.npz"), str(tmp_path / "t1.ckpt.npz")
    r1, one = _cli(tmp_path, scene_file, "p1", "-t", "1", "--progressive", "2", "--checkpoint", ck1, root="3")
    r2, two = _cli(tmp_path, scene_file, "p2", "-t", "2", "--progressive", "2", "--checkpoint", ck2, root="3")
    assert two == one and r1["spp_done"] == r2["spp_done"] == 9
    assert r1["p99_rel_stderr"] == r2["p99_rel_stderr"]
    a, b = np.load(ck1), np.load(ck2)
    np.testing.assert_array_equal(a["acc"], b["acc"])
    np.testing.assert_array_equal(a["lum_sq"], b["lum_sq"])


@pytest.mark.parametrize("devices", [1, 2])
def test_node_serves_its_devices(tmp_path, devices):
    """``serve(devices=n)``: the node's handshake reports n devices, and its
    renderer is a mesh over n CPU shards (spp shards at this frame's size),
    whose frame is the band loop's, to float32 rounding with 2."""
    sd = tiny_scene(w=20, h=13)
    cfg = JobConfiguration(sample_root=2, max_trace_depth=3, rows_per_work_unit=5, seed=4)
    with serving(node.serve, 1, device="cpu", devices=devices) as endpoint:
        net = net_worker(endpoint)
        try:
            assert net.info().num_devices == devices and net.info().platform == "cpu"
            handle, img, _ = run_job([net.handle()], sd, cfg, tmp_path)
        finally:
            net.stop()
    assert handle.ok
    want = band_loop(sd, cfg)
    if devices == 1:
        np.testing.assert_array_equal(img.pixels, want)
    else:
        np.testing.assert_allclose(img.pixels, want, rtol=0, atol=1e-5)


def test_default_factory_builds_a_mesh_for_several_devices():
    sd = tiny_scene(w=20, h=13)
    job = Job(JobID(0, 0), sd, JobConfiguration(sample_root=2, max_trace_depth=3, rows_per_work_unit=5))
    r = default_renderer_factory(job, devices=cpus(2))
    assert isinstance(r, MeshRenderer) and r.mesh.shape == {"rows": 1, "spp": 2}
    assert isinstance(default_renderer_factory(job, device="cpu"), Renderer)
    assert LocalWorker(devices=cpus(3)).info().num_devices == 3


def test_node_command_with_t(tmp_path):
    """``python -m flux_tpu_torch.node --device cpu -t 2`` says what it
    serves and renders a job; SIGTERM stops it with exit code 0."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "flux_tpu_torch.node", "-H", "127.0.0.1", "-p", str(port), "--device", "cpu",
         "-t", "2"], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # A thread reads the node's output line by line: a select() on the pipe
    # misses a line that a buffered readline() already took in with the one
    # before it.
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(iter(proc.stdout.readline, "")), daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + WAIT
        while not any("listening" in ln for ln in lines) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert any("serving 2 of 2 local devices (cpu" in ln for ln in lines), lines
        net = net_worker(f"127.0.0.1:{port}")
        try:
            assert net.info().num_devices == 2
            handle, _, _ = run_job([net.handle()], tiny_scene(), CFG, tmp_path)
        finally:
            net.stop()
        assert handle.ok
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=WAIT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT)
        reader.join(timeout=WAIT)
    assert not reader.is_alive()
    out = "".join(lines)
    assert proc.returncode == 0, out
