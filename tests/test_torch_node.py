"""Masters and render nodes on loopback, on the CPU: a port master driving a
port node, alone and beside a local worker (through the CLI's ``-n`` too); a
``flux_tpu`` master driving a port node; a port master driving a
``flux_tpu`` node (its renderer a numpy stub, so that no JAX render is
compiled); a node that dies mid-render, a node whose renderer fails, a
cancelled job, a malformed client, and the node's command line.

The port node renders at 16x12, root 2, on the CPU; every image it helps
make must be bit-equal to the port's band loop over the same units. Every
socket has a timeout and every thread is joined with one."""

import contextlib
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import yaml

import flux_tpu.manager as j_manager
import flux_tpu.node as j_node
import flux_tpu.workers as j_workers
from flux_tpu import job as j_job
from flux_tpu import scene as j_scene
from flux_tpu_torch import cli, node, wire
from flux_tpu_torch import workers as workers_mod
from flux_tpu_torch.image import ppm_bytes
from flux_tpu_torch.job import Job, JobConfiguration
from flux_tpu_torch.manager import ImageBuilder, JobFailed, RenderManager
from flux_tpu_torch.workers import LocalWorker, NetworkWorker
from tests.test_torch_job import REPO, WAIT, band_loop, cpu_factory, run_job, tiny_doc, tiny_scene

CFG = JobConfiguration(sample_root=2, max_trace_depth=3, rows_per_work_unit=3, seed=4)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def serving(serve, max_connections=1, **kw):
    """A node's accept loop on a free loopback port, in a thread; yields its
    endpoint and joins the thread (it ends with its last connection)."""
    port = free_port()
    ready = threading.Event()
    t = threading.Thread(target=serve, kwargs=dict(host="127.0.0.1", port=port, max_connections=max_connections,
                                                   ready_event=ready, **kw), daemon=True)
    t.start()
    assert ready.wait(timeout=WAIT)
    try:
        yield f"127.0.0.1:{port}"
    finally:
        t.join(timeout=WAIT)
    assert not t.is_alive(), "the node did not end"


def port_node(max_connections=1):
    return serving(node.serve, max_connections, device="cpu")


def net_worker(endpoint):
    return NetworkWorker(endpoint, connect_timeout=10, io_timeout=WAIT)


def test_port_master_and_port_node(tmp_path):
    sd = tiny_scene()
    with port_node() as endpoint:
        net = net_worker(endpoint)
        info = net.info()
        try:
            handle, img, evs = run_job([net.handle()], sd, CFG, tmp_path)
        finally:
            net.stop()
    assert (info.num_devices, info.platform) == (1, "cpu")
    assert handle.ok and handle.retry_rounds == 0 and net.units_done == 4
    assert not any(isinstance(e, JobFailed) for e in evs)
    assert np.array_equal(img.pixels.view(np.int32), band_loop(sd, CFG).view(np.int32))


def test_port_master_with_a_local_worker_beside_a_port_node(tmp_path):
    sd = tiny_scene(h=24)
    cfg = JobConfiguration(sample_root=2, max_trace_depth=3, rows_per_work_unit=2, seed=4)
    with port_node() as endpoint:
        net = net_worker(endpoint)
        local = LocalWorker(renderer_factory=cpu_factory, device="cpu")
        try:
            handle, img, _ = run_job([local.handle(), net.handle()], sd, cfg, tmp_path)
        finally:
            local.stop()
            net.stop()
    assert handle.ok and local.units_done + net.units_done == 12
    assert np.array_equal(img.pixels, band_loop(sd, cfg))


@pytest.mark.parametrize("local", [False, True], ids=["node-only", "node-and-local"])
def test_cli_renders_through_a_port_node(tmp_path, local):
    """``-L -n`` and ``-n``: the PPM is the band loop's bytes. The height is
    not a multiple of -R, so the last unit is short."""
    scene_file = tmp_path / "tiny.yml"
    scene_file.write_text(yaml.safe_dump(tiny_doc(h=11)))
    with port_node() as endpoint:
        argv = [str(scene_file), "-r", "2", "-d", "3", "-R", "3", "--seed", "4", "--device", "cpu",
                "--output-dir", str(tmp_path), "-n", endpoint] + ([] if local else ["-L"])
        ran = cli.run(argv)
    assert ran["error"] is None and ran["retry_rounds"] == 0 and not ran["worker_failures"]
    assert sum(ran["units_by_worker"].values()) == 4
    assert set(ran["units_by_worker"]) == ({"local"} if local else set()) | {f"net:{endpoint}"}
    want = ppm_bytes(band_loop(tiny_scene(h=11), CFG))
    assert (tmp_path / "demo2.ppm").read_bytes() == want


def test_jax_master_drives_a_port_node(tmp_path):
    """flux_tpu's RenderManager, NetworkWorker and ImageBuilder, against a
    port node: the same frames, the same image."""
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(tiny_doc()))
    jcfg = j_job.JobConfiguration(sample_root=2, max_trace_depth=3, rows_per_work_unit=3, seed=4)
    with port_node() as endpoint:
        net = j_workers.NetworkWorker(endpoint, connect_timeout=10)
        manager = j_manager.RenderManager([net.handle()])
        builder = j_manager.ImageBuilder(output_dir=str(tmp_path))
        try:
            handle = manager.schedule_job(j_scene.load_scene(str(path)), jcfg, builder.sender())
            assert handle.wait(timeout=WAIT) and builder.wait_finished(timeout=WAIT)
            img = builder.get_image()
        finally:
            builder.stop()
            manager.stop()
            net.stop()
    assert handle.ok and img.complete()
    assert np.array_equal(img.pixels, band_loop(tiny_scene(), CFG))


class StubRenderer:
    """A numpy renderer for a flux_tpu node: rows as a function of the row,
    the column, the channel and the job's seed."""

    def __init__(self, job):
        self.width = job.scene_data.output_settings.image_width
        self.seed = job.config.seed

    def render_rows(self, row0, n_rows):
        r = np.arange(row0, row0 + n_rows, dtype=np.float32)[:, None, None]
        c = np.arange(self.width, dtype=np.float32)[None, :, None]
        k = np.arange(3, dtype=np.float32)[None, None, :]
        return ((r * 31 + c * 7 + k + self.seed) % 97 / 97).astype(np.float32)


def test_port_master_drives_a_jax_node(tmp_path, monkeypatch):
    monkeypatch.setattr(j_workers, "default_renderer_factory", StubRenderer)
    sd = tiny_scene(h=10)
    with serving(j_node.serve) as endpoint:
        net = net_worker(endpoint)
        try:
            handle, img, _ = run_job([net.handle()], sd, CFG, tmp_path)
        finally:
            net.stop()
    assert handle.ok and net.units_done == 4 and img.complete()
    want = StubRenderer(Job(None, sd, CFG)).render_rows(0, 10)
    assert np.array_equal(img.pixels, want)


def test_node_death_mid_render_survivor_completes(tmp_path):
    """A node that drops its connection with a unit in flight: the master
    marks it dead, the local worker finishes the frame, and a retry round
    re-renders the lost unit."""
    sd = tiny_scene(h=24)
    cfg = JobConfiguration(sample_root=2, max_trace_depth=2, rows_per_work_unit=2, seed=4)
    port = free_port()
    ready = threading.Event()

    def dying_node():
        with socket.socket() as srv:
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(("127.0.0.1", port))
            srv.listen(1)
            srv.settimeout(WAIT)
            ready.set()
            conn, _ = srv.accept()
            with conn:
                conn.settimeout(WAIT)
                wire.send_msg(conn, {"type": "worker_info", "num_devices": 1, "platform": "cpu"})
                job = Job.from_dict(wire.recv_msg(conn)["job"])
                r = cpu_factory(job)
                u = wire.recv_msg(conn)
                rows = r.render_rows(u["row_start"], u["row_end"] - u["row_start"] + 1)
                wire.send_msg(conn, wire.encode_rows(u["row_start"], rows))
                wire.recv_msg(conn)  # the second unit arrives, and the node dies

    class Slow:
        def __init__(self, job):
            self._r = cpu_factory(job)

        def render_rows(self, row0, n_rows):
            time.sleep(0.02)
            return self._r.render_rows(row0, n_rows)

    t = threading.Thread(target=dying_node, daemon=True)
    t.start()
    assert ready.wait(timeout=WAIT)
    net = net_worker(f"127.0.0.1:{port}")
    local = LocalWorker(renderer_factory=Slow, device="cpu")
    try:
        handle, img, _ = run_job([net.handle(), local.handle()], sd, cfg, tmp_path)
    finally:
        local.stop()
        net.stop()
        t.join(timeout=WAIT)
    assert handle.ok, handle.error
    assert not net.handle().alive and net.units_done == 1
    assert handle.retry_rounds >= 1 and local.units_done >= 11
    assert np.array_equal(img.pixels, band_loop(sd, cfg))


def test_node_render_failure_is_reported_not_hung(tmp_path, monkeypatch):
    def explode(job, **kw):
        raise RuntimeError("injected node failure")

    monkeypatch.setattr(workers_mod, "default_renderer_factory", explode)
    with port_node() as endpoint:
        net = net_worker(endpoint)
        try:
            handle, _, evs = run_job([net.handle()], tiny_scene(), CFG, tmp_path)
            alive = net.handle().alive  # a clean job_error keeps the link
        finally:
            net.stop()
    failed = [e for e in evs if isinstance(e, JobFailed)]
    assert failed and "injected node failure" in failed[0].reason
    assert handle.done() and not handle.ok and "lost after retry" in handle.error
    assert alive


def test_cancellation_through_a_node_keeps_the_link(tmp_path, monkeypatch):
    def slow(job, **kw):
        time.sleep(0.4)
        return cpu_factory(job)

    monkeypatch.setattr(workers_mod, "default_renderer_factory", slow)
    sd = tiny_scene()
    cfg = JobConfiguration(sample_root=2, max_trace_depth=2, rows_per_work_unit=2)
    with port_node() as endpoint:
        net = net_worker(endpoint)
        manager = RenderManager([net.handle()])
        b1, b2 = ImageBuilder(output_dir=str(tmp_path)), ImageBuilder(output_dir=str(tmp_path))
        try:
            job = manager.schedule_job(sd, cfg, b1.sender())
            time.sleep(0.1)
            job.cancel()
            assert job.wait(timeout=WAIT), "a cancelled job must release the barrier"
            job2 = manager.schedule_job(sd, cfg, b2.sender())
            assert job2.wait(timeout=WAIT) and b2.wait_finished(timeout=WAIT)
            assert job2.ok and np.array_equal(b2.get_image().pixels, band_loop(sd, cfg))
        finally:
            b1.stop()
            b2.stop()
            manager.stop()
            net.stop()


def test_node_survives_a_malformed_client():
    with port_node(max_connections=2) as endpoint:
        host, port = endpoint.split(":")
        with socket.create_connection((host, int(port)), timeout=10) as c1:
            hello = wire.recv_msg(c1)
            assert hello == {"type": "worker_info", "num_devices": 1, "platform": "cpu", "busy": False,
                             "queued": 0}
            wire.send_msg(c1, {"type": "work_unit", "row_start": 0, "row_end": 3})
        with socket.create_connection((host, int(port)), timeout=10) as c2:
            assert wire.recv_msg(c2)["type"] == "worker_info"
            wire.send_msg(c2, {"type": "shutdown"})


def test_connect_failure_raises():
    with pytest.raises(OSError):
        NetworkWorker(f"127.0.0.1:{free_port()}", connect_timeout=0.5)


def test_node_needs_the_card_unless_told_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        node.main(["-p", str(free_port())])


def test_node_command_serves_and_stops_cleanly(tmp_path):
    """``python -m flux_tpu_torch.node --device cpu``: serves a master, and
    exits 0 on SIGTERM."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "flux_tpu_torch.node", "-H", "127.0.0.1", "-p", str(port), "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
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
        assert any("listening" in ln for ln in lines), lines
        sd = tiny_scene()
        net = net_worker(f"127.0.0.1:{port}")
        try:
            handle, img, _ = run_job([net.handle()], sd, CFG, tmp_path)
        finally:
            net.stop()
        assert handle.ok and np.array_equal(img.pixels, band_loop(sd, CFG))
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
    assert "stopped" in out


def test_package_ships_the_native_source_and_the_node_command():
    import fnmatch
    import tomllib

    from flux_tpu_torch import native

    meta = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = meta["tool"]["setuptools"]["package-data"]["flux_tpu_torch"]
    rel = native.SOURCE.relative_to(REPO / "flux_tpu_torch").as_posix()
    assert rel == "csrc/fluxnative.cpp" and any(fnmatch.fnmatch(rel, g) for g in globs)
    assert meta["project"]["scripts"]["flux-tpu-torch-node"] == "flux_tpu_torch.node:main"
