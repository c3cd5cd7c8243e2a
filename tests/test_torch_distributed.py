"""Two processes in a gloo process group on the CPU render one frame over a
global mesh of the port (``flux_tpu_torch.parallel.init_multihost``; the
models are tests/test_distributed.py and tests/dist_rows_worker.py). The
rows (2, 1) frame assembled from each process's ``render_rows_local``, and
the spp (1, 2) sums gathered by ``all_gather``, equal the one-process mesh
of the same shape bit for bit.

The processes run this module: ``python -m tests.test_torch_distributed
RANK PORT OUT.npz`` from the repository's root."""

import os
import socket
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

from flux_tpu_torch.parallel import MeshRenderer, init_multihost, make_mesh
from flux_tpu_torch.scene import load_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_ARGS = dict(sample_root=3, max_depth=3, seed=3, target_lanes=1 << 12)


def dist_scene():
    """demo1 at 24x13 (13 rows: uneven over two row shards)."""
    sd = load_scene(os.path.join(REPO, "scenes", "demo1.yml"))
    return replace(sd, output_settings=replace(sd.output_settings, image_width=24, image_height=13,
                                               pixel_size=20.0))


def rank_main(rank: int, port: str, out_path: str) -> None:
    """One process: joins the group, renders its slots of a rows (2, 1) and
    an spp (1, 2) global mesh, and saves what it got."""
    init_multihost(f"127.0.0.1:{port}", num_processes=2, process_id=rank, backend="gloo")
    sd = dist_scene()
    h, cpu = sd.output_settings.image_height, [torch.device("cpu")]
    rows = MeshRenderer(sd, mesh=make_mesh(cpu, rows_shards=2, spp_shards=1), **SCENE_ARGS)
    local_rows, local_px = rows.render_rows_local(0, h)
    rows_sum = rows.render_rows_sum_range(0, h, 1, 3, with_stats=True)
    spp = MeshRenderer(sd, mesh=make_mesh(cpu, rows_shards=1, spp_shards=2), **SCENE_ARGS)
    spp_sum = spp.render_rows_sum(0, h)
    np.savez(out_path, rows=local_rows, pixels=local_px, rows_sum=rows_sum.numpy(), spp_sum=spp_sum.numpy())
    torch.distributed.destroy_process_group()
    print(f"rank{rank} TORCH-DIST-OK rows={local_rows.tolist()}", flush=True)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tmp_path):
    """Both ranks as subprocesses; their npz outputs, or a failure with the
    output of the rank that did not exit 0."""
    port = str(free_port())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    paths = [str(tmp_path / f"rank{r}.npz") for r in (0, 1)]
    procs = [
        subprocess.Popen([sys.executable, "-m", "tests.test_torch_distributed", str(r), port, paths[r]],
                         cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate(timeout=30)
            pytest.fail("the two-process render timed out")
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        assert f"rank{r} TORCH-DIST-OK" in out
    return [np.load(path) for path in paths]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("dist"))


def one_process(rows, spp):
    return MeshRenderer(dist_scene(), mesh=make_mesh([torch.device("cpu")] * (rows * spp), rows_shards=rows,
                                                     spp_shards=spp), **SCENE_ARGS)


def test_rows_mesh_assembled_from_each_process(ranks):
    sd = dist_scene()
    h, w = sd.output_settings.image_height, sd.output_settings.image_width
    frame = np.full((h, w, 3), np.nan, np.float32)
    got = []
    for z in ranks:
        frame[z["rows"]] = z["pixels"]
        got.extend(z["rows"].tolist())
    assert sorted(got) == list(range(h))  # disjoint, complete
    assert ranks[0]["rows"].tolist() == list(range(0, h, 2)) and ranks[1]["rows"].tolist() == list(range(1, h, 2))
    want = one_process(2, 1)
    np.testing.assert_array_equal(frame.view(np.int32), want.render_rows(0, h).view(np.int32))
    want_sum = want.render_rows_sum_range(0, h, 1, 3, with_stats=True).numpy()
    for z in ranks:
        np.testing.assert_array_equal(z["rows_sum"].view(np.int32), want_sum.view(np.int32))


def test_spp_mesh_gathered_across_processes(ranks):
    h = dist_scene().output_settings.image_height
    want = one_process(1, 2).render_rows_sum(0, h).numpy()
    for z in ranks:
        np.testing.assert_array_equal(z["spp_sum"].view(np.int32), want.view(np.int32))


def test_init_multihost_wants_all_three_or_none():
    with pytest.raises(ValueError, match="together"):
        init_multihost("127.0.0.1:1", num_processes=2)


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
