"""The port's benchmark on one CUDA card: the cells of the JAX package's
``bench.py``, held against that package's stored results.

Run from a checkout: ``python -m flux_tpu_torch.bench [--out DIR]``. The
headline is the reference's published workload (BASELINE.md): demo2 at
800x600, 16384 spp (root 128), depth 5, seed 0, which took 1479.900397 s on
44 CPU cores, 5.314 Msamples/s for the box; ``vs_baseline`` is the ratio of
the card's primary-sample throughput to that. Six secondary cells follow,
with the scenes, roots, seeds and flags of ``bench.py``: demo2 NEE at 1024
spp, spheres512 at 64 spp (the scan), a 1280-triangle icosphere at 16 spp,
the Cornell box at 1024 spp NEE over its triangle light, demo3 MIS at 16 spp
with its MSE against a 1024-spp truth, and demo2's adaptive stop.

Each timed cell renders once to warm up, then whole frames with one band of
the frame's height (``render_image(rows_per_band=height)``, as ``bench.py``
renders them); a time is the best of 3, and every run is given in
``all_runs_s``. The kernels are built and loaded before the first cell
(``build_s``). Each cell's frame or value is held against the JAX package's
stored result (``artifacts.py``) at the gates ``chip_smoke.py`` enforces;
the gates' results stand in the cell's entry, and a cell that fails records
``{"error": ...}`` without stopping the others.

Stdout is one JSON line: ``bench.py``'s fields (``metric``, ``value``,
``unit``, ``vs_baseline``, ``wall_clock_s``, ``all_runs_s``,
``baseline_wall_clock_s``, ``spp``, ``devices``), the card's name and power
limit (``card``), the build's seconds, the headline's warm-up, launches and
gates, and the six secondary cells (``extra``). ``--out`` (by default
``build/bench/`` of the checkout, which git ignores) receives the headline's
PNG, ``bench_extra.json`` and an appended ``bench_history.jsonl``; a
headline more than 12% below the best recorded there is warned of on
stderr. Nothing is written under ``artifacts/``. The exit code is 1, after
the line, when a cell failed, a gate did not pass or a write failed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import artifacts, meshgen
from .checkpoint import ProgressiveRenderer
from .image import write_png
from .ops import build
from .ops.scene_kernel import render_block_scene
from .ops.sweep_kernel import render_block_sweep
from .render import Renderer, resolve_device
from .scene import SceneData, load_scene

__all__ = ["CELLS", "Cell", "HEADLINE", "DEFAULT_OUT", "card_name", "run_cell", "main"]

REPO = Path(__file__).resolve().parent.parent
BASELINE_MSAMPLES_PER_S = 800 * 600 * 16384 / 1479.900397 / 1e6  # 5.314
BASELINE_WALL_CLOCK_S = 1479.9
DEPTH = 5
HEADLINE = "demo2_16384spp_throughput"
# The adaptive cell: passes of 64 samples until the p99 relative standard
# error is under the noise target (reachable mid-run at root 32).
PASS_SPP = 64
NOISE_TARGET = 0.12
SEED = 0
# The MIS cell's truth: 8x the root (1024 spp at root 32), its own seed.
TRUTH_ROOT_FACTOR, TRUTH_SEED = 8, 7
# The bench reads the checkout's scenes/ and artifacts/; it writes here
# (git ignores build/).
DEFAULT_OUT = REPO / "build" / "bench"


@dataclass(frozen=True)
class Cell:
    """One cell: ``scene`` is ``scenes/<scene>.yml``, or ``mesh1280`` (the
    port's ``meshgen.icosphere(3)`` in ``meshgen.mesh_scene``); ``config``
    the one kernel configuration its launches take on the card; ``png`` the
    JAX package's frame it is held to at ``limits``. ``kind``: ``frame``,
    ``mis`` (16-spp frames and their MSE against a truth) or ``adaptive``."""

    scene: str
    root: int
    config: str
    nee: bool = False
    physical: bool = False
    png: Optional[str] = None
    limits: tuple = ()
    kind: str = "frame"


CELLS = {
    HEADLINE: Cell("demo2", 128, "sweep", png="demo2_16384spp.png", limits=artifacts.HEADLINE_GATES),
    "demo2_nee_1024spp": Cell("demo2", 32, "sweep+nee", nee=True, png="demo2_16384spp.png",
                              limits=artifacts.NEE_GATES),
    "spheres512_64spp_scan": Cell("spheres512", 8, "scan", png="spheres512_64spp.png",
                                  limits=artifacts.SPHERES512_GATES),
    "mesh1280_16spp": Cell("mesh1280", 4, "sweep+tri"),
    "cornell_tri_light_nee_1024spp": Cell("demo5", 32, "sweep+tri+nee+trilight", nee=True,
                                          png="demo5_cornell_2304spp.png", limits=artifacts.CORNELL_GATES),
    "demo3_physical_mis_16spp": Cell("demo3", 4, "sweep+nee+physical", nee=True, physical=True, kind="mis"),
    "demo2_adaptive_stop": Cell("demo2", 32, "sweep+stats", kind="adaptive"),
}


def card_name(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``cpu`` for the plain version on the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def scene_of(cell: Cell, size=None) -> SceneData:
    """The cell's scene, at ``size`` (width, height) with its horizontal
    field of view kept when given."""
    if cell.scene == "mesh1280":
        sd = meshgen.mesh_scene(*meshgen.icosphere(3), width=800, height=600)
    else:
        sd = load_scene(str(REPO / "scenes" / f"{cell.scene}.yml"))
    if size is None:
        return sd
    out = sd.output_settings
    w, h = size
    return replace(sd, output_settings=replace(
        out, image_width=w, image_height=h, pixel_size=out.pixel_size * out.image_width / w))


def _clear_launches() -> None:
    render_block_sweep.launches.clear()
    render_block_scene.launches.clear()


def _launches() -> dict:
    """Launches by configuration since the last clear, of both wrappers."""
    return {**render_block_sweep.launches, **render_block_scene.launches}


def _timed_frames(r: Renderer, reps: int):
    """``reps`` whole frames, one band of the frame's height each; the last
    frame and each frame's wall seconds."""
    walls, img = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        # render_image returns numpy: the frame is on the host, so the card
        # has finished it when the clock stops.
        img = r.render_image(rows_per_band=r.height)
        walls.append(time.perf_counter() - t0)
    return img, walls


def _timing(samples: int, walls: list) -> dict:
    best = min(walls)
    return {"wall_clock_s": best, "msamples_per_s": samples / best / 1e6, "all_runs_s": walls}


def run_cell(name: str, device, *, size=None, root=None, depth=DEPTH, reps: int = 3, target=None):
    """Run the cell ``name`` on ``device``; returns its entry and its last
    frame. ``size`` (width, height), ``root`` and the adaptive cell's
    ``target`` and ``depth`` shrink a cell for the tests; the gates apply only at the
    published size, and a smaller run records ``"not at the published
    size"`` for them."""
    cell = CELLS[name]
    dev = resolve_device(device)
    published = size is None and root in (None, cell.root) and target in (None, NOISE_TARGET) and depth == DEPTH
    sd = scene_of(cell, size)
    root = cell.root if root is None else root
    w, h = sd.output_settings.image_width, sd.output_settings.image_height
    _clear_launches()
    if cell.kind == "adaptive":
        target = NOISE_TARGET if target is None else target
        t0 = time.perf_counter()
        # The first pass of this shape loads the stats kernel: on a
        # throwaway renderer, so that the timed loop measures passes.
        ProgressiveRenderer(sd, root, depth, seed=SEED, device=dev).render_pass(PASS_SPP)
        warmup_s = time.perf_counter() - t0
        pr = ProgressiveRenderer(sd, root, depth, seed=SEED, device=dev)
        err = None
        t0 = time.perf_counter()
        while not pr.complete:
            pr.render_pass(PASS_SPP)
            err = pr.max_rel_stderr()
            if err is not None and err < target:
                break
        entry = {"wall_clock_s": time.perf_counter() - t0, "spp_done": int(pr.samples_done),
                 "spp_max": int(pr.spp), "p99_rel_stderr": err, "noise_target": target}
        img = pr.peek()
    else:
        r = Renderer(sd, root, depth, seed=SEED, device=dev, nee=cell.nee, physical=cell.physical)
        truth = None
        if cell.kind == "mis":
            truth = Renderer(sd, TRUTH_ROOT_FACTOR * root, depth, seed=TRUTH_SEED, device=dev, nee=True,
                             physical=True).render_image(rows_per_band=h)
        t0 = time.perf_counter()
        r.render_rows(0, h)
        warmup_s = time.perf_counter() - t0
        img, walls = _timed_frames(r, reps)
        entry = {**_timing(w * h * root * root, walls), "spp": root * root}
        if truth is not None:
            entry["mse_vs_1024spp"] = float(((img - truth) ** 2).mean())
    entry["warmup_s"] = warmup_s
    entry["launches"] = _launches()
    entry["gates"] = _gates(cell, entry, img, dev) if published else "not at the published size"
    return entry, img


def _gates(cell: Cell, entry: dict, img: np.ndarray, dev) -> list:
    """The cell's gates on the JAX package's stored results; on the card,
    also that every launch took the cell's one configuration (no frame went
    through the plain version)."""
    gates = [artifacts.gate("finite pixels", int(np.isfinite(img).sum()), img.size, np.isfinite(img).all())]
    if cell.kind == "adaptive":
        gates += artifacts.adaptive_gates(entry["spp_done"], entry["p99_rel_stderr"])
    if cell.kind == "mis":
        gates += artifacts.mis_gates(entry["mse_vs_1024spp"])
    if cell.png is not None:
        entry["vs_jax_png"] = artifacts.frame_vs_png(img, cell.png)
        gates += artifacts.frame_gates(entry["vs_jax_png"], cell.limits, cell.png)
    if dev.type == "cuda":
        gates.append(artifacts.gate(f"launches only {cell.config}", sorted(entry["launches"]), [cell.config],
                                    set(entry["launches"]) == {cell.config}))
    return gates


def _failures(entry: dict) -> list:
    """What failed in a cell: its error or the gates that did not pass."""
    if "error" in entry:
        return [entry["error"]]
    return artifacts.failed(entry["gates"]) if isinstance(entry.get("gates"), list) else []


def _append_history(path: Path, result: dict) -> None:
    """Append the run to the history and warn on stderr when the headline
    is more than 12% below the best recorded one."""
    best = None
    if path.exists():
        for line in path.read_text().splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            v = rec.get("value")
            if rec.get("metric") == result["metric"] and v and (best is None or v > best):
                best = v
    with open(path, "a") as f:
        f.write(json.dumps({"when": time.strftime("%Y-%m-%dT%H:%M:%S"), **result}) + "\n")
    if best is not None and result["value"] is not None and result["value"] < 0.88 * best:
        print(f"bench WARNING: headline {result['value']} {result['unit']} is >12% below the best "
              f"recorded run ({best}): possible regression (see {path})", file=sys.stderr)


def main(argv=None, **cell_kw) -> int:
    """The bench; ``cell_kw`` (``run_cell``'s ``size``, ``root``, ``depth``,
    ``reps``) shrinks every cell for the tests."""
    ap = argparse.ArgumentParser(prog="python -m flux_tpu_torch.bench",
                                 description="The port's bench on one CUDA card (bench.py's cells).")
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="directory for the headline's PNG, bench_extra.json and bench_history.jsonl")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu, the plain PyTorch version")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_name(dev)
    build_s = None
    if dev.type == "cuda":
        t0 = time.perf_counter()
        build.build_many(list(build.LIBRARIES))  # one nvcc per source, started together
        for lib in build.LIBRARIES:
            build.load(lib)
        build_s = time.perf_counter() - t0
    cells, head_img = {}, None
    for name in CELLS:
        try:
            cells[name], img = run_cell(name, dev, **cell_kw)
        except Exception as e:  # recorded in the cell's entry; the exit code says so
            traceback.print_exc(file=sys.stderr)
            cells[name], img = {"error": repr(e)}, None
        if name == HEADLINE:
            head_img = img
    head = cells.pop(HEADLINE)
    value = head.get("msamples_per_s")
    result = {
        "metric": HEADLINE,
        "value": value,
        "unit": "Msamples/s/chip",
        "vs_baseline": None if value is None else value / BASELINE_MSAMPLES_PER_S,
        "wall_clock_s": head.get("wall_clock_s"),
        "all_runs_s": head.get("all_runs_s"),
        "baseline_wall_clock_s": BASELINE_WALL_CLOCK_S,
        "spp": head.get("spp"),
        "devices": 1,  # the bench drives one card
        "card": card,
        "build_s": build_s,
        **{k: head[k] for k in ("error", "warmup_s", "launches", "vs_jax_png", "gates") if k in head},
        "extra": cells,
    }
    out = Path(args.out)
    writes = [("bench_extra.json", lambda p: p.write_text(json.dumps(cells, indent=1))),
              ("bench_history.jsonl", lambda p: _append_history(p, result))]
    if head_img is not None:
        # Under the name of the JAX package's frame, in --out.
        writes.insert(0, (CELLS[HEADLINE].png, lambda p: write_png(str(p), head_img)))
    write_errors = []
    for fname, write in writes:
        try:
            out.mkdir(parents=True, exist_ok=True)
            write(out / fname)
        except OSError as e:
            print(f"bench: writing {out / fname} failed: {e!r}", file=sys.stderr)
            write_errors.append(f"{fname}: {e!r}")
    if write_errors:
        result["write_errors"] = write_errors
    print(json.dumps(result), flush=True)
    failures = {name: _failures(entry) for name, entry in [(HEADLINE, head), *cells.items()]}
    failures = {k: v for k, v in failures.items() if v}
    if failures:
        print(f"bench: failed: {json.dumps(failures)}", file=sys.stderr)
    return 1 if failures or write_errors else 0


if __name__ == "__main__":
    sys.exit(main())
