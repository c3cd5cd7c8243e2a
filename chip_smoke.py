#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``flux_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
It needs one Hopper card (the kernels are built for ``sm_90a``), ``nvcc``
and PyTorch built for CUDA; it imports neither JAX nor ``flux_tpu``.

Phases, in order; any failure exits non-zero before the result line:

1. probe: a CUDA device must be present; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build: compiles ``flux_tpu_torch/csrc/sweep_megakernel.cu`` and
   ``scene_megakernel.cu`` (every instantiation of both templates) with
   nvcc, both at once, and prints the build seconds and the compiler's
   register report for each;
3. kernel vs plain: demo2 at its full 800 width, an 8-row band, root 4,
   depth 5, seed 42, through the kernel and through its plain PyTorch
   version on the card; two kernel launches must be bitwise equal, and
   sample ranges must add up;
4. goldens: demo1 and demo2 at 80x60, root 4, depth 5, seed 42 (pixel size
   ×10, as tests/test_golden.py renders them), held against the JAX
   package's committed goldens at that test's gate;
5. the main path: ``python -m flux_tpu_torch.cli scenes/demo2.yml -r 128
   -d 5`` (800x600 at 16384 spp) through the CLI's ``main``; the kernel's
   launch count must rise, the PPM must be whole, and the frame must match
   the JAX package's render of the same frame and seed
   (artifacts/demo2_16384spp.png);
6. measurement at the main path's shapes (one 50-row band at 16384 spp):
   the kernel's time, its bound, and the plain version's time; the two
   results on that launch are held against each other at phase 3's gate,
   and their max |diff| is the ``max_abs_err`` of the kernels line;
7. kernel vs plain for each new instantiation (stats, nee, physical,
   nee+physical, nee+stats, physical+stats, nee+physical+stats) on an
   8-row band of demo3 (demo2 for nee and nee+stats), at phase 3's gate;
   with stats, the Σ luminance² channel too (99% of values at rtol 1e-4,
   mean |diff| under 1e-4 of its mean), and the split on all 4 channels;
8. the quality paths, each through its entry point with the launch counts
   set to 0 just before and read just after:
   a. demo2 adaptive: ``cli scenes/demo2.yml -r 32 -d 5 --progressive 64
      --adaptive 0.12`` must stop at 768 spp with a p99 relative stderr
      within 5e-4 of the JAX package's 0.11675 (artifacts/bench_extra.json);
   b. demo2 NEE: ``cli scenes/demo2.yml -r 32 -d 5 --nee``, against the
      16384-spp frame of phase 5's reference PNG;
   c. demo3 physical MIS: Renderer(nee, physical) frames at 16 spp (seed 0)
      and 1024 spp (seed 7, the truth); their MSE must be within 2% of the
      JAX package's 0.002073 (artifacts/bench_extra.json);
   d. demo3 physical without NEE: ``cli scenes/demo3.yml -r 16 -d 5
      --physical``, against the MIS truth;
   e. demo3 progressive with a checkpoint: 2 passes of 64 through
      ProgressiveRenderer, saved, then finished by ``cli scenes/demo3.yml
      -r 32 -d 5 --nee --physical --progressive 64 --checkpoint <file>
      --resume``; the accumulators must be bitwise equal to the CLI's
      uninterrupted run; then the host seconds of one such pass, step by
      step (launches, copy back, numpy adds, p99, npz save);
   f. demo2 progressive NEE: ``cli scenes/demo2.yml -r 8 -d 5 --nee
      --progressive 32 --checkpoint <file>``; the checkpoint's sums must
      match one launch of all 64 samples within 1e-5 relative;
   g. demo3 progressive physical: the same with ``--physical``;
9. measurement of each new instantiation at its path's launch shape, as
   in phase 6, with phase 7's gate; each measurement prints the launch
   plan (threads per pixel, pixels per block, blocks, blocks resident per
   SM, waves) beside the time;
10. the scene megakernel (scan with block skip, triangle fold, triangle
   lights) against its plain version on an 8-row band at the scene's full
   width, root 4, depth 5, seed 42, at phase 3's gates: the scan on
   spheres512 (also with NEE over its 15 sphere lights, with MIS, with
   stats), triangles on mesh_ico and demo4, triangle lights on demo5 with
   NEE and with MIS, each also with stats; two launches bitwise equal,
   sample ranges add up; the same launch with the AABB skip off, and with
   one level of boxes, must be bitwise equal; prints the share of blocks
   entered; then the scan against the sweep megakernel, bitwise, on whole
   frames of ``sphere_field(24)`` and ``sphere_field(40)``;
11. the slice's paths, each with the launch counts set to 0 just before and
   read just after: ``cli scenes/spheres512.yml -r 8 -d 5`` (the scan picked
   by itself; against the JAX package's frame, artifacts/spheres512_64spp.png),
   ``Renderer`` on ``meshgen.icosphere(3)`` in ``mesh_scene`` (1280
   triangles) at root 4 and ``cli scenes/mesh_ico.yml -r 4 -d 5``,
   ``cli scenes/demo5.yml -r 32 -d 5 --nee`` (512x512, a triangle quad
   light; phase 13 holds one whole band of it against the plain version),
   and short renders that take
   the other configurations (NEE on spheres512, physical on mesh_ico, MIS
   on demo5, and progressive renders with the stats channel, demo5's
   resumed from a checkpoint bitwise); the 96-sphere field at 80x60 on the
   card against tests/golden_field96_80x60_r4_s42.npy;
12. one band of ``sphere_field(16384)`` at 800x600, 16 spp: ms per launch
   with the skip, with one level of boxes and without the skip (bitwise
   equal), the blocks entered per fold, and the band's first row against
   the plain version;
13. measurement of each scene-megakernel configuration at its path's launch
   shape (CUDA events, median of 3) beside its operation bound from the
   kernel's work counters, the plain version's time on the launch's first
   2-4 rows (the whole launch would take minutes; demo5's 1024-spp band is
   run whole), and those rows of the path's own launch held against it; the
   skips timed on and off.
14. design checks: the counting instantiation timed beside the timed one
   on the K1 and K7 bands (the work counters live only in the former), K1
   on 42 rows and K7 on 48 rows beside their 50-row bands (the cost per
   row as the last wave empties), and the triangle skip on and off on
   meshes of 2 to 80 triangle blocks and on the Cornell box, bitwise equal,
   beside the rule ``scene_kernel.TRI_SKIP_ENGAGE``.

Every phase prints its wall seconds. It ends with a ``{"kernels": [...]}``
line (one entry per instantiation and configuration) and then the result
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

from flux_tpu_torch.camera import camera_tensors
from flux_tpu_torch.checkpoint import ProgressiveRenderer, load_checkpoint
from flux_tpu_torch import genscene, meshgen
from flux_tpu_torch.cli import run as cli_run
from flux_tpu_torch.image import read_ppm
from flux_tpu_torch.ops import build, scene_kernel
from flux_tpu_torch.ops.intersect import Intersector, scan_layout, tri_layout
from flux_tpu_torch.ops.nee import extract_lights
from flux_tpu_torch.ops.scene_kernel import render_block_scene
from flux_tpu_torch.ops.sweep_kernel import (
    FluxLights,
    FluxScene,
    config_name,
    flops_lower_bound,
    n_counts,
    render_block_sweep,
)
from flux_tpu_torch.render import Renderer, finalize, plan_chunks, render_block
from flux_tpu_torch.scene import compile_scene, load_scene

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*a) -> None:
    print(*a, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def scene_small(name: str):
    """The golden test's frame: 80x60 with the field of view kept."""
    sd = load_scene(os.path.join(HERE, "scenes", f"{name}.yml"))
    return replace(
        sd,
        output_settings=replace(
            sd.output_settings, image_width=80, image_height=60,
            pixel_size=sd.output_settings.pixel_size * 10,
        ),
    )


def event_ms(fn, reps: int) -> list:
    """Device milliseconds of each of ``reps`` calls, by CUDA events."""
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times


def scene_on(dev, name: str):
    """(SceneData, SceneTensors, CameraTensors) of a stock scene on ``dev``."""
    sd = load_scene(os.path.join(HERE, "scenes", f"{name}.yml"))
    cam = camera_tensors(sd.camera_settings, sd.camera_data, sd.output_settings.pixel_size, dev)
    return sd, compile_scene(sd, dev), cam


def stats_vs_plain(k: torch.Tensor, p: torch.Tensor) -> dict:
    """The Σ luminance² channel of a stats launch against the plain
    version's: the fraction of values within float32 rounding (rtol 1e-4,
    as tests/test_torch_cuda.py holds it) and the mean |diff| relative to
    the channel's mean."""
    k3, p3 = k[..., 3], p[..., 3]
    return {
        "stats_frac_close": float(torch.isclose(k3, p3, rtol=1e-4, atol=1e-5).float().mean()),
        "stats_rel_mean_abs_diff": float((k3 - p3).abs().mean() / p3.abs().mean().clamp_min(1e-30)),
    }


def compare(k: torch.Tensor, p: torch.Tensor, root: int, stats: bool) -> dict:
    """A kernel's sums against the plain version's on the same launch: raw
    and finalized differences, and with stats the Σ luminance² channel."""
    d = (k - p).abs()
    fd = (finalize(k[..., :3], root=root) - finalize(p[..., :3], root=root)).abs()
    res = {
        "max_abs_diff": float(d.max()),
        "mean_abs_diff": float(d.mean()),
        "max_rel_diff": float((d / p.abs().clamp_min(1e-30)).max()),
        "n_over_1e-5": int((d > 1e-5).sum()),
        "n_values": d.numel(),
        "finalized_max_abs_diff": float(fd.max()),
        "finalized_mean_abs_diff": float(fd.mean()),
        "finalized_frac_over_5e-3": float((fd > 5e-3).float().mean()),
    }
    if stats:
        res.update(stats_vs_plain(k, p))
    return res


def check_vs_plain(res: dict, what: str) -> None:
    """Phase 3's gate on the finalized radiance; with stats also 99% of the
    Σ luminance² values within float32 rounding and a relative mean |diff|
    under 1e-4 (a wrong luminance weight or a lost sample moves it by
    percents)."""
    check(res["finalized_mean_abs_diff"] < 1e-3, f"kernel vs plain, {what}: mean |diff| >= 1e-3")
    check(res["finalized_frac_over_5e-3"] < 0.01, f"kernel vs plain, {what}: >= 1% of values off by > 5e-3")
    if "stats_frac_close" in res:
        check(res["stats_frac_close"] >= 0.99, f"kernel vs plain, {what}: Σ lum² off on >= 1% of values")
        check(res["stats_rel_mean_abs_diff"] < 1e-4, f"kernel vs plain, {what}: Σ lum² mean |diff| >= 1e-4 rel")


def phase_kernel_vs_plain(dev, name="demo2", nee=False, physical=False, stats=False) -> dict:
    """An 8-row band at full width, root 4, depth 5, seed 42, through the
    kernel's instantiation (stats, nee, physical) and its plain version."""
    sd, scene, cam = scene_on(dev, name)
    lights = extract_lights(sd, dev) if nee else None
    kw = dict(img_w=800, img_h=600, n_rows=8, root=4, max_depth=5, lights=lights, physical=physical,
              with_stats=stats)
    row0, seed = 296, 42
    k1 = render_block_sweep(scene, cam, row0, 0, seed, n_samples=16, **kw)
    k2 = render_block_sweep(scene, cam, row0, 0, seed, n_samples=16, **kw)
    torch.cuda.synchronize()
    what = f"{config_name(stats, nee, physical)} on {name}"
    check(torch.equal(k1.view(torch.int32), k2.view(torch.int32)), f"{what}: two kernel launches differ")
    plain = render_block(scene, cam, row0, 0, seed, n_samples=16, **kw)
    band_ms = event_ms(lambda: render_block_sweep(scene, cam, row0, 0, seed, n_samples=16, **kw), 3)
    band_plain_ms = event_ms(lambda: render_block(scene, cam, row0, 0, seed, n_samples=16, **kw), 3)
    res = {**compare(k1, plain, 4, stats), "kernel_ms": band_ms, "plain_ms": band_plain_ms}
    log(f"kernel vs plain ({what}, 8x800, root 4, depth 5, seed 42):", json.dumps(res))
    check_vs_plain(res, what)
    # Sample ranges add up: [0, 8) + [8, 16) == [0, 16), to float32 rounding.
    parts = render_block_sweep(scene, cam, row0, 0, seed, n_samples=8, **kw) + render_block_sweep(
        scene, cam, row0, 8, seed, n_samples=8, **kw
    )
    rel = float(((parts - k1).abs() / k1.abs().clamp_min(1e-30)).max())
    log(f"s0 split, {what}: max relative diff of [0,8)+[8,16) vs [0,16): {rel:.3e}")
    check(rel <= 1e-5, f"s0 split, {what}: disagrees beyond 1e-5 relative")
    return res


def phase_goldens(dev) -> None:
    for name in ("demo1", "demo2"):
        img = Renderer(scene_small(name), 4, 5, seed=42, device=dev).render_image()
        golden = np.load(os.path.join(HERE, "tests", f"golden_{name}_80x60_r4_s42.npy"))
        d = np.abs(img - golden)
        over = np.argwhere(d.max(-1) > 5e-3)
        log(
            f"golden {name}: max |diff| {d.max():.3e}, mean |diff| {d.mean():.3e}, "
            f"pixels over 5e-3: {len(over)} {over[:10].tolist()}, "
            f"mean shift {abs(float(img.mean()) - float(golden.mean())):.3e}"
        )
        check(img.shape == golden.shape and np.isfinite(img).all(), f"golden {name}: bad frame")
        check(len(over) == 0, f"golden {name}: pixels off by more than atol 5e-3")
        check(abs(float(img.mean()) - float(golden.mean())) < 1e-3, f"golden {name}: mean shift")


def png_levels(path: str) -> np.ndarray:
    """An 8-bit PNG as int32 levels."""
    from PIL import Image as PILImage

    return np.asarray(PILImage.open(path), np.int32)


def levels(img: np.ndarray) -> np.ndarray:
    """A frame as 8-bit levels, rounded as the PNG writer rounds."""
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.int32)


def phase_main_path(out_dir: str, card: str) -> dict:
    argv = ["scenes/demo2.yml", "-r", "128", "-d", "5", "--seed", "0", "--output-dir", out_dir]
    render_block_sweep.launches.clear()
    t0 = time.perf_counter()
    # cli.run is cli.main without the exit code: it also returns its timings.
    ran = cli_run([os.path.join(HERE, argv[0]), *argv[1:]])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = render_block_sweep.launches.total()
    check(launches > 0, "the main path launched no sweep megakernel")
    check(dict(render_block_sweep.launches) == {"sweep": launches}, "the main path left K1")
    path = os.path.join(out_dir, "demo2.ppm")
    check(ran["out"] == path, f"the CLI wrote {ran['out']}, not {path}")
    with open(path, "rb") as f:
        head = f.read(32).split(b"\n")[:3]
    check(head == [b"P3", b"800 600", b"65535"], f"bad PPM header {head}")
    img = read_ppm(path)
    check(img.shape == (600, 800, 3) and np.isfinite(img).all(), "bad PPM body")
    samples = 800 * 600 * 128 * 128
    check(ran["samples"] == samples, f"the CLI rendered {ran['samples']} samples, not {samples}")
    # The JAX package's render of this frame and seed (bench.py), as 8-bit PNG.
    d = np.abs(levels(img) - png_levels(os.path.join(HERE, "artifacts", "demo2_16384spp.png")))
    res = {
        "cli_seconds": seconds,
        "msamples_per_s": samples / seconds / 1e6,
        "band_loop_seconds": ran["band_seconds"],
        "band_loop_msamples_per_s": samples / ran["band_seconds"] / 1e6,
        "launches": launches,
        "vs_jax_png_mean_abs_levels": float(d.mean()),
        "vs_jax_png_max_abs_levels": int(d.max()),
        "vs_jax_png_frac_over_2_levels": float((d > 2).mean()),
    }
    log(f"main path (cli demo2 800x600, 16384 spp, depth 5, seed 0) on {card}:", json.dumps(res))
    check(res["vs_jax_png_mean_abs_levels"] < 0.5, "frame differs from the JAX render")
    check(res["vs_jax_png_frac_over_2_levels"] < 0.01, "frame differs from the JAX render")
    return res


def plan_of(plan) -> dict:
    """A launch plan as the kernels line prints it: threads per pixel,
    pixels per block, blocks, blocks resident per SM, and waves."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return {"split": plan.split, "pixels_per_block": plan.pixels_per_block, "blocks": plan.blocks,
            "blocks_per_sm": plan.slots // n_sm, "waves": plan.waves}


def measure_launch(dev, name, *, row0, n_rows, n_samples, root, nee=False, physical=False,
                   stats=False, frame=False) -> dict:
    """One of a path's launches (seed 0, depth 5, full width): the kernel's
    time, its bound from the kernel's own work counters, the plain
    version's time on the same launch, and the two results held against
    each other at phase 3's gate. ``frame`` also times a whole frame of
    such launches, as the CLI makes them."""
    sd, scene, cam = scene_on(dev, name)
    lights = extract_lights(sd, dev) if nee else None
    kw = dict(img_w=800, img_h=600, n_rows=n_rows, n_samples=n_samples, root=root, max_depth=5,
              lights=lights, physical=physical, with_stats=stats)
    n_pix = n_rows * 800
    nc = n_counts(nee, physical)
    counts = torch.empty((n_pix,) if nc == 1 else (nc, n_pix), dtype=torch.int32, device=dev)
    render_block_sweep(scene, cam, row0, 0, 0, bounce_counts=counts, **{**kw, "with_stats": False})
    torch.cuda.synchronize()
    work = counts.to(torch.int64).reshape(nc, n_pix).sum(dim=1).tolist() + [0] * (5 - nc)
    samples = n_pix * n_samples
    flops = flops_lower_bound(
        scene, samples, work[0], with_stats=stats, physical=physical, light_samples=work[1],
        shadow_rays=work[2], reverse_densities=work[3], glossy_lobes=work[4],
    )
    # Radiance (and Σ lum²) out; the scene and light constants in.
    bytes_moved = (4 if stats else 3) * n_pix * 4 + ctypes.sizeof(FluxScene) + (
        ctypes.sizeof(FluxLights) if nee else 0)
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    kernel_ms = event_ms(lambda: render_block_sweep(scene, cam, row0, 0, 0, **kw), 3)
    plan = plan_of(render_block_sweep.last_plan)
    k = render_block_sweep(scene, cam, row0, 0, 0, **kw)
    frame_ms = None
    if frame:
        frame_ms = event_ms(
            lambda: [render_block_sweep(scene, cam, r, 0, 0, **kw) for r in range(0, 600, n_rows)], 1)[0]
    # The plain version on the same launch, in chunks of ~4M lanes.
    chunk = max(1, (4 << 20) // n_pix)
    plain_out = []

    def plain():
        acc = None
        for s0, n in plan_chunks(n_samples, chunk):
            part = render_block(scene, cam, row0, s0, 0, **{**kw, "n_samples": n})
            acc = part if acc is None else acc + part
        plain_out.append(acc)

    plain_ms = event_ms(plain, 1)[0]
    p = plain_out[0]
    what = f"{config_name(stats, nee, physical)}, {name} band {n_rows}x800 at row {row0}, {n_samples} spp"
    cmp = compare(k, p, root, stats)
    log(f"kernel vs plain ({what}, depth 5, seed 0):", json.dumps(cmp))
    check_vs_plain(cmp, what)
    res = {
        "vs_plain": cmp,
        "kernel_ms": kernel_ms,
        "launch_plan": plan,
        "frame_kernel_ms": frame_ms,
        "plain_ms": plain_ms,
        "bounces": work[0],
        "samples": samples,
        "bounces_per_sample": work[0] / samples,
        "work_counts": work,
        "flops_lower_bound": flops,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "shape": f"{name} band {n_rows}x800 px, {n_samples} spp, depth 5",
    }
    log(f"measure ({what}):", json.dumps(res))
    return res


def phase_measure(dev) -> dict:
    """The kernel at the main path's launch shape: one 50-row band of demo2
    at 16384 spp, depth 5, seed 0 (rows 300-349, one of the CLI's bands)."""
    return measure_launch(dev, "demo2", row0=300, n_rows=50, n_samples=16384, root=128, frame=True)


# The JAX package's estimator values on these paths (bench.py on a TPU,
# artifacts/bench_extra.json): image statistics of bit-identical sample
# streams, not speeds.
ADAPTIVE_SPP, ADAPTIVE_P99 = 768, 0.11675
MIS_MSE = 0.002073

# Phase 7: (scene, nee, physical, stats) of each new instantiation's check.
CONFIGS = [
    ("demo3", False, False, True),
    ("demo2", True, False, False),
    ("demo3", True, False, False),
    ("demo3", False, True, False),
    ("demo3", True, True, False),
    ("demo2", True, False, True),
    ("demo3", False, True, True),
    ("demo3", True, True, True),
]


def run_path(label: str, fn):
    """Drive one path with every launch count set to 0 just before it;
    returns its result and the launches by instantiation just after."""
    render_block_sweep.launches.clear()
    render_block_scene.launches.clear()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(not set(render_block_sweep.launches) & set(render_block_scene.launches),
          "the two wrappers count under one name")
    launches = {**render_block_sweep.launches, **render_block_scene.launches}
    log(f"path {label}: {seconds:.3f} s, launches {json.dumps(launches)}")
    return res, launches, seconds


def phase_paths(dev, out_dir: str) -> dict:
    """Phase 8: the quality paths through their entry points."""
    demo2 = os.path.join(HERE, "scenes", "demo2.yml")
    demo3 = os.path.join(HERE, "scenes", "demo3.yml")
    launches = {}

    # a. demo2 adaptive.
    ran, n, secs = run_path("demo2 adaptive", lambda: cli_run(
        [demo2, "-r", "32", "-d", "5", "--progressive", "64", "--adaptive", "0.12", "--seed", "0",
         "--output-dir", os.path.join(out_dir, "adaptive")]))
    adaptive = {"spp_done": ran["spp_done"], "p99_rel_stderr": ran["p99_rel_stderr"], "seconds": secs,
                "launches": n}
    log("demo2 adaptive (cli -r 32 -d 5 --progressive 64 --adaptive 0.12):", json.dumps(adaptive))
    check(set(n) == {"sweep+stats"}, "demo2 adaptive: not all launches were the stats kernel")
    check(ran["spp_done"] == ADAPTIVE_SPP, f"demo2 adaptive stopped at {ran['spp_done']}, not {ADAPTIVE_SPP} spp")
    check(abs(ran["p99_rel_stderr"] - ADAPTIVE_P99) <= 5e-4, "demo2 adaptive: p99 rel stderr off by > 5e-4")
    launches.update(n)

    # b. demo2 NEE against the 16384-spp reference-transport frame.
    ran, n, secs = run_path("demo2 nee", lambda: cli_run(
        [demo2, "-r", "32", "-d", "5", "--nee", "--seed", "0", "--output-dir", os.path.join(out_dir, "nee")]))
    img = read_ppm(ran["out"])
    check(img.shape == (600, 800, 3) and np.isfinite(img).all(), "demo2 nee: bad PPM")
    d = np.abs(levels(img) - png_levels(os.path.join(HERE, "artifacts", "demo2_16384spp.png")))
    nee = {"seconds": secs, "band_loop_seconds": ran["band_seconds"], "launches": n,
           "vs_16384spp_png_mean_abs_levels": float(d.mean()),
           "vs_16384spp_png_frac_over_8_levels": float((d > 8).mean())}
    log("demo2 nee (cli -r 32 -d 5 --nee) vs the 16384-spp frame:", json.dumps(nee))
    check(set(n) == {"sweep+nee"}, "demo2 nee: not all launches were the NEE kernel")
    check(nee["vs_16384spp_png_mean_abs_levels"] < 3.0, "demo2 nee: frame far from the reference frame")
    launches.update(n)

    # c. demo3 physical MIS: 16 spp against a 1024-spp truth.
    def mis():
        sd3 = load_scene(demo3)
        truth = Renderer(sd3, 32, 5, seed=7, device=dev, nee=True, physical=True).render_image(rows_per_band=600)
        img16 = Renderer(sd3, 4, 5, seed=0, device=dev, nee=True, physical=True).render_image(rows_per_band=600)
        return truth, img16

    (truth, img16), n, secs = run_path("demo3 mis", mis)
    check(np.isfinite(truth).all() and np.isfinite(img16).all(), "demo3 mis: non-finite pixels")
    mse = float(((img16 - truth) ** 2).mean())
    mis_res = {"seconds": secs, "launches": n, "mse_16spp_vs_1024spp": mse, "jax_mse": MIS_MSE,
               "rel_diff": mse / MIS_MSE - 1.0}
    log("demo3 physical MIS (16 spp seed 0 vs 1024 spp seed 7):", json.dumps(mis_res))
    check(set(n) == {"sweep+nee+physical"}, "demo3 mis: not all launches were the MIS kernel")
    check(abs(mse / MIS_MSE - 1.0) <= 0.02, "demo3 mis: MSE more than 2% off the JAX package's")
    launches.update(n)

    # d. demo3 physical transport without NEE, against the MIS truth.
    ran, n, secs = run_path("demo3 physical", lambda: cli_run(
        [demo3, "-r", "16", "-d", "5", "--physical", "--seed", "0",
         "--output-dir", os.path.join(out_dir, "physical")]))
    img = read_ppm(ran["out"])
    check(img.shape == (600, 800, 3) and np.isfinite(img).all(), "demo3 physical: bad PPM")
    phys = {"seconds": secs, "launches": n, "mse_vs_mis_truth": float(((img - truth) ** 2).mean()),
            "mean": float(img.mean()), "truth_mean": float(truth.mean())}
    log("demo3 physical (cli -r 16 -d 5 --physical) vs the MIS truth:", json.dumps(phys))
    check(set(n) == {"sweep+physical"}, "demo3 physical: not all launches were the physical kernel")
    check(abs(phys["mean"] / phys["truth_mean"] - 1.0) < 0.1, "demo3 physical: mean far from the MIS truth")
    launches.update(n)

    # e. demo3 progressive with a checkpoint, resumed through the CLI.
    ck = os.path.join(out_dir, "demo3.ckpt.npz")
    whole_ck = os.path.join(out_dir, "demo3-whole.ckpt.npz")
    cli_args = [demo3, "-r", "32", "-d", "5", "--nee", "--physical", "--progressive", "64", "--seed", "0"]

    def progressive():
        pr = ProgressiveRenderer(load_scene(demo3), 32, 5, seed=0, device=dev, nee=True, physical=True)
        pr.render_pass(64)
        pr.render_pass(64)
        pr.save(ck)
        resumed = cli_run(cli_args + ["--checkpoint", ck, "--resume", "--output-dir", os.path.join(out_dir, "r")])
        whole = cli_run(cli_args + ["--checkpoint", whole_ck, "--output-dir", os.path.join(out_dir, "w")])
        return resumed, whole

    (resumed, whole), n, secs = run_path("demo3 progressive", progressive)
    a, b = load_checkpoint(ck), load_checkpoint(whole_ck)
    prog = {"seconds": secs, "launches": n, "resumed_spp": resumed["spp_done"], "whole_spp": whole["spp_done"],
            "acc_bitwise_equal": bool(np.array_equal(a[0].view(np.int32), b[0].view(np.int32))),
            "lum_sq_bitwise_equal": bool(np.array_equal(a[3].view(np.int32), b[3].view(np.int32))),
            "pass_loop_seconds_whole": whole["band_seconds"]}
    log("demo3 progressive (2 passes saved, resumed by the CLI) vs uninterrupted:", json.dumps(prog))
    check(set(n) == {"sweep+nee+physical+stats"}, "demo3 progressive: not all launches were the MIS+stats kernel")
    check(a[1] == b[1] == 1024 and a[2] == b[2], "demo3 progressive: checkpoints disagree on samples or fingerprint")
    check(prog["acc_bitwise_equal"] and prog["lum_sq_bitwise_equal"], "demo3 progressive: resumed != uninterrupted")
    check(np.isfinite(a[0]).all() and a[0].max() > 0, "demo3 progressive: bad accumulator")
    launches.update(n)
    prog["host_split"] = progressive_pass_split(dev, demo3, os.path.join(out_dir, "split.ckpt.npz"))

    # f, g. Progressive NEE alone and physical alone (the stats kernel with
    # each): the checkpoint's accumulator of 2 passes of 32 against one
    # launch of all 64 samples of the frame.
    single = {}
    for label, scene, flags, cfg in (
        ("demo2 progressive nee", demo2, ["--nee"], "sweep+nee+stats"),
        ("demo3 progressive physical", demo3, ["--physical"], "sweep+physical+stats"),
    ):
        ck = os.path.join(out_dir, f"{cfg}.ckpt.npz")
        ran, n, secs = run_path(label, lambda: cli_run(
            [scene, "-r", "8", "-d", "5", *flags, "--progressive", "32", "--seed", "0", "--checkpoint", ck,
             "--output-dir", os.path.join(out_dir, cfg)]))
        acc, done = load_checkpoint(ck)[:2]
        r = Renderer(load_scene(scene), 8, 5, seed=0, device=dev, nee="--nee" in flags,
                     physical="--physical" in flags)
        whole = r.render_rows_sum_range(0, r.height, 0, 64).cpu().numpy()
        rel = float((np.abs(acc - whole) / np.maximum(np.abs(whole), 1e-30)).max())
        single[cfg] = {"seconds": secs, "launches": n, "spp_done": done, "p99_rel_stderr": ran["p99_rel_stderr"],
                       "max_rel_diff_vs_one_launch": rel}
        log(f"{label} (cli -r 8 -d 5 {flags[0]} --progressive 32) vs one launch:", json.dumps(single[cfg]))
        check(set(n) == {cfg}, f"{label}: not all launches were the {cfg} kernel")
        check(done == 64 and ran["p99_rel_stderr"] is not None, f"{label}: did not finish its 64 spp")
        check(rel <= 1e-5, f"{label}: passes disagree with one launch beyond 1e-5 relative")
        launches.update(n)
    return {"adaptive": adaptive, "nee": nee, "mis": mis_res, "physical": phys, "progressive": prog,
            "single": single, "launches": launches}


def progressive_pass_split(dev, scene: str, ck: str) -> dict:
    """Host seconds of one progressive pass (demo3 MIS, 64 spp, after a
    first pass), step by step as run_progressive takes them: each band's
    launch to its end, the copy back to numpy, the adds into the
    accumulators (the body of ProgressiveRenderer.render_pass), then
    max_rel_stderr and save; and the whole render_pass of the next pass."""
    r = Renderer(load_scene(scene), 32, 5, seed=0, device=dev, nee=True, physical=True)
    pr = ProgressiveRenderer.from_renderer(r)
    pr.render_pass(64)
    split = dict.fromkeys(("launch_to_end", "copy_back", "numpy_add"), 0.0)
    for row0 in range(0, pr.height, 128):
        n_rows = min(128, pr.height - row0)
        t0 = time.perf_counter()
        part = r.render_rows_sum_range(row0, n_rows, pr.samples_done, 64, with_stats=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        part = part.cpu().numpy()
        t2 = time.perf_counter()
        pr.acc[row0: row0 + n_rows] += part[..., :3]
        pr.lum_sq[row0: row0 + n_rows] += part[..., 3]
        t3 = time.perf_counter()
        split["launch_to_end"] += t1 - t0
        split["copy_back"] += t2 - t1
        split["numpy_add"] += t3 - t2
    pr.samples_done += 64
    t0 = time.perf_counter()
    pr.max_rel_stderr()
    t1 = time.perf_counter()
    pr.save(ck)
    t2 = time.perf_counter()
    pr.render_pass(64)
    t3 = time.perf_counter()
    split.update(max_rel_stderr=t1 - t0, save=t2 - t1, render_pass=t3 - t2)
    log("progressive pass host split (demo3 MIS, 800x600, 64 spp, 5 bands), seconds:", json.dumps(split))
    return split


# Phase 9: each new instantiation at one launch of its path, and the lines
# of the TPU kernel (configurations of pallas_kernel.py::_kernel) it replaces.
MEASURE = [
    ("sweep+stats", "flux_tpu/ops/pallas_kernel.py:908",
     dict(name="demo2", row0=256, n_rows=128, n_samples=64, root=32, stats=True)),
    ("sweep+nee", "flux_tpu/ops/pallas_kernel.py:764",
     dict(name="demo2", row0=300, n_rows=50, n_samples=1024, root=32, nee=True)),
    ("sweep+physical", "flux_tpu/ops/pallas_kernel.py:279",
     dict(name="demo3", row0=300, n_rows=50, n_samples=256, root=16, physical=True)),
    ("sweep+nee+physical", "flux_tpu/ops/pallas_kernel.py:868",
     dict(name="demo3", row0=0, n_rows=600, n_samples=16, root=4, nee=True, physical=True)),
    ("sweep+nee+physical+stats", "flux_tpu/ops/pallas_kernel.py:868",
     dict(name="demo3", row0=256, n_rows=128, n_samples=64, root=32, nee=True, physical=True, stats=True)),
    ("sweep+nee+stats", "flux_tpu/ops/pallas_kernel.py:764",
     dict(name="demo2", row0=256, n_rows=128, n_samples=32, root=8, nee=True, stats=True)),
    ("sweep+physical+stats", "flux_tpu/ops/pallas_kernel.py:279",
     dict(name="demo3", row0=256, n_rows=128, n_samples=32, root=8, physical=True, stats=True)),
]


# ---- the scene megakernel: scan with block skip, triangles, triangle lights


@contextlib.contextmanager
def phase_timer(label: str):
    """Prints a phase's wall seconds when it ends without a failure."""
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    log(f"phase {label}: {time.perf_counter() - t0:.1f} s")


def scene_setup(dev, sd, accel, nee):
    """(scene, camera, intersector, lights, width, height) of a SceneData."""
    sc = compile_scene(sd, dev)
    cam = camera_tensors(sd.camera_settings, sd.camera_data, sd.output_settings.pixel_size, dev)
    isect = Intersector(
        layout=scan_layout(sc) if accel == "scan" else None, mode=accel,
        tri_layout=tri_layout(sc) if sc.num_triangles else None,
    )
    lights = extract_lights(sd, dev) if nee else None
    return sc, cam, isect, lights, sd.output_settings.image_width, sd.output_settings.image_height


def stock(name: str):
    return load_scene(os.path.join(HERE, "scenes", f"{name}.yml"))


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def work_counts(sc, cam, row0, seed, n_pix, dev, **kw) -> dict:
    """One counting launch: the kernel's work counters summed over the band
    (the counting instantiations take no stats channel, which adds no work)."""
    counts = torch.zeros((scene_kernel.N_COUNTS, n_pix), dtype=torch.int32, device=dev)
    render_block_scene(sc, cam, row0, 0, seed, work_counts=counts, **{**kw, "with_stats": False})
    torch.cuda.synchronize()
    return dict(zip(scene_kernel.COUNT_NAMES, counts.to(torch.int64).sum(dim=1).tolist()))


def entered_share(c: dict, isect) -> dict:
    """Blocks entered per fold, and as a share of the table, from a counting
    launch: sphere folds are the bounces and the shadow folds, triangle
    folds the same."""
    folds = max(c["bounces"] + c["shadow_folds"], 1)
    out = {}
    if isect.mode == "scan":
        nb = isect.layout.n_blocks
        out.update(sphere_blocks=nb, sphere_blocks_entered_per_fold=c["sphere_blocks_entered"] / folds,
                   sphere_share_entered=c["sphere_blocks_entered"] / folds / nb,
                   sphere_blocks_needed_per_fold=c["sphere_blocks_needed"] / folds,
                   sphere_box_tests_per_fold=c["sphere_box_tests"] / folds)
    if isect.tri_layout is not None:
        nb = isect.tri_layout.n_blocks
        out.update(tri_blocks=nb, tri_blocks_entered_per_fold=c["tri_blocks_entered"] / folds,
                   tri_share_entered=c["tri_blocks_entered"] / folds / nb,
                   tri_blocks_needed_per_fold=c["tri_blocks_needed"] / folds,
                   tri_box_tests_per_fold=c["tri_box_tests"] / folds)
    return out


# Skip options of the scene kernel: all off, one level of boxes, all on
# (the triangle skip is otherwise engaged by block count).
NO_SKIP = {"scan_skip": False, "tri_skip": False}
ONE_LEVEL = {"two_level": False}
SKIP_ON = {"scan_skip": True, "tri_skip": True}

# Phase 10: (scene, accel, nee, physical, stats).
SCENE_CONFIGS = [
    ("spheres512", "scan", False, False, False),
    ("spheres512", "scan", True, False, False),
    ("spheres512", "scan", True, True, False),
    ("spheres512", "scan", False, False, True),
    ("spheres512", "scan", True, False, True),
    ("mesh_ico", "sweep", False, False, False),
    ("mesh_ico", "sweep", False, True, True),
    ("demo4", "sweep", True, False, False),
    ("demo5", "sweep", True, False, False),
    ("demo5", "sweep", True, True, False),
    ("demo5", "sweep", True, False, True),
    ("demo5", "sweep", True, True, True),
]


def phase_scene_kernel_vs_plain(dev, name, accel, nee, physical, stats) -> dict:
    """An 8-row band at the scene's full width, root 4, depth 5, seed 42,
    through the scene megakernel and its plain version; the skip off and the
    single-level skip bitwise equal."""
    sc, cam, isect, lights, w, h = scene_setup(dev, stock(name), accel, nee)
    kw = dict(isect=isect, img_w=w, img_h=h, n_rows=8, root=4, max_depth=5, lights=lights,
              physical=physical, with_stats=stats)
    row0, seed = h // 2 - 4, 42
    cfg = scene_kernel.config_name(accel, sc.num_triangles > 0, stats, nee, physical,
                                   tri_lights=nee and lights.has_tris)
    what = f"{cfg} on {name}"
    k1 = render_block_scene(sc, cam, row0, 0, seed, n_samples=16, **kw)
    k2 = render_block_scene(sc, cam, row0, 0, seed, n_samples=16, **kw)
    torch.cuda.synchronize()
    check(bits_equal(k1, k2), f"{what}: two kernel launches differ")
    for off in (NO_SKIP, ONE_LEVEL, SKIP_ON):
        ko = render_block_scene(sc, cam, row0, 0, seed, n_samples=16, **kw, **off)
        check(bits_equal(k1, ko), f"{what}: {off} changes the result")
    plain = render_block(sc, cam, row0, 0, seed, n_samples=16, **kw)
    res = {
        **compare(k1, plain, 4, stats),
        "skip_off_bitwise_equal": True,
        "single_level_bitwise_equal": True,
        "skip_on_bitwise_equal": True,
        "kernel_ms": event_ms(lambda: render_block_scene(sc, cam, row0, 0, seed, n_samples=16, **kw), 3),
        "plain_ms": event_ms(lambda: render_block(sc, cam, row0, 0, seed, n_samples=16, **kw), 1),
    }
    res.update(entered_share(work_counts(sc, cam, row0, seed, 8 * w, dev, n_samples=16, **kw), isect))
    log(f"kernel vs plain ({what}, 8x{w}, root 4, depth 5, seed 42):", json.dumps(res))
    check(bool(torch.isfinite(k1).all()), f"{what}: non-finite sums")
    check_vs_plain(res, what)
    parts = render_block_scene(sc, cam, row0, 0, seed, n_samples=8, **kw) + render_block_scene(
        sc, cam, row0, 8, seed, n_samples=8, **kw)
    rel = float(((parts - k1).abs() / k1.abs().clamp_min(1e-30)).max())
    log(f"s0 split, {what}: max relative diff of [0,8)+[8,16) vs [0,16): {rel:.3e}")
    check(rel <= 1e-5, f"s0 split, {what}: disagrees beyond 1e-5 relative")
    return res


def phase_scan_equals_sweep(dev) -> None:
    """The scan (scene megakernel) against the sweep megakernel, bitwise, on
    whole 160x120 frames of sphere_field(24) and (40): 16 spp, depth 5, with
    stats, reference transport and MIS. NaN sums (the reference's estimator
    yields a few on these fields; both kernels at the same pixels) compare
    by their bits too."""
    for n in (24, 40):
        sd = genscene.sphere_field(n, seed=3, width=160, height=120)
        for nee, physical in ((False, False), (True, True)):
            scan = Renderer(sd, 4, 5, seed=1, device=dev, accel="scan", nee=nee, physical=physical)
            sweep = Renderer(sd, 4, 5, seed=1, device=dev, accel="sweep", nee=nee, physical=physical)
            check(not scan.uses_sweep_kernel and sweep.uses_sweep_kernel, "scan vs sweep: wrong kernels")
            a = scan.render_rows_sum_range(0, 120, 0, 16, with_stats=True)
            b = sweep.render_rows_sum_range(0, 120, 0, 16, with_stats=True)
            res = {"spheres": n + 1, "nee": nee, "physical": physical, "bitwise_equal": bits_equal(a, b),
                   "non_finite_values": int((~torch.isfinite(a)).sum()), "n_values": a.numel()}
            log("scan kernel vs sweep kernel:", json.dumps(res))
            check(res["bitwise_equal"], f"scan and sweep kernels differ on sphere_field({n})")
            check(res["non_finite_values"] <= 0.001 * a.numel(), "scan vs sweep: too many non-finite sums")


def frame_vs_png(img: np.ndarray, png: str) -> dict:
    signed = levels(img) - png_levels(os.path.join(HERE, "artifacts", png))
    d = np.abs(signed)
    return {"mean_abs_levels": float(d.mean()), "mean_signed_levels": float(signed.mean()),
            "max_abs_levels": int(d.max()),
            "frac_over_2_levels": float((d > 2).mean()), "frac_over_8_levels": float((d > 8).mean())}


def cli_path(label, argv, out_dir, expect, size) -> tuple:
    """One path through cli.run: its result, launches and seconds; the PPM
    must be whole and every launch of the expected configuration."""
    ran, n, secs = run_path(label, lambda: cli_run([*argv, "--seed", "0", "--output-dir", out_dir]))
    check(set(n) == {expect}, f"{label}: launches {n}, expected only {expect}")
    img = read_ppm(ran["out"])
    check(img.shape == (size[1], size[0], 3) and np.isfinite(img).all(), f"{label}: bad PPM")
    res = {"seconds": secs, "band_loop_seconds": ran["band_seconds"], "launches": n, "samples": ran["samples"],
           "band_loop_msamples_per_s": ran["samples"] / ran["band_seconds"] / 1e6, "mean": float(img.mean())}
    return ran, img, res


def phase_scene_paths(dev, out_dir: str, card: str) -> dict:
    """Phase 11: the slice's paths through their entry points."""
    launches, results = {}, {}

    def note(label, res):
        results[label] = res
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
        log(f"{label} on {card}:", json.dumps(res))

    scene = lambda name: os.path.join(HERE, "scenes", f"{name}.yml")
    # a. Large scenes: spheres512 at 64 spp; the Renderer picks the scan.
    _, img, res = cli_path("spheres512 scan", [scene("spheres512"), "-r", "8", "-d", "5"],
                           os.path.join(out_dir, "s512"), "scan", (800, 600))
    res["vs_jax_png"] = frame_vs_png(img, "spheres512_64spp.png")
    note("spheres512 (cli -r 8 -d 5, 800x600, 64 spp)", res)
    # Among 513 small spheres a sample that grazes one goes another way on
    # another arithmetic, and at 64 spp one such sample moves a pixel by a
    # few levels: the gates are on the means. That these are such samples is
    # held on the CPU, sample by sample against the float64 oracle
    # (tests/test_torch_scan.py), and here by phase 13, which holds rows of
    # this path's own launch against the plain version.
    check(res["vs_jax_png"]["mean_abs_levels"] < 3.0, "spheres512: frame differs from the JAX render")
    check(abs(res["vs_jax_png"]["mean_signed_levels"]) < 0.3, "spheres512: frame brighter or darker than the JAX render")
    check(res["vs_jax_png"]["frac_over_8_levels"] < 0.05, "spheres512: frame differs from the JAX render")
    # b. Meshes: icosphere(3) in mesh_scene (1280 triangles) through the Renderer, mesh_ico.yml through the CLI.
    def mesh1280():
        r = Renderer(meshgen.mesh_scene(*meshgen.icosphere(3)), 4, 5, seed=0, device=dev)
        t0 = time.perf_counter()
        img = r.render_image(rows_per_band=50)
        return r, img, time.perf_counter() - t0

    (r, img, band_s), n, secs = run_path("mesh1280", mesh1280)
    check(r.scene.num_triangles == 1280 and r.isect.tri_layout.n_blocks == 80, "mesh1280: wrong mesh")
    check(set(n) == {"sweep+tri"} and n["sweep+tri"] == 12, f"mesh1280: launches {n}")
    check(img.shape == (600, 800, 3) and np.isfinite(img).all() and img.max() > 0.5, "mesh1280: bad frame")
    samples = 800 * 600 * 16
    note("mesh1280 (Renderer, icosphere(3), 800x600, 16 spp)",
         {"seconds": secs, "band_loop_seconds": band_s, "launches": n, "samples": samples,
          "band_loop_msamples_per_s": samples / band_s / 1e6, "mean": float(img.mean())})
    _, img, res = cli_path("mesh_ico", [scene("mesh_ico"), "-r", "4", "-d", "5"],
                           os.path.join(out_dir, "mesh"), "sweep+tri", (800, 600))
    note("mesh_ico (cli -r 4 -d 5, 320 triangles, 800x600, 16 spp)", res)
    # c. The Cornell box: demo5 at 1024 spp with NEE over its triangle quad light.
    _, img, res = cli_path("demo5 nee", [scene("demo5"), "-r", "32", "-d", "5", "--nee"],
                           os.path.join(out_dir, "d5"), "sweep+tri+nee+trilight", (512, 512))
    # The JAX package's frame of this scene at 2304 spp (another sample count: a loose gate).
    res["vs_jax_2304spp_png"] = frame_vs_png(img, "demo5_cornell_2304spp.png")
    note("demo5 (cli -r 32 -d 5 --nee, 512x512, 1024 spp)", res)
    check(res["vs_jax_2304spp_png"]["mean_abs_levels"] < 3.0, "demo5: frame far from the JAX render")
    # d. Short renders that take the other configurations.
    for label, argv, expect, size in (
        ("spheres512 nee", [scene("spheres512"), "-r", "4", "-d", "5", "--nee"], "scan+nee", (800, 600)),
        ("mesh_ico physical", [scene("mesh_ico"), "-r", "4", "-d", "5", "--physical"], "sweep+tri+physical", (800, 600)),
        ("demo5 mis", [scene("demo5"), "-r", "8", "-d", "5", "--nee", "--physical"],
         "sweep+tri+nee+trilight+physical", (512, 512)),
        ("spheres512 progressive", [scene("spheres512"), "-r", "4", "-d", "5", "--progressive", "8"],
         "scan+stats", (800, 600)),
        ("mesh_ico progressive physical", [scene("mesh_ico"), "-r", "4", "-d", "5", "--physical", "--progressive", "8"],
         "sweep+tri+physical+stats", (800, 600)),
        ("demo5 progressive nee", [scene("demo5"), "-r", "4", "-d", "5", "--nee", "--progressive", "8"],
         "sweep+tri+nee+trilight+stats", (512, 512)),
    ):
        _, img, res = cli_path(label, argv, os.path.join(out_dir, expect), expect, size)
        check(img.max() > 0.2, f"{label}: a black frame")
        note(label, res)
    # e. demo5 MIS progressive with a checkpoint, resumed through the CLI: bitwise equal.
    ck, whole_ck = os.path.join(out_dir, "d5.ckpt.npz"), os.path.join(out_dir, "d5-whole.ckpt.npz")
    args = [scene("demo5"), "-r", "8", "-d", "5", "--nee", "--physical", "--progressive", "16", "--seed", "0"]

    def progressive():
        pr = ProgressiveRenderer(stock("demo5"), 8, 5, seed=0, device=dev, nee=True, physical=True)
        pr.render_pass(16)
        pr.save(ck)
        resumed = cli_run(args + ["--checkpoint", ck, "--resume", "--output-dir", os.path.join(out_dir, "d5r")])
        whole = cli_run(args + ["--checkpoint", whole_ck, "--output-dir", os.path.join(out_dir, "d5w")])
        return resumed, whole

    (resumed, whole), n, secs = run_path("demo5 progressive mis", progressive)
    a, b = load_checkpoint(ck), load_checkpoint(whole_ck)
    res = {"seconds": secs, "launches": n, "resumed_spp": resumed["spp_done"], "whole_spp": whole["spp_done"],
           "acc_bitwise_equal": bool(np.array_equal(a[0].view(np.int32), b[0].view(np.int32))),
           "lum_sq_bitwise_equal": bool(np.array_equal(a[3].view(np.int32), b[3].view(np.int32)))}
    note("demo5 progressive MIS (1 pass saved, resumed by the CLI) vs uninterrupted", res)
    check(set(n) == {"sweep+tri+nee+trilight+physical+stats"}, f"demo5 progressive: launches {n}")
    check(a[1] == b[1] == 64 and a[2] == b[2], "demo5 progressive: checkpoints disagree")
    check(res["acc_bitwise_equal"] and res["lum_sq_bitwise_equal"], "demo5 progressive: resumed != uninterrupted")
    # f. The 96-sphere field at the golden's size, on the card.
    sd = genscene.sphere_field(96, seed=7, width=80, height=60)
    sd = replace(sd, output_settings=replace(sd.output_settings, pixel_size=10.0))
    (r, img), n, secs = run_path("field96 golden", lambda: (lambda r: (r, r.render_image()))(
        Renderer(sd, 4, 5, seed=42, device=dev)))
    golden = np.load(os.path.join(HERE, "tests", "golden_field96_80x60_r4_s42.npy"))
    d = np.abs(img - golden)
    res = {"seconds": secs, "launches": n, "accel": r.accel, "max_abs_diff": float(d.max()),
           "mean_abs_diff": float(d.mean()), "frac_over_5e-3": float((d > 5e-3).mean()),
           "mean_shift": abs(float(img.mean()) - float(golden.mean()))}
    note("field96 golden (80x60, root 4, depth 5, seed 42) on the card", res)
    check(r.accel == "scan" and set(n) == {"scan"}, "field96: the scan was not picked")
    # tests/test_torch_scan.py's gate; there the oracle adjudicates each miss.
    check(res["frac_over_5e-3"] <= 0.005 and res["max_abs_diff"] <= 2.0 / 16 and res["mean_shift"] < 1e-3,
          "field96: frame differs from the golden")
    return {"results": results, "launches": launches}


def phase_big_field(dev) -> dict:
    """Phase 12: one 50-row band of sphere_field(16384) at 800x600, 16 spp,
    depth 5: the size users of the scan call real."""
    sc, cam, isect, _, w, h = scene_setup(dev, genscene.sphere_field(16384, seed=0), "scan", False)
    kw = dict(isect=isect, img_w=w, img_h=h, n_rows=50, n_samples=16, root=4, max_depth=5)
    row0 = 300
    k = render_block_scene(sc, cam, row0, 0, 0, **kw)
    single = render_block_scene(sc, cam, row0, 0, 0, two_level=False, **kw)
    noskip = render_block_scene(sc, cam, row0, 0, 0, scan_skip=False, **kw)
    torch.cuda.synchronize()
    c = work_counts(sc, cam, row0, 0, 50 * w, dev, **kw)
    # The band's first row against the plain version (513 blocks, 65 group boxes).
    plain = []
    plain_ms = event_ms(lambda: plain.append(render_block(sc, cam, row0, 0, 0, **{**kw, "n_rows": 1})), 1)[0]
    cmp = compare(k[:1], plain[0], 4, False)
    res = {
        "vs_plain_first_row": cmp, "plain_ms_first_row": plain_ms,
        "spheres": sc.num_spheres, "blocks": isect.layout.n_blocks,
        "table_bytes": scene_kernel.table_bytes(isect, None, sc.num_spheres + sc.num_planes),
        "ms_two_level": event_ms(lambda: render_block_scene(sc, cam, row0, 0, 0, **kw), 3),
        "ms_one_level": event_ms(lambda: render_block_scene(sc, cam, row0, 0, 0, two_level=False, **kw), 3),
        "ms_no_skip": event_ms(lambda: render_block_scene(sc, cam, row0, 0, 0, scan_skip=False, **kw), 1),
        "one_level_bitwise_equal": bits_equal(k, single), "no_skip_bitwise_equal": bits_equal(k, noskip),
        "bounces_per_sample": c["bounces"] / (50 * w * 16), **entered_share(c, isect),
    }
    log("sphere_field(16384), one 50x800 band, 16 spp, depth 5:", json.dumps(res))
    check(bool(torch.isfinite(k).all()) and float(k.max()) > 0, "16384 spheres: bad sums")
    check(res["one_level_bitwise_equal"] and res["no_skip_bitwise_equal"], "16384 spheres: the skip changes the result")
    check_vs_plain(cmp, "scan on sphere_field(16384), the band's first row")
    return res


def measure_scene_launch(dev, sd, label, *, accel, row0, n_rows, n_samples, root, plain_rows, nee=False,
                         physical=False, stats=False, skips=()) -> dict:
    """One of a path's launches (seed 0, depth 5, the scene's full width):
    the kernel's time (median of 3), its bound from its own work counters,
    and the plain version on the first ``plain_rows`` rows of the band: its
    time there, and those rows of the path's own launch held against it at
    phase 3's gate. ``skips``: wrapper options to time beside the default."""
    sc, cam, isect, lights, w, h = scene_setup(dev, sd, accel, nee)
    kw = dict(isect=isect, img_w=w, img_h=h, n_samples=n_samples, root=root, max_depth=5, lights=lights,
              physical=physical, with_stats=stats)
    n_pix = n_rows * w
    c = work_counts(sc, cam, row0, 0, n_pix, dev, n_rows=n_rows, **kw)
    samples = n_pix * n_samples
    tri_share = 0.0
    if lights is not None and lights.has_tris:
        tri_share = float(lights.host["pick"][lights.host["is_tri"] > 0.5].sum())
    flops = scene_kernel.flops_lower_bound(sc, isect, samples, c, with_stats=stats, physical=physical,
                                           tri_light_fraction=tri_share)
    n_shapes = sc.num_spheres + sc.num_planes + sc.num_triangles
    bytes_moved = (4 if stats else 3) * n_pix * 4 + ctypes.sizeof(FluxScene) + scene_kernel.table_bytes(
        isect, lights, n_shapes)
    ops_ms, bytes_ms = flops / PEAK_FP32_FLOPS * 1e3, bytes_moved / PEAK_BYTES_PER_S * 1e3
    kernel_ms = event_ms(lambda: render_block_scene(sc, cam, row0, 0, 0, n_rows=n_rows, **kw), 3)
    plan = plan_of(render_block_scene.last_plan)
    timed = {json.dumps(o): float(np.median(event_ms(
        lambda: render_block_scene(sc, cam, row0, 0, 0, n_rows=n_rows, **kw, **o), 3))) for o in skips}
    k = render_block_scene(sc, cam, row0, 0, 0, n_rows=n_rows, **kw)[:plain_rows]
    chunk = max(1, (2 << 20) // (plain_rows * w))
    plain_out = []

    def plain():
        acc = None
        for s0, n in plan_chunks(n_samples, chunk):
            part = render_block(sc, cam, row0, s0, 0, n_rows=plain_rows, **{**kw, "n_samples": n})
            acc = part if acc is None else acc + part
        plain_out.append(acc)

    plain_ms = event_ms(plain, 1)[0]
    p = plain_out[0]
    what = f"{label}, rows [0, {plain_rows}) of the {n_rows}x{w} launch at row {row0}, {n_samples} spp"
    cmp = compare(k, p, root, stats)
    log(f"kernel vs plain ({what}, depth 5, seed 0):", json.dumps(cmp))
    check_vs_plain(cmp, what)
    res = {
        "vs_plain": cmp, "kernel_ms": kernel_ms, "launch_plan": plan, "timed_options_ms": timed,
        "plain_ms": plain_ms,
        "plain_shape": f"{plain_rows}x{w} px, {n_samples} spp (rows [0, {plain_rows}) of the launch)",
        "samples": samples, "bounces_per_sample": c["bounces"] / samples, "work_counts": c,
        "flops_lower_bound": flops, "bytes": bytes_moved, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "shape": f"{sd.scene_name} band {n_rows}x{w} px, {n_samples} spp, depth 5",
        **entered_share(c, isect),
    }
    log(f"measure ({label}):", json.dumps(res))
    return res


# Phase 13: configuration -> (K, lines of the TPU kernel it replaces, scene,
# launch). K5 the scan, K6 the triangle fold, K7 triangle lights.
SCENE_MEASURE = [
    ("scan", "flux_tpu/ops/pallas_kernel.py:332", "spheres512",
     dict(accel="scan", row0=300, n_rows=50, n_samples=64, root=8, plain_rows=2, skips=(NO_SKIP, ONE_LEVEL))),
    ("scan+nee", "flux_tpu/ops/pallas_kernel.py:545", "spheres512",
     dict(accel="scan", row0=300, n_rows=50, n_samples=16, root=4, plain_rows=2, nee=True)),
    ("scan+stats", "flux_tpu/ops/pallas_kernel.py:332", "spheres512",
     dict(accel="scan", row0=256, n_rows=128, n_samples=8, root=4, plain_rows=4, stats=True)),
    ("sweep+tri", "flux_tpu/ops/pallas_kernel.py:611", "mesh1280",
     dict(accel="sweep", row0=300, n_rows=50, n_samples=16, root=4, plain_rows=2, skips=(NO_SKIP, ONE_LEVEL))),
    ("sweep+tri+physical", "flux_tpu/ops/pallas_kernel.py:611", "mesh_ico",
     dict(accel="sweep", row0=300, n_rows=50, n_samples=16, root=4, plain_rows=2, physical=True)),
    ("sweep+tri+physical+stats", "flux_tpu/ops/pallas_kernel.py:611", "mesh_ico",
     dict(accel="sweep", row0=256, n_rows=128, n_samples=8, root=4, plain_rows=4, physical=True, stats=True)),
    ("sweep+tri+nee+trilight", "flux_tpu/ops/pallas_kernel.py:302", "demo5",
     dict(accel="sweep", row0=250, n_rows=50, n_samples=1024, root=32, plain_rows=50, nee=True,
          skips=(NO_SKIP, SKIP_ON))),
    ("sweep+tri+nee+trilight+physical", "flux_tpu/ops/pallas_kernel.py:302", "demo5",
     dict(accel="sweep", row0=250, n_rows=50, n_samples=64, root=8, plain_rows=4, nee=True, physical=True)),
    ("sweep+tri+nee+trilight+stats", "flux_tpu/ops/pallas_kernel.py:302", "demo5",
     dict(accel="sweep", row0=256, n_rows=128, n_samples=8, root=4, plain_rows=4, nee=True, stats=True)),
    ("sweep+tri+nee+trilight+physical+stats", "flux_tpu/ops/pallas_kernel.py:302", "demo5",
     dict(accel="sweep", row0=256, n_rows=128, n_samples=16, root=8, plain_rows=4, nee=True, physical=True,
          stats=True)),
]


def scene_by_name(name: str):
    if name == "mesh1280":
        return meshgen.mesh_scene(*meshgen.icosphere(3), name="mesh1280")
    return stock(name)


def median_ms(fn) -> float:
    return float(np.median(event_ms(fn, 3)))


def phase_design(dev) -> dict:
    """Phase 14: what the kernels' design rests on, measured on the main
    paths' launches. The counting instantiation timed beside the timed one
    (the counters' cost); bands of fewer rows (the cost per row as the last
    wave empties); the triangle skip on and off by the triangle table's
    block count, on meshes of 2 to 80 blocks in mesh_scene at 16 spp and on
    the Cornell box with NEE at 1024 spp (the rule TRI_SKIP_ENGAGE)."""
    res = {}
    _, d2, cam2 = scene_on(dev, "demo2")
    kw1 = dict(img_w=800, img_h=600, n_samples=16384, root=128, max_depth=5)
    k1 = lambda n_rows, **o: render_block_sweep(d2, cam2, 300, 0, 0, n_rows=n_rows, **kw1, **o)
    counts = torch.zeros(50 * 800, dtype=torch.int32, device=dev)
    sc5, cam5, isect5, lights5, w5, h5 = scene_setup(dev, stock("demo5"), "sweep", True)
    kw7 = dict(isect=isect5, img_w=w5, img_h=h5, n_samples=1024, root=32, max_depth=5, lights=lights5)
    k7 = lambda n_rows, **o: render_block_scene(sc5, cam5, 250, 0, 0, n_rows=n_rows, **kw7, **o)
    counts7 = torch.zeros((scene_kernel.N_COUNTS, 50 * w5), dtype=torch.int32, device=dev)
    res["K1"] = {"ms_50_rows": median_ms(lambda: k1(50)), "ms_42_rows": median_ms(lambda: k1(42)),
                 "ms_counting_launch": median_ms(lambda: k1(50, bounce_counts=counts))}
    res["K7"] = {"ms_50_rows": median_ms(lambda: k7(50)), "ms_48_rows": median_ms(lambda: k7(48)),
                 "ms_counting_launch": median_ms(lambda: k7(50, work_counts=counts7)),
                 "ms_skip_on": median_ms(lambda: k7(50, tri_skip=True)),
                 "ms_skip_off": median_ms(lambda: k7(50, tri_skip=False))}
    for k in ("K1", "K7"):
        r = res[k]
        short = r.get("ms_42_rows", r.get("ms_48_rows"))
        r["per_row_ratio_short_to_50"] = (short / (42 if k == "K1" else 48)) / (r["ms_50_rows"] / 50)
        r["counting_over_timed"] = r["ms_counting_launch"] / r["ms_50_rows"]
    v2, f2 = meshgen.icosphere(2)
    meshes = {"icosphere(0)": meshgen.icosphere(0), "icosphere(1)": meshgen.icosphere(1),
              "icosphere(2)[:128]": (v2, f2[:128]), "icosphere(2)": (v2, f2), "icosphere(3)": meshgen.icosphere(3)}
    skip = {}
    for name, (v, f) in meshes.items():
        sc, cam, isect, _, w, h = scene_setup(dev, meshgen.mesh_scene(v, f), "sweep", False)
        kw = dict(isect=isect, img_w=w, img_h=h, n_rows=50, n_samples=16, root=4, max_depth=5)
        on = render_block_scene(sc, cam, 300, 0, 0, tri_skip=True, **kw)
        off = render_block_scene(sc, cam, 300, 0, 0, tri_skip=False, **kw)
        check(bits_equal(on, off), f"{name}: the triangle skip changes the result")
        skip[name] = {"blocks": isect.tri_layout.n_blocks,
                      "ms_on": median_ms(lambda: render_block_scene(sc, cam, 300, 0, 0, tri_skip=True, **kw)),
                      "ms_off": median_ms(lambda: render_block_scene(sc, cam, 300, 0, 0, tri_skip=False, **kw)),
                      "engaged": scene_kernel.tri_skip_engaged(isect.tri_layout.n_blocks)}
    skip["demo5 (NEE, 1024 spp)"] = {"blocks": isect5.tri_layout.n_blocks, "ms_on": res["K7"]["ms_skip_on"],
                                      "ms_off": res["K7"]["ms_skip_off"],
                                      "engaged": scene_kernel.tri_skip_engaged(isect5.tri_layout.n_blocks)}
    res["tri_skip"] = skip
    log("design (K1 demo2 band at 16384 spp, K7 demo5 band at 1024 spp; triangle skip by blocks):", json.dumps(res))
    return res


def kernel_entry(name: str, replaces: str, launches: int, meas: dict,
                 source: str = "flux_tpu_torch/csrc/sweep_megakernel.cu") -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": meas["vs_plain"]["max_abs_diff"],
        "ms": float(np.median(meas["kernel_ms"])),
        "plain_ms": meas["plain_ms"],
        "bound_ms": meas["bound_ms"],
        "bound_by": meas["bound_by"],
        "library_ms": None,
        "shape": meas["shape"],
        "launch_plan": meas["launch_plan"],
        "bounces_per_sample": meas["bounces_per_sample"],
        "work_counts": meas["work_counts"],
    }


def main() -> int:
    # 1. probe
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = smi()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    # 2. build: one nvcc per source, both started together
    t0 = time.perf_counter()
    build.build_many(list(build.LIBRARIES))
    log(f"build: {len(build.LIBRARIES)} libraries in {time.perf_counter() - t0:.1f} s of wall time")
    for name in build.LIBRARIES:
        info = build.BUILD_LOG[name]
        log(f"build: {name} in {info['seconds']:.1f} s")
        log(info["ptxas"].strip())
    # 3-6
    with phase_timer("3 kernel vs plain (K1)"):
        cmp = phase_kernel_vs_plain(dev)
    with phase_timer("4 goldens"):
        phase_goldens(dev)
    with phase_timer("5 main path (demo2, 16384 spp)"), tempfile.TemporaryDirectory() as tmp:
        main_res = phase_main_path(tmp, card)
    with phase_timer("6 measure K1"):
        meas = phase_measure(dev)
    kernel = kernel_entry("sweep_megakernel", "flux_tpu/ops/pallas_kernel.py:135", main_res["launches"], meas)
    kernel.update({
        "max_abs_err_check_band": cmp["max_abs_diff"],
        "ms_per_frame": meas["frame_kernel_ms"],
        "cli_seconds_per_frame": main_res["cli_seconds"],
        "cli_band_loop_seconds": main_res["band_loop_seconds"],
    })
    kernels = [kernel]
    # 7-9
    with phase_timer("7 kernel vs plain (K2-K4)"):
        for name, nee, physical, stats in CONFIGS:
            phase_kernel_vs_plain(dev, name, nee=nee, physical=physical, stats=stats)
    with phase_timer("8 quality paths"), tempfile.TemporaryDirectory() as tmp:
        paths = phase_paths(dev, tmp)
    with phase_timer("9 measure K2-K4"):
        for cfg, replaces, shape in MEASURE:
            check(paths["launches"].get(cfg, 0) > 0, f"no path launched the {cfg} instantiation")
            m = measure_launch(dev, **shape)
            kernels.append(kernel_entry(f"sweep_megakernel[{cfg}]", replaces, paths["launches"][cfg], m))
    # 10-13: the scene megakernel (K5 scan, K6 triangles, K7 triangle lights)
    with phase_timer("10 scene kernel vs plain, skip on and off, scan vs sweep"):
        for cfg in SCENE_CONFIGS:
            phase_scene_kernel_vs_plain(dev, *cfg)
        phase_scan_equals_sweep(dev)
    with phase_timer("11 scene paths"), tempfile.TemporaryDirectory() as tmp:
        scene_paths = phase_scene_paths(dev, tmp, card)
    with phase_timer("12 sphere_field(16384) band"):
        big = phase_big_field(dev)
    with phase_timer("13 measure K5-K7"):
        for cfg, replaces, scene_name, shape in SCENE_MEASURE:
            check(scene_paths["launches"].get(cfg, 0) > 0, f"no path launched the {cfg} configuration")
            m = measure_scene_launch(dev, scene_by_name(scene_name), cfg, **shape)
            entry = kernel_entry(f"scene_megakernel[{cfg}]", replaces, scene_paths["launches"][cfg], m,
                                 source="flux_tpu_torch/csrc/scene_megakernel.cu")
            entry.update(plain_shape=m["plain_shape"], timed_options_ms=m["timed_options_ms"])
            if cfg == "scan":
                entry["sphere_field_16384_band"] = big
            kernels.append(entry)
    with phase_timer("14 design checks"):
        phase_design(dev)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
