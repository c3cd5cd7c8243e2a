#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``flux_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
It needs one Hopper card (the kernels are built for ``sm_90a``), ``nvcc``
and PyTorch built for CUDA; it imports neither JAX nor ``flux_tpu``.

Phases, in order; any failure exits non-zero before the result line:

1. probe: a CUDA device must be present; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build: compiles ``flux_tpu_torch/csrc/sweep_megakernel.cu`` (every
   instantiation of the template) with nvcc and prints the build seconds
   and the compiler's register report for each;
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
   in phase 6, with phase 7's gate.

It ends with a ``{"kernels": [...]}`` line (one entry per instantiation)
and then the result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
from flux_tpu_torch.cli import run as cli_run
from flux_tpu_torch.image import read_ppm
from flux_tpu_torch.ops import build
from flux_tpu_torch.ops.nee import extract_lights
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
    d = (k1 - plain).abs()
    fd = (finalize(k1[..., :3], root=4) - finalize(plain[..., :3], root=4)).abs()
    res = {
        "max_abs_diff": float(d.max()),
        "mean_abs_diff": float(d.mean()),
        "n_over_1e-5": int((d > 1e-5).sum()),
        "n_values": d.numel(),
        "finalized_mean_abs_diff": float(fd.mean()),
        "finalized_frac_over_5e-3": float((fd > 5e-3).float().mean()),
        "kernel_ms": band_ms,
        "plain_ms": band_plain_ms,
    }
    if stats:
        res.update(stats_vs_plain(k1, plain))
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
    render_block_sweep(scene, cam, row0, 0, 0, bounce_counts=counts, **kw)
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
    d = (k - p).abs()
    fd = (finalize(k[..., :3], root=root) - finalize(p[..., :3], root=root)).abs()
    what = f"{config_name(stats, nee, physical)}, {name} band {n_rows}x800 at row {row0}, {n_samples} spp"
    cmp = {
        "max_abs_diff": float(d.max()),
        "mean_abs_diff": float(d.mean()),
        "max_rel_diff": float((d / p.abs().clamp_min(1e-30)).max()),
        "n_values": d.numel(),
        "finalized_max_abs_diff": float(fd.max()),
        "finalized_mean_abs_diff": float(fd.mean()),
        "finalized_frac_over_5e-3": float((fd > 5e-3).float().mean()),
    }
    if stats:
        cmp.update(stats_vs_plain(k, p))
    log(f"kernel vs plain ({what}, depth 5, seed 0):", json.dumps(cmp))
    check_vs_plain(cmp, what)
    res = {
        "vs_plain": cmp,
        "kernel_ms": kernel_ms,
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
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(render_block_sweep.launches)
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


def kernel_entry(name: str, replaces: str, launches: int, meas: dict) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": "flux_tpu_torch/csrc/sweep_megakernel.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": meas["vs_plain"]["max_abs_diff"],
        "ms": float(np.median(meas["kernel_ms"])),
        "plain_ms": meas["plain_ms"],
        "bound_ms": meas["bound_ms"],
        "bound_by": meas["bound_by"],
        "library_ms": None,
        "shape": meas["shape"],
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
    # 2. build
    build.build("sweep_megakernel")
    info = build.BUILD_LOG["sweep_megakernel"]
    log(f"build: sweep_megakernel in {info['seconds']:.1f} s")
    log(info["ptxas"].strip())
    # 3-6
    cmp = phase_kernel_vs_plain(dev)
    phase_goldens(dev)
    with tempfile.TemporaryDirectory() as tmp:
        main_res = phase_main_path(tmp, card)
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
    for name, nee, physical, stats in CONFIGS:
        phase_kernel_vs_plain(dev, name, nee=nee, physical=physical, stats=stats)
    with tempfile.TemporaryDirectory() as tmp:
        paths = phase_paths(dev, tmp)
    for cfg, replaces, shape in MEASURE:
        check(paths["launches"].get(cfg, 0) > 0, f"no path launched the {cfg} instantiation")
        m = measure_launch(dev, **shape)
        kernels.append(kernel_entry(f"sweep_megakernel[{cfg}]", replaces, paths["launches"][cfg], m))
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
