#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``flux_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``
(``--parent DIR``: see phase 16).
It needs one Hopper card (the kernels are built for ``sm_90a``), ``nvcc``
and PyTorch built for CUDA; it imports neither JAX nor ``flux_tpu``.

Phases, in order; any failure exits non-zero before the result line:

1. probe: a CUDA device must be present; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build: compiles ``flux_tpu_torch/csrc/sweep_megakernel.cu`` and
   ``scene_megakernel.cu`` (every instantiation of both templates) with
   nvcc, and phase 15's variants of the second (and with ``--parent`` the
   other checkout's two sources), all at once, and prints the build seconds
   and the compiler's register report for each; and the native host code
   (``csrc/fluxnative.cpp``, g++), which must load with its scheduler
   core;
3. kernel vs plain: demo2 at its full 800 width, an 8-row band, root 4,
   depth 5, seed 42, through the kernel and through its plain PyTorch
   version on the card; two kernel launches must be bitwise equal, and
   sample ranges must add up;
4. goldens: demo1 and demo2 at 80x60, root 4, depth 5, seed 42 (pixel size
   ×10, as tests/test_golden.py renders them), held against the JAX
   package's committed goldens at that test's gate;
5. the main path: ``python -m flux_tpu_torch.cli scenes/demo2.yml -r 128
   -d 5`` (800x600 at 16384 spp) through the CLI's ``main`` (the job path:
   the manager and a local worker); no job error, no JobFailed event, no
   retry round, and exactly one K1 launch for each of the 12 units, all
   local; the PPM must be whole, and the frame must match the JAX
   package's render of the same frame and seed (artifacts/demo2_16384spp.png);
6. measurement at the main path's shapes (one 50-row band at 16384 spp):
   the kernel's time (CUDA events around 5 launches back to back, per
   launch, median of 3), its bound, and the plain version's time; the two
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
   NEE and with MIS, each also with stats, and on demo5 with 19 more planes
   (the plane table); two launches bitwise equal, sample ranges add up; the
   same launch with the AABB skip off, with one level of boxes, and with
   every skip on (on demo5: the shadow ray folded where it is drawn, not
   carried to the next bounce) must be bitwise equal; prints the share of
   blocks entered; then the scan against the sweep megakernel, bitwise, on whole
   frames of ``sphere_field(24)`` and ``sphere_field(40)``; then the scenes
   past the sweep megakernel's caps through the Renderer, against the plain
   version: 20 planes (demo2 and ``genscene.plane_ring``) in sweep and scan
   mode, and 101 spheres with ``accel="sweep"`` (it takes the scan; bitwise
   equal to ``accel="scan"``); the 20-plane scene also in the list above;
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
   with the tree of boxes, with one level of boxes and without the skip
   (bitwise equal), the blocks entered per fold, and the band's first row
   against the plain version; then the sweep megakernel against the scan on
   50-row bands of fields of 16, 32, 48 and 64 spheres at 64 spp, in turns,
   bitwise (``render.SCAN_AUTO_THRESHOLD``);
13. measurement of each scene-megakernel configuration at its path's launch
   shape (timed as in phase 6) beside its operation bound from the
   kernel's work counters (and the bound as it was before a shadow ray
   shared its origin terms with the next bounce's ray,
   ``bound_ms_separate_folds``), the plain version's time on the launch's
   first 2-4 rows (the whole launch would take minutes; demo5's 1024-spp
   band is run whole), and those rows of the path's own launch held against
   it; the skips timed on and off.
14. design checks: the counting instantiation timed beside the timed one
   on the K1 and K7 bands (the work counters live only in the former), K1
   on 42 rows and K7 on 48 rows beside their 50-row bands (the cost per
   row as the last wave empties), and the triangle skip on and off on
   meshes of 2 to 1280 triangle blocks and on the Cornell box, bitwise equal,
   beside the rule ``scene_kernel.TRI_SKIP_ENGAGE``, with the direction
   lists' grid, entries and host seconds; on icosphere(5) (20,480
   triangles, past the lists' budget) the lists built at each grid,
   timed, beside the rule ``scene_kernel.BIN_TESTS``;
15. the triangle fold, step by step, on its launches (K6, K6 + K4 and K6 +
   K4 + K2 as phase 13 makes them, and K6 on icosphere(5)): the scene
   source is built again with a design step undone by a text edit (in
   phase 2, beside the two libraries; a variant whose edit no longer
   applies is left out, and said so): a, the widened walk over the blocks'
   boxes one by one with the list, without the tree; t, the widened walk
   over the parent's two levels (groups of 8 blocks, then their blocks, in
   table order) with the list; x and y, the tree without the list and
   without the widening either (not exact: their bits are not held); b,
   the tree (the sources as they are); with
   ``--parent``, the parent's build, and the parent's build with its
   triangle walk's cycles counted (in the sphere walk's clock counters,
   unused on these launches). The phase prints each build's registers,
   spills and stack frame; from each build's counting launch the triangle
   blocks needed, entered and box-tested per fold, the share entered
   beyond what a perfect skip needs, the list entries read and triangles
   folded apart per fold, and the clock64 split of a bounce (spheres and
   planes, triangle box tests, triangle folds, lists, scatter) (the path
   counters of every build of these sources must be equal); then every
   build, and the final build with the triangle skip off, timed in turns
   with its bits against the final build's (equal for every build of these
   sources; the parent's said);
16. with ``--parent DIR`` (the root of another checkout, such as the parent
   commit's, unpacked by ``git archive``): that checkout's package, imported
   under another name and built in phase 2, and this one render every row
   of phases 6, 9 and 13 and phase 12's band through a Renderer each, in
   turns (parent, new, new, parent), bitwise; a row whose bits differ must
   be one where the new launch equals the fold over every triangle block
   (the skip off) of both packages: the parent's triangle skip was not
   exact; then demo2's job path (``cli.run -r 128 -d 5 -R 50``) through
   each package in turns, its seconds and the PPMs' bytes equal;
17. the job path (``cli.run`` → ``RenderManager`` → workers), each run with
   the launch counts set to 0 just before and read just after, and its PPM
   bytes held equal to a band loop over ``Renderer.render_rows`` with the
   same bands, encoded by ``image.ppm_bytes``:
   a. demo2 at 800x600, root 128, depth 5, ``-R 50`` through a local worker
      (K1), with both wall times, its round on the native scheduler core;
      then the same job with its round on the Python core (its job
      seconds beside the native core's);
   b. the same job through a port node (``python -m flux_tpu_torch.node``,
      a subprocess on the card): ``-L -n``, then ``-n`` beside the local
      worker, with the units each worker rendered;
   c. demo3 ``--nee --physical`` (K4 + K3) and demo5 ``--nee`` (K7 on the
      scene kernel, a last unit of 12 rows) at root 8, demo5 through the
      node as well (its triangles go over the wire);
   d. a small job with ``--profile-dir``: the trace must be written; prints
      the kernel names it records;
   e. fails on a JobFailed event, a job error, a retry round, a native
      library that did not load, a scheduler core that did not load, a
      job's round not on the native core (or not closed exactly once), or
      a node that does not exit 0 when stopped; prints the version of
      ``msgpack``, which writes and reads the wire's frames;
18. the device mesh (``flux_tpu_torch.parallel``), over the card repeated,
   each path with the launch counts set to 0 just before and read just
   after:
   a. demo2 at 800x600, root 128, depth 5, 12 units of 50 rows through the
      manager and a LocalWorker whose renderer is a MeshRenderer of shape
      (rows, spp) (1,1), (2,1), (4,1), (1,2) and (2,2), two rounds, each
      after a band loop: one K1 launch a slot a unit; rows-only meshes
      byte-equal to the band loop, spp meshes within float32's
      reassociation bound of a thread's 512 samples; then ``cli.run -t 1
      --rows-shards 1``, byte-equal to phase 17's frame; the job's seconds
      against the band loop's;
   b. each slot of meshes (2,2), (4,2) and (4,4) as the MeshRenderer
      launches it (row stride 2 or 4, samples cut by ``s_limit``, the
      band's split) against the plain version at phase 3's gate: K1, K2,
      K4 + K3, K7 and K7 + K2 on a 16-row band at root 3, and K1 on the
      image's last 10 rows over 4 row shards (padding rows past the
      image); slots past the samples add exact zeros; a band whose own
      launch plan differs from its shards' stays bitwise on a rows mesh;
   c. on a (2,1) mesh: demo2's adaptive stop (768 spp, its p99 the one
      card's), demo3's MIS MSE (the one card's), checkpoints written by the
      mesh and resumed on one card and the other way round (bitwise), the
      Cornell box's ``--nee`` job (the band loop's bytes) and a progressive
      NEE render (the one card's sums);
   d. two processes of this script (``--mesh-rank``) in a gloo group, both
      on the card: demo2 over a rows (2,1) global mesh assembled from each
      one's ``render_rows_local``, and over an spp (1,2) one, bitwise
      against a's one-process meshes; fails on a rank that does not exit 0;
   e. a node with ``-t 1`` serves demo2 byte-equal to phase 17's frame;
      ``sampler_debug`` on the card writes the CPU's eight files;
   f. each configuration as a (2,1) mesh launches it, timed beside its
      bound and its plain version, for the kernels line;
19. (none: the other phases keep the numbers PERF.md cites them by);
20. the f64 audit: every configuration (the 18 rows of PERF.md §6) at its
   scene's full frame, depth 5, seed 0, through ``Renderer.render_rows_sum_range
   (0, H, s, 1)`` (one launch a sample index, with stats for the stats rows;
   the launch counts must be one a sample, all of the row's configuration),
   sample by sample against ``flux_tpu_torch.oracle.oracle_render(...,
   raw_samples=True)`` on the card (the whole frame one band; its seconds
   and peak memory): K1-K4 rows on demo2 and demo3 at 800x600, root 4; the
   scan rows on spheres512 and the triangle rows on mesh1280 and mesh_ico
   at 800x600, root 2; K7 on demo5 at 512x512, root 4, its other rows root
   2. Gates, each row: a. the kernel off the oracle (``off_oracle``:
   beyond 1e-3·max(1, |oracle|), or not finite) on at most 1% of its
   samples; b. on one 8-row band (rows 296-303 of a 600-row frame, the
   middle 8 otherwise) the plain version's samples and the kernel's pass
   ``oracle.adjudicate`` with no unadjudicated flip; c. with stats, each
   launch's fourth channel the luminance² of its radiance at rtol 1e-6.
   Then d. the oracle on the card against the oracle on the CPU, demo3
   (NEE, physical) and demo5 (NEE) at 80x60, root 2, every value within
   1e-9·max(1, |value|); e. ``precision_audit`` through the kernels at
   tests/test_oracle.py's gates (mean |diff| < 5e-3, |f32 mean − f64 mean|
   < 2e-3) on demo2 at 800x600 root 4, that file's Phong exponent 1e5
   scene and its two mirrors at depth 16; f. ``python -m
   flux_tpu_torch.f64_audit scenes/demo2.yml --root 4`` exits 0 and prints
   e's demo2 report. Each row's numbers go into its entry of the kernels
   line as ``f64_audit``;
21. the last parts of ``flux_tpu`` the port gained: b. the scheduler core
   on the card's host: on the native and the Python core, three rounds of
   100,000 units drained by 8 threads, and three by one (each unit handed
   out exactly once, ``missing()`` empty once all are completed), µs a
   pull, their medians;
   1,000 native rounds of 100,000 units created and closed leave no memory
   behind (1,000 left open, the control, show); c. ``Intersector(mode=
   "scan_carry")`` on spheres512: on 4,096 camera rays and 4,096 rays
   leaving surfaces, the hit record and the any-hit mask of ``mode="scan"``
   bit for bit; a 50-row band at root 8 through the scene megakernel with
   a scan_carry intersector, one ``scan`` launch, the scan intersector's
   bits (its count goes into the scan entry of the kernels line).

Every phase prints its wall seconds. It ends with a ``{"kernels": [...]}``
line (one entry per instantiation and configuration, and one per
configuration as a mesh launches it) and then the result line ``{"ok":
true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import replace

import msgpack
import numpy as np
import torch

from flux_tpu_torch.camera import camera_tensors, primary_rays
from flux_tpu_torch.color import luminance, max_to_one
from flux_tpu_torch.checkpoint import ProgressiveRenderer, load_checkpoint
from flux_tpu_torch import genscene, meshgen, native, sampler_debug, sched, wire
from flux_tpu_torch.artifacts import (
    ADAPTIVE_P99, ADAPTIVE_P99_ATOL, ADAPTIVE_SPP, CORNELL_GATES, HEADLINE_GATES, MIS_MSE, MIS_MSE_RTOL, NEE_GATES,
    SPHERES512_GATES, adaptive_gates, failed, frame_gates, frame_vs_png, mis_gates,
)
from flux_tpu_torch.cli import DEFAULT_ROWS_PER_UNIT, FailureLog, run as cli_run
from flux_tpu_torch.image import Image, ppm_bytes, read_ppm
from flux_tpu_torch.job import JobConfiguration, WorkUnit
from flux_tpu_torch.manager import ImageBuilder, MultiSink, RenderManager
from flux_tpu_torch.ops import build, scene_kernel
from flux_tpu_torch.ops.intersect import SCAN_BLOCK, Intersector, scan_layout, tri_layout
from flux_tpu_torch.ops.nee import extract_lights
from flux_tpu_torch.ops.scene_kernel import render_block_scene
from flux_tpu_torch.oracle import adjudicate, off_oracle, oracle_render, precision_audit
from flux_tpu_torch.ops.sweep_kernel import (
    FluxLights,
    FluxScene,
    config_name,
    flops_lower_bound,
    launch_plan,
    n_counts,
    render_block_sweep,
)
from flux_tpu_torch.parallel import MeshRenderer, init_multihost, make_mesh, slot_launch
from flux_tpu_torch.render import Renderer, finalize, plan_chunks, render_block
from flux_tpu_torch.sched import SchedulerRound, native_sched_available
from flux_tpu_torch.vec import Vec3
from flux_tpu_torch.scene import (
    CameraData, CameraSettings, MaterialData, MaterialKind, OutputSettings, SceneData, SphereData, compile_scene,
    load_scene,
)
from flux_tpu_torch.workers import LocalWorker

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


def launch_ms(fn, reps: int = 3, n: int = 5) -> list:
    """Device milliseconds per call, by CUDA events around ``n`` calls back
    to back (the host's work for a call overlaps the device's run of the
    one before, as in a render's band loop), ``reps`` times, after a
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
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


def check_gates(gates: list, what: str) -> None:
    """The JAX package's stored results' gates (flux_tpu_torch.artifacts)."""
    bad = failed(gates)
    check(not bad, f"{what}: {bad}")


def phase_main_path(out_dir: str, card: str) -> dict:
    argv = ["scenes/demo2.yml", "-r", "128", "-d", "5", "--seed", "0", "--output-dir", out_dir]
    render_block_sweep.launches.clear()
    t0 = time.perf_counter()
    # cli.run is cli.main without the exit code: it also returns its timings.
    ran = cli_run([os.path.join(HERE, argv[0]), *argv[1:]])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = render_block_sweep.launches.total()
    # The manager must not hide a kernel fault behind a retry round: one
    # launch of K1 for each of the frame's units, each rendered once, locally.
    n_units = -(-600 // DEFAULT_ROWS_PER_UNIT)
    check(ran["error"] is None, f"the main path's job failed: {ran['error']}")
    check(not ran["worker_failures"], f"the main path's JobFailed events: {ran['worker_failures']}")
    check(ran["retry_rounds"] == 0, f"the main path took {ran['retry_rounds']} retry rounds")
    check(ran["units_by_worker"] == {"local": n_units}, f"the main path's units {ran['units_by_worker']}")
    check(dict(render_block_sweep.launches) == {"sweep": n_units},
          f"the main path launched {dict(render_block_sweep.launches)}, not {n_units} of K1")
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
    vs = frame_vs_png(img, "demo2_16384spp.png")
    res = {
        "cli_seconds": seconds,
        "msamples_per_s": samples / seconds / 1e6,
        "band_loop_seconds": ran["band_seconds"],
        "band_loop_msamples_per_s": samples / ran["band_seconds"] / 1e6,
        "launches": launches,
        "vs_jax_png_mean_abs_levels": vs["mean_abs_levels"],
        "vs_jax_png_max_abs_levels": vs["max_abs_levels"],
        "vs_jax_png_frac_over_2_levels": vs["frac_over_2_levels"],
    }
    log(f"main path (cli demo2 800x600, 16384 spp, depth 5, seed 0) on {card}:", json.dumps(res))
    check_gates(frame_gates(vs, HEADLINE_GATES, "demo2_16384spp.png"), "frame differs from the JAX render")
    return res


def plan_of(plan) -> dict:
    """A launch plan as the kernels line prints it: threads per pixel,
    pixels per block, blocks, blocks resident per SM, and waves."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return {"split": plan.split, "pixels_per_block": plan.pixels_per_block, "blocks": plan.blocks,
            "blocks_per_sm": plan.slots // n_sm, "waves": plan.waves}


def measure_launch(dev, name, *, row0, n_rows, n_samples, root, nee=False, physical=False,
                   stats=False, frame=False, row_stride=1, split=None) -> dict:
    """One of a path's launches (seed 0, depth 5, full width): the kernel's
    time, its bound from the kernel's own work counters, the plain
    version's time on the same launch, and the two results held against
    each other at phase 3's gate. ``frame`` also times a whole frame of
    such launches, as the CLI makes them. ``row_stride`` and ``split``: a
    device mesh's launch (phase 18), rows ``row0 + k·row_stride`` at its
    band's split."""
    sd, scene, cam = scene_on(dev, name)
    lights = extract_lights(sd, dev) if nee else None
    kw = dict(img_w=800, img_h=600, n_rows=n_rows, n_samples=n_samples, root=root, max_depth=5,
              lights=lights, physical=physical, with_stats=stats, row_stride=row_stride)
    kk = {**kw, "split": split}  # the kernel's arguments (the plain version has no split)
    n_pix = n_rows * 800
    nc = n_counts(nee, physical)
    counts = torch.empty((n_pix,) if nc == 1 else (nc, n_pix), dtype=torch.int32, device=dev)
    render_block_sweep(scene, cam, row0, 0, 0, bounce_counts=counts, **{**kk, "with_stats": False})
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
    kernel_ms = launch_ms(lambda: render_block_sweep(scene, cam, row0, 0, 0, **kk))
    plan = plan_of(render_block_sweep.last_plan)
    k = render_block_sweep(scene, cam, row0, 0, 0, **kk)
    frame_ms = None
    if frame:
        frame_ms = event_ms(
            lambda: [render_block_sweep(scene, cam, r, 0, 0, **kk) for r in range(0, 600, n_rows)], 1)[0]
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
    what = (f"{config_name(stats, nee, physical)}, {name} band {n_rows}x800 at row {row0}"
            + f" stride {row_stride}" * (row_stride > 1) + f", {n_samples} spp")
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
        "shape": f"{name} band {n_rows}x800 px" + f" (rows {row0} + k*{row_stride})" * (row_stride > 1)
                 + f", {n_samples} spp, depth 5",
    }
    log(f"measure ({what}):", json.dumps(res))
    return res


def phase_measure(dev) -> dict:
    """The kernel at the main path's launch shape: one 50-row band of demo2
    at 16384 spp, depth 5, seed 0 (rows 300-349, one of the CLI's bands)."""
    return measure_launch(dev, "demo2", row0=300, n_rows=50, n_samples=16384, root=128, frame=True)


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
    check_gates(adaptive_gates(ran["spp_done"], ran["p99_rel_stderr"]), "demo2 adaptive")
    launches.update(n)

    # b. demo2 NEE against the 16384-spp reference-transport frame.
    ran, n, secs = run_path("demo2 nee", lambda: cli_run(
        [demo2, "-r", "32", "-d", "5", "--nee", "--seed", "0", "--output-dir", os.path.join(out_dir, "nee")]))
    img = read_ppm(ran["out"])
    check(img.shape == (600, 800, 3) and np.isfinite(img).all(), "demo2 nee: bad PPM")
    vs = frame_vs_png(img, "demo2_16384spp.png")
    nee = {"seconds": secs, "band_loop_seconds": ran["band_seconds"], "launches": n,
           "vs_16384spp_png_mean_abs_levels": vs["mean_abs_levels"],
           "vs_16384spp_png_frac_over_8_levels": vs["frac_over_8_levels"]}
    log("demo2 nee (cli -r 32 -d 5 --nee) vs the 16384-spp frame:", json.dumps(nee))
    check(set(n) == {"sweep+nee"}, "demo2 nee: not all launches were the NEE kernel")
    check_gates(frame_gates(vs, NEE_GATES, "demo2_16384spp.png"), "demo2 nee: frame far from the reference frame")
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
    check_gates(mis_gates(mse), "demo3 mis: MSE more than 2% off the JAX package's")
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
    """A stock scene, or "planes20": demo2 with a ring of 19 more planes (20
    in all, past the sweep megakernel's 16), or "demo5planes": the Cornell
    box with the same ring (19 planes, in the plane table)."""
    if name == "planes20":
        return genscene.plane_ring(stock("demo2"), 19)
    if name == "demo5planes":
        return genscene.plane_ring(stock("demo5"), 19)
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
    """Work per fold from a counting launch: for spheres the walk's units
    entered (tree leaves, or blocks with one level or none), the spheres
    tested and their share of the table, the blocks and tree leaves a
    perfect skip needs, the box tests; sphere folds of nearest hits are the
    bounces, of shadow rays the shadow folds. Triangle blocks per fold, of
    both."""
    folds = max(c["bounces"] + c["shadow_folds"], 1)
    out = {}
    if isect.scans:
        nb, near, sh = isect.layout.n_blocks, max(c["bounces"], 1), max(c["shadow_folds"], 1)
        out.update(sphere_blocks=nb, sphere_units_entered_per_fold=c["sphere_blocks_entered"] / near,
                   sphere_tests_per_fold=c["sphere_tests"] / near,
                   sphere_share_tested=c["sphere_tests"] / near / (nb * SCAN_BLOCK),
                   sphere_blocks_needed_per_fold=c["sphere_blocks_needed"] / near,
                   sphere_leaves_needed_per_fold=c["sphere_leaves_needed"] / near,
                   sphere_box_tests_per_fold=c["sphere_box_tests"] / near)
        if c["shadow_folds"]:
            out.update(shadow_sphere_units_entered_per_fold=c["shadow_sphere_blocks_entered"] / sh,
                       shadow_sphere_tests_per_fold=c["shadow_sphere_tests"] / sh,
                       shadow_sphere_blocks_needed_per_fold=c["shadow_sphere_blocks_needed"] / sh,
                       shadow_sphere_box_tests_per_fold=c["shadow_sphere_box_tests"] / sh)
    if isect.tri_layout is not None:
        nb = isect.tri_layout.n_blocks
        out.update(tri_list_entries_per_fold=c["tri_candidates"] / folds,
                   tris_folded_apart_per_fold=c["tri_exceptions"] / folds)
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
    ("planes20", "sweep", False, False, False),
    ("planes20", "scan", True, False, False),
    ("demo5planes", "sweep", True, False, False),
    ("demo5planes", "sweep", True, True, True),
]


def phase_past_the_caps(dev) -> None:
    """Scenes past the sweep megakernel's caps, through the Renderer: 20
    planes in sweep and in scan mode (the scene megakernel reads them from
    its plane table), and sphere_field(100) (101 spheres) with accel "sweep",
    which takes the scan; each an 8-row band against the plain version at
    phase 3's gates, counted under its real configuration, and the 101-sphere
    sweep bitwise equal to accel "scan"."""
    cases = (("planes20", stock("planes20"), "sweep", "sweep"), ("planes20", stock("planes20"), "scan", "scan"),
             ("sphere_field(100)", genscene.sphere_field(100, seed=2), "sweep", "scan"))
    for label, sd, accel, taken in cases:
        r = Renderer(sd, 4, 5, seed=42, device=dev, accel=accel)
        check(r.accel == taken and not r.uses_sweep_kernel, f"{label}, accel {accel}: took {r.accel}")
        row0 = r.height // 2 - 4
        k, n, _ = run_path(f"{label}, accel {accel}", lambda: r.render_rows_sum_range(row0, 8, 0, 16))
        check(n == {taken: 1}, f"{label}, accel {accel}: launches {n}")
        p = render_block(r.scene, r.cam, row0, 0, r.seed, img_w=r.width, img_h=r.height, n_rows=8, n_samples=16,
                         root=4, max_depth=5, isect=r.isect)
        res = compare(k, p, 4, False)
        if label.startswith("sphere_field"):
            scan = Renderer(sd, 4, 5, seed=42, device=dev, accel="scan").render_rows_sum_range(row0, 8, 0, 16)
            res["bitwise_equal_accel_scan"] = bits_equal(k, scan)
            check(res["bitwise_equal_accel_scan"], f"{label}: accel sweep and scan differ")
        log(f"past the sweep's caps ({label}, accel {accel} -> {taken}, 8x{r.width}, 16 spp):", json.dumps(res))
        check(bool(torch.isfinite(k).all()), f"{label}: non-finite sums")
        check_vs_plain(res, f"{label}, accel {accel}")


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
    check_gates(frame_gates(res["vs_jax_png"], SPHERES512_GATES, "spheres512_64spp.png"),
                "spheres512: frame differs from the JAX render")
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
    check_gates(frame_gates(res["vs_jax_2304spp_png"], CORNELL_GATES, "demo5_cornell_2304spp.png"),
                "demo5: frame far from the JAX render")
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
    # The band's first row against the plain version (513 blocks under a tree of 1024 leaves).
    plain = []
    plain_ms = event_ms(lambda: plain.append(render_block(sc, cam, row0, 0, 0, **{**kw, "n_rows": 1})), 1)[0]
    cmp = compare(k[:1], plain[0], 4, False)
    res = {
        "vs_plain_first_row": cmp, "plain_ms_first_row": plain_ms,
        "spheres": sc.num_spheres, "blocks": isect.layout.n_blocks,
        "table_bytes": scene_kernel.table_bytes(isect, None, sc.num_spheres + sc.num_planes, sc),
        "ms_tree": event_ms(lambda: render_block_scene(sc, cam, row0, 0, 0, **kw), 3),
        "ms_one_level": event_ms(lambda: render_block_scene(sc, cam, row0, 0, 0, two_level=False, **kw), 3),
        "ms_no_skip": event_ms(lambda: render_block_scene(sc, cam, row0, 0, 0, scan_skip=False, **kw), 1),
        "one_level_bitwise_equal": bits_equal(k, single), "no_skip_bitwise_equal": bits_equal(k, noskip),
        "bounces_per_sample": c["bounces"] / (50 * w * 16), **entered_share(c, isect),
    }
    log("sphere_field(16384), one 50x800 band, 16 spp, depth 5:", json.dumps(res))
    check(bool(torch.isfinite(k).all()) and float(k.max()) > 0, "16384 spheres: bad sums")
    check(res["one_level_bitwise_equal"] and res["no_skip_bitwise_equal"], "16384 spheres: the skip changes the result")
    check_vs_plain(cmp, "scan on sphere_field(16384), the band's first row")
    res["sweep_vs_scan"] = sweep_vs_scan(dev)
    return res


def sweep_vs_scan(dev) -> dict:
    """Where the scan starts to beat the sweep megakernel
    (render.SCAN_AUTO_THRESHOLD): one 50-row band of sphere_field(n - 1)
    (n spheres with the environment sphere), n = 16, 32, 48, 64, at 800x600,
    64 spp, depth 5, through a Renderer of each accel, in turns (6 rounds),
    bitwise."""
    res = {}
    for n in (16, 32, 48, 64):
        sd = genscene.sphere_field(n - 1, seed=0)
        rs = {a: Renderer(sd, 8, 5, seed=0, device=dev, accel=a) for a in ("sweep", "scan")}
        check(rs["sweep"].uses_sweep_kernel and rs["scan"].accel == "scan", f"{n} spheres: wrong kernels")
        fns = {a: (lambda r=r: r.render_rows_sum_range(300, 50, 0, 64)) for a, r in rs.items()}
        r = in_turns(fns)
        r["bitwise_equal"] = bits_equal(fns["sweep"](), fns["scan"]())
        r["scan_over_sweep"] = r["ms"]["scan"] / r["ms"]["sweep"]
        res[n] = r
        log(f"sweep vs scan, {n} spheres (sphere_field({n - 1}), 50x800 band, 64 spp):", json.dumps(r))
        check(r["bitwise_equal"], f"{n} spheres: the scan and the sweep differ")
    return res


def measure_scene_launch(dev, sd, label, *, accel, row0, n_rows, n_samples, root, plain_rows, nee=False,
                         physical=False, stats=False, skips=(), row_stride=1, split=None) -> dict:
    """One of a path's launches (seed 0, depth 5, the scene's full width):
    the kernel's time (as in phase 6), its bound from its own work
    counters, and the plain version on the first ``plain_rows`` rows of the band: its
    time there, and those rows of the path's own launch held against it at
    phase 3's gate. ``skips``: wrapper options to time beside the default.
    ``row_stride`` and ``split``: a device mesh's launch (phase 18)."""
    sc, cam, isect, lights, w, h = scene_setup(dev, sd, accel, nee)
    kw = dict(isect=isect, img_w=w, img_h=h, n_samples=n_samples, root=root, max_depth=5, lights=lights,
              physical=physical, with_stats=stats, row_stride=row_stride)
    kk = {**kw, "split": split}  # the kernel's arguments (the plain version has no split)
    n_pix = n_rows * w
    c = work_counts(sc, cam, row0, 0, n_pix, dev, n_rows=n_rows, **kk)
    samples = n_pix * n_samples
    tri_share = 0.0
    if lights is not None and lights.has_tris:
        tri_share = float(lights.host["pick"][lights.host["is_tri"] > 0.5].sum())
    flops = scene_kernel.flops_lower_bound(sc, isect, samples, c, with_stats=stats, physical=physical,
                                           tri_light_fraction=tri_share)
    by_blocks = scene_kernel.flops_lower_bound(sc, isect, samples, c, with_stats=stats, physical=physical,
                                               tri_light_fraction=tri_share, by_blocks=True)
    separate = scene_kernel.flops_lower_bound(sc, isect, samples, c, with_stats=stats, physical=physical,
                                              tri_light_fraction=tri_share, separate_folds=True)
    n_shapes = sc.num_spheres + sc.num_planes + sc.num_triangles
    bytes_moved = (4 if stats else 3) * n_pix * 4 + ctypes.sizeof(FluxScene) + scene_kernel.table_bytes(
        isect, lights, n_shapes, sc)
    ops_ms, bytes_ms = flops / PEAK_FP32_FLOPS * 1e3, bytes_moved / PEAK_BYTES_PER_S * 1e3
    kernel_ms = launch_ms(lambda: render_block_scene(sc, cam, row0, 0, 0, n_rows=n_rows, **kk))
    plan = plan_of(render_block_scene.last_plan)
    timed = {json.dumps(o): float(np.median(event_ms(
        lambda: render_block_scene(sc, cam, row0, 0, 0, n_rows=n_rows, **kk, **o), 3))) for o in skips}
    k = render_block_scene(sc, cam, row0, 0, 0, n_rows=n_rows, **kk)[:plain_rows]
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
        "vs_plain": cmp, "kernel_ms": kernel_ms, "launch_plan": plan,
        "timed_options_ms": timed,
        "plain_ms": plain_ms,
        "plain_shape": f"{plain_rows}x{w} px, {n_samples} spp (rows [0, {plain_rows}) of the launch)",
        "samples": samples, "bounces_per_sample": c["bounces"] / samples, "work_counts": c,
        "flops_lower_bound": flops, "bytes": bytes_moved, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bound_ms_by_blocks": max(by_blocks / PEAK_FP32_FLOPS * 1e3, bytes_ms),
        "bound_ms_separate_folds": max(separate / PEAK_FP32_FLOPS * 1e3, bytes_ms),
        "shape": f"{sd.scene_name} band {n_rows}x{w} px" + f" (rows {row0} + k*{row_stride})" * (row_stride > 1)
                 + f", {n_samples} spp, depth 5",
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
    block count, on meshes of 2 to 1280 blocks in mesh_scene at 16 spp
    (with the direction lists' grid, entries, host seconds and work a fold)
    and on the Cornell box with NEE at 1024 spp (the rule TRI_SKIP_ENGAGE);
    on icosphere(5), past the lists' budget, the lists at each grid of
    BIN_GRIDS (the rule BIN_TESTS)."""
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
              "icosphere(2)[:128]": (v2, f2[:128]), "icosphere(2)": (v2, f2), "icosphere(3)": meshgen.icosphere(3),
              "icosphere(4)": meshgen.icosphere(4), "icosphere(5)": meshgen.icosphere(5)}
    skip, outs = {}, {}
    for name, (v, f) in meshes.items():
        sc, cam, isect, _, w, h = scene_setup(dev, meshgen.mesh_scene(v, f), "sweep", False)
        t0 = time.perf_counter()
        _, cand, grid, _ = scene_kernel.tri_bins(isect.tri_layout)
        pack_s = time.perf_counter() - t0
        kw = dict(isect=isect, img_w=w, img_h=h, n_rows=50, n_samples=16, root=4, max_depth=5)
        on = render_block_scene(sc, cam, 300, 0, 0, tri_skip=True, **kw)
        off = render_block_scene(sc, cam, 300, 0, 0, tri_skip=False, **kw)
        check(bits_equal(on, off), f"{name}: the triangle skip changes the result")
        outs[name] = on
        c = work_counts(sc, cam, 300, 0, 50 * w, dev, tri_skip=True, **kw)
        skip[name] = {"blocks": isect.tri_layout.n_blocks, "bin_grid": grid, "list_entries": len(cand),
                      "lists_pack_s": pack_s, **entered_share(c, isect),
                      "ms_on": median_ms(lambda: render_block_scene(sc, cam, 300, 0, 0, tri_skip=True, **kw)),
                      "ms_off": median_ms(lambda: render_block_scene(sc, cam, 300, 0, 0, tri_skip=False, **kw)),
                      "engaged": scene_kernel.tri_skip_engaged(isect.tri_layout.n_blocks)}
    # The lists' grid on a mesh past their budget: each grid's lists built anew
    # (a fresh layout), their host seconds and entries, and the skip's ms.
    grids = {}
    v5, f5 = meshgen.icosphere(5)
    for grid in sorted(scene_kernel.BIN_GRIDS):
        sc, cam, isect, _, w, h = scene_setup(dev, meshgen.mesh_scene(v5, f5), "sweep", False)
        t0 = time.perf_counter()
        _, cand, _, _ = scene_kernel.tri_bins(isect.tri_layout, grid=grid)
        pack_s = time.perf_counter() - t0
        kw = dict(isect=isect, img_w=w, img_h=h, n_rows=50, n_samples=16, root=4, max_depth=5, tri_skip=True)
        check(bits_equal(render_block_scene(sc, cam, 300, 0, 0, **kw), outs["icosphere(5)"]),
              f"icosphere(5), grid {grid}: other bits")
        c = work_counts(sc, cam, 300, 0, 50 * w, dev, **kw)
        grids[grid] = {"list_entries": len(cand), "lists_pack_s": pack_s,
                       "list_entries_per_fold": entered_share(c, isect)["tri_list_entries_per_fold"],
                       "ms_on": median_ms(lambda: render_block_scene(sc, cam, 300, 0, 0, **kw))}
        del isect, sc
    skip["icosphere(5) by the lists' grid"] = grids
    skip["demo5 (NEE, 1024 spp)"] = {"blocks": isect5.tri_layout.n_blocks, "ms_on": res["K7"]["ms_skip_on"],
                                      "ms_off": res["K7"]["ms_skip_off"],
                                      "engaged": scene_kernel.tri_skip_engaged(isect5.tri_layout.n_blocks)}
    res["tri_skip"] = skip
    log("design (K1 demo2 band at 16384 spp, K7 demo5 band at 1024 spp; triangle skip by blocks):", json.dumps(res))
    return res


# ---- phase 15: the triangle fold, step by step --------------------------------

# The design steps of the triangle walk, each a build of the current sources
# with a text edit (file, text in the sources, text in the variant), or of
# the parent's (--parent): the parent's build as it is (step 1's counts and
# times), the parent's build with the cycles of its triangle box tests and
# folds counted in the sphere walk's clock counters (which its triangle
# launches, in sweep mode, leave unused); a, the repaired walk over the
# blocks' boxes one by one in table order, without the tree; t, the
# repaired walk over the parent's two levels (groups of 8 blocks, then their
# blocks, in table order, each lane on its own path); and, timed for what a
# part costs and with their bits not held, the tree without the list (x)
# and without the widening either (y).
PARENT = "the parent's build"
PARENT_LAPS = "the parent's build, triangle walk timed"
TREE_CALL = ("      walk_tree_with(\n"
             "          g.tri_tree, g.tri_block_leaves, inv_d,\n"
             "          [&](float4 lo, float4 hi) { return tri_box_enter(lo, hi, o, inv_d, pad, cap, strict); }, "
             "tests, entered,\n"
             "          cnt, CLK_TRI_BOX, leaf);\n")
ONE_LEVEL_TREE = ("scene_geom.cuh", TREE_CALL,
                  "      for (int b = 0; b < g.n_tri_blocks && !stopped; ++b) {\n"
                  "        const float4* box = g.tri_tree + 2 * (g.tri_block_leaves - 1 + b);\n"
                  "        tests += 1u;\n"
                  "        if (tri_box_enter(__ldg(&box[0]), __ldg(&box[1]), o, inv_d, pad, cap, strict)) {\n"
                  "          entered += 1u;\n"
                  "          leaf(b);\n"
                  "        }\n"
                  "      }\n")
# The tree's level of nodes over 8 leaves holds the parent's group boxes: the
# unions of 8 blocks' boxes in table order, here widened as every box is.
TWO_LEVEL_TREE = ("scene_geom.cuh", TREE_CALL,
                  "      const int grp = min(8, g.tri_block_leaves);\n"
                  "      const float4* group = g.tri_tree + 2 * (g.tri_block_leaves / grp - 1);\n"
                  "      const float4* box = g.tri_tree + 2 * (g.tri_block_leaves - 1);\n"
                  "      for (int s = 0; s * grp < g.n_tri_blocks && !stopped; ++s) {\n"
                  "        tests += 1u;\n"
                  "        if (!tri_box_enter(__ldg(&group[2 * s]), __ldg(&group[2 * s + 1]), o, inv_d, pad, cap, "
                  "strict)) continue;\n"
                  "        for (int b = s * grp; b < min(s * grp + grp, g.n_tri_blocks) && !stopped; ++b) {\n"
                  "          tests += 1u;\n"
                  "          if (tri_box_enter(__ldg(&box[2 * b]), __ldg(&box[2 * b + 1]), o, inv_d, pad, cap, strict)) {\n"
                  "            entered += 1u;\n"
                  "            leaf(b);\n"
                  "          }\n"
                  "        }\n"
                  "      }\n")
PARENT_LAP_EDIT = ("scene_geom.cuh",
                   "g.tri_skip != 0, o, inv_d, rs_tri, tr_t, false,\n                  tests, entered, cnt, NO_LAPS,",
                   "g.tri_skip != 0, o, inv_d, rs_tri, tr_t, false,\n                  tests, entered, cnt, CLK_SPH_BOX,")
NO_LIST = ("scene_geom.cuh", "      if (!stopped) {\n        long long t = cnt.now();",
           "      if (false) {\n        long long t = cnt.now();")
NO_WIDENING = ("scene_geom.cuh",
               "      const V3 pad = tri_pads(__ldg(&g.tri_tree[0]), __ldg(&g.tri_tree[1]), o, inv_d, g.tri_rcap);",
               "      const V3 pad = V3{0.0f, 0.0f, 0.0f};")
FINAL = "b: the tree over the blocks (the sources)"
ONE_LEVEL_STEP = "a: the blocks' boxes one by one, widened, with the list"
TWO_LEVEL_STEP = "t: the parent's two levels in table order, widened, with the list"
# Builds whose bits are not held (not exact: what a part of the design costs).
INEXACT = ("x: b without the list (not exact)", "y: b without the widening and the list (not exact)")
# name -> (parent's sources or not, edits)
TRI_VARIANTS = {
    PARENT_LAPS: (True, (PARENT_LAP_EDIT,)),
    ONE_LEVEL_STEP: (False, (ONE_LEVEL_TREE,)),
    TWO_LEVEL_STEP: (False, (TWO_LEVEL_TREE,)),
    INEXACT[0]: (False, (NO_LIST,)),
    INEXACT[1]: (False, (NO_LIST, NO_WIDENING)),
}
VARIANT_FILES = ("flux_trace.cuh", "scan_walk.cuh", "scene_geom.cuh", "scene_megakernel.cu")
# The triangle fold's rows of phase 13 (seed 0, depth 5, 800 wide): K6 on
# mesh1280, K6 + K4 and K6 + K4 + K2 on mesh_ico.
TRI_ROWS = {
    "K6 sweep+tri": dict(name="mesh1280", row0=300, n_rows=50, n_samples=16, root=4),
    "K6+K4 sweep+tri+physical": dict(name="mesh_ico", row0=300, n_rows=50, n_samples=16, root=4, physical=True),
    "K6+K4+K2 sweep+tri+physical+stats": dict(name="mesh_ico", row0=256, n_rows=128, n_samples=8, root=4,
                                              physical=True, stats=True),
    # Past the direction lists' budget (their grid coarser than the finest).
    "K6 sweep+tri, mesh20480": dict(name="mesh20480", row0=300, n_rows=50, n_samples=16, root=4),
}


def start_variant_builds(parent=None) -> dict:
    """Writes each design variant's sources (of this checkout, or of the
    parent's) under the build directory, in a folder named by a hash of the
    sources and the flags as ops/build.py names a library, and starts one
    nvcc for each that is not built yet (a variant of the parent's only with
    ``parent``). Returns (process or None, library, start, package) by
    variant."""
    running = {}
    for name, (of_parent, edits) in TRI_VARIANTS.items():
        if of_parent and parent is None:
            continue
        bld = parent.ops.build if of_parent else build
        base = {f: (bld.CSRC / f).read_text() for f in VARIANT_FILES}
        stale = [f for f, new, _ in edits if base[f].count(new) != 1]
        if stale:
            log(f"build: variant {name!r} left out: its edit of {', '.join(stale)} no longer applies")
            continue
        srcs = dict(base)
        for f, new, old in edits:
            srcs[f] = srcs[f].replace(new, old)
        digest = hashlib.sha256(" ".join(bld.NVCC_FLAGS).encode())
        for f in VARIANT_FILES:
            digest.update(f.encode() + b"\0" + srcs[f].encode())
        d = build.BUILD_DIR / "variants" / digest.hexdigest()[:16]
        lib = d / "libscene_megakernel.so"
        pkg = parent if of_parent else None
        if lib.exists():
            running[name] = (None, lib, time.perf_counter(), pkg)
            continue
        d.mkdir(parents=True, exist_ok=True)
        for f, text in srcs.items():
            (d / f).write_text(text)
        tmp = d / f"lib.{os.getpid()}.tmp"
        cmd = [bld._nvcc(), *bld.NVCC_FLAGS, "-o", str(tmp), str(d / "scene_megakernel.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib,
                         time.perf_counter(), pkg)
    return running


def finish_variant_builds(running: dict, parent=None) -> dict:
    """Waits for the variants' builds: variant -> (library, ptxas report,
    package: None for this one), each library declared through its own
    package's scene_kernel; with ``parent`` (its package, built) the
    parent's scene kernel too."""
    built = {}
    if parent is not None:
        lib = ctypes.CDLL(str(parent.ops.build.build("scene_megakernel")))
        built[PARENT] = (parent.ops.scene_kernel.declare(lib), parent.ops.build.BUILD_LOG["scene_megakernel"]["ptxas"],
                         parent)
    for name, (proc, lib, t0, pkg) in running.items():
        log_file = lib.with_suffix(".log")
        if proc is None:
            report = log_file.read_text()
            log(f"build: variant {name!r} already built")
        else:
            report = proc.communicate()[0]
            log(f"build: variant {name!r} in {time.perf_counter() - t0:.1f} s, rc {proc.returncode}")
            check(proc.returncode == 0, f"variant {name} failed to build:\n{report}")
            log_file.write_text(report)
            os.replace(lib.parent / f"lib.{os.getpid()}.tmp", lib)
        sk = scene_kernel if pkg is None else pkg.ops.scene_kernel
        built[name] = (sk.declare(ctypes.CDLL(str(lib))), report, pkg)
    built[FINAL] = (scene_kernel._library(), build.BUILD_LOG["scene_megakernel"]["ptxas"], None)
    return built


def ptxas_rows(report: str, kernel: str = "scene_megakernel") -> dict:
    """Registers, spill bytes and stack frame of each instantiation of a
    kernel from a ptxas report, keyed <STATS,NEE,PHYSICAL,COUNT> and, for a
    kernel with a fifth parameter (the scene kernel's geometry policy), that
    parameter after a slash."""
    import re

    rows, cur = {}, None
    for line in report.splitlines():
        m = re.search(rf"Compiling entry function '_Z{len(kernel)}{kernel}ILb(\d)ELb(\d)ELb(\d)ELb(\d)E(?:Li(\d+)E)?",
                      line)
        if m:
            cur = "<" + ",".join(m.groups()[:4]) + ">" + (f"/{m[5]}" if m[5] is not None else "")
            rows[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            rows[cur].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[cur]["registers"] = int(m[1])
    return rows


def submodule(pkg, name: str):
    """Module ``name`` of package ``pkg`` (this one or the parent's): by
    import, since a package may export a function of the module's name."""
    import importlib

    return importlib.import_module(f"{pkg.__name__}.{name}")


def arm_setup(dev, shape: dict, pkg=None) -> dict:
    """The scene, camera, intersector and lights of a row of phase 15, made
    by ``pkg`` (this package if None), and its launch arguments."""
    if pkg is None:
        import flux_tpu_torch as pkg
    sd = package_scene(pkg, shape["name"])
    sc = submodule(pkg, "scene").compile_scene(sd, dev)
    cam = submodule(pkg, "camera").camera_tensors(sd.camera_settings, sd.camera_data, sd.output_settings.pixel_size,
                                                  dev)
    ti = submodule(pkg, "ops.intersect")
    isect = ti.Intersector(mode="sweep", tri_layout=ti.tri_layout(sc))
    return dict(pkg=pkg, sc=sc, cam=cam, isect=isect, lights=None, w=sd.output_settings.image_width,
                h=sd.output_settings.image_height, row0=shape["row0"], n_rows=shape["n_rows"],
                n_samples=shape["n_samples"], root=shape["root"], stats=shape.get("stats", False),
                physical=shape.get("physical", False))


def raw_scene(lib, st: dict, counts=None, **skips) -> torch.Tensor:
    """One launch of a scene kernel library as its package's
    render_block_scene makes it (seed 0, depth 5, the launch plan's split),
    not counted in the wrapper's launches."""
    sk, swk = submodule(st["pkg"], "ops.scene_kernel"), submodule(st["pkg"], "ops.sweep_kernel")
    sc = st["sc"]
    n_pix = st["n_rows"] * st["w"]
    stats = st["stats"] and counts is None
    nee = st["lights"] is not None
    out = torch.empty((4 if stats else 3, n_pix), dtype=torch.float32, device=sc.device)
    packed = swk.pack_scene(sc, st["cam"], spheres=st["isect"].mode != "scan",
                            planes=sc.num_planes <= swk.MAX_PLANES)
    geom, keep = sk.pack_geom(sc, st["isect"], st["lights"], sc.device, **skips)
    split = swk.launch_plan(n_pix, st["n_samples"]).split
    stream = torch.cuda.current_stream()
    counts_ptr = None if counts is None else counts.data_ptr()
    tail = (int(stats), int(nee), int(st["physical"]), n_pix, st["w"], st["h"], st["row0"], 1, 0, st["n_samples"],
            1 << 32, 0, st["root"], 5, split, stream.cuda_stream)
    if hasattr(sk, "send_records"):
        # The scene record goes up apart from the launch, through the
        # package's record of what the library holds.
        pb = submodule(st["pkg"], "ops.build")
        with pb.LAUNCH_LOCK:
            sk.send_records(lib, torch.cuda.current_device(), stream, packed, sent=pb.SENT)
            err = lib.flux_scene_render(out.data_ptr(), counts_ptr, ctypes.byref(geom), *tail)
            if err == 0:
                pb.SENT.launched(lib, torch.cuda.current_device(), stream)
    else:
        err = lib.flux_scene_render(out.data_ptr(), counts_ptr, ctypes.byref(packed), ctypes.byref(geom), *tail)
    check(err == 0, f"raw scene launch failed: CUDA error {err}")
    del keep
    return out


def tri_counts(lib, st: dict, laps_in_sphere_clocks: bool = False) -> dict:
    """A build's counting launch on a row of phase 15 (no NEE: every fold is
    a nearest fold): triangle blocks needed, entered and box-tested per
    fold, the share of entered blocks beyond what a perfect skip needs (the
    far side), the direction lists' entries read and triangles folded apart
    per fold, and the clock64 split of a bounce: the nearest fold (spheres
    and planes; triangle box tests; triangle folds; the lists), the scatter
    and the rest. Cycles are one thread's, in launches that spill: shares
    count, cycles do not. The parent's build counts its triangle walk in the
    sphere walk's clocks (``laps_in_sphere_clocks``)."""
    sk = submodule(st["pkg"], "ops.scene_kernel")
    n_pix = st["n_rows"] * st["w"]
    counts = torch.zeros((sk.N_COUNTS, n_pix), dtype=torch.int32, device=st["sc"].device)
    raw_scene(lib, st, counts=counts)
    torch.cuda.synchronize()
    c = dict(zip(sk.COUNT_NAMES, ((counts.to(torch.int64) & 0xFFFFFFFF).sum(dim=1)).tolist()))
    folds = max(c["bounces"], 1)
    boxes, tri_folds = (("clk_sphere_boxes", "clk_sphere_folds") if laps_in_sphere_clocks
                        else ("clk_tri_boxes", "clk_tri_folds"))
    split = {"tri_box_tests": c.get(boxes, 0), "tri_folds": c.get(tri_folds, 0),
             "tri_lists": c.get("clk_tri_exceptions", 0)}
    split["spheres_and_planes"] = c["clk_nearest"] - c["clk_needed_walk"] - sum(split.values())
    split["scatter"], split["mis"] = c["clk_scatter"], c["clk_mis"]
    total = max(sum(split.values()), 1)
    entered = max(c["tri_blocks_entered"], 1)
    return {
        "bounces": c["bounces"], "path_counts": {k: c[k] for k in PATH_COUNTS},
        "tri_blocks": st["isect"].tri_layout.n_blocks,
        "tri_blocks_needed_per_fold": c["tri_blocks_needed"] / folds,
        "tri_blocks_entered_per_fold": c["tri_blocks_entered"] / folds,
        "tri_box_tests_per_fold": c["tri_box_tests"] / folds,
        "entered_beyond_needed_share": (c["tri_blocks_entered"] - c["tri_blocks_needed"]) / entered,
        "tri_list_entries_per_fold": c.get("tri_candidates", 0) / folds,
        "tris_folded_apart_per_fold": c.get("tri_exceptions", 0) / folds,
        "tris_needed_per_fold": c["tris_needed"] / folds,
        "bounce_cycles_share": {k: v / total for k, v in split.items()},
        "cycles_per_bounce": {k: v / folds for k, v in split.items()},
    }


# Counters of the paths themselves: every build must count the same.
PATH_COUNTS = ("bounces", "light_samples", "shadow_rays", "reverse_densities", "glossy_lobes")


def in_turns(fns: dict, rounds: int = 6) -> dict:
    """Each function timed in turns, forward then backward (CUDA events
    around 3 launches back to back, one per round): the median and the
    quartile spread of its rounds."""
    names = list(fns)
    times = {n: [] for n in names}
    for n in names:
        fns[n]()  # warm-up
    for rnd in range(rounds):
        for n in (names if rnd % 2 == 0 else names[::-1]):
            times[n] += launch_ms(fns[n], reps=1, n=3)
    return {"ms": {n: float(np.median(t)) for n, t in times.items()},
            "ms_quartile_spread": {n: float(np.subtract(*np.percentile(t, [75, 25]))) for n, t in times.items()}}


def phase_tri_steps(dev, built: dict) -> dict:
    """Phase 15: the triangle fold's design, step by step, on the rows of
    TRI_ROWS. Each build's registers, spills and stack frame; each build's
    counting launch (tri_counts; the path counters of every build equal);
    then every build, and the final build with the triangle skip off (the
    fold over every block), timed in turns (6 rounds), with their sums
    against the final build's bits: every build of these sources equal, the
    parent's said (its skip is not exact), and the final build's bits equal
    with the skip off."""
    res = {"ptxas": {n: ptxas_rows(r) for n, (_, r, _) in built.items()}}
    log("triangle fold, builds (registers, spills, stack):", json.dumps(res["ptxas"]))
    for row, shape in TRI_ROWS.items():
        sts = {}
        for n, (lib, _, pkg) in built.items():
            key = "parent" if pkg is not None else "new"
            if key not in sts:
                sts[key] = arm_setup(dev, shape, pkg)
        builds = {n: (lib, sts["parent" if pkg is not None else "new"]) for n, (lib, _, pkg) in built.items()}
        counted = {n: tri_counts(lib, st, n == PARENT_LAPS) for n, (lib, st) in builds.items()}
        log(f"triangle fold, counts ({row}, {shape['name']} band {shape['n_rows']}x800, {shape['n_samples']} spp):",
            json.dumps(counted))
        paths = {json.dumps(r["path_counts"]) for r in counted.values()}
        fns = {n: (lambda lib=lib, st=st: raw_scene(lib, st)) for n, (lib, st) in builds.items() if n != PARENT_LAPS}
        final = built[FINAL][0]
        fns["b, the triangle skip off"] = lambda: raw_scene(final, sts["new"], tri_skip=False)
        ref = fns[FINAL]()
        torch.cuda.synchronize()
        r = in_turns(fns)
        r["bits_equal_final"] = {n: bits_equal(fn(), ref) for n, fn in fns.items()}
        res[row] = {"counts": counted, "times": r, "paths_equal": len(paths) == 1}
        log(f"triangle fold, times ({row}):", json.dumps(r))
        check(all(v for n, v in r["bits_equal_final"].items() if n != PARENT and n not in INEXACT),
              f"{row}: a build of these sources gives other bits")
        if len(paths) != 1:
            log(f"{row}: the builds count different paths (the parent's skip is not exact):", json.dumps(
                {n: c["path_counts"] for n, c in counted.items()}))
        check(len({json.dumps(c["path_counts"]) for n, c in counted.items()
                   if built[n][2] is None and n not in INEXACT}) == 1,
              f"{row}: the builds of these sources count different paths")
    return res


# ---- phase 16: every row against the parent's build -------------------------


def load_parent(root: str):
    """The package of another checkout (``root``/flux_tpu_torch, e.g. the
    parent commit's unpacked by ``git archive``), imported under the name
    ``flux_tpu_torch_parent`` with its own build module, build directory and
    launch counters."""
    import importlib
    import importlib.util

    pkg = os.path.join(os.path.abspath(root), "flux_tpu_torch")
    spec = importlib.util.spec_from_file_location("flux_tpu_torch_parent", os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["flux_tpu_torch_parent"] = mod
    spec.loader.exec_module(mod)
    for sub in ("ops.build", "ops.scene_kernel", "ops.sweep_kernel", "ops.intersect", "camera", "render", "scene",
                "genscene", "meshgen"):
        importlib.import_module(f"flux_tpu_torch_parent.{sub}")
    return mod


def package_scene(pkg, name: str):
    """A row's SceneData as ``pkg`` (this package or the parent's) makes it."""
    if name in ("mesh1280", "mesh20480"):
        return pkg.meshgen.mesh_scene(*pkg.meshgen.icosphere(3 if name == "mesh1280" else 5), name=name)
    if name == "field16384":
        return pkg.genscene.sphere_field(16384, seed=0)
    return pkg.scene.load_scene(os.path.join(HERE, "scenes", f"{name}.yml"))


def parent_rows(dev, parent) -> dict:
    """Every row of phases 6, 9 and 13 and phase 12's band through the
    parent's package and this one (each a Renderer of its own making one
    launch), in turns (parent, new, new, parent, twice; CUDA events around
    3 launches back to back, median of the 8 rounds of each, with the
    quartile spread), and whether the two give the same bits."""
    import flux_tpu_torch

    rows = [("sweep", dict(name="demo2", row0=300, n_rows=50, n_samples=16384, root=128))]
    rows += [(cfg, shape) for cfg, _, shape in MEASURE]
    rows += [(cfg, {"name": name, **shape}) for cfg, _, name, shape in SCENE_MEASURE]
    rows += [("scan, sphere_field(16384)", dict(name="field16384", row0=300, n_rows=50, n_samples=16, root=4))]
    res = {}
    for cfg, shape in rows:
        pkgs = {"parent": parent, "new": flux_tpu_torch}
        fns, outs, r_of = {}, {}, {}
        for label, pkg in pkgs.items():
            r = r_of[label] = pkg.render.Renderer(package_scene(pkg, shape["name"]), shape["root"], 5, seed=0,
                                                  device=dev, accel=shape.get("accel"), nee=shape.get("nee", False),
                                                  physical=shape.get("physical", False))
            fns[label] = (lambda r=r: r.render_rows_sum_range(shape["row0"], shape["n_rows"], 0, shape["n_samples"],
                                                              with_stats=shape.get("stats", False)))
            outs[label] = fns[label]()
        times = {n: [] for n in fns}
        for rnd in range(4):
            for n in (("parent", "new", "new", "parent") if rnd % 2 == 0 else ("new", "parent", "parent", "new")):
                times[n] += launch_ms(fns[n], reps=1, n=3)
        res[cfg] = {"bits_equal": bits_equal(outs["parent"], outs["new"]),
                    "ms": {n: float(np.median(t)) for n, t in times.items()},
                    "ms_quartile_spread": {n: float(np.subtract(*np.percentile(t, [75, 25])))
                                           for n, t in times.items()}}
        if not res[cfg]["bits_equal"]:
            # Only the parent's triangle skip, which was not exact, may differ:
            # then the new launch must equal the fold over every block, the
            # parent's and its own.
            whole = {label: whole_fold(pkg, r_of[label], shape) for label, pkg in pkgs.items()}
            res[cfg]["triangle_skip_of_the_parent"] = {
                "new_equals_its_whole_fold": bits_equal(outs["new"], whole["new"]),
                "new_equals_the_parents_whole_fold": bits_equal(outs["new"], whole["parent"])}
            check(all(res[cfg]["triangle_skip_of_the_parent"].values()),
                  f"{cfg}: the new build differs from the parent's and from the fold over every block")
        log(f"against the parent ({cfg}, {shape['name']} band {shape['n_rows']} rows, {shape['n_samples']} spp):",
            json.dumps(res[cfg]))
    return res


def parent_job_path(parent, out_dir: str) -> dict:
    """demo2's job path (``cli.run -r 128 -d 5 -R 50``: the manager, a local
    worker, 12 K1 launches) through the parent's package and this one, in
    turns (parent, new, new, parent, three times): the seconds from
    schedule_job to the job's end, and the two PPMs' bytes equal."""
    argv = [os.path.join(HERE, "scenes", "demo2.yml"), "-r", "128", "-d", "5", "-R", "50", "--seed", "0"]
    runs = {"parent": submodule(parent, "cli").run, "new": cli_run}
    times, ppm = {n: [] for n in runs}, {}
    for _ in range(3):
        for n in ("parent", "new", "new", "parent"):
            ran = runs[n]([*argv, "--output-dir", os.path.join(out_dir, n)])
            check(ran["error"] is None, f"the {n} job path failed: {ran['error']}")
            times[n].append(ran["band_seconds"])
            with open(ran["out"], "rb") as f:
                ppm[n] = f.read()
    check(ppm["parent"] == ppm["new"], "the job path's PPM differs from the parent's")
    res = {"job_seconds": times, "median": {n: float(np.median(t)) for n, t in times.items()},
           "quartile_spread": {n: float(np.subtract(*np.percentile(t, [75, 25]))) for n, t in times.items()},
           "ppm_equal": True}
    log("against the parent, demo2's job path (cli.run, 800x600, 16384 spp, -R 50), seconds:", json.dumps(res))
    return res


def whole_fold(pkg, r, shape) -> torch.Tensor:
    """A row's launch through ``pkg``'s scene kernel with the triangle skip
    off (every triangle block folded), as the Renderer ``r`` would make it."""
    return pkg.ops.scene_kernel.render_block_scene(
        r.scene, r.cam, shape["row0"], 0, r.seed, isect=r.isect, img_w=r.width, img_h=r.height,
        n_rows=shape["n_rows"], n_samples=shape["n_samples"], root=r.root, max_depth=r.max_depth, lights=r.lights,
        physical=r.physical, with_stats=shape.get("stats", False), tri_skip=False).reshape(
            shape["n_rows"], r.width, -1)


# ---- phase 17: the job path ---------------------------------------------------


def band_loop_ppm(dev, argv: list) -> tuple:
    """The PPM bytes of ``argv``'s scene, root, depth, bands (``-R``) and
    estimator rendered by a band loop over ``Renderer.render_rows``, the
    loop's seconds and the frame."""
    opt = dict(zip(argv[1::2], argv[2::2]))
    sd = load_scene(argv[0])
    r = Renderer(sd, int(opt["-r"]), int(opt["-d"]), seed=int(opt["--seed"]), device=dev,
                 nee="--nee" in argv, physical="--physical" in argv)
    img, rows = Image(r.width, r.height), int(opt["-R"])
    t0 = time.perf_counter()
    for row0 in range(0, r.height, rows):
        img.set_rows(row0, r.render_rows(row0, min(rows, r.height - row0)))
    seconds = time.perf_counter() - t0
    return ppm_bytes(img.pixels), seconds, img.pixels


@contextlib.contextmanager
def counted_rounds(force_python: bool = False):
    """While open, every scheduler round a manager of this process makes
    (``sched.SchedulerRound``, which the manager looks up at each round) is
    recorded with the times it was closed; ``force_python`` puts them on
    the Python core."""
    made = []

    class Counted(SchedulerRound):
        def __init__(self, *a, **kw):
            super().__init__(*a, **{**kw, "force_python": force_python})
            self.closes = 0
            made.append(self)

        def close(self):
            self.closes += 1
            super().close()

    sched.SchedulerRound = Counted
    try:
        yield made
    finally:
        sched.SchedulerRound = SchedulerRound


def job_path(label: str, argv: list, out_dir: str, want: bytes, config: str, force_python: bool = False) -> dict:
    """One job through cli.run, its launch counts set to 0 just before and
    read just after: no JobFailed, no job error, no retry round, every unit
    rendered once, one launch of ``config`` here for each unit the local
    worker rendered (none with -L), and the PPM bytes equal to ``want``.
    Its one round runs on the native scheduler core (the Python core with
    ``force_python``) and is closed once."""
    opt = dict(zip(argv[1::2], argv[2::2]))
    n_units = -(-load_scene(argv[0]).output_settings.image_height // int(opt["-R"]))
    with counted_rounds(force_python) as rounds:
        ran, n, secs = run_path(label, lambda: cli_run([*argv, "--output-dir", out_dir]))
    check(len(rounds) == 1, f"{label}: {len(rounds)} scheduler rounds, not 1")
    check(rounds[0].native is not force_python, f"{label}: the round ran on the wrong scheduler core")
    check(rounds[0].closes == 1, f"{label}: the round was closed {rounds[0].closes} times, not once")
    check(ran["error"] is None, f"{label}: the job failed: {ran['error']}")
    check(not ran["worker_failures"], f"{label}: JobFailed events {ran['worker_failures']}")
    check(ran["retry_rounds"] == 0, f"{label}: {ran['retry_rounds']} retry rounds, {ran['retried_units']} units")
    check(sum(ran["units_by_worker"].values()) == n_units, f"{label}: units {ran['units_by_worker']}, not {n_units}")
    local = ran["units_by_worker"].get("local", 0)
    check(n == ({config: local} if local else {}), f"{label}: launches {n}, {local} local units of {config}")
    with open(ran["out"], "rb") as f:
        check(f.read() == want, f"{label}: the PPM differs from the band loop's bytes")
    res = {"seconds": secs, "job_seconds": ran["band_seconds"], "launches": n,
           "units_by_worker": ran["units_by_worker"], "ppm_equal": True,
           "scheduler_core": "native" if rounds[0].native else "python"}
    return {**res, "trace": ran.get("trace")}


class NodeProcess:
    """``python -m flux_tpu_torch.node`` on a free loopback port, started
    from this checkout with ``extra`` arguments; its output is kept.
    ``stop`` ends it with SIGTERM and returns its exit code (0 for a clean
    stop)."""

    def __init__(self, *extra: str):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self.lines = []
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "flux_tpu_torch.node", "-H", "127.0.0.1", "-p", str(self.port), *extra],
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        self._reader = threading.Thread(target=lambda: self.lines.extend(iter(self.proc.stdout.readline, "")),
                                        daemon=True)
        self._reader.start()
        deadline = time.monotonic() + 120
        while not any("listening" in ln for ln in self.lines):
            check(self.proc.poll() is None, f"the node exited {self.proc.returncode}: {''.join(self.lines)}")
            check(time.monotonic() < deadline, f"the node did not listen in 120 s: {''.join(self.lines)}")
            time.sleep(0.05)
        self.endpoint = f"127.0.0.1:{self.port}"

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=60)
        self._reader.join(timeout=10)
        return self.proc.returncode


def wire_unit_ms(rows: np.ndarray) -> dict:
    """Host milliseconds of one unit's rows over the wire, median of 5: the
    node's encode (deflate) and pack, the master's unpack and decode, and
    the frame's bytes raw and deflated."""
    def median_ms(fn):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times)), out

    enc_ms, msg = median_ms(lambda: wire.encode_rows(0, rows))
    pack_ms, data = median_ms(lambda: wire.packb(msg))
    unpack_ms, back = median_ms(lambda: wire.unpackb(data))
    dec_ms, got = median_ms(lambda: wire.decode_rows(back))
    check(np.array_equal(got, rows), "the wire changed a unit's rows")
    return {"shape": list(rows.shape), "raw_bytes": rows.nbytes, "frame_bytes": len(data),
            "deflated": msg.get("enc") == "zlib", "encode_ms": enc_ms, "pack_ms": pack_ms,
            "unpack_ms": unpack_ms, "decode_ms": dec_ms}


def trace_kernels(path: str) -> dict:
    """Device kernels a Chrome trace records: name -> (count, total ms)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    out = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            n, ms = out.get(ev["name"], (0, 0.0))
            out[ev["name"]] = (n + 1, ms + ev.get("dur", 0) / 1e3)
    return out


def phase_job_path(dev, out_dir: str, card: str) -> dict:
    check(native.available(), f"the native host code did not load: {native.load_error}")
    check(native_sched_available(), "the native scheduler core did not load")
    log(f"native host code and scheduler core: {native.library_path()}; the wire's msgpack: "
        f"{'.'.join(map(str, msgpack.version))}")
    scene = lambda name: os.path.join(HERE, "scenes", f"{name}.yml")
    results = {}

    def note(label, res):
        results[label] = res
        log(f"job path, {label} on {card}:", json.dumps(res))

    # a. The published workload through the manager and a local worker.
    demo2 = [scene("demo2"), "-r", "128", "-d", "5", "-R", "50", "--seed", "0"]
    want, loop_s, frame = band_loop_ppm(dev, demo2)
    res = job_path("demo2 local", demo2, os.path.join(out_dir, "a"), want, "sweep")
    res.update(band_loop_seconds=loop_s, job_path_over_band_loop_s=res["job_seconds"] - loop_s,
               cli_over_band_loop_s=res["seconds"] - loop_s)
    note("a. demo2 800x600 root 128 depth 5 -R 50, local worker", res)
    # The same job with its round on the Python core, beside the native one.
    res = job_path("demo2 local, python core", demo2, os.path.join(out_dir, "a2"), want, "sweep", force_python=True)
    res.update(band_loop_seconds=loop_s, job_path_over_band_loop_s=res["job_seconds"] - loop_s)
    note("a. demo2 the same, the round on the Python scheduler core", res)
    note("a. one demo2 unit over the wire (host)", wire_unit_ms(frame[:50]))
    node = NodeProcess()
    try:
        # b. The same job through a port node, then the node and the local worker.
        res = job_path("demo2 node", demo2 + ["-L", "-n", node.endpoint], os.path.join(out_dir, "b1"), want, "sweep")
        res["band_loop_seconds"] = loop_s
        note("b. demo2 through a port node (-L -n)", res)
        res = job_path("demo2 node again", demo2 + ["-L", "-n", node.endpoint], os.path.join(out_dir, "b1r"), want,
                       "sweep")
        note("b. demo2 through the port node again", {**res, "band_loop_seconds": loop_s})
        res = job_path("demo2 node + local", demo2 + ["-n", node.endpoint], os.path.join(out_dir, "b2"), want,
                       "sweep")
        note("b. demo2 through a port node and the local worker (-n)", res)
        # c. Other kernels through the job path: K4 + K3 and K7 (demo5's last unit is 12 rows).
        demo3 = [scene("demo3"), "-r", "8", "-d", "5", "-R", "50", "--seed", "0", "--nee", "--physical"]
        want3, loop3, _ = band_loop_ppm(dev, demo3)
        res = job_path("demo3 mis", demo3, os.path.join(out_dir, "c3"), want3, "sweep+nee+physical")
        note("c. demo3 --nee --physical root 8, local worker", {**res, "band_loop_seconds": loop3})
        demo5 = [scene("demo5"), "-r", "8", "-d", "5", "-R", "50", "--seed", "0", "--nee"]
        want5, loop5, _ = band_loop_ppm(dev, demo5)
        res = job_path("demo5 nee", demo5, os.path.join(out_dir, "c5"), want5, "sweep+tri+nee+trilight")
        note("c. demo5 --nee root 8, local worker", {**res, "band_loop_seconds": loop5})
        res = job_path("demo5 nee node", demo5 + ["-L", "-n", node.endpoint], os.path.join(out_dir, "c5n"), want5,
                       "sweep+tri+nee+trilight")
        note("c. demo5 --nee root 8, through the port node", res)
    finally:
        rc = node.stop()
        log(f"node output (exit code {rc}):\n" + "".join(node.lines).rstrip())
    check(rc == 0, f"the node exited {rc}")
    # d. The profiler.
    small = [scene("demo2"), "-r", "4", "-d", "5", "-R", "50", "--seed", "0"]
    want_s, _, _ = band_loop_ppm(dev, small)
    res = job_path("demo2 profiled", small + ["--profile-dir", os.path.join(out_dir, "prof")],
                   os.path.join(out_dir, "d"), want_s, "sweep")
    check(res["trace"] is not None and os.path.isfile(res["trace"]), "--profile-dir wrote no trace")
    kernels = trace_kernels(res["trace"])
    res["trace_kernels"] = {k: {"count": n, "ms": ms} for k, (n, ms) in kernels.items()}
    res["trace_bytes"] = os.path.getsize(res["trace"])
    note("d. demo2 root 4 with --profile-dir", res)
    if not kernels:
        log("d. the trace records no device kernel (CUPTI gave no kernel activity)")
    return results, want


# ---- phase 18: the device mesh -------------------------------------------------

# The meshes of phase 18 a, over the one card repeated: (rows, spp) shards.
MESH_SHAPES = [(1, 1), (2, 1), (4, 1), (1, 2), (2, 2)]


def card_mesh(dev, shape):
    return make_mesh([dev] * (shape[0] * shape[1]), rows_shards=shape[0], spp_shards=shape[1])


def job_config(argv: list):
    """(SceneData, JobConfiguration) of a CLI argument list."""
    opt = dict(zip(argv[1::2], argv[2::2]))
    cfg = JobConfiguration(sample_root=int(opt["-r"]), max_trace_depth=int(opt["-d"]),
                           rows_per_work_unit=int(opt["-R"]), seed=int(opt["--seed"]),
                           nee="--nee" in argv, physical="--physical" in argv)
    return load_scene(argv[0]), cfg


def mesh_job(dev, argv: list, shape, out_dir: str) -> dict:
    """``argv``'s job through RenderManager and a LocalWorker whose renderer
    is a MeshRenderer of ``shape`` over the card repeated (the CLI's mesh
    branch, on one card): the frame and the seconds from schedule_job to
    the job's end. Fails on a job error, a JobFailed event, a retry round
    or a unit not rendered once."""
    sd, cfg = job_config(argv)
    mesh = card_mesh(dev, shape)

    def factory(job):
        return MeshRenderer(job.scene_data, job.config.sample_root, job.config.max_trace_depth,
                            seed=job.config.seed, mesh=mesh, nee=job.config.nee, physical=job.config.physical)

    worker = LocalWorker(renderer_factory=factory, devices=[dev] * mesh.size)
    check(worker.info().num_devices == mesh.size, "the worker does not report the mesh's devices")
    manager = RenderManager([worker.handle()])
    builder = ImageBuilder(output_dir=out_dir)
    failures = FailureLog()
    try:
        t0 = time.perf_counter()
        job = manager.schedule_job(sd, cfg, MultiSink([builder.sender(), failures]))
        check(job.wait(timeout=600), f"mesh {shape}: the job did not end in 600 s")
        seconds = time.perf_counter() - t0
        check(builder.wait_finished(timeout=60), f"mesh {shape}: the image was not finished")
        pixels = builder.get_image().pixels.copy()
    finally:
        builder.stop()
        manager.stop()
        worker.stop()
    n_units = -(-sd.output_settings.image_height // cfg.rows_per_work_unit)
    check(job.error is None and not failures.reasons, f"mesh {shape}: {job.error} {failures.reasons}")
    check(job.retry_rounds == 0 and worker.units_done == n_units, f"mesh {shape}: {worker.units_done} units, "
          f"{job.retry_rounds} retry rounds")
    return {"pixels": pixels, "job_seconds": seconds, "units": worker.units_done}


def bitwise(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def phase_mesh_main_path(dev, out_dir: str, card: str, want17: bytes) -> dict:
    """Phase 18 a: demo2 at 800x600, root 128, depth 5, 12 units of 50 rows
    through the manager and a MeshRenderer of each shape in MESH_SHAPES over
    the card, in two rounds after a band loop each; rows-only meshes
    byte-equal to the band loop, meshes with spp shards within float32's
    reassociation bound of it; then ``cli.run -t 1 --rows-shards 1``,
    byte-equal to phase 17's frame."""
    demo2 = [os.path.join(HERE, "scenes", "demo2.yml"), "-r", "128", "-d", "5", "-R", "50", "--seed", "0"]
    res = {"band_loop_seconds": [], "meshes": {}}
    frames = {}
    for rnd in range(2):
        want, loop_s, frame = band_loop_ppm(dev, demo2)
        check(want == want17, "phase 18's band loop differs from phase 17's bytes")
        res["band_loop_seconds"].append(loop_s)
        for shape in MESH_SHAPES:
            label = f"demo2 on a {shape[0]}x{shape[1]} mesh"
            ran, n, secs = run_path(label, lambda: mesh_job(dev, demo2, shape, os.path.join(out_dir, "a")))
            k = shape[0] * shape[1]
            check(n == {"sweep": 12 * k}, f"{label}: launches {n}, not {12 * k} of K1")
            px = ran["pixels"]
            row = res["meshes"].setdefault(f"{shape[0]}x{shape[1]}", {"job_seconds": [], "launches": n})
            row["job_seconds"].append(ran["job_seconds"])
            if shape[1] == 1:
                check(bitwise(px, frame) and ppm_bytes(px) == want, f"{label}: not the band loop's bits")
                row["bitwise_equal_to_band_loop"] = True
            else:
                # Sample shards add partial sums where one launch's thread
                # adds its samples in turn: float32 reassociation, which
                # for a thread's ceil(16384 / 32) = 512 terms can move a
                # finalized value v <= 1 by up to 512 * 2^-24 * v (flux_tpu's
                # atol 1e-5 is its gate at 4-16 spp; the CPU tests keep it).
                d = float(np.abs(px - frame).max())
                bound = -(-128 * 128 // launch_plan(50 * 800, 128 * 128).split) * 2.0 ** -24
                row.update(max_abs_diff_vs_band_loop=d, mean_abs_diff_vs_band_loop=float(np.abs(px - frame).mean()),
                           reassociation_bound=bound)
                check(d <= bound, f"{label}: max |diff| {d} over the reassociation bound {bound}")
            if rnd == 0:
                frames[shape] = px
            else:
                check(bitwise(px, frames[shape]), f"{label}: two runs differ")
    cli_dir = os.path.join(out_dir, "cli")
    ran, n, secs = run_path("cli -t 1 --rows-shards 1", lambda: cli_run(
        [*demo2, "-t", "1", "--rows-shards", "1", "--output-dir", cli_dir]))
    check(ran["error"] is None and n == {"sweep": 12}, f"cli -t 1: {ran['error']} {n}")
    with open(ran["out"], "rb") as f:
        check(f.read() == want17, "cli -t 1 --rows-shards 1: not phase 17's bytes")
    res["cli_t1"] = {"seconds": secs, "job_seconds": ran["band_seconds"], "launches": n, "ppm_equal": True}
    for key, row in res["meshes"].items():
        row["over_band_loop_s"] = [a - b for a, b in zip(row["job_seconds"], res["band_loop_seconds"])]
    log(f"mesh main path (demo2 800x600, 16384 spp, depth 5, 12 units of 50 rows) on {card}:", json.dumps(res))
    return {"result": res, "frames": frames}


# Phase 18 b: (label, scene, nee, physical, stats, (rows, spp), band rows):
# each slot's launch of the band at root 3, seed 42, depth 5, against the
# plain version.
MESH_CHECKS = [
    ("K1", "demo2", False, False, False, (2, 2), 16),
    ("K1", "demo2", False, False, False, (4, 4), 16),
    ("K2", "demo2", False, False, True, (2, 2), 16),
    ("K2", "demo2", False, False, True, (4, 2), 16),
    ("K4 + K3", "demo3", True, True, False, (2, 2), 16),
    ("K4 + K3", "demo3", True, True, False, (4, 2), 16),
    ("K7", "demo5", True, False, False, (2, 2), 16),
    ("K7", "demo5", True, False, False, (4, 2), 16),
    ("K7 + K2", "demo5", True, False, True, (2, 2), 16),
    ("K7 + K2", "demo5", True, False, True, (4, 2), 16),
    ("K1, a 10-row band", "demo2", False, False, False, (4, 2), 10),  # the image's last 10 rows
]


def phase_mesh_launches(dev) -> dict:
    """Phase 18 b: every slot of each MESH_CHECKS mesh, launched as the
    MeshRenderer launches it (rows ``row0 + ri + k·R``, samples from
    ``si·per_dev`` masked at 9, the band's split), against the plain version
    at phase 3's gate; a slot wholly past the samples must add exact zeros;
    the mesh's band against the Renderer's (rows-only: bitwise; else atol
    1e-5 finalized). Then a band whose launch plan is not its shards'."""
    out = {}
    for label, name, nee, physical, stats, (R, S), n_rows in MESH_CHECKS:
        sd = stock(name)
        r = Renderer(sd, 3, 5, seed=42, device=dev, nee=nee, physical=physical)
        # A 10-row band over 4 row shards renders 12 rows: the last two lie
        # past the image's last row, and are rendered and dropped.
        row0 = r.height - n_rows if n_rows == 10 else r.height // 2 - 8
        strides, limits, errs = set(), [], []

        def slots():
            res = []
            for ri in range(R):
                for si in range(S):
                    a = slot_launch(row0, n_rows, 0, 9, R, S, ri, si)
                    res.append((a, r.render_rows_sum_range(with_stats=stats, **a)))
            return res

        launched, n, _ = run_path(f"mesh launches, {label} on {name} {R}x{S}", slots)
        cfg = next(iter(n))
        check(len(n) == 1 and n[cfg] == R * S, f"{label}: launches {n}")
        for a, k in launched:
            p = render_block(r.scene, r.cam, a["row0"], a["s0"], r.seed, img_w=r.width, img_h=r.height,
                             n_rows=a["n_rows"], n_samples=a["n_samples"], root=3, max_depth=5,
                             s_limit=a["s_limit"], row_stride=a["row_stride"], with_stats=stats, lights=r.lights,
                             physical=physical, isect=None if r.uses_sweep_kernel else r.isect)
            strides.add(a["row_stride"])
            limits.append([a["s0"], a["s0"] + a["n_samples"], a["s_limit"]])
            what = f"{label} on {name}, mesh {R}x{S}, slot rows {a['row0']}+k*{R}, samples [{a['s0']}, " \
                   f"{a['s0'] + a['n_samples']}) limit {a['s_limit']}"
            if a["s_limit"] <= a["s0"]:
                check(not bool(k.any()) and not bool(p.any()), f"{what}: a slot past the samples added non-zeros")
                continue
            cmp = compare(k, p, 3, stats)
            check_vs_plain(cmp, what)
            errs.append(cmp["max_abs_diff"])
        m = MeshRenderer(sd, 3, 5, seed=42, mesh=card_mesh(dev, (R, S)), nee=nee, physical=physical)
        got = m.render_rows_sum_range(row0, n_rows, 0, 9, with_stats=stats)
        want = r.render_rows_sum_range(row0, n_rows, 0, 9, with_stats=stats)
        if S == 1:
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)), f"{label}: mesh band != Renderer band")
        mesh_d = float((finalize(got[..., :3], root=3) - finalize(want[..., :3], root=3)).abs().max())
        check(mesh_d <= 1e-5, f"{label}: mesh band {mesh_d} over atol 1e-5 of the Renderer's")
        inside = sum(1 for s0, end, lim in limits if s0 < lim < end)
        cut = sum(1 for s0, end, lim in limits if lim < end)
        check(max(strides) > 1 and cut > 0, f"{label}: no strided launch cut by s_limit")
        row = out.setdefault(cfg, {"checks": [], "max_abs_err": 0.0})
        row["checks"].append({"label": label, "scene": name, "mesh": [R, S], "band_rows": n_rows,
                              "row_stride": R, "slot_sample_ranges_and_limits": limits,
                              "slots_with_s_limit_inside": inside, "slots_past_the_samples": cut - inside,
                              "max_abs_diff_vs_plain": max(errs),
                              "mesh_band_max_finalized_diff_vs_renderer": mesh_d})
        row["max_abs_err"] = max(row["max_abs_err"], max(errs))
        log(f"mesh launches vs plain ({label} on {name}, mesh {R}x{S}, {n_rows}-row band, root 3):",
            json.dumps(row["checks"][-1]))
    for cfg, row in out.items():
        check(any(c["slots_with_s_limit_inside"] for c in row["checks"]), f"{cfg}: no s_limit inside a launch")
    # The split hazard: a 16-row band at 17 samples is cut at another split
    # than its 4-row shards would be alone; the shards take the band's.
    sd, n = stock("demo2"), 17
    plans = (launch_plan(16 * 800, n).split, launch_plan(4 * 800, n).split)
    check(plans[0] != plans[1], "the split-hazard band's plans agree")
    r = Renderer(sd, 5, 5, seed=42, device=dev)
    m = MeshRenderer(sd, 5, 5, seed=42, mesh=card_mesh(dev, (4, 1)))
    want = r.render_rows_sum_range(292, 16, 0, n, with_stats=True)
    got = m.render_rows_sum_range(292, 16, 0, n, with_stats=True)
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)), "a rows mesh lost its band's split")
    out["split_hazard"] = {"band_split": plans[0], "shard_own_split": plans[1], "bitwise_equal": True}
    log("mesh, the split hazard (demo2 16x800 band, 17 spp, 4x1 mesh):", json.dumps(out["split_hazard"]))
    return out


def progressive_run(renderer, n_pass: int, target: float = 0.0, rows_per_band=None):
    """ProgressiveRenderer passes of ``n_pass`` until complete, or until the
    p99 relative stderr drops below ``target``, as run_progressive does."""
    pr = ProgressiveRenderer.from_renderer(renderer, rows_per_band=rows_per_band)
    err = None
    while not pr.complete:
        pr.render_pass(n_pass)
        err = pr.max_rel_stderr()
        if target > 0 and err is not None and err < target:
            break
    return pr, err


def phase_mesh_progressive(dev, out_dir: str, mis_mse: float) -> dict:
    """Phase 18 c: demo2's adaptive stop, demo3's MIS MSE, checkpoints both
    ways between a rows (2, 1) mesh and one card, and the Cornell box
    (K7, K7 + K2) through the mesh; every launch count read around its path."""
    demo2, demo3, demo5 = (load_scene(os.path.join(HERE, "scenes", f"{s}.yml")) for s in ("demo2", "demo3", "demo5"))
    rows2 = card_mesh(dev, (2, 1))
    res, launches = {}, {}

    # Adaptive: demo2 root 32 depth 5, passes of 64, target 0.12.
    one, err1 = progressive_run(Renderer(demo2, 32, 5, seed=0, device=dev), 64, 0.12)
    (mesh, errm), n, secs = run_path("demo2 adaptive on a 2x1 mesh", lambda: progressive_run(
        MeshRenderer(demo2, 32, 5, seed=0, mesh=rows2), 64, 0.12))
    res["adaptive"] = {"spp_done": mesh.samples_done, "p99_rel_stderr": errm, "one_card_p99": err1,
                       "seconds": secs, "launches": n}
    check(set(n) == {"sweep+stats"}, f"adaptive mesh: launches {n}")
    check(mesh.samples_done == one.samples_done == ADAPTIVE_SPP, f"adaptive mesh stopped at {mesh.samples_done}")
    check(errm == err1 and abs(errm - ADAPTIVE_P99) <= ADAPTIVE_P99_ATOL, f"adaptive mesh p99 {errm} vs one card {err1}")
    check(bitwise(mesh.acc, one.acc) and bitwise(mesh.lum_sq, one.lum_sq), "adaptive mesh: sums differ")
    launches.update(n)

    # MIS: 16 spp (seed 0) against 1024 spp (seed 7), both on the mesh.
    def mis():
        truth = MeshRenderer(demo3, 32, 5, seed=7, mesh=rows2, nee=True, physical=True).render_image(600)
        img16 = MeshRenderer(demo3, 4, 5, seed=0, mesh=rows2, nee=True, physical=True).render_image(600)
        return truth, img16

    (truth, img16), n, secs = run_path("demo3 MIS on a 2x1 mesh", mis)
    mse = float(((img16 - truth) ** 2).mean())
    res["mis"] = {"mse_16spp_vs_1024spp": mse, "one_card_mse": mis_mse, "seconds": secs, "launches": n}
    check(set(n) == {"sweep+nee+physical"}, f"MIS mesh: launches {n}")
    check(mse == mis_mse and abs(mse / MIS_MSE - 1.0) <= MIS_MSE_RTOL, f"MIS mesh MSE {mse}, one card {mis_mse}")
    launches.update(n)

    # Checkpoints: demo3 MIS + stats at root 8, passes of 16, both ways.
    def interchange():
        whole = progressive_run(Renderer(demo3, 8, 5, seed=0, device=dev, nee=True, physical=True), 16)[0]
        out = {}
        for first in ("mesh", "card"):
            make = {
                "mesh": lambda: MeshRenderer(demo3, 8, 5, seed=0, mesh=rows2, nee=True, physical=True),
                "card": lambda: Renderer(demo3, 8, 5, seed=0, device=dev, nee=True, physical=True),
            }
            a = ProgressiveRenderer.from_renderer(make[first]())
            a.render_pass(16)
            a.render_pass(16)
            ck = os.path.join(out_dir, f"{first}.ckpt.npz")
            a.save(ck)
            b = ProgressiveRenderer.from_renderer(make["card" if first == "mesh" else "mesh"]())
            b.resume(ck)
            while not b.complete:
                b.render_pass(16)
            out[f"{first} -> other"] = bitwise(b.acc, whole.acc) and bitwise(b.lum_sq, whole.lum_sq)
        return out

    eq, n, secs = run_path("demo3 MIS checkpoints between a 2x1 mesh and one card", interchange)
    res["checkpoints"] = {**eq, "seconds": secs, "launches": n}
    check(all(eq.values()), f"checkpoints: {eq}")
    check(n.get("sweep+nee+physical+stats", 0) > 0, f"checkpoints: launches {n}")
    launches.update(n)

    # The Cornell box: a --nee job through the mesh (K7), bytes of the band
    # loop; a progressive NEE render on it (K7 + K2), the one card's sums.
    argv5 = [os.path.join(HERE, "scenes", "demo5.yml"), "-r", "8", "-d", "5", "-R", "50", "--seed", "0", "--nee"]
    want5, _, _ = band_loop_ppm(dev, argv5)
    ran, n, secs = run_path("demo5 --nee job on a 2x1 mesh", lambda: mesh_job(dev, argv5, (2, 1), out_dir))
    check(ppm_bytes(ran["pixels"]) == want5, "demo5 mesh job: not the band loop's bytes")
    check(n == {"sweep+tri+nee+trilight": 22}, f"demo5 mesh job: launches {n}")
    res["demo5_job"] = {"job_seconds": ran["job_seconds"], "launches": n, "ppm_equal": True}
    launches.update(n)
    one5 = progressive_run(Renderer(demo5, 4, 5, seed=0, device=dev, nee=True), 16)[0]
    mesh5, n, secs = run_path("demo5 progressive NEE on a 2x1 mesh", lambda: progressive_run(
        MeshRenderer(demo5, 4, 5, seed=0, mesh=rows2, nee=True), 16)[0])
    check(set(n) == {"sweep+tri+nee+trilight+stats"}, f"demo5 progressive mesh: launches {n}")
    check(bitwise(mesh5.acc, one5.acc) and bitwise(mesh5.lum_sq, one5.lum_sq), "demo5 progressive mesh: sums differ")
    res["demo5_progressive"] = {"seconds": secs, "launches": n, "bitwise_equal": True}
    launches.update(n)
    log("mesh progressive paths (2x1 mesh on one card):", json.dumps(res))
    return {"result": res, "launches": launches}


def mesh_rank(rank: int, port: int, out: str) -> int:
    """One of phase 18 d's two processes (``--mesh-rank``): joins a gloo
    group with the other, both on the card, and renders demo2 at 800x600,
    16384 spp over a rows (2, 1) global mesh, keeping its own rows
    (``render_rows_local``), then over an spp (1, 2) one, band by band."""
    dev = torch.device("cuda", 0)
    init_multihost(f"127.0.0.1:{port}", num_processes=2, process_id=rank, backend="gloo")
    sd = load_scene(os.path.join(HERE, "scenes", "demo2.yml"))
    rows_r = MeshRenderer(sd, 128, 5, seed=0, mesh=make_mesh([dev], rows_shards=2, spp_shards=1))
    spp_r = MeshRenderer(sd, 128, 5, seed=0, mesh=make_mesh([dev], rows_shards=1, spp_shards=2))
    torch.distributed.barrier()
    t0 = time.perf_counter()
    got = [rows_r.render_rows_local(row0, 50) for row0 in range(0, 600, 50)]
    torch.cuda.synchronize()
    rows_s = time.perf_counter() - t0
    torch.distributed.barrier()
    t0 = time.perf_counter()
    frame = spp_r.render_image(rows_per_band=50)
    spp_s = time.perf_counter() - t0
    np.savez(out, rows=np.concatenate([g[0] for g in got]), pixels=np.concatenate([g[1] for g in got]),
             spp_frame=frame, rows_seconds=rows_s, spp_seconds=spp_s)
    torch.distributed.destroy_process_group()
    print(f"mesh rank {rank}: rows {rows_s:.3f} s, spp {spp_s:.3f} s", flush=True)
    return 0


def phase_mesh_two_processes(out_dir: str, frames: dict, card: str) -> dict:
    """Phase 18 d: two processes of this script (``--mesh-rank``), both on
    the card, over gloo: the rows (2, 1) frame assembled from each one's
    rows and each one's spp (1, 2) frame, bitwise against phase 18 a's
    one-process meshes of those shapes; fails on a rank that does not exit
    0."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outs = [os.path.join(out_dir, f"rank{r}.npz") for r in (0, 1)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "chip_smoke.py"), "--mesh-rank", str(r),
                               "--mesh-port", str(port), "--mesh-out", outs[r]], cwd=HERE,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, logs)):
        log(f"mesh rank {r} (exit code {p.returncode}):\n{text.rstrip()[-3000:]}")
        check(p.returncode == 0, f"mesh rank {r} exited {p.returncode}")
    z = [np.load(o) for o in outs]
    frame = np.full((600, 800, 3), np.nan, np.float32)
    rows = []
    for zi in z:
        frame[zi["rows"]] = zi["pixels"]
        rows.extend(zi["rows"].tolist())
    check(sorted(rows) == list(range(600)), "the two processes' rows do not cover the frame once")
    check(bitwise(frame, frames[(2, 1)]), "two processes, rows 2x1: not the one-process mesh's bits")
    for r, zi in enumerate(z):
        check(bitwise(zi["spp_frame"], frames[(1, 2)]), f"two processes, spp 1x2, rank {r}: not the one-process bits")
    res = {"rows_2x1_seconds": [float(zi["rows_seconds"]) for zi in z],
           "spp_1x2_seconds": [float(zi["spp_seconds"]) for zi in z], "wall_seconds_with_start": wall,
           "rows_bitwise_equal": True, "spp_bitwise_equal": True}
    log(f"mesh over two processes (gloo, both on the card; demo2 800x600, 16384 spp) on {card}:", json.dumps(res))
    return res


def phase_mesh_node_and_sampler(dev, out_dir: str, want17: bytes) -> dict:
    """Phase 18 e: a node with ``-t 1`` serves demo2 byte-equal to phase
    17's; ``sampler_debug`` on the card writes the CPU's eight files."""
    demo2 = [os.path.join(HERE, "scenes", "demo2.yml"), "-r", "128", "-d", "5", "-R", "50", "--seed", "0"]
    node = NodeProcess("-t", "1")
    try:
        res = job_path("demo2 node -t 1", demo2 + ["-L", "-n", node.endpoint], os.path.join(out_dir, "node"),
                       want17, "sweep")
    finally:
        rc = node.stop()
        log(f"node -t 1 output (exit code {rc}):\n" + "".join(node.lines).rstrip())
    check(rc == 0, f"the node -t 1 exited {rc}")
    check(any("serving 1 of 1 local devices" in ln for ln in node.lines), "the node did not say what it serves")
    files = {}
    for d in ("cuda", "cpu"):
        sub = os.path.join(out_dir, f"sampler-{d}")
        check(sampler_debug.main(["-r", "10", "--device", d, "--output-dir", sub]) == 0, f"sampler_debug on {d}")
        files[d] = {f: open(os.path.join(sub, f), "rb").read() for f in sorted(os.listdir(sub))}
    check(len(files["cuda"]) == 8 and files["cuda"] == files["cpu"], "sampler_debug: the card's files differ")
    res = {"node": res, "sampler_debug_files_equal": sorted(files["cuda"])}
    log("mesh phase, node -t 1 and sampler_debug:", json.dumps(res))
    return res


# Phase 18's kernels line: each configuration as a rows (2, 1) mesh
# launches it on its phase 18 path, measured at that launch.
MESH_MEASURE = [
    ("sweep", "a", "flux_tpu/ops/pallas_kernel.py:135",
     dict(name="demo2", row0=300, n_rows=25, n_samples=16384, root=128), 50),
    ("sweep+stats", "c", "flux_tpu/ops/pallas_kernel.py:908",
     dict(name="demo2", row0=256, n_rows=64, n_samples=64, root=32, stats=True), 128),
    ("sweep+nee+physical", "c", "flux_tpu/ops/pallas_kernel.py:868",
     dict(name="demo3", row0=0, n_rows=300, n_samples=16, root=4, nee=True, physical=True), 600),
    ("sweep+nee+physical+stats", "c", "flux_tpu/ops/pallas_kernel.py:868",
     dict(name="demo3", row0=256, n_rows=64, n_samples=16, root=8, nee=True, physical=True, stats=True), 128),
]
MESH_SCENE_MEASURE = [
    ("sweep+tri+nee+trilight", "flux_tpu/ops/pallas_kernel.py:302",
     dict(accel="sweep", row0=250, n_rows=25, n_samples=64, root=8, plain_rows=4, nee=True), 50),
    ("sweep+tri+nee+trilight+stats", "flux_tpu/ops/pallas_kernel.py:302",
     dict(accel="sweep", row0=256, n_rows=64, n_samples=16, root=4, plain_rows=4, nee=True, stats=True), 128),
]


def mesh_kernel_entries(dev, main_launches: dict, path_launches: dict, checks: dict) -> list:
    """The kernels line's entries of phase 18: launches from the mesh paths
    (a: the main path's 2x1 mesh; c: the progressive and Cornell paths),
    the time, bound and plain version at that path's launch, and 18 b's
    strided, masked checks."""
    entries = []
    for cfg, path, replaces, shape, band in MESH_MEASURE:
        n = main_launches.get(cfg, 0) if path == "a" else path_launches.get(cfg, 0)
        check(n > 0, f"no mesh path launched {cfg}")
        split = launch_plan(band * 800, shape["n_samples"]).split
        m = measure_launch(dev, **shape, row_stride=2, split=split)
        e = kernel_entry(f"sweep_megakernel[{cfg}] on a 2x1 mesh", replaces, n, m)
        e["mesh_checks"] = checks.get(cfg)
        entries.append(e)
    for cfg, replaces, shape, band in MESH_SCENE_MEASURE:
        n = path_launches.get(cfg, 0)
        check(n > 0, f"no mesh path launched {cfg}")
        split = launch_plan(band * 512, shape["n_samples"]).split
        m = measure_scene_launch(dev, stock("demo5"), f"{cfg} on a 2x1 mesh", **shape, row_stride=2, split=split)
        e = kernel_entry(f"scene_megakernel[{cfg}] on a 2x1 mesh", replaces, n, m,
                         source="flux_tpu_torch/csrc/scene_megakernel.cu")
        e.update(plain_shape=m["plain_shape"], mesh_checks=checks.get(cfg))
        entries.append(e)
    return entries


# ---- phase 20: the f64 audit ----------------------------------------------------

# Configuration -> (scene, root); depth 5, seed 0, the scene's full frame,
# NEE and physical transport as the configuration names them.
AUDIT = [
    ("sweep", "demo2", 4), ("sweep+stats", "demo2", 4),
    ("sweep+nee", "demo2", 4), ("sweep+nee+stats", "demo2", 4),
    ("sweep+physical", "demo3", 4), ("sweep+physical+stats", "demo3", 4),
    ("sweep+nee+physical", "demo3", 4), ("sweep+nee+physical+stats", "demo3", 4),
    ("scan", "spheres512", 2), ("scan+stats", "spheres512", 2), ("scan+nee", "spheres512", 2),
    ("sweep+tri", "mesh1280", 2),
    ("sweep+tri+physical", "mesh_ico", 2), ("sweep+tri+physical+stats", "mesh_ico", 2),
    ("sweep+tri+nee+trilight", "demo5", 4), ("sweep+tri+nee+trilight+stats", "demo5", 2),
    ("sweep+tri+nee+trilight+physical", "demo5", 2), ("sweep+tri+nee+trilight+physical+stats", "demo5", 2),
]
AUDIT_DEPTH, AUDIT_SEED = 5, 0
# tests/test_oracle.py's gates on a precision audit.
AUDIT_MEAN_ABS, AUDIT_MEAN_SHIFT = 5e-3, 2e-3


def timed_oracle(dev, sd, root: int, nee: bool, physical: bool) -> tuple:
    """A whole frame's per-sample radiance from the oracle on ``dev``, one
    band; its seconds and its peak device memory (GiB)."""
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    oz = oracle_render(sd, root, AUDIT_DEPTH, seed=AUDIT_SEED, nee=nee, physical=physical, raw_samples=True,
                       rows_per_band=sd.output_settings.image_height, device=dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else None
    return oz, time.perf_counter() - t0, peak


def audit_row(dev, cfg: str, scene: str, root: int, oracles: dict) -> tuple:
    """Gates a-c of phase 20 on one configuration: the name of its entry in
    the kernels line, and its numbers. ``oracles`` keeps the last oracle
    frame, which the next rows of the same scene and estimator share."""
    nee, physical, stats = "+nee" in cfg, "+physical" in cfg, cfg.endswith("+stats")
    sd = scene_by_name(scene)
    r = Renderer(sd, root, AUDIT_DEPTH, seed=AUDIT_SEED, device=dev, nee=nee, physical=physical)
    W, H, spp = r.width, r.height, root * root
    key = (scene, root, nee, physical)
    if key not in oracles:
        oracles.clear()
        oracles[key] = timed_oracle(dev, sd, root, nee, physical)
        fresh = True
    else:
        fresh = False
    oz, oracle_s, peak = oracles[key]

    # a. the kernel, one launch a sample index, against the oracle
    render_block_sweep.launches.clear()
    render_block_scene.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k = torch.stack([r.render_rows_sum_range(0, H, s, 1, with_stats=stats) for s in range(spp)])
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    launches = {**render_block_sweep.launches, **render_block_scene.launches}
    check(launches == {cfg: spp}, f"f64 audit {cfg}: launches {launches}, not {spp} of {cfg}")
    bad = off_oracle(k[..., :3], oz)
    budget = int(0.01 * bad.numel())
    f32, f64 = finalize(k.sum(dim=0)[..., :3], root=root).to(torch.float64), max_to_one(oz.mean(dim=0))
    res = {
        "scene": scene, "frame": f"{W}x{H}", "spp": spp, "samples": bad.numel(), "bad_kernel": int(bad.sum()),
        "nans_kernel": int((~torch.isfinite(k[..., :3])).any(dim=-1).sum()), "budget": budget,
        "frame_mean_abs_diff": float((f32 - f64).abs().mean()), "f32_mean": float(f32.mean()),
        "f64_mean": float(f64.mean()), "oracle_s": oracle_s, "oracle_shared": not fresh,
        "oracle_peak_gib": peak, "kernel_s": kernel_s,
    }

    # b. the plain version on an 8-row band, adjudicated against the kernel
    b0 = 296 if H == 600 else H // 2 - 4
    kw = dict(img_w=W, img_h=H, n_rows=8, n_samples=1, root=root, max_depth=AUDIT_DEPTH, lights=r.lights,
              physical=physical, with_stats=stats)
    if not r.uses_sweep_kernel:
        kw["isect"] = r.isect
    t0 = time.perf_counter()
    plain = torch.stack([render_block(r.scene, r.cam, b0, s, r.seed, **kw) for s in range(spp)])
    torch.cuda.synchronize()
    band = adjudicate(k[:, b0:b0 + 8, :, :3], plain[..., :3], oz[:, b0:b0 + 8])
    names = {"bad_a": "bad_kernel", "bad_b": "bad_plain", "nan_a": "nans_kernel", "nan_b": "nans_plain"}
    res["band"] = {"rows": [b0, b0 + 8], "plain_s": time.perf_counter() - t0,
                   **{names.get(n, n): v for n, v in band.items()}}

    # c. the stats channel: each launch's Σ luminance² is its own sample's,
    # at rtol 1e-6; a luminance² below float32's smallest normal number
    # (1.18e-38: a sample of radiance about 1e-19) is held to that absolute
    # bound, since float32 cannot keep 1e-6 of it
    if stats:
        lum2 = luminance(k[..., :3].to(torch.float64)) ** 2
        k3 = k[..., 3].to(torch.float64)
        tiny = torch.finfo(torch.float32).tiny
        close = torch.isclose(k3, lum2, rtol=1e-6, atol=tiny, equal_nan=True)
        normal = lum2 >= tiny
        res["stats_channel_consistent"] = bool(close.all())
        rel = torch.where(normal, (k3 - lum2).abs() / lum2, 0.0).nan_to_num(0.0)
        res["stats_channel_max_rel_diff"] = float(rel.max())
        res["stats_channel_subnormal"] = int((~normal & (lum2 > 0)).sum())
        if not res["stats_channel_consistent"]:
            at = torch.nonzero(~close)[:5]
            log(f"f64 audit {cfg}: Σ luminance² off at", at.tolist(),
                [(k[tuple(i)].tolist(), float(lum2[tuple(i)])) for i in at])

    log(f"f64 audit {cfg} ({scene} {W}x{H}, {spp} spp, depth 5, seed 0):", json.dumps(res))
    check(res["bad_kernel"] <= budget, f"f64 audit {cfg}: {res['bad_kernel']} samples off the oracle, budget {budget}")
    check(band["ok"] and band["unadjudicated"] == 0, f"f64 audit {cfg}: the band's adjudication failed: {band}")
    if stats:
        check(res["stats_channel_consistent"], f"f64 audit {cfg}: Σ luminance² is not the sample's luminance²")
    if r.uses_sweep_kernel:
        return ("sweep_megakernel" if cfg == "sweep" else f"sweep_megakernel[{cfg}]"), res
    return f"scene_megakernel[{cfg}]", res


def audit_scenes() -> dict:
    """tests/test_oracle.py's adversarial audits as the port's SceneData:
    the Phong exponent 1e5 sphere (24x18, root 8) and two facing mirrors
    walked 16 bounces (16x12, root 4), each in an emissive environment
    sphere, seed 1; the audit's arguments beside each."""
    def scene(shapes, w, h):
        return SceneData(
            scene_name="test", output_settings=OutputSettings(image_width=w, image_height=h, pixel_size=0.5),
            background=(0.0, 0.0, 0.0), shapes=tuple(shapes),
            camera_settings=CameraSettings(eye=(0.0, 1.0, -9.0), look_at=(0.0, 1.0, 0.0), up=(0.0, 1.0, 0.0)),
            camera_data=CameraData(zoom_factor=1.0, view_plane_distance=500.0, focal_distance=10.0, lens_radius=0.0),
        )

    def env(power):
        return SphereData(center=(0.0, 0.0, 0.0), radius=100.0, invert=True,
                          material=MaterialData(kind=MaterialKind.EMISSIVE, color=(1.0, 0.9686, 0.8588), param=power))

    def sphere(center, radius, kind, color, param, exponent=0.0):
        return SphereData(center=center, radius=radius,
                          material=MaterialData(kind=kind, color=color, param=param, exponent=exponent))

    glossy = sphere((0.0, 1.0, 0.0), 1.2, MaterialKind.GLOSSY, (0.9, 0.85, 0.8), 0.9, exponent=1e5)
    mirrors = [sphere((0.0, 1.0, 2.6), 1.0, MaterialKind.REFLECTIVE, (0.97, 0.96, 0.95), 0.95),
               sphere((0.0, 1.0, -2.6), 1.0, MaterialKind.REFLECTIVE, (0.95, 0.96, 0.97), 0.95)]
    return {
        "extreme exponent (Phong 1e5), 24x18": (scene([env(1.0), glossy], 24, 18), 8, 5),
        "two mirrors, depth 16, 16x12": (scene([env(0.8), *mirrors], 16, 12), 4, 16),
    }


def phase_f64_audit(dev, kernels: list) -> dict:
    """Phase 20: every row against the float64 oracle (gates a-c), the
    card's oracle against the CPU's (d), the precision audit through the
    kernels (e) and its CLI (f). Adds each row's numbers to its entry of
    ``kernels`` as ``f64_audit``."""
    t_phase = time.perf_counter()
    by_cfg = {e["name"]: e for e in kernels}
    oracles, rows = {}, {}
    for cfg, scene, root in AUDIT:
        name, rows[cfg] = audit_row(dev, cfg, scene, root, oracles)
        check(name in by_cfg, f"f64 audit: no kernels entry {name}")
        by_cfg[name]["f64_audit"] = rows[cfg]
    oracles.clear()
    oracle_s = sum(row["oracle_s"] for row in rows.values() if not row["oracle_shared"])

    # d. the card's oracle against the CPU's
    for name, nee, physical in (("demo3", True, True), ("demo5", True, False)):
        sd = scene_small(name)
        card, secs, _ = timed_oracle(dev, sd, 2, nee, physical)
        cpu, cpu_s, _ = timed_oracle(torch.device("cpu"), sd, 2, nee, physical)
        oracle_s += secs
        diff = (card.cpu() - cpu).abs()
        over = ~(diff <= 1e-9 * cpu.abs().clamp_min(1.0))
        log(f"f64 audit d, the oracle on the card against the CPU ({name} 80x60, root 2, nee {nee}, physical "
            f"{physical}): max |diff| {float(diff.max()):.3e}, values over 1e-9·max(1, |value|) {int(over.sum())} "
            f"of {over.numel()}, equal bits {float((card.cpu() == cpu).double().mean()):.6f}, card {secs:.2f} s, "
            f"CPU {cpu_s:.2f} s")
        check(bool(torch.isfinite(cpu).all()) and not bool(over.any()),
              f"f64 audit d: the card's oracle differs from the CPU's on {name}")

    # e. the precision audit through the kernels
    cases = {"demo2 800x600, root 4": (stock("demo2"), 4, 5, 0), **{
        label: (sd, root, depth, 1) for label, (sd, root, depth) in audit_scenes().items()}}
    reports = {}
    for label, (sd, root, depth, seed) in cases.items():
        render_block_sweep.launches.clear()
        t0 = time.perf_counter()
        rep = precision_audit(sd, root, depth, seed=seed, device=dev)
        torch.cuda.synchronize()
        reports[label] = rep
        log(f"f64 audit e, precision_audit ({label}, depth {depth}, seed {seed}; {time.perf_counter() - t0:.2f} s, "
            f"launches {json.dumps(dict(render_block_sweep.launches))}):", json.dumps(rep))
        check(render_block_sweep.launches.total() > 0, f"precision_audit ({label}) launched no kernel")
        check(rep["mean_abs_diff"] < AUDIT_MEAN_ABS and abs(rep["f32_mean"] - rep["f64_mean"]) < AUDIT_MEAN_SHIFT,
              f"precision_audit ({label}) misses tests/test_oracle.py's gates: {rep}")

    # f. the CLI, as a user runs it
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "flux_tpu_torch.f64_audit", "scenes/demo2.yml", "--root", "4"],
                          cwd=HERE, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        log(proc.stdout[-4000:], proc.stderr[-8000:])
    check(proc.returncode == 0, f"python -m flux_tpu_torch.f64_audit exited {proc.returncode}")
    cli_rep = json.loads(proc.stdout)
    log(f"f64 audit f, python -m flux_tpu_torch.f64_audit scenes/demo2.yml --root 4 "
        f"({time.perf_counter() - t0:.1f} s with the process's start):", json.dumps(cli_rep))
    want = reports["demo2 800x600, root 4"]
    check(set(cli_rep) == set(want) and all(np.isclose(cli_rep[k], want[k], rtol=1e-9, atol=0) for k in want),
          f"f64_audit's report {cli_rep} is not e's {want}")

    seconds = time.perf_counter() - t_phase
    log(f"f64 audit: {len(rows)} rows, {seconds:.1f} s, of which the oracle on the card {oracle_s:.1f} s "
        f"({oracle_s / seconds:.1%})")
    return {"rows": rows, "audits": reports, "seconds": seconds, "oracle_s": oracle_s}


# ---- phase 21: the scheduler core on the card's host, and scan_carry ----------


def rss_bytes() -> int:
    """This process's resident memory."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def drain_round(force_python: bool, n_units: int, n_threads: int) -> float:
    """One scheduler round of ``n_units`` drained by ``n_threads`` threads
    started together: every unit handed out exactly once, ``missing()``
    empty once every unit is completed, the round closed. Returns the
    drain's wall time over the units, in µs a pull."""
    units = [WorkUnit(row_start=i, row_end=i, job_id=None) for i in range(n_units)]
    rnd = SchedulerRound(units, n_threads, force_python=force_python)
    check(rnd.native is not force_python, "a round on the wrong scheduler core")
    pulled = [[] for _ in range(n_threads)]
    start = threading.Barrier(n_threads + 1)

    def worker(k):
        start.wait()
        while (u := rnd.get()) is not None:
            pulled[k].append(u.row_start)
        rnd.done()

    threads = [threading.Thread(target=worker, args=(k,), daemon=True) for k in range(n_threads)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    released = rnd.wait(120.0)
    seconds = time.perf_counter() - t0
    for t in threads:
        t.join(10)
    check(released and not any(t.is_alive() for t in threads), "a scheduler round's barrier did not release")
    rows = sorted(r for p in pulled for r in p)
    check(rows == list(range(n_units)), "a scheduler round handed a unit out twice, or lost one")
    check(len(rnd.missing()) == n_units, "the ledger holds a unit no one completed")
    for r in rows:
        rnd.complete_row(r)
    check(rnd.missing() == [], "units missing after every unit was completed")
    rnd.close()
    return seconds * 1e6 / n_units


def phase_scheduler_core(card: str) -> dict:
    """Phase 21 b: on each core, three rounds of 100,000 units drained by 8
    threads (µs a pull, their median), and three by one thread; then the
    native handle's lifetime:
    1,000 rounds of 100,000 units created and closed leave the process's
    resident memory where it was (under 4 MiB of growth, where a handle
    not freed would leave its 100,000-byte ledger: 95 MiB), and 1,000
    left open, the control, grow it by at least half their 95.4 MiB (freed
    memory the process already holds takes up some of theirs)."""
    check(native_sched_available(), "the native scheduler core did not load")
    res = {"units": 100_000, "threads": 8}
    for core, force in (("native", False), ("python", True)):
        runs = [drain_round(force, 100_000, 8) for _ in range(3)]
        res[f"{core}_us_per_pull"] = float(np.median(runs))
        res[f"{core}_us_per_pull_runs"] = runs
        # One thread: the pull's own cost, without the threads' contention.
        res[f"{core}_us_per_pull_one_thread"] = float(np.median([drain_round(force, 100_000, 1) for _ in range(3)]))
    lib = native.get_lib()
    sched._register(lib)  # the round's own core, without a 100,000-unit list each time
    rss0 = rss_bytes()
    for _ in range(1000):
        sched._NativeCore(lib, 100_000, 8).close()
    rss1 = rss_bytes()
    open_cores = [sched._NativeCore(lib, 100_000, 8) for _ in range(1000)]
    grown = rss_bytes() - rss1
    for core in open_cores:
        core.close()
    res.update(rss_growth_of_1000_closed_rounds_mib=(rss1 - rss0) / 2**20,
               rss_growth_of_1000_open_rounds_mib=grown / 2**20)
    log(f"scheduler core on the host of {card}:", json.dumps(res))
    check(rss1 - rss0 < 4 * 2**20, "1,000 closed rounds left memory behind")
    check(grown >= 48 * 2**20, "1,000 open rounds (95.4 MiB of ledgers) grew the resident memory by less than "
          "half of that: the check could not see a leak")
    return res


def hits_equal(a, b) -> bool:
    """Two hit records bit for bit, every field."""
    fields = lambda h: (h.mask, h.t, h.shape, h.kind, h.exponent, *h.point, *h.normal, *h.albedo)
    return all(torch.equal(x, y) if not x.is_floating_point() else bits_equal(x, y)
               for x, y in zip(fields(a), fields(b)))


def phase_scan_carry(dev) -> dict:
    """Phase 21 c: ``Intersector(mode="scan_carry")`` on spheres512 (513
    spheres) against ``mode="scan"`` bit for bit, on the card: 4,096 camera
    rays (the frame's middle 64x64 pixels) and 4,096 rays leaving the
    surfaces they hit (``prev`` set, random directions), hit records and
    any-hit masks; then a 50-row band at root 8 through the scene
    megakernel with the scan_carry intersector, counted as one ``scan``
    launch and equal to the scan intersector's launch bit for bit."""
    sd = stock("spheres512")
    sc, cam, isect, _, w, h = scene_setup(dev, sd, "scan", False)
    carry = replace(isect, mode="scan_carry")
    check(sc.num_spheres == 513 and carry.scans, "spheres512 is not 513 spheres, or scan_carry does not scan")
    rows = torch.arange(h // 2 - 32, h // 2 + 32, device=dev).repeat_interleave(64)
    cols = torch.arange(w // 2 - 32, w // 2 + 32, device=dev).repeat(64)
    half = torch.full(rows.shape, 0.5, device=dev)
    o, d = primary_rays(cam, rows, cols, w, h, half, half, torch.zeros_like(half), torch.zeros_like(half))
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    hit = carry(sc, o, d)
    check(hits_equal(hit, isect(sc, o, d)), "scan_carry's hit record differs from the scan's on camera rays")
    on = (hit.mask & (hit.kind != MaterialKind.EMISSIVE)).nonzero().flatten()
    check(len(on) > 0, "no camera ray hit a surface")
    idx = on[torch.arange(4096, device=dev) % len(on)]
    po = Vec3(*(c[idx] for c in hit.point))
    raw = torch.randn((3, 4096), generator=gen, device=dev)
    raw = raw / raw.norm(dim=0)
    pd = Vec3(raw[0], raw[1], raw[2])
    prev = hit.shape[idx]
    leaving = carry(sc, po, pd, prev=prev)
    check(hits_equal(leaving, isect(sc, po, pd, prev=prev)), "scan_carry's hit record differs on leaving rays")
    t_max = torch.rand(4096, generator=gen, device=dev) * 29.5 + 0.5
    excl = torch.zeros(4096, dtype=torch.int32, device=dev)
    occ = carry.occluded(sc, po, pd, t_max, excl, origin_idx=prev)
    check(torch.equal(occ, isect.occluded(sc, po, pd, t_max, excl, origin_idx=prev)),
          "scan_carry's any-hit mask differs from the scan's")
    rays_s = time.perf_counter() - t0
    row0 = h // 2 - 25
    kw = dict(img_w=w, img_h=h, n_rows=50, n_samples=64, root=8, max_depth=5)
    band, launches, secs = run_path("21 c spheres512 50-row band, root 8, through scan_carry",
                                    lambda: render_block_scene(sc, cam, row0, 0, 0, isect=carry, **kw))
    check(launches == {"scan": 1}, f"the scan_carry band launched {launches}, not one scan")
    ref = render_block_scene(sc, cam, row0, 0, 0, isect=isect, **kw)
    check(bits_equal(band, ref), "the scan_carry band differs from the scan band")
    check(bool(torch.isfinite(band).any()) and float(band.max()) > 0, "the scan_carry band is empty")
    res = {"camera_rays": 4096, "camera_hits": int(hit.mask.sum()), "leaving_rays": 4096,
           "leaving_hits": int(leaving.mask.sum()), "occluded": int(occ.sum()), "rays_seconds": rays_s,
           "hits_and_masks_bitwise_equal": True, "band_launches": launches, "band_seconds": secs,
           "band_bitwise_equal": True}
    log("scan_carry on spheres512:", json.dumps(res))
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke test of flux_tpu_torch on one CUDA card.")
    ap.add_argument("--parent", help="root of another checkout (say the parent commit's, unpacked by git "
                    "archive): phase 2 builds its kernel sources beside the current ones, and phase 16 times "
                    "every row through both packages on the same launches, bitwise")
    ap.add_argument("--mesh-rank", type=int, help=argparse.SUPPRESS)  # phase 18 d's processes
    ap.add_argument("--mesh-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    # 1. probe
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.mesh_rank is not None:
        return mesh_rank(args.mesh_rank, args.mesh_port, args.mesh_out)
    dev = torch.device("cuda")
    card = smi()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    # 2. build: one nvcc per source, per design variant of phase 15 and per
    # source of the parent's package, all started together
    t0 = time.perf_counter()
    parent = load_parent(args.parent) if args.parent else None
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        parent_built = None if parent is None else pool.submit(parent.ops.build.build_many,
                                                               list(parent.ops.build.LIBRARIES))
        variants = start_variant_builds(parent)
        native_built = pool.submit(native.get_lib)
        build.build_many(list(build.LIBRARIES))
        check(native_built.result() is not None, f"the native host code did not build: {native.load_error}")
        check(native_sched_available(), "the native scheduler core did not load")
        if parent_built is not None:
            parent_built.result()
            for name, info in parent.ops.build.BUILD_LOG.items():
                log(f"build: the parent's {name} in {info['seconds']:.1f} s:",
                    json.dumps(ptxas_rows(info["ptxas"], name)))
        built_variants = finish_variant_builds(variants, parent)
    log(f"build: {len(build.LIBRARIES)} libraries in {time.perf_counter() - t0:.1f} s of wall time")
    for name in build.LIBRARIES:
        info = build.BUILD_LOG[name]
        log(f"build: {name} in {info['seconds']:.1f} s")
        log(info["ptxas"].strip())
    log(f"build: with {len(variants)} design variants, {time.perf_counter() - t0:.1f} s of wall time")
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
    with phase_timer("10 scene kernel vs plain, skip on and off, scan vs sweep, past the sweep's caps"):
        for cfg in SCENE_CONFIGS:
            phase_scene_kernel_vs_plain(dev, *cfg)
        phase_scan_equals_sweep(dev)
        phase_past_the_caps(dev)
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
            entry.update(plain_shape=m["plain_shape"], timed_options_ms=m["timed_options_ms"],
                         bound_ms_separate_folds=m["bound_ms_separate_folds"])
            if cfg == "scan":
                entry["sphere_field_16384_band"] = big
            kernels.append(entry)
    with phase_timer("14 design checks"):
        phase_design(dev)
    with phase_timer("15 the triangle fold, step by step"):
        phase_tri_steps(dev, built_variants)
    if parent is not None:
        with phase_timer("16 against the parent's build"), tempfile.TemporaryDirectory() as tmp:
            parent_rows(dev, parent)
            parent_job_path(parent, tmp)
    with phase_timer("17 the job path"), tempfile.TemporaryDirectory() as tmp:
        job, want17 = phase_job_path(dev, tmp, card)
    kernels[0]["job_path_launches"] = job["a. demo2 800x600 root 128 depth 5 -R 50, local worker"]["launches"].get("sweep", 0)
    # 18: the device mesh, on the card repeated
    with tempfile.TemporaryDirectory() as tmp:
        with phase_timer("18 a the mesh's main path"):
            mesh_main = phase_mesh_main_path(dev, tmp, card, want17)
        with phase_timer("18 b mesh launches vs plain"):
            mesh_checks = phase_mesh_launches(dev)
        with phase_timer("18 c the mesh's progressive and Cornell box paths"):
            mesh_paths = phase_mesh_progressive(dev, tmp, paths["mis"]["mse_16spp_vs_1024spp"])
        with phase_timer("18 d two processes"):
            phase_mesh_two_processes(tmp, mesh_main["frames"], card)
        with phase_timer("18 e the node's -t and sampler_debug"):
            phase_mesh_node_and_sampler(dev, tmp, want17)
        with phase_timer("18 f the mesh launches measured"):
            kernels += mesh_kernel_entries(dev, mesh_main["result"]["meshes"]["2x1"]["launches"],
                                           mesh_paths["launches"], mesh_checks)
    with phase_timer("20 the f64 audit"):
        phase_f64_audit(dev, kernels)
    with phase_timer("21 b the scheduler core"):
        phase_scheduler_core(card)
    with phase_timer("21 c scan_carry"):
        carried = phase_scan_carry(dev)
    scan_entry = next(k for k in kernels if k["name"] == "scene_megakernel[scan]")
    scan_entry["scan_carry_launches"] = carried["band_launches"]["scan"]
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
