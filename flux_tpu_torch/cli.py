"""flux_tpu_torch command line: render a scene file to ``<scene_name>.ppm``.

The local-render subset of ``flux_tpu/cli.py`` (whose flags mirror the
reference's flux/src/main.rs:126-205): positional scene file, ``-r/--root``
(sample root, default 1), ``-d/--depth`` (default 5), ``-R/--rows`` (rows
per band, default 50), ``--seed``, ``--output-dir``, ``--png``, the
estimator flags ``--nee`` and ``--physical``, the progressive flags
``--progressive SPP``, ``--checkpoint PATH``, ``--adaptive TOL`` and
``--resume``, ``--accel`` (``sweep`` or ``scan``; by default the scan above
64 spheres) and ``--device`` (``cuda`` by default; ``cpu`` runs the plain
PyTorch version). Row bands render one after another through the port's
``Renderer``; on the card each band is one launch of a megakernel (the
sweep megakernel, or the scene megakernel for the scan and for triangles).
The job, manager, worker and node path, the live preview and multi-device
rendering are not ported yet (ROADMAP.md).

Run: ``python -m flux_tpu_torch.cli scenes/demo2.yml -r 128 -d 5``, or
``python -m flux_tpu_torch.cli scenes/demo3.yml -r 32 -d 5 --nee --physical
--progressive 64 --checkpoint demo3.ckpt.npz``, or
``python -m flux_tpu_torch.cli scenes/spheres512.yml -r 8 -d 5`` (the scan),
``python -m flux_tpu_torch.cli scenes/demo5.yml -r 32 -d 5 --nee`` (a mesh
with a triangle light)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .image import Image, write_png, write_ppm
from .render import Renderer
from .scene import load_scene

DEFAULT_SAMPLE_ROOT = 1
DEFAULT_DEPTH = 5
DEFAULT_ROWS_PER_UNIT = 50


def _pos_int(v):
    n = int(v)
    if n < 1:
        raise argparse.ArgumentTypeError("must be >= 1")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="flux-tpu-torch", description="Monte Carlo path tracer on PyTorch and CUDA"
    )
    p.add_argument("scene_file", help="YAML scene file")
    p.add_argument("-r", "--root", type=_pos_int, default=DEFAULT_SAMPLE_ROOT, help="sample root")
    p.add_argument("-d", "--depth", type=_pos_int, default=DEFAULT_DEPTH, help="maximum trace depth")
    p.add_argument(
        "-R", "--rows", type=_pos_int, default=DEFAULT_ROWS_PER_UNIT, help="rows per band"
    )
    p.add_argument("--seed", type=int, default=0, help="RNG seed (renders are deterministic)")
    p.add_argument("--output-dir", default=".", help="directory for output images")
    p.add_argument("--png", action="store_true", help="also write a PNG next to the PPM")
    p.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="cuda (default) runs the megakernels; cpu their plain PyTorch version",
    )
    p.add_argument(
        "--accel",
        choices=("sweep", "scan"),
        default=None,
        help="sphere intersection: sweep (every sphere; at most 64) or scan (Morton-sorted "
        "blocks with an AABB skip; any number). Default: scan above 64 spheres",
    )
    p.add_argument(
        "--nee",
        action="store_true",
        help="next-event estimation: sample the sphere and triangle lights directly with shadow rays "
        "at diffuse vertices",
    )
    p.add_argument(
        "--physical",
        action="store_true",
        help="physical transport: cosine-weighted matte and normalized-Phong glossy; "
        "with --nee, multiple importance sampling at matte and glossy vertices",
    )
    p.add_argument(
        "--progressive",
        type=_pos_int,
        metavar="SPP",
        default=0,
        help="render the whole frame in passes of SPP samples",
    )
    p.add_argument(
        "--checkpoint",
        metavar="PATH",
        default=None,
        help="with --progressive: save a resumable checkpoint after each pass",
    )
    p.add_argument(
        "--adaptive",
        type=float,
        metavar="TOL",
        default=0.0,
        help="with --progressive: stop once the p99 relative standard error of the "
        "pixel means drops below TOL",
    )
    p.add_argument(
        "--resume",
        action="store_true",
        help="with --checkpoint: resume from the checkpoint if it exists",
    )
    return p


def run_progressive(args, scene, renderer) -> dict:
    """The --progressive path on one device: passes of ``args.progressive``
    samples over the whole frame, a checkpoint after each pass, an early
    stop once the noise target is met. Prints the status lines of
    ``flux_tpu.cli.run_progressive``; returns the output path, the pass
    loop's seconds, the samples rendered in this run, the samples done and
    the last p99 relative standard error."""
    from .checkpoint import ProgressiveRenderer

    pr = ProgressiveRenderer.from_renderer(renderer)
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        pr.resume(args.checkpoint)
        print(f"resumed at {pr.samples_done}/{pr.spp} spp from {args.checkpoint}")
    start = pr.samples_done
    err = None
    t0 = time.perf_counter()
    while not pr.complete:
        pr.render_pass(args.progressive)
        done = pr.samples_done
        rate = (done - start) * pr.width * pr.height / max(time.perf_counter() - t0, 1e-9) / 1e6
        err = pr.max_rel_stderr()
        err_s = f", p99 rel stderr {err:.4f}" if err is not None else ""
        print(f"pass done: {done}/{pr.spp} spp ({rate:.1f} Msamples/s{err_s})")
        if args.checkpoint:
            pr.save(args.checkpoint)
        if args.adaptive > 0 and err is not None and err < args.adaptive:
            print(f"adaptive stop: noise target {args.adaptive} reached at {done}/{pr.spp} spp")
            break
    seconds = time.perf_counter() - t0
    img = pr.peek()
    out = os.path.join(args.output_dir, f"{scene.scene_name}.ppm")
    write_ppm(out, img)
    print(f"Wrote {out}")
    if args.png:
        write_png(out.rsplit(".", 1)[0] + ".png", img)
    return {
        "out": out,
        "band_seconds": seconds,
        "samples": (pr.samples_done - start) * pr.width * pr.height,
        "spp_done": pr.samples_done,
        "p99_rel_stderr": err,
    }


def run(argv=None) -> dict:
    """Everything ``main`` does; returns the output path, the seconds of the
    band loop (the renders, without scene load and image writing) and the
    number of samples rendered (and, with --progressive, the samples per
    pixel done and the last p99 relative standard error)."""
    args = build_parser().parse_args(argv)
    scene = load_scene(args.scene_file)
    renderer = Renderer(
        scene, args.root, args.depth, seed=args.seed, device=args.device, accel=args.accel,
        nee=args.nee, physical=args.physical,
    )
    if args.progressive:
        return run_progressive(args, scene, renderer)
    img = Image(renderer.width, renderer.height)
    t0 = time.perf_counter()
    for row0 in range(0, renderer.height, args.rows):
        n = min(args.rows, renderer.height - row0)
        img.set_rows(row0, renderer.render_rows(row0, n))
    seconds = time.perf_counter() - t0
    out = os.path.join(args.output_dir, f"{scene.scene_name}.ppm")
    write_ppm(out, img)
    if args.png:
        write_png(out.rsplit(".", 1)[0] + ".png", img)
    samples = renderer.width * renderer.height * renderer.root**2
    print(
        f"rendered {scene.scene_name} {renderer.width}x{renderer.height} at "
        f"{renderer.root**2} spp, depth {renderer.max_depth}, on {renderer.device}: "
        f"{seconds:.3f} s, {samples / seconds / 1e6:.1f} Msamples/s -> {out}",
        file=sys.stderr,
    )
    return {"out": out, "band_seconds": seconds, "samples": samples}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
