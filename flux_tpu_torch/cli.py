"""flux_tpu_torch master CLI — the ``flux`` binary's counterpart
(``flux_tpu/cli.py``).

Flags mirror the reference's flux/src/main.rs:126-205: positional scene
file, ``-n/--node`` (repeatable), ``-d/--depth`` (default 5), ``-R/--rows``
(rows per work unit, default 50), ``-L/--no-local``, ``-g/--preview``,
``-r/--root`` (default 1). As in ``flux_tpu``: ``--seed``, ``--output-dir``,
``--png``, ``--verbose``, ``--profile-dir`` (a ``torch.profiler`` trace of
the render), the estimator flags ``--nee`` and ``--physical``, the
progressive flags ``--progressive SPP``, ``--checkpoint PATH``,
``--adaptive TOL`` and ``--resume``, and ``--accel`` (``sweep`` or
``scan``; by default the scan above 64 spheres). ``--device`` (``cuda`` by
default; ``cpu`` runs the plain PyTorch version) is the local worker's;
``-t/--devices`` takes that many of its cards (default: all; with the CPU,
that many shards of it) and ``--rows-shards`` the mesh's row shards, as in
``flux_tpu``.

A render is a job: ``main`` → ``RenderManager`` → a ``LocalWorker`` on this
process's device and a ``NetworkWorker`` per ``-n`` (render nodes of either
package), which pull work units of ``-R`` rows; on the card each unit is
one launch of a megakernel (the sweep megakernel, or the scene megakernel
for the scan and for triangles), or with several devices one launch per
slot of a device mesh (``parallel/``). ``--progressive`` renders on the
local devices in passes instead, by default row-sharded over them.

Run: ``python -m flux_tpu_torch.cli scenes/demo2.yml -r 128 -d 5``, or
``python -m flux_tpu_torch.cli scenes/demo3.yml -r 32 -d 5 --nee --physical
--progressive 64 --checkpoint demo3.ckpt.npz``, or
``python -m flux_tpu_torch.cli scenes/spheres512.yml -r 8 -d 5`` (the scan),
``python -m flux_tpu_torch.cli scenes/demo5.yml -r 32 -d 5 --nee`` (a mesh
with a triangle light), or against a node
(``python -m flux_tpu_torch.node -p 2099``):
``python -m flux_tpu_torch.cli scenes/demo2.yml -r 8 -n localhost:2099 -L``
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .debug import set_debug
from .image import write_png, write_ppm
from .job import JobConfiguration
from .manager import ImageBuilder, JobFailed, MultiSink, RenderManager
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
    p.add_argument(
        "-n",
        "--node",
        action="append",
        default=[],
        metavar="ADDR[:PORT]",
        help="render node to connect to (repeatable)",
    )
    p.add_argument(
        "-L", "--no-local", action="store_true", help="do not use a local render worker"
    )
    p.add_argument(
        "-g", "--preview", action="store_true",
        help="live preview: in the terminal, and a <scene>-preview.png refreshed as rows land",
    )
    p.add_argument("-r", "--root", type=_pos_int, default=DEFAULT_SAMPLE_ROOT, help="sample root")
    p.add_argument("-d", "--depth", type=_pos_int, default=DEFAULT_DEPTH, help="maximum trace depth")
    p.add_argument(
        "-R", "--rows", type=_pos_int, default=DEFAULT_ROWS_PER_UNIT, help="rows per work unit"
    )
    p.add_argument("--seed", type=int, default=0, help="RNG seed (renders are deterministic)")
    p.add_argument("--output-dir", default=".", help="directory for output images")
    p.add_argument("--png", action="store_true", help="also write a PNG next to the PPM")
    p.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="the local worker's device: cuda (default) runs the megakernels; cpu their plain "
        "PyTorch version",
    )
    p.add_argument(
        "-t",
        "--devices",
        type=int,
        default=None,
        help="number of local devices to use (default: all); with --device cpu, that many CPU shards",
    )
    p.add_argument(
        "--rows-shards",
        type=int,
        default=None,
        help="tile-sharding factor of the local device mesh; the rest goes "
        "to sample sharding (default: auto — sample-only at demo scale, "
        "row sharding engages on memory-bound tall frames)",
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
    p.add_argument("--verbose", action="store_true", help="enable debug tracing")
    p.add_argument(
        "--profile-dir",
        default=None,
        help="capture a torch.profiler trace of the render (Chrome trace JSON) into this directory",
    )
    return p


def run_progressive(args, scene) -> dict:
    """The --progressive path on the local devices: passes of
    ``args.progressive`` samples over the whole frame, a checkpoint after
    each pass, an early stop once the noise target is met, and with
    ``-g`` the preview after each pass. Prints the status lines of
    ``flux_tpu.cli.run_progressive``; returns the output path, the pass
    loop's seconds, the samples rendered in this run, the samples done and
    the last p99 relative standard error."""
    from .checkpoint import ProgressiveRenderer
    from .parallel import MeshRenderer, local_devices, make_mesh
    from .termview import TermPreview

    devices = local_devices(args.device, args.devices)
    if len(devices) > 1:
        # Rows-only sharding by default: every pixel's samples are summed
        # on one device in the single-device order, so the accumulators,
        # checkpoints and adaptive stops are bit-identical to one device's.
        # An explicit --rows-shards buys an spp axis for whoever wants it.
        rows_shards, spp_shards = (len(devices), 1) if args.rows_shards is None else (args.rows_shards, None)
        renderer = MeshRenderer(
            scene, args.root, args.depth, seed=args.seed,
            mesh=make_mesh(devices, rows_shards=rows_shards, spp_shards=spp_shards), accel=args.accel,
            nee=args.nee, physical=args.physical,
        )
    else:
        renderer = Renderer(
            scene, args.root, args.depth, seed=args.seed, device=devices[0], accel=args.accel,
            nee=args.nee, physical=args.physical,
        )
    pr = ProgressiveRenderer.from_renderer(renderer)
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        pr.resume(args.checkpoint)
        print(f"resumed at {pr.samples_done}/{pr.spp} spp from {args.checkpoint}")
    start = pr.samples_done
    err = None
    preview_path = os.path.join(args.output_dir, f"{scene.scene_name}-preview.png")
    term = TermPreview() if args.preview else None
    t0 = time.perf_counter()
    while not pr.complete:
        pr.render_pass(args.progressive)
        done = pr.samples_done
        rate = (done - start) * pr.width * pr.height / max(time.perf_counter() - t0, 1e-9) / 1e6
        err = pr.max_rel_stderr()
        err_s = f", p99 rel stderr {err:.4f}" if err is not None else ""
        status = f"pass done: {done}/{pr.spp} spp ({rate:.1f} Msamples/s{err_s})"
        if term is not None:
            peek = pr.peek()
            write_png(preview_path, peek)
            # The status rides the redraw: a print() between updates would
            # break the cursor-up rewind.
            term.update(peek, status=status)
        if term is None or term.mode is None:
            print(status)
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


def make_local_worker(args, scene):
    """A LocalWorker on ``-t`` devices of ``--device`` (resolved here: it
    raises without a card unless the CPU is named), whose factory builds
    the port's Renderer, or with several devices a MeshRenderer over one
    mesh for every job (``--rows-shards``, or a shape picked from the
    scene's frame), with the job's configuration and ``--accel``."""
    from .parallel import MeshRenderer, local_devices, make_mesh
    from .workers import LocalWorker, default_renderer_factory

    devices = local_devices(args.device, args.devices)
    if len(devices) > 1:
        out = scene.output_settings
        mesh = make_mesh(devices, rows_shards=args.rows_shards, n_rows_hint=out.image_height,
                         n_cols_hint=out.image_width)

        def factory(job):
            return MeshRenderer(
                job.scene_data, job.config.sample_root, job.config.max_trace_depth, seed=job.config.seed,
                mesh=mesh, accel=args.accel, nee=job.config.nee, physical=job.config.physical,
            )
    else:
        def factory(job):
            return default_renderer_factory(job, device=devices[0], accel=args.accel)

    return LocalWorker(renderer_factory=factory, devices=devices)


class FailureLog:
    """Event sink that keeps and prints each JobFailed: a worker's failure
    is shown even when a retry round saves the job."""

    def __init__(self):
        self.reasons = []

    def put(self, ev) -> None:
        if isinstance(ev, JobFailed):
            self.reasons.append(ev.reason)
            print(f"worker failed: {ev.reason}", file=sys.stderr)


def _preview_loop(args, scene, manager, builder, sink, job, jobcfg):
    """Progressive preview with the reference's interactive controls
    (flux/src/main.rs:288-316): on a TTY, ``+``/``-`` re-submit the job at
    sample_root ± 1 and ``q`` cancels; headless it streams progress. The
    preview is drawn in the terminal (``termview.py``) and written as a
    PNG as rows land. Returns the handle of the job that finished."""
    import select
    from dataclasses import replace as dc_replace

    from .termview import TermPreview

    preview_path = os.path.join(args.output_dir, f"{scene.scene_name}-preview.png")
    interactive = sys.stdin.isatty()
    if interactive:
        print("preview controls: '+' more samples, '-' fewer, 'q' cancel")
    term = TermPreview()
    last = -1.0
    while True:
        if job.wait(timeout=0.5):
            break
        img = builder.get_image()
        if img is not None:
            done = float(img.filled_rows.mean())
            if done != last:
                write_png(preview_path, img)
                term.update(img.pixels)
                if term.mode is None:
                    print(f"preview: {done * 100:.0f}% rows done -> {preview_path}")
                last = done
        if interactive:
            ready, _, _ = select.select([sys.stdin], [], [], 0)
            if not ready:
                continue
            key = sys.stdin.readline().strip()
            if key == "q":
                print("cancelling")
                job.cancel()
                job.wait(timeout=60)
                break
            if key in ("+", "-"):
                new_root = jobcfg.sample_root + (1 if key == "+" else -1)
                if new_root < 1:
                    continue
                print(f"re-rendering at sample root {new_root}")
                job.cancel()
                job.wait(timeout=60)
                jobcfg = dc_replace(jobcfg, sample_root=new_root)
                job = manager.schedule_job(scene, jobcfg, sink)
                last = -1.0
    # Always leave the finished frame behind: a job that ends inside the
    # first wait breaks the loop before any refresh. The job's handle is
    # done before the builder has taken its last rows off its queue: wait
    # for the builder (the manager sends RenderingFinished after the rows,
    # a cancelled job too).
    builder.wait_finished(timeout=60)
    img = builder.get_image()
    if img is not None:
        write_png(preview_path, img)
        term.update(img.pixels)
    return job


def _run_job_path(args, scene) -> dict:
    if args.progressive:
        return run_progressive(args, scene)
    none = {"out": None, "band_seconds": 0.0, "samples": 0}
    if args.no_local and not args.node:
        print("No workers specified, exiting")
        return {**none, "error": None}

    from .workers import NetworkWorker

    workers = []
    if not args.no_local:
        w = make_local_worker(args, scene)
        info = w.info()
        print(f"Local worker ready, info:\nDevices: {info.num_devices} ({info.platform})")
        workers.append(w)
    try:
        for endpoint in args.node:
            print(f"Connecting to {endpoint}")
            try:
                w = NetworkWorker(endpoint)
            except (OSError, RuntimeError) as e:
                print(f"Could not connect network node '{endpoint}': {e}")
                return {**none, "error": f"could not connect {endpoint}: {e}"}
            info = w.info()
            print(f"Network worker ready, info:\nDevices: {info.num_devices} ({info.platform})")
            workers.append(w)

        print("Starting rendering manager")
        manager = RenderManager([w.handle() for w in workers])
        jobcfg = JobConfiguration(
            sample_root=args.root,
            max_trace_depth=args.depth,
            rows_per_work_unit=args.rows,
            seed=args.seed,
            nee=args.nee,
            physical=args.physical,
        )
        builder = ImageBuilder(output_dir=args.output_dir, write_png_too=args.png)
        failures = FailureLog()
        print("Sending job to rendering manager")
        t0 = time.perf_counter()
        sink = MultiSink([builder.sender(), failures])
        job = manager.schedule_job(scene, jobcfg, sink)
        if args.preview:
            # The loop may have re-submitted the job (+/- re-render); status
            # comes from the handle that finished.
            job = _preview_loop(args, scene, manager, builder, sink, job, jobcfg)
        else:
            job.wait()
        seconds = time.perf_counter() - t0
        if job.error:
            print(f"render failed: {job.error}", file=sys.stderr)
        builder.wait_finished(timeout=60)
        if builder.last_path:
            print(f"Wrote {builder.last_path}")
        print("Shutting down")
        builder.stop()
        manager.stop()
    finally:
        for w in workers:
            w.stop()
    out = scene.output_settings
    samples = out.image_width * out.image_height * args.root**2
    print(
        f"rendered {scene.scene_name} {out.image_width}x{out.image_height} at {args.root**2} spp, "
        f"depth {args.depth}, by {len(workers)} worker(s): {seconds:.3f} s, "
        f"{samples / seconds / 1e6:.1f} Msamples/s -> {builder.last_path}",
        file=sys.stderr,
    )
    return {
        "out": builder.last_path,
        "band_seconds": seconds,
        "samples": samples,
        "error": job.error,
        "retry_rounds": job.retry_rounds,
        "retried_units": job.retried_units,
        "worker_failures": failures.reasons,
        "units_by_worker": {w.handle().name: w.units_done for w in workers},
    }


def run(argv=None) -> dict:
    """Everything ``main`` does; returns the output path, the seconds from
    scheduling the job to its end (``band_seconds``; with --progressive the
    pass loop's) and the number of samples rendered. The job path also
    returns the job's ``error`` (None when it succeeded), its retry rounds
    and retried units, the reasons of the JobFailed events, and the units
    each worker rendered; with --progressive, the samples per pixel done
    and the last p99 relative standard error; with --profile-dir, the
    trace's path (``trace``)."""
    args = build_parser().parse_args(argv)
    if args.verbose:
        set_debug(True)
    scene = load_scene(args.scene_file)
    if args.profile_dir:
        from .metrics import profile_trace

        with profile_trace(args.profile_dir) as prof:
            ran = _run_job_path(args, scene)
        return {**ran, "trace": prof.trace_path}
    return _run_job_path(args, scene)


def main(argv=None) -> int:
    return 1 if run(argv).get("error") else 0


if __name__ == "__main__":
    sys.exit(main())
