"""Warm-process perf harness of the port: repeated whole frames in one
process, min and median wall time, for A/B work on the card (the JAX
package's ``perf.py``). Not the bench: ``flux_tpu_torch.bench`` is.

Run: ``python -m flux_tpu_torch.perf [--root 128] [--reps 5] [--nee]
[--scene PATH | --field N | --mesh-tris N]``. Each frame is one band of the
frame's height after a warm-up band; prints one JSON line with
``wall_min_s``, ``wall_med_s``, ``msamples_per_s_best``,
``msamples_per_s_med``, ``times``, a ``checksum`` (the last frame's mean)
and ``card``. ``--s-blk`` and ``--early-exit`` are the TPU megakernel's tile
height and early-exit form; the port has neither, and asking for them
raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import genscene, meshgen
from .bench import REPO, card_name
from .render import Renderer, resolve_device
from .scene import load_scene


def scene_for(args):
    """The workload: a procedural sphere field, a procedural triangle mesh,
    or a scene file (demo2 by default)."""
    if args.field is not None:
        return genscene.sphere_field(
            args.field, seed=args.field_seed, width=args.width or 400, height=args.height or 300,
            spread=14.0 * (args.field / 512.0) ** 0.5,
        )
    if args.mesh_tris is not None:
        subdiv = max(1, int(np.ceil(np.log(args.mesh_tris / 20) / np.log(4))))
        return meshgen.mesh_scene(*meshgen.icosphere(subdiv), width=args.width or 400,
                                  height=args.height or 300)  # 20·4^subdiv triangles
    return load_scene(args.scene or str(REPO / "scenes" / "demo2.yml"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m flux_tpu_torch.perf", description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=int, default=128)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--nee", action="store_true")
    ap.add_argument("--scene", default=None)
    ap.add_argument("--field", type=int, default=None, help="procedural sphere_field(N) workload instead of --scene")
    ap.add_argument("--field-seed", type=int, default=1)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--mesh-tris", type=int, default=None, help="procedural triangle-mesh workload with ~N triangles")
    ap.add_argument("--accel", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu, the plain PyTorch version")
    ap.add_argument("--s-blk", type=int, default=None, help="not ported (the TPU megakernel's tile height)")
    ap.add_argument("--early-exit", default=None, help="not ported (the TPU megakernel's early-exit form)")
    args = ap.parse_args(argv)
    for flag, value in (("--s-blk", args.s_blk), ("--early-exit", args.early_exit)):
        if value is not None:
            raise NotImplementedError(
                f"{flag} sets a TPU workaround of the Pallas megakernel, which the port does not "
                "carry over (ROADMAP.md, North star and A6)")
    dev = resolve_device(args.device)
    sd = scene_for(args)
    w, h = sd.output_settings.image_width, sd.output_settings.image_height
    r = Renderer(sd, args.root, args.depth, seed=0, device=dev, nee=args.nee, accel=args.accel)
    r.render_rows(0, h)  # loads the kernel, warms the card
    times, img = [], None
    for _ in range(args.reps):
        t0 = time.perf_counter()
        img = r.render_image(rows_per_band=h)  # numpy: the card has finished the frame
        times.append(time.perf_counter() - t0)
    samples = w * h * args.root * args.root
    best, med = min(times), sorted(times)[len(times) // 2]
    print(json.dumps({
        "wall_min_s": best,
        "wall_med_s": med,
        "msamples_per_s_best": samples / best / 1e6,
        "msamples_per_s_med": samples / med / 1e6,
        "times": times,
        "checksum": float(np.asarray(img, np.float64).mean()),
        "card": card_name(dev),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
