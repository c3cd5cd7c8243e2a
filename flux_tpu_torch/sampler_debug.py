"""sampler-debug: plots of every sampling strategy (``flux_tpu/
sampler_debug.py``; the reference's sampler-debug/src/main.rs).

For each strategy (regular, jittered, multi-jittered, correlated
multi-jittered) it writes a 100×100 PPM scatter of the unit square and one
of the cos-weighted hemisphere warp (x and y position, z in the red
channel), named as the reference names them,
``sampler-debug-{r,j,mj,cmj}[-hemi].ppm`` (main.rs:31,41). The points are
drawn on ``--device`` (the CUDA card unless ``cpu``); the files are
byte-equal to ``flux_tpu``'s.

Run: ``python -m flux_tpu_torch.sampler_debug -r 10``
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .image import Image, write_ppm
from .render import resolve_device
from .samplers import Sampler, grid_regular, to_hemisphere

SIZE = 100


def plot_2d(points: np.ndarray) -> Image:
    """Unit-square scatter (main.rs:12-16): red-ish dots."""
    img = Image(SIZE, SIZE)
    xs = (points[:, 0] * (SIZE - 0.01)).astype(int)
    ys = (points[:, 1] * (SIZE - 0.01)).astype(int)
    for x, y in zip(xs, ys):
        img.set_pixel(y, x, (1.0, 0.2, 0.2))
    return img


def plot_hemi(dirs: np.ndarray) -> Image:
    """Hemisphere-warp scatter (main.rs:18-22): z in the red channel."""
    img = Image(SIZE, SIZE)
    xs = ((dirs[:, 0] / 2.0 + 0.5) * (SIZE - 0.01)).astype(int)
    ys = ((dirs[:, 1] / 2.0 + 0.5) * (SIZE - 0.01)).astype(int)
    for x, y, z in zip(xs, ys, dirs[:, 2]):
        img.set_pixel(y, x, (float(z), 0.2, 0.2))
    return img


def plot(points, basename: str, out_dir: str = ".") -> None:
    """Write the unit-square and hemisphere plots of a ``(N, 2)`` tensor."""
    p1 = os.path.join(out_dir, f"sampler-debug-{basename}.ppm")
    write_ppm(p1, plot_2d(points.cpu().numpy()))
    print(f"Wrote output to {p1}")

    hemi = to_hemisphere(points, 0.0).cpu().numpy()
    p2 = os.path.join(out_dir, f"sampler-debug-{basename}-hemi.ppm")
    write_ppm(p2, plot_hemi(hemi))
    print(f"Wrote output to {p2}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="flux-tpu-torch-sampler-debug", description="Sampler debugging utility")
    p.add_argument("-r", "--root", type=int, default=10, help="Sample root")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-dir", default=".")
    p.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where the points are drawn: cuda (default) or cpu",
    )
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    s = Sampler(seed=args.seed, device=dev)
    os.makedirs(args.output_dir, exist_ok=True)
    plot(grid_regular(args.root, device=dev), "r", args.output_dir)
    plot(s.grid_jittered(args.root), "j", args.output_dir)
    plot(s.grid_multi_jittered(args.root), "mj", args.output_dir)
    plot(s.grid_correlated_multi_jittered(args.root), "cmj", args.output_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
