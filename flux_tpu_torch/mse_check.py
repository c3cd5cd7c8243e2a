"""Estimator-variance check of the port (the JAX package's
``tools/mse_check.py``): demo2 at a low sample count, its MSE against the
JAX package's converged 16384-spp frame (``artifacts/demo2_16384spp.png``).
A change to the sample stream must hold this MSE within noise of its value
before the change: a speed-up that adds variance is no speed-up at equal
image quality.

Run from a checkout: ``python -m flux_tpu_torch.mse_check [--root 16]
[--seeds 0 1 2]``; prints one JSON line with ``root``, ``spp``,
``mse_per_seed``, ``mse_mean`` and ``card``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .artifacts import png_levels
from .bench import REPO, card_name
from .render import Renderer, resolve_device
from .scene import load_scene

REFERENCE = "demo2_16384spp.png"


def mse_vs_reference(root: int, seeds, device, *, rows=None) -> list:
    """The MSE of demo2 at ``root``, depth 5, for each seed, against the
    stored frame in [0, 1]; ``rows`` (row0, n) holds one band of the frame
    only, for the tests."""
    ref = png_levels(REFERENCE).astype(np.float64) / 255.0
    sd = load_scene(str(REPO / "scenes" / "demo2.yml"))
    row0, n = (0, sd.output_settings.image_height) if rows is None else rows
    mses = []
    for seed in seeds:
        r = Renderer(sd, root, 5, seed=seed, device=device)
        # One band of the frame's height, as tools/mse_check.py renders it.
        img = np.asarray(r.render_rows(row0, n), np.float64)
        mses.append(float(np.mean((img - ref[row0:row0 + n]) ** 2)))
    return mses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m flux_tpu_torch.mse_check", description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=int, default=16)
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu, the plain PyTorch version")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mses = mse_vs_reference(args.root, args.seeds, dev)
    print(json.dumps({
        "root": args.root,
        "spp": args.root * args.root,
        "mse_per_seed": mses,
        "mse_mean": float(np.mean(mses)),
        "card": card_name(dev),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
