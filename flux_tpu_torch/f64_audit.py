"""Precision audit CLI: the port's float32 path against the float64 oracle
(``tools/f64_audit.py`` on the port).

Renders a scene with ``flux_tpu_torch.render.Renderer`` (float32; on the
card its kernels) and with ``flux_tpu_torch.oracle.oracle_render`` (float64,
bit-identical sample streams) on one device, and prints the difference
statistics as JSON.

Usage: python -m flux_tpu_torch.f64_audit scenes/demo1.yml [--root 8]
       [--depth 5] [--seed 0] [--width 80 --height 60] [--physical]
       [--device cuda|cpu]

The card is the default device; without one it raises unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import replace

from .oracle import precision_audit
from .render import resolve_device
from .scene import load_scene


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="float32 path against the float64 oracle")
    ap.add_argument("scene")
    ap.add_argument("--root", type=int, default=8)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--physical", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    sd = load_scene(args.scene)
    if args.width or args.height:
        osx = sd.output_settings
        sd = replace(sd, output_settings=replace(
            osx, image_width=args.width or osx.image_width, image_height=args.height or osx.image_height))
    report = precision_audit(sd, args.root, args.depth, seed=args.seed, physical=args.physical, device=device)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
