"""Procedural scene generation — scenes beyond the reference's demo scale.

The reference ships two hand-written YAML scenes of ~a dozen shapes
(scenes/demo1.yml, demo2.yml) and its linear ``Scene::hit`` sweep
(fluxcore/src/scene.rs:156-160) could never go much further. This module
generates arbitrarily large sphere-field scenes in the *same* YAML schema
(scene.rs:42-74, shapes.rs:15-81) — they load in the reference unmodified —
and is the workload generator for the large-scene scan path. This is the
port's own copy of ``flux_tpu/genscene.py`` (numpy only): the same
arguments give the same scene in both packages.

CLI: ``python -m flux_tpu_torch.genscene -n 512 --seed 1 -o scenes/spheres512.yml``
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import yaml

from .scene import (
    CameraData,
    CameraSettings,
    MaterialData,
    MaterialKind,
    OutputSettings,
    PlaneData,
    SceneData,
    SphereData,
)

__all__ = ["sphere_field"]


def sphere_field(
    n: int,
    seed: int = 0,
    *,
    name: str | None = None,
    width: int = 800,
    height: int = 600,
    spread: float = 14.0,
    emissive_fraction: float = 0.04,
) -> SceneData:
    """A field of ``n`` random spheres resting on a matte ground plane,
    lit by an inverted emissive environment sphere (the demo2 setup,
    scenes/demo2.yml:30-38) plus a sprinkling of small emissive spheres.

    Deterministic in ``seed``. Radii are drawn small relative to spacing so
    the field reads as a sphere carpet with depth; materials cycle through
    matte / reflective / glossy with per-sphere colors.
    """
    rng = np.random.default_rng(seed)
    shapes: list = []

    # Environment light: giant inverted emissive sphere (demo2.yml:30-38).
    shapes.append(
        SphereData(
            center=(0.0, 0.0, 0.0),
            radius=1000.0,
            invert=True,
            material=MaterialData(
                kind=MaterialKind.EMISSIVE, color=(0.55, 0.65, 0.85), param=0.8
            ),
        )
    )

    # Ground plane.
    shapes.append(
        PlaneData(
            point=(0.0, 0.0, 0.0),
            normal=(0.0, 1.0, 0.0),
            material=MaterialData(
                kind=MaterialKind.MATTE, color=(0.9, 0.9, 0.9), param=1.0
            ),
        )
    )

    pos = rng.uniform(-spread, spread, size=(n, 2))
    radii = rng.uniform(0.12, 0.55, size=n)
    hues = rng.uniform(0.15, 1.0, size=(n, 3))
    rolls = rng.uniform(0.0, 1.0, size=n)
    for i in range(n):
        x, z = float(pos[i, 0]), float(pos[i, 1])
        r = float(radii[i])
        color = tuple(round(float(c), 4) for c in hues[i])
        if rolls[i] < emissive_fraction:
            mat = MaterialData(
                kind=MaterialKind.EMISSIVE, color=color, param=4.0
            )
        elif rolls[i] < 0.55:
            mat = MaterialData(kind=MaterialKind.MATTE, color=color, param=1.0)
        elif rolls[i] < 0.85:
            mat = MaterialData(
                kind=MaterialKind.GLOSSY,
                color=color,
                param=0.9,
                exponent=float(rng.choice([10.0, 50.0, 200.0])),
            )
        else:
            mat = MaterialData(kind=MaterialKind.REFLECTIVE, color=color, param=0.9)
        shapes.append(
            SphereData(center=(x, r, z), radius=r, material=mat)
        )

    return SceneData(
        scene_name=name or f"spheres{n}",
        output_settings=OutputSettings(
            image_width=width, image_height=height, pixel_size=1.0
        ),
        background=(0.0, 0.0, 0.0),
        shapes=tuple(shapes),
        camera_settings=CameraSettings(
            eye=(0.0, 6.0, 22.0), look_at=(0.0, 0.5, 0.0), up=(0.0, 1.0, 0.0)
        ),
        camera_data=CameraData(
            zoom_factor=1.0,
            view_plane_distance=500.0,
            focal_distance=21.0,
            lens_radius=0.0,
        ),
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m flux_tpu_torch.genscene", description="generate a sphere-field scene YAML"
    )
    p.add_argument("-n", "--num-spheres", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("-o", "--output", default="-", help="output path (default stdout)")
    args = p.parse_args(argv)
    if args.num_spheres < 0:
        p.error("--num-spheres must be >= 0")

    sd = sphere_field(
        args.num_spheres, args.seed, width=args.width, height=args.height
    )
    text = yaml.safe_dump(sd.to_dict(), sort_keys=False)
    if args.output == "-":
        sys.stdout.write(text)
    else:
        with open(args.output, "w") as f:
            f.write(text)
        print(f"Wrote {args.output} ({args.num_spheres} spheres)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
