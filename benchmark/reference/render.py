"""Radiance sums of a list of pixels: ``flux_tpu_torch.render.render_block``
(frozen at commit f2c28681) with each lane's row and column given per pixel
instead of as a band of rows, and ``finalize``.

``round_state`` is the control's hook: a function applied to every float
tensor of the path state (primary rays, then the state after each bounce).
The control passes :func:`to_bfloat16`, which holds the state in bfloat16
between operations: the reference computed one precision below the
float32 that the configurations state.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .camera import camera_tensors, primary_rays
from .color import luminance, max_to_one
from .constants import SALT_AA, SALT_BOUNCE, SALT_LENS, SALT_NEE, SALT_NEEPICK
from .hash import MASK, hash_combine, randfloat
from .intersect import Intersector
from .nee import extract_lights
from .patterns import bounce_point, cmj_point
from .scene import compile_scene, load_scene
from .shade import PathState, bounce
from .vec import Vec3
from .warps import to_poisson_disc

__all__ = ["Reference", "finalize", "to_bfloat16"]

# Lanes (pixels x samples) per call of the wavefront.
LANES = 1 << 22


def to_bfloat16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _round_vec(v: Optional[Vec3], f) -> Optional[Vec3]:
    return None if v is None else Vec3(f(v.x), f(v.y), f(v.z))


def _round_path(state: PathState, f) -> PathState:
    return state._replace(
        o=_round_vec(state.o, f), d=_round_vec(state.d, f), throughput=_round_vec(state.throughput, f),
        radiance=_round_vec(state.radiance, f), prev_pdf=None if state.prev_pdf is None else f(state.prev_pdf),
        prev_normal=_round_vec(state.prev_normal, f),
    )


def finalize(acc: torch.Tensor, root: int) -> torch.Tensor:
    """Average the root² samples and tone-map (trace.rs:85-87)."""
    return max_to_one(acc * float(np.float32(1.0 / (root * root))))


class Reference:
    """A scene of the reference's own loading, on ``device``, rendered per
    pixel with the port's estimator (sweep intersection, triangles folded
    after it; ``nee`` and ``physical`` as the job states them)."""

    def __init__(self, scene_path: str, *, root: int, depth: int, nee: bool = False, physical: bool = False,
                 device="cpu", round_state: Optional[Callable] = None):
        sd = load_scene(scene_path)
        self.device = torch.device(device)
        self.scene = compile_scene(sd, self.device)
        self.lights = extract_lights(sd, self.device) if nee else None
        self.physical = bool(physical)
        out = sd.output_settings
        self.width, self.height = out.image_width, out.image_height
        self.cam = camera_tensors(sd.camera_settings, sd.camera_data, out.pixel_size, self.device)
        self.root, self.depth = int(root), int(depth)
        self.round_state = round_state
        self.isect = Intersector()

    def sums(self, rows, cols, seed: int, s0: int, n_samples: int, with_stats: bool = False) -> torch.Tensor:
        """Radiance sums over sample indices [s0, s0 + n_samples) of the
        pixels (rows[i], cols[i]): ``(P, 3)`` float32 (``(P, 4)`` with the
        Σ luminance² channel)."""
        rows = torch.as_tensor(np.asarray(rows), dtype=torch.int32, device=self.device)[None, None, :]
        cols = torch.as_tensor(np.asarray(cols), dtype=torch.int32, device=self.device)[None, None, :]
        chunk = max(1, LANES // rows.shape[-1])
        acc = None
        for off in range(0, n_samples, chunk):
            part = self._block(rows, cols, seed, s0 + off, min(chunk, n_samples - off), with_stats)
            acc = part if acc is None else acc + part
        return acc

    def pixels(self, rows, cols, seed: int) -> torch.Tensor:
        """Final (averaged, tone-mapped) pixels of a whole render."""
        return finalize(self.sums(rows, cols, seed, 0, self.root * self.root), self.root)

    def _block(self, row, col, seed, s0, n_samples, with_stats):
        dev, root, f = self.device, self.root, self.round_state
        s_idx = ((int(s0) + torch.arange(n_samples, dtype=torch.int64, device=dev)) & MASK)[:, None, None]
        seed = int(seed) & MASK
        pixel_base = hash_combine(seed, row, col)  # (1, 1, P)
        ax, ay = cmj_point(s_idx, root, hash_combine(pixel_base, SALT_AA))
        ux, uy = cmj_point(s_idx, root, hash_combine(pixel_base, SALT_LENS))
        lx, ly = to_poisson_disc(ux, uy)
        o, d = primary_rays(self.cam, row, col, self.width, self.height, ax, ay, lx, ly)
        shape = (n_samples, 1, row.shape[-1])

        def full(v: Vec3) -> Vec3:
            return Vec3(*(c.expand(shape) for c in v))

        lights, physical = self.lights, self.physical
        ones = torch.ones(shape, dtype=torch.float32, device=dev)
        zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
        state = PathState(
            o=full(o), d=full(d), throughput=Vec3(ones, ones, ones), radiance=Vec3(zeros, zeros, zeros),
            alive=torch.ones(shape, dtype=torch.bool, device=dev),
            prev_shape=torch.full(shape, -1, dtype=torch.int32, device=dev),
            suppress=None if lights is None else torch.zeros(shape, dtype=torch.bool, device=dev),
            prev_pdf=None if lights is None else zeros,
            prev_normal=Vec3(zeros, zeros, zeros) if lights is not None and physical else None,
        )
        if f is not None:
            state = _round_path(state, f)
        for depth in range(1, self.depth + 1):
            bx, by = bounce_point(s_idx, root, hash_combine(pixel_base, SALT_BOUNCE, depth), depth)
            nee_samples = None
            if lights is not None:
                nx, ny = bounce_point(s_idx, root, hash_combine(pixel_base, SALT_NEE, depth), depth)
                upick = randfloat(s_idx, hash_combine(pixel_base, SALT_NEEPICK, depth))
                nee_samples = (nx.expand(shape), ny.expand(shape), upick.expand(shape), depth < self.depth)
            state = bounce(
                self.scene, state, bx.expand(shape), by.expand(shape), isect=self.isect, first_bounce=depth == 1,
                lights=lights, nee_samples=nee_samples, physical=physical,
            )
            if f is not None:
                state = _round_path(state, f)
        rad = state.radiance
        channels = [rad.x, rad.y, rad.z]
        if with_stats:
            lum = luminance(rad)
            channels.append(lum * lum)
        # (n, 1, P, C) -> (P, C, n): the sum over samples runs along a
        # contiguous innermost axis, as render_block sums it.
        return torch.stack(channels, dim=-1)[:, 0].permute(1, 2, 0).contiguous().sum(dim=-1)
