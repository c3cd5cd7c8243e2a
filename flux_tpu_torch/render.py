"""The renderer: radiance sums over row bands, and the single-device
``Renderer`` (``flux_tpu/render.py``).

:func:`render_block` is the plain PyTorch version of the megakernels (the
sweep megakernel with the default ``isect``; the scene megakernel with an
``Intersector`` in scan mode or a scene with triangles):
an eager wavefront over lanes ``(samples, rows, cols)`` that regenerates
every lane's stratified samples from counters, builds thin-lens primary
rays, runs ``max_depth`` bounces with alive-masking and sums radiance over
the sample axis. It is what the kernel is held against, and what runs when
the scene's tensors lie on the CPU. With ``lights`` each bounce also draws
the NEE sample streams (``SALT_NEE`` for the cone point, ``SALT_NEEPICK``
for the light pick) and gates the light sample off at the final depth.

The ``Renderer`` renders a band of rows through
:func:`flux_tpu_torch.ops.sweep_kernel.render_block_sweep` (the sweep over
at most 64 spheres, no triangles) or
:func:`flux_tpu_torch.ops.scene_kernel.render_block_scene` (the scan over a
sphere table of any size, and triangles): the CUDA kernel on the card, its
plain version on the CPU. Pixel averaging and the
``max_to_one`` tone map (trace.rs:85-87) happen in :func:`finalize` once all
samples of a pixel are summed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .camera import CameraTensors, camera_tensors, primary_rays
from .color import luminance, max_to_one
from .constants import SALT_AA, SALT_BOUNCE, SALT_LENS, SALT_NEE, SALT_NEEPICK
from .ops.intersect import Intersector, scan_layout, tri_layout
from .ops.nee import LightTensors, extract_lights
from .ops.shade import PathState, bounce
from .samplers.hash import MASK, hash_combine, randfloat
from .samplers.patterns import bounce_point, cmj_point
from .samplers.warps import to_poisson_disc
from .scene import SceneData, SceneTensors, compile_scene
from .vec import Vec3

__all__ = ["render_block", "finalize", "plan_chunks", "resolve_device", "Renderer"]

# Sphere count above which the Renderer picks the blocked scan over the
# sweep. flux_tpu chose 64 for XLA's compile time (flux_tpu/render.py:50-52),
# which does not bind here; the port keeps the number so that both packages
# take the same path for the same scene (it is also the sweep kernel's
# constant-memory capacity). Where the scan starts to win on the card is
# still to be measured.
SCAN_AUTO_THRESHOLD = 64


def render_block(
    scene: SceneTensors,
    cam: CameraTensors,
    row0: int,
    s0: int,
    seed: int,
    *,
    img_w: int,
    img_h: int,
    n_rows: int,
    n_samples: int,
    root: int,
    max_depth: int,
    s_limit: Optional[int] = None,
    row_stride: int = 1,
    with_stats: bool = False,
    lights: Optional[LightTensors] = None,
    physical: bool = False,
    isect: Optional[Intersector] = None,
) -> torch.Tensor:
    """Radiance sum over sample indices [s0, s0+n_samples) for a band of
    rows ``row0 + k·row_stride``. Returns ``(n_rows, img_w, 3)`` float32
    (a fourth channel, the per-pixel Σ luminance², with ``with_stats``).
    Lanes whose sample index is ``>= s_limit`` add nothing. ``lights``
    turns on next-event estimation and ``physical`` the physical transport
    (with both: MIS); ``isect`` is the intersection strategy (the sweep by
    default). The contract of ``flux_tpu.render.render_block_impl``."""
    dev = scene.device
    s_idx = ((int(s0) + torch.arange(n_samples, dtype=torch.int64, device=dev)) & MASK)[:, None, None]
    row = (int(row0) + torch.arange(n_rows, dtype=torch.int32, device=dev) * int(row_stride))[None, :, None]
    col = torch.arange(img_w, dtype=torch.int32, device=dev)[None, None, :]
    seed = int(seed) & MASK

    pixel_base = hash_combine(seed, row, col)  # (1, n_rows, img_w)
    # Anti-aliasing jitter and lens sample: CMJ per pixel (sampling.rs:16-21).
    ax, ay = cmj_point(s_idx, root, hash_combine(pixel_base, SALT_AA))
    ux, uy = cmj_point(s_idx, root, hash_combine(pixel_base, SALT_LENS))
    lx, ly = to_poisson_disc(ux, uy)
    o, d = primary_rays(cam, row, col, img_w, img_h, ax, ay, lx, ly)

    shape = (n_samples, n_rows, img_w)

    def full(v: Vec3) -> Vec3:
        return Vec3(*(c.expand(shape) for c in v))

    ones = torch.ones(shape, dtype=torch.float32, device=dev)
    zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
    alive = torch.ones(shape, dtype=torch.bool, device=dev)
    if s_limit is not None:
        alive = (s_idx < (int(s_limit) & MASK)).expand(shape)
    state = PathState(
        o=full(o),
        d=full(d),
        throughput=Vec3(ones, ones, ones),
        radiance=Vec3(zeros, zeros, zeros),
        alive=alive,
        prev_shape=torch.full(shape, -1, dtype=torch.int32, device=dev),
        suppress=None if lights is None else torch.zeros(shape, dtype=torch.bool, device=dev),
        prev_pdf=None if lights is None else zeros,
        # Camera lanes have prev_pdf 0, so this start value is never read.
        prev_normal=Vec3(zeros, zeros, zeros) if lights is not None and physical else None,
    )
    for depth in range(1, max_depth + 1):
        # A fresh stratified sample per (pixel, sample, depth).
        pat = hash_combine(pixel_base, SALT_BOUNCE, depth)
        bx, by = bounce_point(s_idx, root, pat, depth)
        nee_samples = None
        if lights is not None:
            ux, uy = bounce_point(s_idx, root, hash_combine(pixel_base, SALT_NEE, depth), depth)
            upick = randfloat(s_idx, hash_combine(pixel_base, SALT_NEEPICK, depth))
            # Final-depth gate: the BSDF walk would collect this light at
            # the next vertex, which a depth-capped walk never reaches.
            nee_samples = (ux.expand(shape), uy.expand(shape), upick.expand(shape), depth < max_depth)
        state = bounce(
            scene, state, bx.expand(shape), by.expand(shape), isect=isect, first_bounce=depth == 1,
            lights=lights, nee_samples=nee_samples, physical=physical,
        )
    rad = state.radiance
    channels = [rad.x.sum(dim=0), rad.y.sum(dim=0), rad.z.sum(dim=0)]
    if with_stats:
        lum = luminance(rad)
        channels.append((lum * lum).sum(dim=0))
    return torch.stack(channels, dim=-1)


def finalize(acc: torch.Tensor, *, root: int) -> torch.Tensor:
    """Average the root² samples and tone-map (trace.rs:85-87)."""
    return max_to_one(acc * float(np.float32(1.0 / (root * root))))


def plan_chunks(total: int, chunk: int):
    """Split ``total`` samples into (s0, n) launches, at most two shapes."""
    chunk = max(1, min(chunk, total))
    out = []
    s = 0
    while s + chunk <= total:
        out.append((s, chunk))
        s += chunk
    if s < total:
        out.append((s, total - s))
    return out


def resolve_device(device=None) -> torch.device:
    """The device an entry point renders on: the CUDA card unless the caller
    names another. Raises when the card is asked for (or implied) and
    absent; it never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
            "to render with the plain PyTorch version on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class Renderer:
    """Single-device renderer: compiles a scene once and renders row bands
    at full sample depth (the contract of ``flux_tpu.render.Renderer``).

    ``accel`` picks the sphere intersection: ``"sweep"`` (every sphere, from
    constant memory on the card; at most 64), ``"scan"`` (Morton-sorted
    blocks with an AABB skip; any number), or None for the scan above
    ``SCAN_AUTO_THRESHOLD`` spheres. Triangles fold in after either. The
    ``Intersector`` and both block tables are built once, here.

    On the card each band is one launch of a megakernel with every
    requested sample. On the CPU the plain version runs, in sample chunks of
    about ``target_lanes`` lanes. ``nee`` and ``physical`` select the
    estimator as in ``flux_tpu``; ``.nee``, ``.physical`` and ``.lights``
    say what was built (``nee`` is False for a scene with no light).
    """

    def __init__(
        self,
        scene_data: SceneData,
        sample_root: int,
        max_depth: int,
        seed: int = 0,
        device=None,
        target_lanes: int = 1 << 20,
        accel: Optional[str] = None,
        nee: bool = False,
        physical: bool = False,
    ):
        self.device = resolve_device(device)
        self.scene = compile_scene(scene_data, self.device)
        if accel is None:
            accel = "scan" if self.scene.num_spheres > SCAN_AUTO_THRESHOLD else "sweep"
        if accel not in ("sweep", "scan"):
            raise ValueError(f"unknown accel {accel!r}")
        self.accel = accel
        self.isect = Intersector(
            layout=scan_layout(self.scene) if accel == "scan" else None,
            mode=accel,
            tri_layout=tri_layout(self.scene) if self.scene.num_triangles else None,
        )
        # Next-event estimation over the scene's sphere and triangle lights
        # (None, and nee False, when it has none), and physical transport.
        self.lights = extract_lights(scene_data, self.device) if nee else None
        self.nee = self.lights is not None
        self.physical = bool(physical)
        self.scene_data = scene_data
        self.cam = camera_tensors(
            scene_data.camera_settings,
            scene_data.camera_data,
            scene_data.output_settings.pixel_size,
            self.device,
        )
        self.width = scene_data.output_settings.image_width
        self.height = scene_data.output_settings.image_height
        self.root = int(sample_root)
        self.max_depth = int(max_depth)
        self.seed = int(seed) & MASK
        self.target_lanes = int(target_lanes)

    def _chunk_size(self, n_rows: int, n_samples: int) -> int:
        if self.device.type == "cuda":
            # The kernels keep no per-lane state in memory: one launch.
            return n_samples
        return max(1, self.target_lanes // max(n_rows * self.width, 1))

    @property
    def uses_sweep_kernel(self) -> bool:
        """True where a band goes to the sweep megakernel (K1-K4), False
        where it goes to the scene megakernel (scan or triangles)."""
        return self.accel == "sweep" and self.scene.num_triangles == 0

    def render_rows_sum(self, row0: int, n_rows: int) -> torch.Tensor:
        """Radiance sum over all root² samples for a row band."""
        return self.render_rows_sum_range(row0, n_rows, 0, self.root * self.root)

    def render_rows_sum_range(
        self, row0: int, n_rows: int, s0: int, n_samples: int, with_stats: bool = False
    ) -> torch.Tensor:
        """Radiance sum over sample indices [s0, s0 + n_samples) for a row
        band, ``(n_rows, width, 3)`` on the renderer's device (a fourth
        channel, Σ luminance², with ``with_stats``)."""
        from .ops.scene_kernel import render_block_scene
        from .ops.sweep_kernel import render_block_sweep

        kernel, extra = render_block_sweep, {}
        if not self.uses_sweep_kernel:
            kernel, extra = render_block_scene, {"isect": self.isect}
        acc = None
        for off, n in plan_chunks(n_samples, self._chunk_size(n_rows, n_samples)):
            part = kernel(
                self.scene,
                self.cam,
                row0,
                s0 + off,
                self.seed,
                img_w=self.width,
                img_h=self.height,
                n_rows=n_rows,
                n_samples=n,
                root=self.root,
                max_depth=self.max_depth,
                with_stats=with_stats,
                lights=self.lights,
                physical=self.physical,
                **extra,
            )
            acc = part if acc is None else acc + part
        return acc

    def render_rows(self, row0: int, n_rows: int) -> np.ndarray:
        """Final (averaged, tone-mapped) pixels for rows [row0, row0+n_rows)."""
        img = finalize(self.render_rows_sum(row0, n_rows), root=self.root)
        return img.cpu().numpy()

    def render_image(self, rows_per_band: Optional[int] = None) -> np.ndarray:
        """Render the full frame, band by band."""
        rows_per_band = rows_per_band or min(self.height, 64)
        out = np.zeros((self.height, self.width, 3), np.float32)
        r = 0
        while r < self.height:
            n = min(rows_per_band, self.height - r)
            out[r : r + n] = self.render_rows(r, n)
            r += n
        return out
