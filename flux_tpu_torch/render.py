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
at most 64 spheres and 16 planes, no triangles) or
:func:`flux_tpu_torch.ops.scene_kernel.render_block_scene` (the scan over a
sphere table of any size, any number of planes, and triangles): the CUDA
kernel on the card, its plain version on the CPU. Pixel averaging and the
``max_to_one`` tone map (trace.rs:85-87) happen in :func:`finalize` once all
samples of a pixel are summed.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .camera import CameraTensors, camera_tensors, primary_rays
from .color import luminance, max_to_one
from .constants import SALT_AA, SALT_BOUNCE, SALT_LENS, SALT_NEE, SALT_NEEPICK
from .metrics import span
from .ops.intersect import Intersector, scan_layout, tri_layout
from .ops.nee import LightTensors, extract_lights
from .ops.shade import PathState, bounce
from .ops.sweep_kernel import MAX_PLANES, MAX_SPHERES, launch_plan
from .samplers.hash import MASK, hash_combine, randfloat
from .samplers.patterns import bounce_point, cmj_point
from .samplers.warps import to_poisson_disc
from .scene import SceneData, SceneTensors, compile_scene
from .vec import Vec3

__all__ = ["render_block", "finalize", "plan_chunks", "resolve_device", "SceneState", "Renderer", "LaunchStreams",
           "launch_streams"]

# Sphere count above which the Renderer picks the blocked scan over the
# sweep. flux_tpu chose 64 for XLA's compile time (flux_tpu/render.py:50-52),
# which does not bind here; the port keeps the number so that both packages
# take the same path for the same scene (it is also the sweep kernel's
# constant-memory capacity, MAX_SPHERES). On an NVIDIA H100 80GB HBM3 at
# 700 W the sweep megakernel beats the scan at every size up to it: a
# 50-row band of sphere_field(n - 1) at 64 spp takes the scan 1.36, 1.18,
# 1.23 and 1.13 times the sweep's time for n = 16, 32, 48, 64 spheres
# (chip_smoke.py phase 12).
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
    channels = [rad.x, rad.y, rad.z]
    if with_stats:
        lum = luminance(rad)
        channels.append(lum * lum)
    # The sum over samples runs along a contiguous innermost axis, so that
    # a pixel's sum depends on its own samples alone: summed along the
    # outer axis, PyTorch's CPU reduction adds a pixel's samples in another
    # order where the pixel falls in the vectorized part of a row of lanes
    # than at its end, and a row shard of a band would not be bit-equal to
    # the band.
    return torch.stack(channels, dim=-1).permute(1, 2, 3, 0).contiguous().sum(dim=-1)


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


class LaunchStreams:
    """The streams of one card on which :meth:`Renderer.queue_rows` queues
    its bands: two launch streams, taken in turn, so that the blocks of a
    band's kernel may start on the SMs that the last blocks of the band
    before it leave idle, where the two would drain one after the other on
    one stream; and a readback stream of higher priority for each band's
    :func:`finalize` and copy, which would otherwise wait behind the
    thousands of blocks of the kernel queued after it."""

    def __init__(self, device: torch.device):
        self.launch = (torch.cuda.Stream(device), torch.cuda.Stream(device))
        self.readback = torch.cuda.Stream(device, priority=-1)
        self._last = [None, None]  # the event behind each launch stream's last launch
        self._turn = 0
        self._lock = threading.Lock()

    def take(self):
        """(index, stream, overlapped) for the next launch: the launch stream
        whose turn it is, and whether the other's last kernel was still
        running."""
        with self._lock:
            k, self._turn = self._turn, self._turn ^ 1
            other = self._last[k ^ 1]
        return k, self.launch[k], other is not None and not other.query()

    def launched(self, k: int, event) -> None:
        """Note ``event``, recorded behind a launch on launch stream ``k``."""
        with self._lock:
            self._last[k] = event


@functools.cache
def launch_streams(index: int) -> LaunchStreams:
    """The :class:`LaunchStreams` of card ``index``, made at its first band."""
    return LaunchStreams(torch.device("cuda", index))


@dataclass(frozen=True, eq=False)
class SceneState:
    """What a :class:`Renderer` derives from its scene alone, for one device,
    ``accel`` and ``nee`` (the ones asked for, kept as ``asked``): the
    compiled scene, the ``accel`` taken, the ``Intersector`` with its block
    tables, the lights (None without NEE or without a light), the camera and
    the frame's size. A launch packs its device tables from these objects and
    keeps them in their ``host`` dicts, so the renderers built on one state
    pack and copy each table once. Nothing in it depends on a job's sample
    root, depth, seed or estimator."""

    scene_data: SceneData
    device: torch.device
    asked: tuple  # (accel, nee) as given to build
    scene: SceneTensors
    accel: str
    isect: Intersector
    lights: Optional[LightTensors]
    cam: CameraTensors
    width: int
    height: int

    @classmethod
    def build(cls, scene_data: SceneData, device=None, accel: Optional[str] = None,
              nee: bool = False) -> "SceneState":
        """Compile ``scene_data`` on ``device`` (the CUDA card unless the
        CPU is named) and build its intersector, lights and camera."""
        dev = resolve_device(device)
        asked = (accel, bool(nee))
        scene = compile_scene(scene_data, dev)
        if accel is None:
            accel = "scan" if scene.num_spheres > SCAN_AUTO_THRESHOLD else "sweep"
        if accel not in ("sweep", "scan"):
            raise ValueError(f"unknown accel {accel!r}")
        if scene.num_spheres > MAX_SPHERES:
            accel = "scan"
        isect = Intersector(
            layout=scan_layout(scene) if accel == "scan" else None,
            mode=accel,
            tri_layout=tri_layout(scene) if scene.num_triangles else None,
        )
        out = scene_data.output_settings
        return cls(
            scene_data=scene_data,
            device=dev,
            asked=asked,
            scene=scene,
            accel=accel,
            isect=isect,
            # Next-event estimation over the scene's sphere and triangle
            # lights (None when it has none).
            lights=extract_lights(scene_data, dev) if nee else None,
            cam=camera_tensors(scene_data.camera_settings, scene_data.camera_data, out.pixel_size, dev),
            width=out.image_width,
            height=out.image_height,
        )

    def matches(self, scene_data: SceneData, device=None, accel: Optional[str] = None,
                nee: bool = False) -> bool:
        """True where :meth:`build` with these arguments would build this
        state: the device, ``accel`` and ``nee`` are the ones asked for and
        the scene compares equal (field by field, so a scene decoded from
        the wire matches the one it was sent from; floats compare as
        values, so a zero matches a zero of the other sign)."""
        return (
            self.asked == (accel, bool(nee))
            and self.device == resolve_device(device)
            and (self.scene_data is scene_data or self.scene_data == scene_data)
        )


class Renderer:
    """Single-device renderer: compiles a scene once and renders row bands
    at full sample depth (the contract of ``flux_tpu.render.Renderer``).

    ``accel`` picks the sphere intersection: ``"sweep"`` (every sphere, from
    constant memory on the card), ``"scan"`` (Morton-sorted blocks under a
    tree of boxes; any number), or None for the scan above
    ``SCAN_AUTO_THRESHOLD`` spheres. A sweep asked for above the sweep's
    ``MAX_SPHERES`` (64) spheres takes the scan, which gives the same bits;
    ``.accel`` says which was taken. Triangles fold in after either. The
    ``Intersector`` and both block tables are built once, with the scene
    state below.

    A band goes to the sweep megakernel (K1-K4) for a sweep without
    triangles over at most ``MAX_PLANES`` (16) planes, and to the scene
    megakernel (K5-K7) otherwise, which reads any number of planes from a
    table in device memory (``uses_sweep_kernel``).

    On the card each band is one launch of a megakernel with every
    requested sample. On the CPU the plain version runs, in sample chunks of
    about ``target_lanes`` lanes. ``nee`` and ``physical`` select the
    estimator as in ``flux_tpu``; ``.nee``, ``.physical`` and ``.lights``
    say what was built (``nee`` is False for a scene with no light).

    What the renderer derives from the scene alone is its :class:`SceneState`
    (``.state``): built here, or given as ``state``, built for the same
    ``scene_data``, ``device``, ``accel`` and ``nee`` (a ValueError
    otherwise), in which case renderers of several jobs share the compiled
    scene, the intersector and the tables packed from them. The sample
    root, depth, seed, ``physical`` and ``target_lanes`` are the renderer's
    own.
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
        *,
        state: Optional[SceneState] = None,
    ):
        if state is None:
            state = SceneState.build(scene_data, device, accel, nee)
        elif not state.matches(scene_data, device, accel, nee):
            raise ValueError("the scene state was built for another scene, device, accel or nee")
        self.state = state
        self.device = state.device
        self.scene = state.scene
        self.accel = state.accel
        self.isect = state.isect
        self.lights = state.lights
        self.nee = self.lights is not None
        self.physical = bool(physical)
        self.scene_data = scene_data
        self.cam = state.cam
        self.width = state.width
        self.height = state.height
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
        where it goes to the scene megakernel (scan, triangles, or more than
        ``MAX_PLANES`` planes)."""
        return self.accel == "sweep" and self.scene.num_triangles == 0 and self.scene.num_planes <= MAX_PLANES

    def render_rows_sum(self, row0: int, n_rows: int) -> torch.Tensor:
        """Radiance sum over all root² samples for a row band."""
        return self.render_rows_sum_range(row0, n_rows, 0, self.root * self.root)

    def render_rows_sum_range(
        self, row0: int, n_rows: int, s0: int, n_samples: int, with_stats: bool = False, *,
        row_stride: int = 1, s_limit: Optional[int] = None, band_rows: Optional[int] = None,
    ) -> torch.Tensor:
        """Radiance sum over sample indices [s0, s0 + n_samples) for a row
        band, ``(n_rows, width, 3)`` on the renderer's device (a fourth
        channel, Σ luminance², with ``with_stats``).

        A row shard of a band (``parallel/shard.py``) passes the rest: its
        rows are ``row0 + k·row_stride``, its samples from ``s_limit`` on
        add nothing, and its launch is cut as that of the band of
        ``band_rows`` rows over ``n_samples`` would be (the split on the
        card, the sample chunks on the CPU), so that each of its pixels
        sums its samples in the band's order and the band's bits come
        back."""
        return self._sum_range(row0, n_rows, s0, n_samples, with_stats, row_stride=row_stride, s_limit=s_limit,
                               band_rows=band_rows)

    def _sum_range(self, row0: int, n_rows: int, s0: int, n_samples: int, with_stats: bool = False, *,
                   row_stride: int = 1, s_limit: Optional[int] = None, band_rows: Optional[int] = None,
                   attrs=()) -> torch.Tensor:
        """:meth:`render_rows_sum_range`, with ``attrs`` ((key, value)
        pairs) set on each ``kernel.launch`` span beside the configuration
        and whether the launch uploaded the kernel's scene record."""
        from .ops.scene_kernel import render_block_scene
        from .ops.sweep_kernel import render_block_sweep

        kernel, extra = render_block_sweep, {}
        if not self.uses_sweep_kernel:
            kernel, extra = render_block_scene, {"isect": self.isect}
        band_rows = n_rows if band_rows is None else band_rows
        if self.device.type == "cuda":
            extra["split"] = launch_plan(band_rows * self.width, n_samples).split
        acc = None
        for off, n in plan_chunks(n_samples, self._chunk_size(band_rows, n_samples)):
            # On the card the call is the wrapper's host work up to the launch
            # queued (the tables packed on a first launch among it): the span
            # kernel.launch. On the CPU it is the plain render, no launch.
            with span("kernel.launch") if self.device.type == "cuda" else contextlib.nullcontext() as sp:
                if sp:
                    sp.set("config", self._launch_config(with_stats))
                    for key, value in attrs:
                        sp.set(key, value)
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
                    s_limit=s_limit,
                    row_stride=row_stride,
                    with_stats=with_stats,
                    lights=self.lights,
                    physical=self.physical,
                    **extra,
                )
                if sp:
                    sp.set("uploaded", kernel.last_uploaded)
            acc = part if acc is None else acc + part
        return acc

    def _launch_config(self, with_stats: bool) -> str:
        """The configuration a band's launch is counted under."""
        from .ops import scene_kernel, sweep_kernel

        if self.uses_sweep_kernel:
            return sweep_kernel.config_name(with_stats, self.nee, self.physical)
        return scene_kernel.launch_config(self.scene, self.isect, with_stats, self.lights, self.physical)

    def render_rows(self, row0: int, n_rows: int) -> np.ndarray:
        """Final (averaged, tone-mapped) pixels for rows [row0, row0+n_rows)."""
        return self.wait_rows(self.queue_rows(row0, n_rows))

    def queue_rows(self, row0: int, n_rows: int):
        """The first half of :meth:`render_rows`: on the card, queue the
        band's launch on the next of the card's two launch streams
        (:class:`LaunchStreams`), behind the work queued on the device's
        current stream, then on the readback stream, behind the launch,
        :func:`finalize`, a copy of the pixels into page-locked host memory
        and an event, and return without waiting for any of it; on the CPU,
        render the band. Returns the handle that :meth:`wait_rows` takes.

        The band's kernel may thus start while the kernel of a band queued
        before it still runs; its ``kernel.launch`` span says on which
        launch stream (``stream``) and whether the other's last kernel was
        running (``overlapped``). The host buffer comes from PyTorch's caching
        host allocator: it goes back to the cache once the array
        :meth:`wait_rows` returned is gone, and serves a later band, so
        steady work allocates no page-locked memory."""
        if self.device.type != "cuda":
            acc = self.render_rows_sum(row0, n_rows)
            with span("unit.readback"):
                return finalize(acc, root=self.root), None
        streams = launch_streams(self.device.index if self.device.index is not None
                                 else torch.cuda.current_device())
        k, launch, overlapped = streams.take()
        launch.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(launch):
            acc = self._sum_range(row0, n_rows, 0, self.root * self.root,
                                  attrs=(("stream", k), ("overlapped", overlapped)))
            launched = torch.cuda.Event()
            launched.record(launch)
        streams.launched(k, launched)
        readback = streams.readback
        with span("unit.readback"), torch.cuda.stream(readback):
            readback.wait_event(launched)
            acc.record_stream(readback)  # made on the launch stream, read here
            rows = finalize(acc, root=self.root)
            host = torch.empty_strided(rows.size(), rows.stride(), dtype=rows.dtype, pin_memory=True)
            host.copy_(rows, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(readback)
        return host, copied

    @staticmethod
    def wait_rows(pending) -> np.ndarray:
        """The pixels of a :meth:`queue_rows` handle, once its copy has ended
        (the wait releases the GIL). The array is the band's own: no later
        band writes it."""
        host, copied = pending
        if copied is not None:
            copied.synchronize()
        return host.numpy()

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
