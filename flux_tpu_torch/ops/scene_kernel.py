"""The scene megakernel: a band's whole render in one CUDA launch, for
sphere tables of any size (the scan with its block skip) and for triangles.

:func:`render_block_scene` has the contract of
:func:`flux_tpu_torch.render.render_block` with an
:class:`~flux_tpu_torch.ops.intersect.Intersector` (radiance sums over the
samples ``[s0, s0 + n_samples)`` of a band of rows). For a scene whose
tensors lie on the CPU it returns the plain version's result. For a scene on
a CUDA card it launches ``csrc/scene_megakernel.cu`` (built for ``sm_90a`` at
first use; see :mod:`flux_tpu_torch.ops.build`) or raises; it never falls
back to the plain version there.

The kernel replaces the TPU kernel ``flux_tpu/ops/pallas_kernel.py::_kernel``
in its scan and triangle configurations: K5 (scan over Morton-sorted sphere
blocks with the AABB skip), K6 (the triangle fold) and K7 (triangle lights
in NEE), each with the stats channel, NEE and physical transport as the
sweep megakernel has them. Sweep or scan, triangles, triangle lights and the
skips are run-time choices of one launch; the template instantiations are
``<STATS, NEE, PHYSICAL>`` only. The source's header says what bounds it on
the H100 and how its design meets that.

What this module does on the host, once per layout and light set: it packs
the :class:`ScanLayout`, the :class:`TriLayout` and the light set into one
float32 device buffer each (rows of 4 floats, the boxes of every block and of
every group of 8 blocks behind them), and keeps the buffer beside the
layout's host arrays.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..camera import CameraTensors
from ..samplers.hash import MASK
from ..scene import SceneTensors
from . import build
from .intersect import SCAN_BLOCK, TRI_SCAN_BLOCK, Intersector, ScanLayout, TriLayout
from .nee import LightTensors
from .sweep_kernel import FluxScene, check_launch, pack_scene, plan_launch

__all__ = [
    "render_block_scene",
    "FluxGeom",
    "config_name",
    "pack_sphere_table",
    "pack_tri_table",
    "pack_light_table",
    "union_boxes",
    "COUNT_NAMES",
    "N_COUNTS",
    "SUPER",
    "TRI_SKIP_ENGAGE",
    "tri_skip_engaged",
    "flops_lower_bound",
    "table_bytes",
]

SUPER = 8  # blocks under one second-level box
# The kernel's work counters per pixel, in order (see the source).
COUNT_NAMES = (
    "bounces", "light_samples", "shadow_rays", "reverse_densities", "glossy_lobes",
    "sphere_blocks_needed", "sphere_blocks_entered", "sphere_box_tests",
    "tri_blocks_needed", "tri_blocks_entered", "tri_box_tests", "shadow_folds",
)
N_COUNTS = len(COUNT_NAMES)
# The triangle skip is engaged from this many triangle blocks on; below it
# the launch folds every block (flux_tpu's rule, pallas_kernel.py:1177-1178).
# The threshold was measured on an NVIDIA H100 80GB HBM3 at 700 W
# (chip_smoke.py phase 14, ms with the skip on / off): a mesh of 2 blocks at
# 16 spp 0.376 / 0.539, 5 blocks 0.568 / 0.831, 20 blocks 0.814 / 2.199, 80
# blocks 1.334 / 8.317; the Cornell box's 3 blocks at 1024 spp with NEE
# 42.22 / 36.95 (in a closed room every ray enters every box). No block
# count separates the open 2-block mesh from the room: 4 gives up 0.16 ms on
# the first to save 5.3 ms on the second.
TRI_SKIP_ENGAGE = 4
_SOURCE = "scene_megakernel"
_SKIPS = {"scan_skip", "tri_skip", "two_level"}  # pack_geom's measurement switches

_POINTERS = (
    "sph_geo", "sph_idx", "sph_mat", "sph_alb", "sph_box", "sph_sbox",
    "tri_v0", "tri_e1", "tri_e2", "tri_idx", "tri_n", "tri_alb", "tri_box", "tri_sbox",
    "l_center", "l_emit", "l_pick", "l_cdf", "l_shape", "l_is_tri", "l_v0", "l_e1", "l_e2", "l_n",
    "light_of",
)
_INTS = (
    "n_sph_blocks", "n_tri_blocks", "scan", "ns_base", "plane_row0", "tri_base", "sph_skip",
    "tri_skip", "n_lights", "lights_have_tris",
)


class FluxGeom(ctypes.Structure):
    """The kernel's launch parameters (``struct FluxGeom``): device pointers
    into the packed tables, then the launch-uniform choices."""

    _fields_ = [(k, ctypes.c_void_p) for k in _POINTERS] + [(k, ctypes.c_int) for k in _INTS]


def config_name(accel: str, tris: bool, with_stats: bool, nee: bool, physical: bool,
                tri_lights: bool = False) -> str:
    """The name a launch is counted under: ``scan`` or ``sweep``, ``+tri``
    with triangles, then ``+nee`` (``+trilight`` where the light set has a
    triangle), ``+physical`` and ``+stats`` as the sweep megakernel names
    them."""
    return (accel + "+tri" * tris + "+nee" * nee + "+trilight" * (nee and tri_lights)
            + "+physical" * physical + "+stats" * with_stats)


def _rows4(*cols) -> np.ndarray:
    """(N, 4) float32 rows from columns of width 1 or 3; int32 columns ride
    as their bits; missing width is zero."""
    n = cols[0].shape[0]
    out = np.zeros((n, 4), np.float32)
    c = 0
    for col in cols:
        col = np.asarray(col)
        if col.dtype == np.int32:
            col = col.view(np.float32)
        col = col.reshape(n, -1)
        out[:, c:c + col.shape[1]] = col
        c += col.shape[1]
    return out


def union_boxes(bmin: np.ndarray, bmax: np.ndarray, group: int = SUPER):
    """Boxes over each ``group`` consecutive blocks: the union of their
    boxes, ignoring NaN (empty) ones; NaN where the whole group is empty.
    ``bmin`` and ``bmax`` are (n_blocks, k): the reduction is per column."""
    nb, k = bmin.shape
    ng = -(-nb // group)
    pad = np.full((ng * group - nb, k), np.nan, np.float32)
    lo = np.fmin.reduce(np.concatenate([bmin, pad]).reshape(ng, group, k), axis=1)
    hi = np.fmax.reduce(np.concatenate([bmax, pad]).reshape(ng, group, k), axis=1)
    return lo.astype(np.float32), hi.astype(np.float32)


def _boxes(bmin: np.ndarray, bmax: np.ndarray, inv_rmin=None) -> np.ndarray:
    """(n, 2, 4) float32: per box its lo and hi corner rows; ``inv_rmin``
    (sphere boxes: 1 / the least radius inside) rides in lo's fourth
    float."""
    lo = _rows4(bmin) if inv_rmin is None else _rows4(bmin, inv_rmin)
    return np.stack([lo, _rows4(bmax)], axis=1)


def _concat(sections: dict):
    """One flat float32 buffer from named (N, 4) or (N,) sections, and each
    section's offset in floats (a multiple of 4: float4 loads stay aligned)."""
    offsets, parts, at = {}, [], 0
    for name, a in sections.items():
        a = np.ascontiguousarray(a)
        flat = (a.view(np.float32) if a.dtype == np.int32 else a.astype(np.float32, copy=False)).reshape(-1)
        padn = -flat.size % 4
        offsets[name] = at
        parts.append(flat)
        if padn:
            parts.append(np.zeros(padn, np.float32))
        at += flat.size + padn
    return (np.concatenate(parts) if parts else np.zeros(4, np.float32)), offsets


def pack_sphere_table(layout: ScanLayout):
    """The kernel's sphere table from a ScanLayout's host arrays."""
    h = layout.host
    n = h["idx"].size
    slo, shi = union_boxes(h["bmin"], h["bmax"])
    # 1 / (least radius of the block's real spheres): the slab test widens a
    # box by the sphere test's error, which grows as 1/r.
    inv_r = np.where(h["idx"] >= 0, np.float32(1.0) / h["rad"], np.float32(np.nan))
    inv_rmin = np.fmax.reduce(inv_r, axis=1).astype(np.float32)
    inv_rmin = np.where(np.isnan(inv_rmin), np.float32(0.0), inv_rmin)
    s_inv = np.nan_to_num(union_boxes(inv_rmin[:, None], inv_rmin[:, None])[1][:, 0])
    return _concat({
        "sph_geo": _rows4(h["ctr"].reshape(n, 3), h["rad"].reshape(n)),
        "sph_idx": h["idx"].reshape(n),
        "sph_mat": _rows4(h["inv_r"].reshape(n), h["exp"].reshape(n), h["kind"].reshape(n)),
        "sph_alb": _rows4(h["alb"].reshape(n, 3)),
        "sph_box": _boxes(h["bmin"], h["bmax"], inv_rmin),
        "sph_sbox": _boxes(slo, shi, s_inv.astype(np.float32)),
    })


def pack_tri_table(layout: TriLayout):
    """The kernel's triangle table from a TriLayout's host arrays."""
    h = layout.host
    n = h["idx"].size
    slo, shi = union_boxes(h["bmin"], h["bmax"])
    return _concat({
        "tri_v0": _rows4(h["v0"].reshape(n, 3)),
        "tri_e1": _rows4(h["e1"].reshape(n, 3)),
        "tri_e2": _rows4(h["e2"].reshape(n, 3)),
        "tri_idx": h["idx"].reshape(n),
        "tri_n": _rows4(h["n"].reshape(n, 3), h["exp"].reshape(n)),
        "tri_alb": _rows4(h["alb"].reshape(n, 3), h["kind"].reshape(n)),
        "tri_box": _boxes(h["bmin"], h["bmax"]),
        "tri_sbox": _boxes(slo, shi),
    })


def pack_light_table(lights: LightTensors, n_shapes: int):
    """The kernel's light table: the light rows and the inverse map shape →
    light index (-1: no light), over all ``n_shapes`` shapes."""
    h = lights.host
    n = lights.num_lights
    light_of = np.full(n_shapes, -1, np.int32)
    light_of[h["shape_idx"]] = np.arange(n, dtype=np.int32)
    sections = {
        "l_center": _rows4(h["center"], h["radius"]),
        "l_emit": _rows4(h["emit"]),
        "l_pick": h["pick"],
        "l_cdf": h["cdf"],
        "l_shape": h["shape_idx"],
        "light_of": light_of,
    }
    if lights.has_tris:
        sections.update({
            "l_is_tri": (h["is_tri"] > 0.5).astype(np.int32),
            "l_v0": _rows4(h["tri_v0"]),
            "l_e1": _rows4(h["tri_e1"]),
            "l_e2": _rows4(h["tri_e2"]),
            "l_n": _rows4(h["tri_n"], h["tri_area"]),
        })
    return _concat(sections)


def table_bytes(isect: Intersector, lights: Optional[LightTensors], n_shapes: int) -> int:
    """Bytes of the packed tables a launch reads (each counted once)."""
    total = 0
    if isect.mode == "scan":
        total += pack_sphere_table(isect.layout)[0].nbytes
    if isect.tri_layout is not None:
        total += pack_tri_table(isect.tri_layout)[0].nbytes
    if lights is not None:
        total += pack_light_table(lights, n_shapes)[0].nbytes
    return total


def _device_table(host: dict, dev: torch.device, pack, *what):
    """(tensor on ``dev``, offsets) of a packed table, built once and kept
    beside the host arrays it was packed from; ``what`` names whatever else
    the packing depends on."""
    key = ("table", str(dev), *what)
    if key not in host:
        buf, offsets = pack()
        host[key] = (torch.from_numpy(buf).to(dev), offsets)
    return host[key]


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load(_SOURCE)
    for fn in ("flux_scene_scene_bytes", "flux_scene_geom_bytes"):
        getattr(lib, fn).restype = ctypes.c_size_t
        getattr(lib, fn).argtypes = []
    for fn in ("flux_scene_n_counts", "flux_scene_block_sizes"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = []
    lib.flux_scene_blocks_per_sm.restype = ctypes.c_int
    lib.flux_scene_blocks_per_sm.argtypes = [ctypes.c_int] * 6
    lib.flux_scene_error_string.restype = ctypes.c_char_p
    lib.flux_scene_error_string.argtypes = [ctypes.c_int]
    lib.flux_scene_render.restype = ctypes.c_int
    lib.flux_scene_render.argtypes = [
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # counts (may be null)
        ctypes.POINTER(FluxScene),
        ctypes.POINTER(FluxGeom),
        ctypes.c_int,  # with_stats
        ctypes.c_int,  # nee
        ctypes.c_int,  # physical
        ctypes.c_int,  # n_pix
        ctypes.c_int,  # img_w
        ctypes.c_int,  # img_h
        ctypes.c_int,  # row0
        ctypes.c_int,  # row_stride
        ctypes.c_uint32,  # s0
        ctypes.c_uint32,  # n_samples
        ctypes.c_ulonglong,  # s_limit
        ctypes.c_uint32,  # seed
        ctypes.c_uint32,  # root
        ctypes.c_int,  # max_depth
        ctypes.c_int,  # split
        ctypes.c_void_p,  # stream
    ]
    if (
        lib.flux_scene_scene_bytes() != ctypes.sizeof(FluxScene)
        or lib.flux_scene_geom_bytes() != ctypes.sizeof(FluxGeom)
        or lib.flux_scene_n_counts() != N_COUNTS
        or lib.flux_scene_block_sizes() != SCAN_BLOCK * 10000 + TRI_SCAN_BLOCK * 100 + SUPER
    ):
        raise RuntimeError("FluxScene/FluxGeom layout differs between Python and CUDA")
    return lib


def tri_skip_engaged(n_tri_blocks: int) -> bool:
    """Whether the triangle skip is on by default for a table of
    ``n_tri_blocks`` blocks: at ``TRI_SKIP_ENGAGE`` blocks and above."""
    return n_tri_blocks >= TRI_SKIP_ENGAGE


def pack_geom(scene: SceneTensors, isect: Intersector, lights: Optional[LightTensors], dev, *,
              scan_skip: bool = True, tri_skip: Optional[bool] = None, two_level: bool = True):
    """The launch's FluxGeom, and the tensors its pointers point into (keep
    them alive until the launch is queued).

    The switches, read by the kernel only (the result is bit-equal either
    way): ``scan_skip`` turns the AABB skip over sphere blocks off (every
    block is folded), ``two_level`` the second level of boxes over groups of
    8 blocks; ``tri_skip`` forces the skip over triangle blocks on or off,
    and by default (None) engages it by :func:`tri_skip_engaged`."""
    geom = FluxGeom()
    keep = []

    def point(table, offsets, skip=()):
        keep.append(table)
        for name, off in offsets.items():
            if name not in skip:
                setattr(geom, name, table.data_ptr() + 4 * off)

    scan = isect.mode == "scan"
    if scan:
        if isect.layout is None:
            raise ValueError("an Intersector in scan mode needs its ScanLayout")
        point(*_device_table(isect.layout.host, dev, lambda: pack_sphere_table(isect.layout)),
              skip=() if two_level else ("sph_sbox",))
        geom.n_sph_blocks = isect.layout.n_blocks
    nt = scene.num_triangles
    if nt:
        if isect.tri_layout is None:
            raise ValueError("a scene with triangles needs the Intersector's TriLayout")
        point(*_device_table(isect.tri_layout.host, dev, lambda: pack_tri_table(isect.tri_layout)),
              skip=() if two_level else ("tri_sbox",))
        geom.n_tri_blocks = isect.tri_layout.n_blocks
    ns, npl = scene.num_spheres, scene.num_planes
    if lights is not None:
        n_shapes = ns + npl + nt
        # light_of spans the scene's shapes: one table per shape count.
        point(*_device_table(lights.host, dev, lambda: pack_light_table(lights, n_shapes), n_shapes))
        geom.n_lights = lights.num_lights
        geom.lights_have_tris = int(lights.has_tris)
    geom.scan = int(scan)
    geom.ns_base = ns
    geom.plane_row0 = 0 if scan else ns
    geom.tri_base = ns + npl
    geom.sph_skip = int(scan_skip)
    geom.tri_skip = int(tri_skip_engaged(geom.n_tri_blocks) if tri_skip is None else tri_skip)
    return geom, keep


def render_block_scene(
    scene: SceneTensors,
    cam: CameraTensors,
    row0: int,
    s0: int,
    seed: int,
    *,
    isect: Intersector,
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
    work_counts: Optional[torch.Tensor] = None,
    **skips: bool,
) -> torch.Tensor:
    """Radiance sums over samples [s0, s0+n_samples) of rows
    ``row0 + k·row_stride``, ``(n_rows, img_w, 3)`` float32 on the scene's
    device (``(n_rows, img_w, 4)`` with ``with_stats``), with the sphere
    intersection of ``isect`` (sweep or scan) and the scene's triangles.

    ``skips`` are :func:`pack_geom`'s switches (``scan_skip``, ``tri_skip``,
    ``two_level``), which change the kernel's work and not its result. On
    the card, ``work_counts`` (optional contiguous int32 ``(N_COUNTS,
    n_rows·img_w)`` tensor) receives each pixel's work counters summed over
    its samples (``COUNT_NAMES``), including the blocks a perfect skip would
    still have had to fold, from the counting instantiation, without
    ``with_stats``. The launch's plan is kept as
    ``render_block_scene.last_plan``."""
    dev = scene.device
    if not set(skips) <= _SKIPS:
        raise TypeError(f"unknown options {sorted(set(skips) - _SKIPS)}")
    if dev.type == "cpu":
        if work_counts is not None:
            raise ValueError("work_counts is counted by the CUDA kernel only")
        from ..render import render_block

        return render_block(
            scene, cam, row0, s0, seed,
            img_w=img_w, img_h=img_h, n_rows=n_rows, n_samples=n_samples, root=root,
            max_depth=max_depth, s_limit=s_limit, row_stride=row_stride, with_stats=with_stats,
            lights=lights, physical=physical, isect=isect,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if cam.eye.device != dev or (lights is not None and lights.center.device != dev):
        raise ValueError(f"camera on {cam.eye.device}, scene on {dev}")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(
            f"the scene megakernel is built for sm_90a (Hopper); {torch.cuda.get_device_name(dev)} "
            f"is sm_{''.join(map(str, torch.cuda.get_device_capability(dev)))}"
        )
    scan = isect.mode == "scan"
    if not scan and scene.num_triangles == 0:
        # Its launches would also be counted under the sweep megakernel's names.
        raise ValueError("a sweep without triangles is the sweep megakernel's launch (render_block_sweep)")
    n_pix = n_rows * img_w
    check_launch(n_pix, n_samples, root, max_depth, with_stats, work_counts is not None)
    n_ch = 4 if with_stats else 3
    out = torch.empty((n_ch, n_pix), dtype=torch.float32, device=dev)
    counts_ptr = None
    if work_counts is not None:
        if (
            work_counts.device != dev
            or work_counts.dtype != torch.int32
            or tuple(work_counts.shape) != (N_COUNTS, n_pix)
            or not work_counts.is_contiguous()
        ):
            raise ValueError(f"work_counts must be a contiguous int32 {(N_COUNTS, n_pix)} tensor on {dev}")
        counts_ptr = work_counts.data_ptr()
    lib = _library()
    packed = pack_scene(scene, cam, spheres=not scan)
    geom, keep = pack_geom(scene, isect, lights, dev, **skips)
    limit = (1 << 32) if s_limit is None else int(s_limit) & MASK
    plan = plan_launch(lib.flux_scene_blocks_per_sm, dev, n_pix, n_samples, with_stats, lights is not None,
                       physical, work_counts is not None, max_depth)
    with torch.cuda.device(dev):
        err = lib.flux_scene_render(
            out.data_ptr(), counts_ptr, ctypes.byref(packed), ctypes.byref(geom), int(with_stats),
            int(lights is not None), int(physical), n_pix, img_w, img_h, int(row0), int(row_stride),
            int(s0) & MASK, int(n_samples), limit, int(seed) & MASK, int(root), int(max_depth),
            plan.split, torch.cuda.current_stream(dev).cuda_stream,
        )
    del keep  # the tables stay cached beside their layouts
    if err != 0:
        raise RuntimeError(
            f"scene megakernel launch failed: CUDA error {err} "
            f"({lib.flux_scene_error_string(err).decode()})"
        )
    name = config_name(isect.mode, scene.num_triangles > 0, with_stats, lights is not None, physical,
                       tri_lights=lights is not None and lights.has_tris)
    render_block_scene.launches[name] += 1
    render_block_scene.last_plan = plan
    return out.t().reshape(n_rows, img_w, n_ch)


# Kernel launches by configuration (config_name, e.g. "scan+nee" or
# "sweep+tri+nee+trilight+physical") since the count was last cleared.
render_block_scene.launches = collections.Counter()
render_block_scene.last_plan = None


# float32 operations per unit of work, counted from csrc/scene_megakernel.cu
# and csrc/flux_trace.cuh with the conventions of
# sweep_kernel.flops_lower_bound (add, sub, mul, div and sqrt count one each;
# compares, selects, min and max are not counted).
_OPS_PER_TRIANGLE_TEST = 46  # two cross products, the determinant, 1/det, s, u, v, t, u + v
_OPS_PER_BOX_TEST = 12  # six slab values (a subtract and a multiply each); the ten min/max not counted
_OPS_PER_RAY_INVERSE = 3  # 1/d per nearest or shadow fold
# The triangle light sample: the barycentric fold and point (14), the
# direction and its length (13), cos θ_l (5), the weight (9) and the density
# (3); against 123 for the cone sample it replaces.
_OPS_PER_TRI_LIGHT_SAMPLE = 44
_OPS_PER_TRI_REVERSE_DENSITY = 9  # cos θ_l, pick·t², A·cosθ_l, the quotient


def flops_lower_bound(scene: SceneTensors, isect: Intersector, n_samples: int, counts: dict, *,
                      with_stats: bool = False, physical: bool = False,
                      tri_light_fraction: float = 0.0) -> int:
    """A lower bound on the kernel's float32 operations for a launch that
    traced ``n_samples`` samples, from its work counters summed over the
    band (``counts`` by ``COUNT_NAMES``).

    Everything but the geometry is charged as the sweep megakernel's bound
    charges it. The geometry is charged what a perfect skip would still
    do: every sphere (triangle) of each block whose box a ray enters at or
    before its final hit, and one box test for each such block; in sweep
    mode every sphere for every bounce. ``tri_light_fraction`` is the share
    of the light set's pick probability that lies on triangle lights: those
    samples are charged the cheaper triangle sample."""
    from . import sweep_kernel as sk

    base = sk.flops_lower_bound(
        scene, n_samples, counts["bounces"], with_stats=with_stats, physical=physical,
        light_samples=0, shadow_rays=0, reverse_densities=0, glossy_lobes=counts["glossy_lobes"],
    )
    if isect.mode == "scan":  # the spheres are charged by blocks below, not per bounce
        base -= counts["bounces"] * scene.num_spheres * sk._OPS_PER_SPHERE_TEST
    cone = sk._OPS_PER_LIGHT_SAMPLE
    tri_sample = cone - 123 + _OPS_PER_TRI_LIGHT_SAMPLE
    f = tri_light_fraction
    contrib = sk._OPS_PER_SHADOW_CONTRIB + (sk._OPS_PER_SHADOW_CONTRIB_MIS if physical else 0)
    shadow_planes = max(scene.num_planes - 1, 0) * sk._OPS_PER_PLANE_TEST
    shadow_spheres = max(scene.num_spheres - 1, 0) * sk._OPS_PER_SPHERE_TEST if isect.mode == "sweep" else 0
    return int(
        base
        + counts["light_samples"] * ((1.0 - f) * cone + f * tri_sample)
        + counts["shadow_rays"] * (contrib + shadow_planes + shadow_spheres)
        + counts["reverse_densities"] * ((1.0 - f) * sk._OPS_PER_REVERSE_DENSITY + f * _OPS_PER_TRI_REVERSE_DENSITY)
        + counts["sphere_blocks_needed"] * (SCAN_BLOCK * sk._OPS_PER_SPHERE_TEST + _OPS_PER_BOX_TEST)
        + counts["tri_blocks_needed"] * (TRI_SCAN_BLOCK * _OPS_PER_TRIANGLE_TEST + _OPS_PER_BOX_TEST)
        + (counts["bounces"] + counts["shadow_folds"]) * _OPS_PER_RAY_INVERSE
    )

