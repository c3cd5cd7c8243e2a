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
``<STATS, NEE, PHYSICAL>`` and the geometry policy, which the library picks
per launch from the packed :class:`FluxGeom`: in sweep mode, where no shadow
ray would walk the triangle skip and the triangle table fits the kernel's
shared-memory stage, a policy without the scan's walk that folds a light
sample's shadow ray beside the next bounce's ray. The
source's header says what bounds it on the H100 and how its design meets
that.

What this module does on the host, once per layout and light set: it packs
the :class:`ScanLayout` (with the binary tree of boxes over runs of
``SCAN_LEAF`` of its spheres, see :func:`sphere_tree`), more than
``MAX_PLANES`` planes, the :class:`TriLayout` (with the tree of boxes over its
blocks and the lists of triangles by ray direction, see :func:`tri_bins`) and
the light set into one float32 device buffer each (rows of 4 floats), and
keeps the buffer beside the host arrays it was packed from.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..camera import CameraTensors
from ..metrics import span
from ..samplers.hash import MASK
from ..scene import SceneTensors
from . import build
from .intersect import SCAN_BLOCK, TRI_SCAN_BLOCK, Intersector, ScanLayout, TriLayout, _block_boxes
from .nee import LightTensors
from .sweep_kernel import COUNT_NAMES as TRACER_COUNT_NAMES
from .sweep_kernel import MAX_PLANES, FluxScene, check_launch, check_split, pack_scene, plan_launch

__all__ = [
    "render_block_scene",
    "send_records",
    "FluxGeom",
    "declare",
    "config_name",
    "launch_config",
    "pack_sphere_table",
    "pack_plane_table",
    "pack_tri_table",
    "pack_light_table",
    "sphere_tree",
    "tri_bins",
    "COUNT_NAMES",
    "N_COUNTS",
    "SCAN_LEAF",
    "TRI_RCAP",
    "BIN_GRIDS",
    "BIN_TESTS",
    "TRI_SKIP_ENGAGE",
    "tri_skip_engaged",
    "flops_lower_bound",
    "table_bytes",
]

SCAN_LEAF = 16  # spheres under one leaf of the sphere tree (FLUX_SCAN_LEAF)
# Triangles whose R = |d|·|e1|·|e2| / |d·(e1 × e2)| for a ray exceeds this are
# folded apart from the tree, by the ray's direction; the tree's boxes are
# widened to hold the hits of the others (csrc/scan_walk.cuh; at most 2^13,
# for the kernel's rounding slack). 256 against 1024 on an NVIDIA H100 80GB
# HBM3 at 700 W: a quarter of the widening, four times the triangles folded
# apart, the triangle fold's rows 4-6% faster (PERF.md, the design steps).
TRI_RCAP = 256
# The direction lists' grids, finest first, and the (bin, triangle) pairs
# that building them may test: the first grid that keeps within it is taken
# (tri_bins). A finer grid shortens the lists a ray reads, and costs the host
# time in proportion to those pairs. On an NVIDIA H100 80GB HBM3 at 700 W and
# its host (chip_smoke.py phase 14, icosphere(5), K6's launch): 13-20 ns a
# pair; grids 16 / 32 / 64 / 128 pack in 0.31 / 0.89 / 3.7 / 13.4 s and run
# 11.36 / 9.87 / 8.76 / 7.59 ms. The budget keeps a table's pack near a
# second: mesh1280 takes 128, icosphere(4) 64, icosphere(5) 32.
BIN_GRIDS = (128, 64, 32, 16, 8)
BIN_TESTS = 1 << 26
# The kernel's counters per pixel, in order (csrc/scan_walk.cuh): the
# tracer's (work, then the cycles of each phase of a bounce), then the
# geometry's: sphere blocks of nearest folds (needed, walk units entered:
# tree leaves or blocks, box tests), triangle blocks of all folds, shadow
# folds, sphere blocks of shadow folds, the tree leaves needed and the
# spheres tested (nearest, shadow); and the cycles of sphere box tests and
# folds inside clk_nearest and clk_shadow, and of the counting launch's own
# passes for the *_needed counters (inside clk_nearest, clk_shadow); then the
# triangle blocks needed by shadow rays (part of tri_blocks_needed), the
# triangles those blocks hold without their padding (all rays, shadow rays;
# one for a shadow ray a triangle stopped) and the shadow folds a sphere of
# the scan stopped; then the triangles the direction lists offered and those
# of them folded, and the cycles of the triangle tree's box tests, its
# leaves' folds and the lists.
COUNT_NAMES = TRACER_COUNT_NAMES + (
    "sphere_blocks_needed", "sphere_blocks_entered", "sphere_box_tests",
    "tri_blocks_needed", "tri_blocks_entered", "tri_box_tests", "shadow_folds",
    "shadow_sphere_blocks_needed", "shadow_sphere_blocks_entered", "shadow_sphere_box_tests",
    "sphere_leaves_needed", "shadow_sphere_leaves_needed", "sphere_tests", "shadow_sphere_tests",
    "clk_sphere_boxes", "clk_sphere_folds", "clk_shadow_sphere_boxes", "clk_shadow_sphere_folds",
    "clk_needed_walk", "clk_shadow_needed_walk",
    "shadow_tri_blocks_needed", "tris_needed", "shadow_tris_needed", "shadow_sphere_stops",
    "tri_candidates", "tri_exceptions", "clk_tri_boxes", "clk_tri_folds", "clk_tri_exceptions",
)
N_COUNTS = len(COUNT_NAMES)
# The triangle skip is engaged from this many triangle blocks on; below it
# the launch folds every block (flux_tpu's rule, pallas_kernel.py:1177-1178).
# The threshold was measured on an NVIDIA H100 80GB HBM3 at 700 W
# (chip_smoke.py phase 14, ms with the skip on / off, the tree over the
# blocks): a mesh of 2 blocks at 16 spp 0.376 / 0.380, 5 blocks 0.577 /
# 0.762, 8 blocks 0.646 / 1.106, 20 blocks 1.019 / 2.646, 80 blocks 1.931 /
# 8.980; the Cornell box's 3 blocks at 1024 spp with NEE 51.24 / 25.22 (in a
# closed room every ray enters every box, and the skip's shadow ray has a
# fold of its own). The skip wins from 5 blocks and ties at 2.
TRI_SKIP_ENGAGE = 4
_SOURCE = "scene_megakernel"
_SKIPS = {"scan_skip", "tri_skip", "two_level"}  # pack_geom's measurement switches

_POINTERS = (
    "sph_geo", "sph_idx", "sph_mat", "sph_alb", "sph_box", "sph_tree", "pl_point", "pl_normal", "pl_alb",
    "tri_v0", "tri_e1", "tri_e2", "tri_idx", "tri_n", "tri_alb", "tri_tree", "tri_bin_off", "tri_cand",
    "l_center", "l_emit", "l_pick", "l_cdf", "l_shape", "l_is_tri", "l_v0", "l_e1", "l_e2", "l_n",
    "light_of",
)
_INTS = (
    "n_sph_blocks", "sph_block_leaves", "n_planes", "n_tri_blocks", "tri_block_leaves", "tri_bin_grid", "scan",
    "ns_base", "plane_row0", "tri_base", "sph_walk", "tri_skip", "n_lights", "lights_have_tris",
)


class FluxGeom(ctypes.Structure):
    """The kernel's launch parameters (``struct FluxGeom``): device pointers
    into the packed tables, then the launch-uniform choices."""

    _fields_ = ([(k, ctypes.c_void_p) for k in _POINTERS] + [(k, ctypes.c_int) for k in _INTS]
                + [("tri_rcap", ctypes.c_float)])


def config_name(accel: str, tris: bool, with_stats: bool, nee: bool, physical: bool,
                tri_lights: bool = False) -> str:
    """The name a launch is counted under: ``scan`` or ``sweep``, ``+tri``
    with triangles, then ``+nee`` (``+trilight`` where the light set has a
    triangle), ``+physical`` and ``+stats`` as the sweep megakernel names
    them."""
    return (accel + "+tri" * tris + "+nee" * nee + "+trilight" * (nee and tri_lights)
            + "+physical" * physical + "+stats" * with_stats)


def launch_config(scene: SceneTensors, isect: Intersector, with_stats: bool, lights: Optional[LightTensors],
                  physical: bool) -> str:
    """The configuration a launch of :func:`render_block_scene` is counted
    under: ``scan…`` for an intersector that scans (``"scan"`` or
    ``"scan_carry"``: the kernel's scan carries the winner's record, as
    ``flux_tpu``'s Pallas body does under either), ``sweep…`` otherwise."""
    return config_name("scan" if isect.scans else "sweep", scene.num_triangles > 0, with_stats,
                       lights is not None, physical, tri_lights=lights is not None and lights.has_tris)


def _rows4(*cols) -> np.ndarray:
    """(N, 4) float32 rows from columns of width 1 or 3; int32 columns ride
    as their bits; missing width is zero."""
    n = cols[0].shape[0]
    out = np.zeros((n, 4), np.float32)
    if n == 0:
        return out
    c = 0
    for col in cols:
        col = np.asarray(col)
        if col.dtype == np.int32:
            col = col.view(np.float32)
        col = col.reshape(n, -1)
        out[:, c:c + col.shape[1]] = col
        c += col.shape[1]
    return out


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


def sphere_tree(leaf_box: np.ndarray) -> np.ndarray:
    """The binary tree of boxes over runs of a sphere table's entries,
    ``(2L - 1, 2, 4)`` float32 for ``L`` leaves (the runs up to a power of
    two): node ``i``'s children are ``2i + 1`` and ``2i + 2``, the leaves
    ``L - 1 + k`` are the runs' boxes ``leaf_box`` (``(n, 2, 4)``, lo.w
    1 / r_min) in table order, then empty (NaN) boxes. A node's box is the
    union of its children's, ignoring empty ones (empty where both are), its
    lo.w the largest 1 / r_min below it, and its hi.w, as int32 bits, the
    axis on which its children's centers lie farthest apart (bits 0-1) and
    whether the second child is the lower one there (bit 2): the kernel
    visits the child nearer along that axis first."""
    nb = leaf_box.shape[0]
    n_leaves = 1 << max(nb - 1, 0).bit_length()
    tree = np.full((2 * n_leaves - 1, 2, 4), np.nan, np.float32)
    tree[n_leaves - 1:n_leaves - 1 + nb] = leaf_box
    tree[:, 1, 3] = 0.0
    level = n_leaves - 1  # the first node of the level whose parents are filled next
    while level > 0:
        parents = np.arange((level - 1) // 2, level)
        kids = tree[2 * parents + 1], tree[2 * parents + 2]
        tree[parents, 0] = np.fmin(kids[0][:, 0], kids[1][:, 0])
        tree[parents, 1, :3] = np.fmax(kids[0][:, 1, :3], kids[1][:, 1, :3])
        tree[parents, 0, 3] = np.fmax(kids[0][:, 0, 3], kids[1][:, 0, 3])
        centers = [(k[:, 0, :3] + k[:, 1, :3]) * np.float32(0.5) for k in kids]
        gap = np.nan_to_num(centers[1] - centers[0])
        axis = np.argmax(np.abs(gap), axis=1)
        second_lower = gap[np.arange(len(parents)), axis] < 0
        tree[parents, 1, 3] = (axis | second_lower.astype(np.int64) << 2).astype(np.int32).view(np.float32)
        level = (level - 1) // 2
    tree[:, 0, 3] = np.nan_to_num(tree[:, 0, 3])
    return tree


def _run_boxes(h: dict, run: int) -> np.ndarray:
    """(n, 2, 4) boxes of the table's runs of ``run`` entries, as
    scan_layout computes each block's (a run of 32), with 1 / (the least
    radius of the run's real spheres) in lo.w (0 for a run of padding): the
    slab test widens a box by the sphere test's error, which grows as 1/r."""
    n = h["idx"].size // run
    ctr, rad, idx = h["ctr"].reshape(n, run, 3), h["rad"].reshape(n, run), h["idx"].reshape(n, run)
    real = idx >= 0
    r3 = rad[..., None]
    bmin, bmax = _block_boxes(ctr - r3, ctr + r3, real[..., None])
    inv_r = np.where(real, np.float32(1.0) / rad, np.float32(np.nan))
    inv_rmin = np.fmax.reduce(inv_r, axis=1).astype(np.float32)
    return _boxes(bmin, bmax, np.where(np.isnan(inv_rmin), np.float32(0.0), inv_rmin))


def pack_sphere_table(layout: ScanLayout):
    """The kernel's sphere table from a ScanLayout's host arrays: the
    spheres by block, each block's box and the tree of boxes over runs of
    ``SCAN_LEAF`` spheres."""
    h = layout.host
    n = h["idx"].size
    return _concat({
        "sph_geo": _rows4(h["ctr"].reshape(n, 3), h["rad"].reshape(n)),
        "sph_idx": h["idx"].reshape(n),
        "sph_mat": _rows4(h["inv_r"].reshape(n), h["exp"].reshape(n), h["kind"].reshape(n)),
        "sph_alb": _rows4(h["alb"].reshape(n, 3)),
        "sph_box": _run_boxes(h, SCAN_BLOCK),
        "sph_tree": sphere_tree(_run_boxes(h, SCAN_LEAF)),
    })


def pack_plane_table(scene: SceneTensors, sweep: bool):
    """The kernel's plane table: point; normal as authored and exponent;
    albedo (color × param) and kind. The exponent is the one the plain
    version's intersection gives the hit: in sweep mode with the two low
    mantissa bits clear (where the sweep packs the kind), in scan mode as
    authored."""
    h = scene.host
    rows = slice(scene.num_spheres, scene.num_spheres + scene.num_planes)
    exp = h["mat_exp"][rows]
    if sweep:
        exp = (exp.view(np.uint32) & np.uint32(0xFFFFFFFC)).view(np.float32)
    return _concat({
        "pl_point": _rows4(h["plane_point"]),
        "pl_normal": _rows4(h["plane_normal"], exp),
        "pl_alb": _rows4((h["mat_color"] * h["mat_param"][:, None])[rows],
                         h["mat_kind"][rows].astype(np.int32)),
    })


def _cube_cells(grid: int):
    """Each direction bin's center (unit, float64) and the largest chord from
    it to a direction of its cell, for the ``3·grid²`` cells of the cube
    faces (csrc/scene_geom.cuh::tri_bin): face ``f``'s cell ``(i, j)`` holds
    the directions whose largest component is the ``f``-th, with the other
    two over it in ``[-1 + 2i/grid, -1 + 2(i + 1)/grid]`` and the same for
    ``j``, up to sign. A cell is convex on the sphere, so its farthest
    direction from the center is a corner."""
    edge = np.linspace(-1.0, 1.0, grid + 1)
    mid = (edge[:-1] + edge[1:]) / 2

    def unit(f, a, b):
        one = np.ones_like(a)
        v = np.stack([(one, a, b), (a, one, b), (a, b, one)][f], axis=-1)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    centers, chords = [], []
    for f in range(3):
        a, b = np.meshgrid(mid, mid, indexing="ij")
        c = unit(f, a, b)
        chord = np.zeros(a.shape)
        for da in (0, 1):
            for db in (0, 1):
                ca, cb = np.meshgrid(edge[da:grid + da], edge[db:grid + db], indexing="ij")
                chord = np.maximum(chord, np.linalg.norm(unit(f, ca, cb) - c, axis=-1))
        centers.append(c.reshape(-1, 3))
        chords.append(chord.reshape(-1))
    return np.concatenate(centers), np.concatenate(chords)


def tri_bins(layout: TriLayout, grid: Optional[int] = None):
    """The lists of triangles a ray may run nearly parallel to, by its
    direction's bin: ``(offsets, candidates, grid, rcap)``, ``offsets``
    int32 of ``3·grid² + 1`` (bin ``k``'s candidates are ``[offsets[k],
    offsets[k + 1])``), ``candidates`` (n, 4) float32 rows: ``w = N · rcap /
    (|e1|·|e2|)`` (``N = e1 × e2``; 0 for a degenerate triangle) and the
    table slot as int32 bits, ``rcap`` the TRI_RCAP they were built for. A
    triangle's R for a ray is above ``rcap`` exactly when ``|w·d| < |d|``;
    bin ``k`` lists every triangle for which that can hold for a direction
    of the cell, ``|w·c| <= 1.01 + |w|·(chord + 1e-5)`` at its center ``c``,
    with room for rounding in the kernel's test and in its choice of the bin
    (an ulp or two of the quotients it bins by). Every (bin, triangle) pair
    is tested, so ``grid`` by default is the first of ``BIN_GRIDS`` at which
    the table's triangles times the bins stay within ``BIN_TESTS`` (the last
    one otherwise). Built once per layout and kept in its host dict; a
    layout whose lists are built at one grid takes no other."""
    h = layout.host
    if "tri_bins" in h:
        if grid is not None and grid != h["tri_bins"][2]:
            raise ValueError(f"the layout's lists are built at grid {h['tri_bins'][2]}, not {grid}")
        return h["tri_bins"]
    n = h["idx"].size
    e1, e2 = (h[k].reshape(n, 3).astype(np.float64) for k in ("e1", "e2"))
    slots = np.flatnonzero(h["idx"].reshape(n) >= 0)
    nrm = np.cross(e1[slots], e2[slots])
    scale = np.linalg.norm(e1[slots], axis=1) * np.linalg.norm(e2[slots], axis=1)
    rcap = TRI_RCAP
    if not 1 <= rcap <= 1 << 13:
        raise ValueError(f"TRI_RCAP {rcap} outside [1, 2^13]")
    with np.errstate(invalid="ignore", divide="ignore"):
        w = np.where(scale[:, None] > 0, nrm * (rcap / scale)[:, None], 0.0)
    w = np.nan_to_num(w).astype(np.float32)  # the kernel tests the rounded rows
    wlen = np.linalg.norm(w.astype(np.float64), axis=1).astype(np.float32)
    if grid is None:
        grid = next((g for g in BIN_GRIDS if len(slots) * 3 * g * g <= BIN_TESTS), BIN_GRIDS[-1])
    centers, chords = _cube_cells(grid)
    # In float32: the dot's rounding (3 ulp of |w|) is well inside |w|·1e-5.
    centers_t, reach = centers.T.astype(np.float32), (chords + 1e-5).astype(np.float32)
    pairs, step = [], max(16, (1 << 22) // len(centers))
    for k0 in range(0, len(slots), step):
        k1 = min(k0 + step, len(slots))
        near = np.abs(w[k0:k1] @ centers_t) <= np.float32(1.01) + wlen[k0:k1, None] * reach
        tri, cell = np.nonzero(near)
        pairs.append(np.stack([cell, tri + k0], axis=1))
    pairs = np.concatenate(pairs) if pairs else np.zeros((0, 2), np.int64)
    pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    offsets = np.zeros(len(centers) + 1, np.int32)
    np.cumsum(np.bincount(pairs[:, 0], minlength=len(centers)), out=offsets[1:])
    tri = pairs[:, 1]
    h["tri_bins"] = (offsets, _rows4(w[tri], slots[tri].astype(np.int32)), grid, rcap)
    return h["tri_bins"]


def pack_tri_table(layout: TriLayout):
    """The kernel's triangle table from a TriLayout's host arrays: the
    triangles by block, the binary tree of boxes whose leaves are the
    blocks' boxes (built as :func:`sphere_tree` builds the spheres'; lo.w 0),
    and the lists of :func:`tri_bins`."""
    h = layout.host
    n = h["idx"].size
    offsets, cand, _, _ = tri_bins(layout)
    return _concat({
        "tri_v0": _rows4(h["v0"].reshape(n, 3)),
        "tri_e1": _rows4(h["e1"].reshape(n, 3)),
        "tri_e2": _rows4(h["e2"].reshape(n, 3)),
        "tri_idx": h["idx"].reshape(n),
        "tri_n": _rows4(h["n"].reshape(n, 3), h["exp"].reshape(n)),
        "tri_alb": _rows4(h["alb"].reshape(n, 3), h["kind"].reshape(n)),
        "tri_tree": sphere_tree(_boxes(h["bmin"], h["bmax"])),
        "tri_bin_off": offsets,
        "tri_cand": cand,
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


def table_bytes(isect: Intersector, lights: Optional[LightTensors], n_shapes: int,
                scene: Optional[SceneTensors] = None) -> int:
    """Bytes of the packed tables a launch reads (each counted once), with
    ``scene`` its plane table (more than ``MAX_PLANES`` planes)."""
    total = 0
    if scene is not None and scene.num_planes > MAX_PLANES:
        total += pack_plane_table(scene, not isect.scans)[0].nbytes
    if isect.scans:
        total += pack_sphere_table(isect.layout)[0].nbytes
    if isect.tri_layout is not None:
        total += pack_tri_table(isect.tri_layout)[0].nbytes
    if lights is not None:
        total += pack_light_table(lights, n_shapes)[0].nbytes
    return total


def _device_table(host: dict, dev: torch.device, table: str, pack, *what):
    """(tensor on ``dev``, offsets) of a packed table, built once and kept
    beside the host arrays it was packed from; ``what`` names whatever else
    the packing depends on. A build is the span ``kernel.pack_tables``,
    with ``table`` as its attribute."""
    key = ("table", str(dev), *what)
    if key not in host:
        with span("kernel.pack_tables") as sp:
            sp.set("table", table)
            buf, offsets = pack()
            host[key] = (torch.from_numpy(buf).to(dev), offsets)
    return host[key]


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = declare(build.load(_SOURCE))
    if lib.flux_scene_scan_leaf() != SCAN_LEAF:
        raise RuntimeError("the sphere tree's leaf differs between Python and CUDA")
    return lib


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signatures of a loaded scene kernel library and checks
    that its FluxScene, FluxGeom and counters match this module's."""
    for fn in ("flux_scene_scene_bytes", "flux_scene_geom_bytes"):
        getattr(lib, fn).restype = ctypes.c_size_t
        getattr(lib, fn).argtypes = []
    for fn in ("flux_scene_n_counts", "flux_scene_block_sizes"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = []
    lib.flux_scene_blocks_per_sm.restype = ctypes.c_int
    lib.flux_scene_blocks_per_sm.argtypes = [ctypes.POINTER(FluxGeom)] + [ctypes.c_int] * 6
    lib.flux_scene_error_string.restype = ctypes.c_char_p
    lib.flux_scene_error_string.argtypes = [ctypes.c_int]
    lib.flux_scene_upload.restype = ctypes.c_int
    lib.flux_scene_upload.argtypes = [ctypes.POINTER(FluxScene), ctypes.c_void_p]  # scene, stream
    lib.flux_scene_render.restype = ctypes.c_int
    lib.flux_scene_render.argtypes = [
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # counts (may be null)
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
    lib.flux_scene_scan_leaf.restype = ctypes.c_int
    lib.flux_scene_scan_leaf.argtypes = []
    if (
        lib.flux_scene_scene_bytes() != ctypes.sizeof(FluxScene)
        or lib.flux_scene_geom_bytes() != ctypes.sizeof(FluxGeom)
        or lib.flux_scene_n_counts() != N_COUNTS
        or lib.flux_scene_block_sizes() != SCAN_BLOCK * 10000 + TRI_SCAN_BLOCK * 100
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
    block is folded), ``two_level`` the levels of boxes above the sphere
    blocks (the sphere tree): without them each block's box is tested;
    ``tri_skip`` forces the skip over triangle blocks (their tree, and the
    triangles folded apart by the ray's direction) on or off, and by default
    (None) engages it by :func:`tri_skip_engaged`."""
    geom = FluxGeom()
    keep = []

    def point(table, offsets, skip=()):
        keep.append(table)
        for name, off in offsets.items():
            if name not in skip:
                setattr(geom, name, table.data_ptr() + 4 * off)

    scan = isect.scans
    if scan:
        if isect.layout is None:
            raise ValueError("an Intersector in scan mode needs its ScanLayout")
        point(*_device_table(isect.layout.host, dev, "spheres", lambda: pack_sphere_table(isect.layout)))
        geom.n_sph_blocks = isect.layout.n_blocks
        geom.sph_block_leaves = 1 << max(isect.layout.n_blocks - 1, 0).bit_length()
    if scene.num_planes > MAX_PLANES:  # else they ride in the constant record
        point(*_device_table(scene.host, dev, "planes", lambda: pack_plane_table(scene, not scan), "planes", scan))
    nt = scene.num_triangles
    if nt:
        if isect.tri_layout is None:
            raise ValueError("a scene with triangles needs the Intersector's TriLayout")
        point(*_device_table(isect.tri_layout.host, dev, "triangles", lambda: pack_tri_table(isect.tri_layout)))
        geom.n_tri_blocks = isect.tri_layout.n_blocks
        geom.tri_block_leaves = 1 << max(isect.tri_layout.n_blocks - 1, 0).bit_length()
        _, _, geom.tri_bin_grid, rcap = tri_bins(isect.tri_layout)
        geom.tri_rcap = rcap
    ns, npl = scene.num_spheres, scene.num_planes
    if lights is not None:
        n_shapes = ns + npl + nt
        # light_of spans the scene's shapes: one table per shape count.
        point(*_device_table(lights.host, dev, "lights", lambda: pack_light_table(lights, n_shapes), n_shapes))
        geom.n_lights = lights.num_lights
        geom.lights_have_tris = int(lights.has_tris)
    geom.scan = int(scan)
    geom.n_planes = npl
    geom.ns_base = ns
    geom.plane_row0 = 0 if scan else ns
    geom.tri_base = ns + npl
    geom.sph_walk = 0 if not scan_skip else 2 if two_level else 1
    geom.tri_skip = int(tri_skip_engaged(geom.n_tri_blocks) if tri_skip is None else tri_skip)
    return geom, keep


def send_records(lib, device: int, stream, scene: FluxScene, sent: build.SentRecords = build.SENT) -> bool:
    """Upload the scene record on ``stream`` where ``lib``'s ``__constant__``
    memory on ``device`` does not hold it yet
    (:class:`~flux_tpu_torch.ops.build.SentRecords`); True where it was
    sent. Call under ``build.LAUNCH_LOCK``."""
    return sent.send(lib, device, stream, {"scene": bytes(scene)},
                     lambda names: lib.flux_scene_upload(ctypes.byref(scene), stream.cuda_stream))


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
    split: Optional[int] = None,
    **skips: bool,
) -> torch.Tensor:
    """Radiance sums over samples [s0, s0+n_samples) of rows
    ``row0 + k·row_stride``, ``(n_rows, img_w, 3)`` float32 on the scene's
    device (``(n_rows, img_w, 4)`` with ``with_stats``), with the sphere
    intersection of ``isect`` (sweep or scan) and the scene's triangles.

    ``skips`` are :func:`pack_geom`'s switches (``scan_skip``, ``tri_skip``,
    ``two_level``), which change the kernel's work and not its result.
    ``split`` is as for :func:`~flux_tpu_torch.ops.sweep_kernel.render_block_sweep`.
    On
    the card, ``work_counts`` (optional contiguous int32 ``(N_COUNTS,
    n_rows·img_w)`` tensor) receives each pixel's work counters summed over
    its samples (``COUNT_NAMES``), including the blocks a perfect skip would
    still have had to fold, from the counting instantiation, without
    ``with_stats``. The launch's plan is kept as
    ``render_block_scene.last_plan``, and whether it uploaded the scene
    record (:func:`send_records`) as ``render_block_scene.last_uploaded``.
    The launch is queued on the device's current stream."""
    dev = scene.device
    check_split(split)
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
    scan = isect.scans
    if not scan and scene.num_triangles == 0 and scene.num_planes <= MAX_PLANES:
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
    packed = pack_scene(scene, cam, spheres=not scan, planes=scene.num_planes <= MAX_PLANES)
    geom, keep = pack_geom(scene, isect, lights, dev, **skips)
    limit = (1 << 32) if s_limit is None else int(s_limit) & MASK
    plan = plan_launch(functools.partial(lib.flux_scene_blocks_per_sm, ctypes.byref(geom)), dev, n_pix, n_samples,
                       with_stats, lights is not None, physical, work_counts is not None, max_depth, split)
    name = launch_config(scene, isect, with_stats, lights, physical)
    with build.LAUNCH_LOCK, torch.cuda.device(dev):
        index, stream = torch.cuda.current_device(), torch.cuda.current_stream(dev)
        uploaded = send_records(lib, index, stream, packed)
        err = lib.flux_scene_render(
            out.data_ptr(), counts_ptr, ctypes.byref(geom), int(with_stats), int(lights is not None),
            int(physical), n_pix, img_w, img_h, int(row0), int(row_stride), int(s0) & MASK, int(n_samples),
            limit, int(seed) & MASK, int(root), int(max_depth), plan.split, stream.cuda_stream,
        )
        if err == 0:
            build.SENT.launched(lib, index, stream)
            # The tables stay cached beside their layouts, and may have been
            # made on another stream: none is freed under this launch.
            for table in keep:
                table.record_stream(stream)
            render_block_scene.launches[name] += 1
            render_block_scene.last_plan = plan
            render_block_scene.last_uploaded = uploaded
    del keep
    if err != 0:
        raise RuntimeError(
            f"scene megakernel launch failed: CUDA error {err} "
            f"({lib.flux_scene_error_string(err).decode()})"
        )
    return out.t().reshape(n_rows, img_w, n_ch)


# Kernel launches by configuration (config_name, e.g. "scan+nee" or
# "sweep+tri+nee+trilight+physical") since the count was last cleared.
render_block_scene.launches = collections.Counter()
render_block_scene.last_plan = None
render_block_scene.last_uploaded = None


# float32 operations per unit of work, counted from csrc/scene_megakernel.cu
# and csrc/flux_trace.cuh with the conventions of
# sweep_kernel.flops_lower_bound (add, sub, mul, div and sqrt count one each;
# compares, selects, min and max are not counted).
_OPS_PER_TRIANGLE_TEST = 46  # two cross products, the determinant, 1/det, s, u, v, t, u + v
_OPS_PER_BOX_TEST = 12  # six slab values (a subtract and a multiply each); the ten min/max not counted
# Of these, what depends on the ray's origin alone (a triangle's s = o - v0,
# q = s × e1 and e2·q; a box's six lo - o, hi - o): a shadow ray shares it
# with the next bounce's ray, which leaves the same point.
_OPS_PER_TRIANGLE_ORIGIN = 17
_OPS_PER_BOX_ORIGIN = 6
_OPS_PER_RAY_INVERSE = 3  # 1/d per nearest or shadow fold
# The triangle light sample: the barycentric fold and point (14), the
# direction and its length (13), cos θ_l (5), the weight (9) and the density
# (3); against 123 for the cone sample it replaces.
_OPS_PER_TRI_LIGHT_SAMPLE = 44
_OPS_PER_TRI_REVERSE_DENSITY = 9  # cos θ_l, pick·t², A·cosθ_l, the quotient


def flops_lower_bound(scene: SceneTensors, isect: Intersector, n_samples: int, counts: dict, *,
                      with_stats: bool = False, physical: bool = False,
                      tri_light_fraction: float = 0.0, by_blocks: bool = False,
                      separate_folds: bool = False) -> int:
    """A lower bound on the kernel's float32 operations for a launch that
    traced ``n_samples`` samples, from its work counters summed over the
    band (``counts`` by ``COUNT_NAMES``).

    Everything but the geometry is charged as the sweep megakernel's bound
    charges it. The geometry is charged what a perfect skip over the
    table's finest boxes would still do: one box test for each leaf of the
    sphere tree (``SCAN_LEAF`` spheres; with ``by_blocks``, each block of
    32, the rule before the tree) and each triangle block whose box a ray
    enters at or before its final hit (a shadow ray that came through:
    before its far end), and a test of every sphere of the leaf and every
    triangle of the block, padding left out; one box and one shape test for
    a shadow ray the scan's spheres or a triangle stopped; in sweep mode
    every sphere for every bounce. A shadow ray leaves the point the next
    bounce's ray leaves, so it is charged only the part of each test that
    depends on its direction (``_OPS_PER_*_ORIGIN`` less), as the sweep
    megakernel's bound charges it; ``separate_folds`` charges it every test
    in full and every block with 16 triangles, the rule before the shadow
    ray was folded beside the next bounce's ray, for comparison.
    ``tri_light_fraction`` is the share of the light set's pick probability
    that lies on triangle lights: those samples are charged the cheaper
    triangle sample."""
    from . import sweep_kernel as sk

    unit, size = ("blocks", SCAN_BLOCK) if by_blocks else ("leaves", SCAN_LEAF)
    c = counts
    base = sk.flops_lower_bound(
        scene, n_samples, c["bounces"], with_stats=with_stats, physical=physical,
        light_samples=0, shadow_rays=0, reverse_densities=0, glossy_lobes=c["glossy_lobes"],
    )
    if isect.scans:  # the spheres are charged by leaves below, not per bounce
        base -= c["bounces"] * scene.num_spheres * sk._OPS_PER_SPHERE_TEST
    shared = 0 if separate_folds else 1
    sphere_sh = sk._OPS_PER_SPHERE_TEST - shared * sk._OPS_PER_SPHERE_ORIGIN
    plane_sh = sk._OPS_PER_PLANE_TEST - shared * sk._OPS_PER_PLANE_ORIGIN
    tri_sh = _OPS_PER_TRIANGLE_TEST - shared * _OPS_PER_TRIANGLE_ORIGIN
    box_sh = _OPS_PER_BOX_TEST - shared * _OPS_PER_BOX_ORIGIN
    cone = sk._OPS_PER_LIGHT_SAMPLE
    tri_sample = cone - 123 + _OPS_PER_TRI_LIGHT_SAMPLE
    f = tri_light_fraction
    contrib = sk._OPS_PER_SHADOW_CONTRIB + (sk._OPS_PER_SHADOW_CONTRIB_MIS if physical else 0)
    shadow_planes = max(scene.num_planes - 1, 0) * plane_sh
    shadow_spheres = max(scene.num_spheres - 1, 0) * sphere_sh if not isect.scans else 0
    leaves = c[f"sphere_{unit}_needed"] * (size * sk._OPS_PER_SPHERE_TEST + _OPS_PER_BOX_TEST)
    if separate_folds:
        leaves += c[f"shadow_sphere_{unit}_needed"] * (size * sk._OPS_PER_SPHERE_TEST + _OPS_PER_BOX_TEST)
        tris = c["tri_blocks_needed"] * (TRI_SCAN_BLOCK * _OPS_PER_TRIANGLE_TEST + _OPS_PER_BOX_TEST)
    else:
        stops = c["shadow_sphere_stops"]
        leaves += ((c[f"shadow_sphere_{unit}_needed"] - stops) * (size * sphere_sh + box_sh)
                   + stops * (sphere_sh + box_sh))
        sh_blocks, sh_tris = c["shadow_tri_blocks_needed"], c["shadow_tris_needed"]
        tris = ((c["tri_blocks_needed"] - sh_blocks) * _OPS_PER_BOX_TEST + sh_blocks * box_sh
                + (c["tris_needed"] - sh_tris) * _OPS_PER_TRIANGLE_TEST + sh_tris * tri_sh)
    return int(
        base
        + c["light_samples"] * ((1.0 - f) * cone + f * tri_sample)
        + c["shadow_rays"] * (contrib + shadow_planes + shadow_spheres)
        + c["reverse_densities"] * ((1.0 - f) * sk._OPS_PER_REVERSE_DENSITY + f * _OPS_PER_TRI_REVERSE_DENSITY)
        + leaves
        + tris
        + (c["bounces"] + c["shadow_folds"]) * _OPS_PER_RAY_INVERSE
    )

