"""The sweep megakernel: a band's whole render in one CUDA launch.

:func:`render_block_sweep` has the contract of
:func:`flux_tpu_torch.render.render_block` (radiance sums over the samples
``[s0, s0 + n_samples)`` of a band of rows, ``(n_rows, img_w, 3)`` float32,
a fourth channel Σ luminance² with ``with_stats``; ``lights`` for NEE,
``physical`` for physical transport). For a scene whose tensors lie on the
CPU it returns the plain version's result. For a scene on a CUDA card it
launches ``csrc/sweep_megakernel.cu`` (built for ``sm_90a`` at first use;
see :mod:`flux_tpu_torch.ops.build`) or raises; it never falls back to the
plain version there.

The kernel replaces the TPU kernel ``flux_tpu/ops/pallas_kernel.py::_kernel``
in its sweep configurations (no triangles): K1 (reference transport), K2
(the stats channel), K3 (NEE over sphere lights) and K4 (physical
transport, MIS with NEE), one template instantiation per combination. The
source's header says what bounds it on the H100 and how its design meets
that.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..camera import CameraTensors
from ..samplers.hash import MASK
from ..scene import MaterialKind, SceneTensors
from . import build
from .nee import LightTensors

__all__ = [
    "render_block_sweep",
    "pack_scene",
    "FluxScene",
    "FluxLights",
    "pack_lights",
    "config_name",
    "n_counts",
    "MAX_SPHERES",
    "MAX_PLANES",
    "MAX_DEPTH",
    "flops_lower_bound",
    "LaunchPlan",
    "launch_plan",
]

MAX_SPHERES = 64
MAX_PLANES = 16
MAX_SHAPES = MAX_SPHERES + MAX_PLANES
MAX_LIGHTS = MAX_SPHERES  # every sphere light is a sweep sphere
N_COUNTS = 5  # work counters per pixel with NEE or physical (else 1)
MAX_DEPTH = 32  # the deepest path the kernels' sampler rows hold (FLUX_MAX_DEPTH)
BLOCK_THREADS = 256  # threads of a block (FLUX_BLOCK_THREADS)
SPLITS = (8, 16, 32)  # threads per pixel a launch may take
_SOURCE = "sweep_megakernel"

_F4 = ctypes.c_float * 4


class FluxScene(ctypes.Structure):
    """The kernel's ``__constant__`` scene record (``struct FluxScene``)."""

    _fields_ = [
        ("n_spheres", ctypes.c_int),
        ("n_planes", ctypes.c_int),
        ("unit_d", ctypes.c_int),
        ("pad", ctypes.c_int),
        ("sph", _F4 * MAX_SPHERES),  # center x, y, z, radius
        ("sph_invert", ctypes.c_float * MAX_SPHERES),
        ("pl_point", _F4 * MAX_PLANES),
        ("pl_normal", _F4 * MAX_PLANES),
        ("alb", _F4 * MAX_SHAPES),  # color × param
        ("exponent", ctypes.c_float * MAX_SHAPES),  # low 2 mantissa bits clear
        ("kind", ctypes.c_int * MAX_SHAPES),
        ("bg", _F4),
        ("eye", _F4),
        ("u", _F4),
        ("v", _F4),
        ("w", _F4),
        ("focal_distance", ctypes.c_float),
        ("lens_radius", ctypes.c_float),
        ("vp_factor", ctypes.c_float),
        ("adjusted_pixel_size", ctypes.c_float),
    ]


class FluxLights(ctypes.Structure):
    """The kernel's ``__constant__`` light record (``struct FluxLights``)."""

    _fields_ = [
        ("n_lights", ctypes.c_int),
        ("pad", ctypes.c_int * 3),
        ("center", _F4 * MAX_LIGHTS),  # x, y, z, radius
        ("emit", _F4 * MAX_LIGHTS),
        ("pick", ctypes.c_float * MAX_LIGHTS),
        ("cdf", ctypes.c_float * MAX_LIGHTS),
        ("shape_idx", ctypes.c_int * MAX_LIGHTS),
        ("light_of", ctypes.c_int * MAX_SHAPES),  # light index of a shape, -1 if none
    ]


def pack_lights(lights: LightTensors) -> FluxLights:
    """The kernel's light record from the float32/int32 host copies of the
    light set, with the inverse map shape → light index."""
    n = lights.num_lights
    if n > MAX_LIGHTS or lights.has_tris:
        raise ValueError(f"the sweep megakernel takes at most {MAX_LIGHTS} sphere lights, got {n}"
                         + " with triangle lights" * lights.has_tris)
    h = lights.host
    st = FluxLights()
    st.n_lights = n
    arr = np.ctypeslib.as_array
    arr(st.center)[:n, :3] = h["center"]
    arr(st.center)[:n, 3] = h["radius"]
    arr(st.emit)[:n, :3] = h["emit"]
    arr(st.pick)[:n] = h["pick"]
    arr(st.cdf)[:n] = h["cdf"]
    arr(st.shape_idx)[:n] = h["shape_idx"]
    arr(st.light_of)[:] = -1
    for k, i in enumerate(h["shape_idx"].tolist()):
        if not 0 <= i < MAX_SHAPES:
            raise ValueError(f"light {k} has shape index {i}, outside the sweep's {MAX_SHAPES} shapes")
        arr(st.light_of)[i] = k
    return st


def config_name(with_stats: bool, nee: bool, physical: bool) -> str:
    """The name of a kernel instantiation: ``sweep`` (K1), plus ``+nee``,
    ``+physical`` and ``+stats`` for the configurations it adds."""
    return "sweep" + "+nee" * nee + "+physical" * physical + "+stats" * with_stats


def pack_scene(scene: SceneTensors, cam: CameraTensors, *, spheres: bool = True) -> FluxScene:
    """The kernels' constant record, from the float32 host copies of the
    scene and camera. Albedo is the float32 product color × param. With
    ``spheres`` (the sweep) the record holds the spheres and, behind their
    material rows, the planes'; exponents have the two low mantissa bits
    clear, as the plain sweep decodes them after packing the material kind
    there. Without (the scene megakernel's scan, whose spheres live in a
    device table) it holds the planes only, their material rows from row 0
    and their exponents as authored, as the plain scan gathers them.
    Triangle rows are never part of it."""
    ns, npl = (scene.num_spheres if spheres else 0), scene.num_planes
    if ns > MAX_SPHERES or npl > MAX_PLANES:
        raise ValueError(
            f"the sweep takes at most {MAX_SPHERES} spheres and {MAX_PLANES} planes, "
            f"got {ns} and {npl}; more spheres need accel='scan'"
        )
    h, c = scene.host, cam.host
    st = FluxScene()
    st.n_spheres, st.n_planes, st.unit_d = ns, npl, int(scene.unit_d)
    arr = np.ctypeslib.as_array
    arr(st.sph)[:ns, :3] = h["sphere_center"][:ns]
    arr(st.sph)[:ns, 3] = h["sphere_radius"][:ns]
    arr(st.sph_invert)[:ns] = h["sphere_invert"][:ns]
    arr(st.pl_point)[:npl, :3] = h["plane_point"]
    arr(st.pl_normal)[:npl, :3] = h["plane_normal"]
    n = ns + npl
    rows = slice(0, n) if spheres else slice(scene.num_spheres, scene.num_spheres + npl)
    arr(st.alb)[:n, :3] = (h["mat_color"] * h["mat_param"][:, None])[rows]
    exp = h["mat_exp"][rows]
    if spheres:
        exp = (exp.view(np.uint32) & np.uint32(0xFFFFFFFC)).view(np.float32)
    arr(st.exponent)[:n] = exp
    arr(st.kind)[:n] = h["mat_kind"][rows]
    arr(st.bg)[:3] = h["background"]
    for k in ("eye", "u", "v", "w"):
        arr(getattr(st, k))[:3] = c[k]
    for k in ("focal_distance", "lens_radius", "vp_factor", "adjusted_pixel_size"):
        setattr(st, k, float(c[k]))
    return st


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load(_SOURCE)
    lib.flux_sweep_scene_bytes.restype = ctypes.c_size_t
    lib.flux_sweep_scene_bytes.argtypes = []
    lib.flux_sweep_lights_bytes.restype = ctypes.c_size_t
    lib.flux_sweep_lights_bytes.argtypes = []
    lib.flux_sweep_n_counts.restype = ctypes.c_int
    lib.flux_sweep_n_counts.argtypes = []
    lib.flux_sweep_max_spheres.restype = ctypes.c_int
    lib.flux_sweep_max_spheres.argtypes = []
    lib.flux_sweep_max_planes.restype = ctypes.c_int
    lib.flux_sweep_max_planes.argtypes = []
    lib.flux_sweep_max_depth.restype = ctypes.c_int
    lib.flux_sweep_max_depth.argtypes = []
    lib.flux_sweep_blocks_per_sm.restype = ctypes.c_int
    lib.flux_sweep_blocks_per_sm.argtypes = [ctypes.c_int] * 6
    lib.flux_sweep_error_string.restype = ctypes.c_char_p
    lib.flux_sweep_error_string.argtypes = [ctypes.c_int]
    lib.flux_sweep_render.restype = ctypes.c_int
    lib.flux_sweep_render.argtypes = [
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # counts (may be null)
        ctypes.POINTER(FluxScene),
        ctypes.POINTER(FluxLights),  # null without NEE
        ctypes.c_int,  # with_stats
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
        lib.flux_sweep_scene_bytes() != ctypes.sizeof(FluxScene)
        or lib.flux_sweep_max_depth() != MAX_DEPTH
        or lib.flux_sweep_lights_bytes() != ctypes.sizeof(FluxLights)
        or lib.flux_sweep_n_counts() != N_COUNTS
        or lib.flux_sweep_max_spheres() != MAX_SPHERES
        or lib.flux_sweep_max_planes() != MAX_PLANES
    ):
        raise RuntimeError("FluxScene/FluxLights layout differs between Python and CUDA")
    return lib


class LaunchPlan(NamedTuple):
    """How a launch cuts its band: ``pixels_per_block`` pixels × ``split``
    threads per pixel in each of ``blocks`` blocks of 256 threads, of which
    the card holds ``slots`` at once."""

    split: int
    pixels_per_block: int
    blocks: int
    slots: int

    @property
    def waves(self) -> float:
        return self.blocks / self.slots


# The slots the plan assumes: an H100's 132 SMs at 4 blocks of 256 threads
# each. The plan depends on the launch's shape alone, not on the card or the
# kernel's occupancy, so that both kernels (whose sums must agree bit for
# bit) and every card cut a launch alike.
PLAN_SLOTS = 132 * 4


def launch_plan(n_pix: int, n_samples: int, slots: int = PLAN_SLOTS) -> LaunchPlan:
    """The split (threads per pixel, one of ``SPLITS``) of a launch of
    ``n_pix`` pixels × ``n_samples`` samples on a card that holds ``slots``
    blocks at once. Blocks of one launch take about equally long, so a
    launch lasts about its waves, rounded up, times the samples a thread
    takes; the plan minimises that product over the splits that leave no
    thread without a sample, ties to the larger split (a warp over fewer
    pixels and more of their samples, finer blocks)."""
    best = None
    for split in SPLITS:
        if split > max(n_samples, SPLITS[0]):
            continue
        px = BLOCK_THREADS // split
        blocks = -(-n_pix // px)
        cost = -(-blocks // slots) * -(-max(n_samples, 1) // split)
        if best is None or cost <= best[0]:
            best = (cost, LaunchPlan(split, px, blocks, slots))
    return best[1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_launch(blocks_per_sm, dev: torch.device, n_pix: int, n_samples: int, with_stats: bool,
                nee: bool, physical: bool, count: bool, max_depth: int) -> LaunchPlan:
    """The launch plan of one launch, with the slots the card really holds
    for it, from the kernel library's occupancy query ``blocks_per_sm(
    with_stats, nee, physical, count, split, max_depth)``."""
    plan = launch_plan(n_pix, n_samples)
    n = blocks_per_sm(int(with_stats), int(nee), int(physical), int(count), plan.split, int(max_depth))
    if n <= 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return plan._replace(slots=n * _sm_count(index))


def check_launch(n_pix: int, n_samples: int, root: int, max_depth: int, with_stats: bool, counting: bool) -> None:
    """Raises on a launch the kernels do not take."""
    if not (0 < n_pix < 2**31 and 0 <= n_samples < 2**32 and root >= 1 and 0 <= max_depth <= MAX_DEPTH):
        raise ValueError(f"bad launch shape n_pix={n_pix} n_samples={n_samples} root={root} "
                         f"max_depth={max_depth} (at most {MAX_DEPTH})")
    if counting and with_stats:
        raise ValueError("work counters come from a launch without with_stats (the stats channel adds no work)")


def n_counts(nee: bool, physical: bool) -> int:
    """Work counters per pixel of an instantiation: bounces only for K1 and
    K2; with NEE or physical also light samples, unoccluded shadow rays,
    MIS reverse densities and glossy lobe evaluations."""
    return N_COUNTS if (nee or physical) else 1


def render_block_sweep(
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
    bounce_counts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Radiance sums over samples [s0, s0+n_samples) of rows
    ``row0 + k·row_stride``, ``(n_rows, img_w, 3)`` float32 on the scene's
    device (``(n_rows, img_w, 4)`` with ``with_stats``). On the card,
    ``bounce_counts`` (optional contiguous int32 tensor) receives each
    pixel's work counters summed over its samples: shape ``(n_rows·img_w,)``
    (bounces) for K1 and K2, ``(N_COUNTS, n_rows·img_w)`` with ``lights`` or
    ``physical`` (row 0 bounces; see :func:`flops_lower_bound`), from the
    counting instantiation, without ``with_stats``. The launch's
    :class:`LaunchPlan` is kept as ``render_block_sweep.last_plan``."""
    dev = scene.device
    if scene.num_triangles:
        raise ValueError("the sweep megakernel takes no triangles; use render_block_scene")
    if dev.type == "cpu":
        if bounce_counts is not None:
            raise ValueError("bounce_counts is counted by the CUDA kernel only")
        from ..render import render_block

        return render_block(
            scene, cam, row0, s0, seed,
            img_w=img_w, img_h=img_h, n_rows=n_rows, n_samples=n_samples, root=root,
            max_depth=max_depth, s_limit=s_limit, row_stride=row_stride, with_stats=with_stats,
            lights=lights, physical=physical,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if cam.eye.device != dev or (lights is not None and lights.center.device != dev):
        raise ValueError(f"camera on {cam.eye.device}, scene on {dev}")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(
            f"the sweep megakernel is built for sm_90a (Hopper); {torch.cuda.get_device_name(dev)} "
            f"is sm_{''.join(map(str, torch.cuda.get_device_capability(dev)))}"
        )
    n_pix = n_rows * img_w
    check_launch(n_pix, n_samples, root, max_depth, with_stats, bounce_counts is not None)
    n_ch = 4 if with_stats else 3
    out = torch.empty((n_ch, n_pix), dtype=torch.float32, device=dev)
    counts_ptr = None
    if bounce_counts is not None:
        nc = n_counts(lights is not None, physical)
        want = (n_pix,) if nc == 1 else (nc, n_pix)
        if (
            bounce_counts.device != dev
            or bounce_counts.dtype != torch.int32
            or tuple(bounce_counts.shape) != want
            or not bounce_counts.is_contiguous()
        ):
            raise ValueError(f"bounce_counts must be a contiguous int32 {want} tensor on {dev}")
        counts_ptr = bounce_counts.data_ptr()
    lib = _library()
    packed = pack_scene(scene, cam)
    packed_lights = None if lights is None else ctypes.byref(pack_lights(lights))
    limit = (1 << 32) if s_limit is None else int(s_limit) & MASK
    plan = plan_launch(lib.flux_sweep_blocks_per_sm, dev, n_pix, n_samples, with_stats, lights is not None,
                       physical, bounce_counts is not None, max_depth)
    with torch.cuda.device(dev):
        err = lib.flux_sweep_render(
            out.data_ptr(), counts_ptr, ctypes.byref(packed), packed_lights, int(with_stats),
            int(physical), n_pix, img_w, img_h, int(row0), int(row_stride), int(s0) & MASK,
            int(n_samples), limit, int(seed) & MASK, int(root), int(max_depth),
            plan.split, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"sweep megakernel launch failed: CUDA error {err} "
            f"({lib.flux_sweep_error_string(err).decode()})"
        )
    render_block_sweep.launches[config_name(with_stats, lights is not None, physical)] += 1
    render_block_sweep.last_plan = plan
    return out.t().reshape(n_rows, img_w, n_ch)


# Kernel launches by instantiation (config_name, e.g. "sweep+nee+physical")
# since the count was last cleared; .total() counts them all.
render_block_sweep.launches = collections.Counter()
render_block_sweep.last_plan = None


# float32 operations per unit of work, counted from csrc/sweep_megakernel.cu
# (add, sub, mul, div, sqrt, rsqrt, cos, sin and pow count one each; integer
# hashing, compares and selects are not counted; a subexpression used twice
# counts once). Unit-direction scenes.
_OPS_PER_SAMPLE = 88  # CMJ AA + lens points, disc warp, thin-lens ray, sum
_OPS_PER_SAMPLE_STATS = 7  # luminance, its square, the sum
_OPS_PER_SPHERE_TEST = 20
_OPS_PER_PLANE_TEST = 14
_OPS_PER_BOUNCE = 6  # hit point, or the background add on a miss
_OPS_PER_SCATTER_WARPED = 81  # reflect, bounce point, hemisphere warp, frame, throughput
_OPS_PER_SCATTER_MIRROR = 15  # reflect and throughput only
_OPS_PER_SCATTER_PHYSICAL = 8  # cos θ_i and the throughput factor's multiplies
# NEE: the jittered cone point and the pick number (7), the cone sample
# with its frame, ring decomposition, clipped arc and weight (123), cos θ_s
# (5) and the light's own sphere test (20).
_OPS_PER_LIGHT_SAMPLE = 155
_OPS_PER_SHADOW_CONTRIB = 12  # (throughput × albedo × weight) × factor, added
_OPS_PER_SHADOW_CONTRIB_MIS = 5  # pdf_b, the balance weight, f·cos
_OPS_PER_REVERSE_DENSITY = 95  # nee_pdf_toward with the clipped arc, the weight
_OPS_PER_GLOSSY_LOBE = 23  # r·w, pow, flipped twin, its horizon test, density


def flops_lower_bound(
    scene: SceneTensors,
    n_samples: int,
    n_bounces: int,
    *,
    with_stats: bool = False,
    physical: bool = False,
    light_samples: int = 0,
    shadow_rays: int = 0,
    reverse_densities: int = 0,
    glossy_lobes: int = 0,
) -> int:
    """A lower bound on the kernel's float32 operations for a launch that
    traced ``n_samples`` samples in ``n_bounces`` bounces; the other counts
    are the kernel's work counters, summed (``bounce_counts`` rows 1-4).
    At least ``n_bounces - n_samples`` bounces scattered, since each
    sample's last bounce ends it or hits the depth cap; each is charged the
    cheapest scatter the scene's materials allow. An unoccluded shadow ray
    swept every sphere but its light and every plane but its origin's; an
    occluded one is charged nothing beyond its light sample."""
    per_test = scene.num_spheres * _OPS_PER_SPHERE_TEST + scene.num_planes * _OPS_PER_PLANE_TEST
    mirror = bool((scene.host["mat_kind"] == MaterialKind.REFLECTIVE).any())
    scatter = _OPS_PER_SCATTER_MIRROR if mirror else _OPS_PER_SCATTER_WARPED
    if physical:
        scatter += _OPS_PER_SCATTER_PHYSICAL
    shadow_sweep = (
        max(scene.num_spheres - 1, 0) * _OPS_PER_SPHERE_TEST
        + max(scene.num_planes - 1, 0) * _OPS_PER_PLANE_TEST
    )
    contrib = _OPS_PER_SHADOW_CONTRIB + (_OPS_PER_SHADOW_CONTRIB_MIS if physical else 0)
    return (
        n_samples * (_OPS_PER_SAMPLE + (_OPS_PER_SAMPLE_STATS if with_stats else 0))
        + n_bounces * (per_test + _OPS_PER_BOUNCE)
        + max(n_bounces - n_samples, 0) * scatter
        + light_samples * _OPS_PER_LIGHT_SAMPLE
        + shadow_rays * (shadow_sweep + contrib)
        + reverse_densities * _OPS_PER_REVERSE_DENSITY
        + glossy_lobes * _OPS_PER_GLOSSY_LOBE
    )
