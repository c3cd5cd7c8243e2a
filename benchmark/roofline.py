"""The frozen float32 operation count of a frame, for ``kernel_roofline_pct``.

The weights and formulas are copies, taken at commit f2c28681, of
``flux_tpu_torch/ops/sweep_kernel.py::flops_lower_bound`` and
``flux_tpu_torch/ops/scene_kernel.py::flops_lower_bound`` (the default
rule: a perfect skip over the sphere tree's leaves, a shadow ray charged
only the part of each test that depends on its direction). They are kept
here so that no later change to the kernels or their bounds moves the
yardstick: ``tools/freeze_counts.py`` takes a frame's work counters from
the kernel's counting launch once and writes the operations they give to
``frozen/<cell>.json``, which the metric reads.
"""

from __future__ import annotations

# float32 operations per unit of work, counted from csrc/sweep_megakernel.cu
# (add, sub, mul, div, sqrt, rsqrt, cos, sin and pow count one each; integer
# hashing, compares and selects are not counted; a subexpression used twice
# counts once).
OPS_PER_SAMPLE = 88  # CMJ AA + lens points, disc warp, thin-lens ray, sum
OPS_PER_SAMPLE_STATS = 7  # luminance, its square, the sum
OPS_PER_SPHERE_TEST = 20
OPS_PER_PLANE_TEST = 14
OPS_PER_SPHERE_ORIGIN = 10  # of a sphere test, what depends on the origin alone
OPS_PER_PLANE_ORIGIN = 8
OPS_PER_BOUNCE = 6  # hit point, or the background add on a miss
OPS_PER_SCATTER_WARPED = 81  # reflect, bounce point, hemisphere warp, frame, throughput
OPS_PER_SCATTER_MIRROR = 15  # reflect and throughput only
OPS_PER_SCATTER_PHYSICAL = 8
OPS_PER_LIGHT_SAMPLE = 155  # cone point and pick (7), cone sample (123), cos (5), light's test (20)
OPS_PER_CONE_SAMPLE = 123
OPS_PER_SHADOW_CONTRIB = 12
OPS_PER_SHADOW_CONTRIB_MIS = 5
OPS_PER_REVERSE_DENSITY = 95
OPS_PER_GLOSSY_LOBE = 23
# csrc/scene_megakernel.cu and csrc/flux_trace.cuh, the same conventions.
OPS_PER_TRIANGLE_TEST = 46
OPS_PER_BOX_TEST = 12
OPS_PER_TRIANGLE_ORIGIN = 17
OPS_PER_BOX_ORIGIN = 6
OPS_PER_RAY_INVERSE = 3  # 1/d per nearest or shadow fold
OPS_PER_TRI_LIGHT_SAMPLE = 44
OPS_PER_TRI_REVERSE_DENSITY = 9
SCAN_LEAF = 16  # spheres under one leaf of the sphere tree


def sweep_ops(*, n_spheres: int, n_planes: int, mirror: bool, n_samples: int, bounces: int,
              with_stats: bool = False, physical: bool = False, light_samples: int = 0, shadow_rays: int = 0,
              reverse_densities: int = 0, glossy_lobes: int = 0) -> int:
    """The sweep megakernel's lower bound for ``n_samples`` samples traced
    in ``bounces`` bounces with the given work counters; ``mirror`` when the
    scene has a mirror material (the cheapest scatter)."""
    per_test = n_spheres * OPS_PER_SPHERE_TEST + n_planes * OPS_PER_PLANE_TEST
    scatter = OPS_PER_SCATTER_MIRROR if mirror else OPS_PER_SCATTER_WARPED
    if physical:
        scatter += OPS_PER_SCATTER_PHYSICAL
    shadow_sweep = (max(n_spheres - 1, 0) * (OPS_PER_SPHERE_TEST - OPS_PER_SPHERE_ORIGIN)
                    + max(n_planes - 1, 0) * (OPS_PER_PLANE_TEST - OPS_PER_PLANE_ORIGIN))
    contrib = OPS_PER_SHADOW_CONTRIB + (OPS_PER_SHADOW_CONTRIB_MIS if physical else 0)
    return (
        n_samples * (OPS_PER_SAMPLE + (OPS_PER_SAMPLE_STATS if with_stats else 0))
        + bounces * (per_test + OPS_PER_BOUNCE)
        + max(bounces - n_samples, 0) * scatter
        + light_samples * OPS_PER_LIGHT_SAMPLE
        + shadow_rays * (shadow_sweep + contrib)
        + reverse_densities * OPS_PER_REVERSE_DENSITY
        + glossy_lobes * OPS_PER_GLOSSY_LOBE
    )


def scene_ops(*, n_spheres: int, n_planes: int, mirror: bool, scans: bool, n_samples: int, counts: dict,
              with_stats: bool = False, physical: bool = False, tri_light_fraction: float = 0.0) -> int:
    """The scene megakernel's lower bound from its work counters summed
    over the launches (``counts`` by the counter names of
    ``scene_kernel.COUNT_NAMES``); ``tri_light_fraction`` is the light
    set's pick probability on triangle lights."""
    c = counts
    base = sweep_ops(n_spheres=n_spheres, n_planes=n_planes, mirror=mirror, n_samples=n_samples,
                     bounces=c["bounces"], with_stats=with_stats, physical=physical,
                     glossy_lobes=c["glossy_lobes"])
    if scans:
        base -= c["bounces"] * n_spheres * OPS_PER_SPHERE_TEST
    sphere_sh = OPS_PER_SPHERE_TEST - OPS_PER_SPHERE_ORIGIN
    plane_sh = OPS_PER_PLANE_TEST - OPS_PER_PLANE_ORIGIN
    tri_sh = OPS_PER_TRIANGLE_TEST - OPS_PER_TRIANGLE_ORIGIN
    box_sh = OPS_PER_BOX_TEST - OPS_PER_BOX_ORIGIN
    cone = OPS_PER_LIGHT_SAMPLE
    tri_sample = cone - OPS_PER_CONE_SAMPLE + OPS_PER_TRI_LIGHT_SAMPLE
    f = tri_light_fraction
    contrib = OPS_PER_SHADOW_CONTRIB + (OPS_PER_SHADOW_CONTRIB_MIS if physical else 0)
    shadow_planes = max(n_planes - 1, 0) * plane_sh
    shadow_spheres = max(n_spheres - 1, 0) * sphere_sh if not scans else 0
    stops = c["shadow_sphere_stops"]
    leaves = (c["sphere_leaves_needed"] * (SCAN_LEAF * OPS_PER_SPHERE_TEST + OPS_PER_BOX_TEST)
              + (c["shadow_sphere_leaves_needed"] - stops) * (SCAN_LEAF * sphere_sh + box_sh)
              + stops * (sphere_sh + box_sh))
    sh_blocks, sh_tris = c["shadow_tri_blocks_needed"], c["shadow_tris_needed"]
    tris = ((c["tri_blocks_needed"] - sh_blocks) * OPS_PER_BOX_TEST + sh_blocks * box_sh
            + (c["tris_needed"] - sh_tris) * OPS_PER_TRIANGLE_TEST + sh_tris * tri_sh)
    return int(
        base
        + c["light_samples"] * ((1.0 - f) * cone + f * tri_sample)
        + c["shadow_rays"] * (contrib + shadow_planes + shadow_spheres)
        + c["reverse_densities"] * ((1.0 - f) * OPS_PER_REVERSE_DENSITY + f * OPS_PER_TRI_REVERSE_DENSITY)
        + leaves
        + tris
        + (c["bounces"] + c["shadow_folds"]) * OPS_PER_RAY_INVERSE
    )
