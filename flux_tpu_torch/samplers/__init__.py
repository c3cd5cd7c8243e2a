"""flux_tpu_torch.samplers — deterministic, counter-based stratified sampling,
bit-equal to ``flux_tpu.samplers`` (hashes, sample points and grids)."""

from .grids import (
    Sampler,
    grid_correlated_multi_jittered,
    grid_jittered,
    grid_multi_jittered,
    grid_regular,
)
from .hash import hash_combine, mix, permute_pow2, randfloat
from .patterns import bounce_point, cmj_point, jittered_point, mj_point, point, regular_point
from .warps import to_hemisphere, to_poisson_disc, to_unit_hemi

__all__ = [
    "Sampler",
    "grid_regular",
    "grid_jittered",
    "grid_multi_jittered",
    "grid_correlated_multi_jittered",
    "hash_combine",
    "mix",
    "permute_pow2",
    "randfloat",
    "regular_point",
    "jittered_point",
    "mj_point",
    "cmj_point",
    "bounce_point",
    "point",
    "to_unit_hemi",
    "to_hemisphere",
    "to_poisson_disc",
]
