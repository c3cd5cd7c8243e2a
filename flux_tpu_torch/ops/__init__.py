"""flux_tpu_torch.ops — wavefront ops (intersection, BRDF, next-event
estimation, shading) and the CUDA megakernels (sweep and scene)."""

from .brdf import sample_directions
from .intersect import Hit, Intersector, intersect, occluded_sweep
from .nee import LightTensors, extract_lights
from .shade import PathState, bounce

__all__ = [
    "Hit",
    "Intersector",
    "intersect",
    "occluded_sweep",
    "sample_directions",
    "LightTensors",
    "extract_lights",
    "PathState",
    "bounce",
]
