"""flux_tpu_torch.ops — wavefront ops (intersection, BRDF, next-event
estimation, shading) and the CUDA sweep megakernel."""

from .brdf import sample_directions
from .intersect import Hit, intersect, occluded_sweep
from .nee import LightTensors, extract_lights
from .shade import PathState, bounce

__all__ = [
    "Hit",
    "intersect",
    "occluded_sweep",
    "sample_directions",
    "LightTensors",
    "extract_lights",
    "PathState",
    "bounce",
]
