"""Color utilities: luminance and the per-pixel ``max_to_one`` tone map
(``flux_tpu/color.py``; reference fluxcore/src/color.rs)."""

import numpy as np
import torch

__all__ = ["max_to_one", "luminance"]

# Rec. 709 luma weights (noise estimation for adaptive sampling).
_LUM_R, _LUM_G, _LUM_B = (float(np.float32(v)) for v in (0.2126, 0.7152, 0.0722))


def luminance(rgb):
    """Luma of a Vec3 (SoA) or an (..., 3) tensor."""
    if hasattr(rgb, "x"):
        return _LUM_R * rgb.x + _LUM_G * rgb.y + _LUM_B * rgb.z
    return _LUM_R * rgb[..., 0] + _LUM_G * rgb[..., 1] + _LUM_B * rgb[..., 2]


def max_to_one(img: torch.Tensor) -> torch.Tensor:
    """Divide each pixel by its max channel when that exceeds 1
    (color.rs:35-44), applied after the sample average (trace.rs:85-87)."""
    m = torch.amax(img, dim=-1, keepdim=True)
    scale = torch.where(m > 1.0, 1.0 / m, torch.ones_like(m))
    return img * scale
