"""The adaptive stop's statistic, worked out again from a render's own
accumulators: the percentile over pixels of the relative standard error of
each pixel's mean luminance (the contract of
``flux_tpu_torch.checkpoint.ProgressiveRenderer.max_rel_stderr``), in
float64, or in the control's lower precision."""

import numpy as np
import torch

# Rec. 709 luma as float32 values, as the renderers weigh them.
LUM = np.array([0.2126, 0.7152, 0.0722], np.float32)


def rel_stderr(acc: np.ndarray, lum_sq: np.ndarray, k: int, percentile: float, dtype=torch.float64) -> float:
    a = torch.from_numpy(np.ascontiguousarray(acc)).to(dtype)
    mean = (a * torch.from_numpy(LUM).to(dtype)).sum(dim=-1) / k
    var = torch.clamp(torch.from_numpy(np.ascontiguousarray(lum_sq)).to(dtype) / k - mean * mean, min=0) * (k / (k - 1))
    rel = torch.sqrt(var / k) / torch.clamp(mean, min=1e-3)
    return float(np.percentile(rel.to(torch.float64).numpy(), percentile))
