"""The JAX package's stored results, and the gates that hold the port to them.

``artifacts/`` in a checkout holds what the JAX package's ``bench.py`` and
quality scripts rendered on a TPU: 8-bit PNG frames, and in
``bench_extra.json`` the estimator values of its paths (image statistics
of sample streams that the port reproduces bit for bit, not speeds).
``chip_smoke.py`` holds the port's frames and values to these, at the gates
below. Nothing here writes under ``artifacts/``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = [
    "ARTIFACTS", "ADAPTIVE_SPP", "ADAPTIVE_P99", "ADAPTIVE_P99_ATOL", "MIS_MSE", "MIS_MSE_RTOL",
    "HEADLINE_GATES", "NEE_GATES", "SPHERES512_GATES", "CORNELL_GATES",
    "png_levels", "levels", "frame_vs_png", "gate", "frame_gates", "adaptive_gates", "mis_gates", "failed",
]

ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"

# demo2 at root 32, passes of 64, noise target 0.12: the adaptive stop's
# samples and its p99 relative standard error (bench_extra.json).
ADAPTIVE_SPP, ADAPTIVE_P99 = 768, 0.11675
ADAPTIVE_P99_ATOL = 5e-4
# demo3 MIS at 16 spp, seed 0, against its 1024-spp truth, seed 7.
MIS_MSE = 0.002073
MIS_MSE_RTOL = 0.02

# Frame gates: (statistic of frame_vs_png, upper limit).
# demo2 at 16384 spp, seed 0, against the JAX package's render of that frame.
HEADLINE_GATES = (("mean_abs_levels", 0.5), ("frac_over_2_levels", 0.01))
# demo2 NEE at 1024 spp against the 16384-spp frame (another estimator).
NEE_GATES = (("mean_abs_levels", 3.0),)
# spheres512 at 64 spp: among 513 small spheres a sample that grazes one
# goes another way on another arithmetic, and at 64 spp one such sample
# moves a pixel by a few levels, so the gates are on the means.
SPHERES512_GATES = (("mean_abs_levels", 3.0), ("abs_mean_signed_levels", 0.3), ("frac_over_8_levels", 0.05))
# The Cornell box at 1024 spp NEE against the JAX package's 2304-spp frame.
CORNELL_GATES = (("mean_abs_levels", 3.0),)


def png_levels(png: str) -> np.ndarray:
    """A stored 8-bit PNG (a file name under ``artifacts/``, or a path) as
    int32 levels."""
    from PIL import Image as PILImage

    with PILImage.open(ARTIFACTS / png) as im:
        return np.asarray(im, np.int32)


def levels(img: np.ndarray) -> np.ndarray:
    """A frame as 8-bit levels, rounded as the PNG writer rounds."""
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.int32)


def frame_vs_png(img: np.ndarray, png: str) -> dict:
    """A frame against a stored PNG of the same size, in 8-bit levels."""
    want = png_levels(png)
    if want.shape != img.shape:
        raise ValueError(f"frame of shape {img.shape} against {png} of shape {want.shape}")
    signed = levels(img) - want
    d = np.abs(signed)
    return {"mean_abs_levels": float(d.mean()), "mean_signed_levels": float(signed.mean()),
            "abs_mean_signed_levels": abs(float(signed.mean())), "max_abs_levels": int(d.max()),
            "frac_over_2_levels": float((d > 2).mean()), "frac_over_8_levels": float((d > 8).mean())}


def gate(what: str, value, limit, passed: bool) -> dict:
    """A gate's result: what it checks, the value, the limit and whether it passed."""
    return {"gate": what, "value": value, "limit": limit, "passed": bool(passed)}


def frame_gates(stats: dict, limits, png: str) -> list:
    """Each (statistic, limit) of ``limits`` on ``stats`` (frame_vs_png's)."""
    return [gate(f"{key} vs {png} < {limit}", stats[key], limit, stats[key] < limit) for key, limit in limits]


def adaptive_gates(spp_done: int, p99) -> list:
    return [
        gate("spp_done == ADAPTIVE_SPP", spp_done, ADAPTIVE_SPP, spp_done == ADAPTIVE_SPP),
        gate("|p99_rel_stderr - ADAPTIVE_P99| <= 5e-4", p99, ADAPTIVE_P99,
              p99 is not None and abs(p99 - ADAPTIVE_P99) <= ADAPTIVE_P99_ATOL),
    ]


def mis_gates(mse: float) -> list:
    return [gate("|mse / MIS_MSE - 1| <= 0.02", mse, MIS_MSE, abs(mse / MIS_MSE - 1.0) <= MIS_MSE_RTOL)]


def failed(gates: list) -> list:
    """The names of the gates that did not pass."""
    return [g["gate"] for g in gates if not g["passed"]]
