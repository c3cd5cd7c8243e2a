"""Progressive rendering with sample-level checkpoint and resume
(``flux_tpu/checkpoint.py``).

With counter-based sampling a frame's accumulator is a plain sum over
disjoint ranges of sample indices, so (radiance sum, Σ luminance², samples
done) is a complete checkpoint: a resumed render continues the same sample
stream and ends on the same accumulator as one that never stopped. The file
format, the npz keys and the configuration fingerprint are the JAX
package's, so checkpoints pass between the two packages in both directions.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np
import torch

from .color import luminance, max_to_one
from .render import Renderer
from .scene import SceneData

__all__ = ["ProgressiveRenderer", "save_checkpoint", "load_checkpoint"]

_FORMAT = 2


def _config_fingerprint(
    sd: SceneData,
    root: int,
    depth: int,
    seed: int,
    nee: bool = False,
    physical: bool = False,
) -> str:
    """Hash of everything that determines the accumulated estimator: the
    same JSON and version keys as ``flux_tpu.checkpoint._config_fingerprint``
    (sampler v2, transport v2, and nee v2 / physical / mis v2 only when set),
    so equal configurations hash equal in both packages."""
    cfg = {"scene": sd.to_dict(), "root": root, "depth": depth, "seed": seed}
    cfg["sampler"] = 2
    cfg["transport"] = 2
    if nee:
        cfg["nee"] = 2
    if physical:
        cfg["physical"] = True
    if nee and physical:
        cfg["mis"] = 2
    blob = json.dumps(cfg, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def save_checkpoint(
    path: str,
    acc: np.ndarray,
    samples_done: int,
    fingerprint: str,
    lum_sq: Optional[np.ndarray] = None,
) -> None:
    """Write a format-2 checkpoint atomically (a temporary file, then
    ``os.replace``). Without ``lum_sq`` the moments are zeros and
    ``stats_valid`` is False, so a resume disables the adaptive stop."""
    tmp = path + ".tmp"
    stats_valid = lum_sq is not None
    if lum_sq is None:
        lum_sq = np.zeros(acc.shape[:2], np.float32)
    np.savez_compressed(
        tmp,  # numpy appends .npz
        format=np.int32(_FORMAT),
        acc=np.asarray(acc, np.float32),
        lum_sq=np.asarray(lum_sq, np.float32),
        stats_valid=np.bool_(stats_valid),
        samples_done=np.int64(samples_done),
        fingerprint=np.frombuffer(fingerprint.encode(), np.uint8),
    )
    os.replace(tmp + ".npz", path)


def load_checkpoint(path: str):
    """(acc, samples_done, fingerprint, lum_sq, stats_valid) of a format-1
    or format-2 checkpoint."""
    with np.load(path) as z:
        fmt = int(z["format"])
        if fmt not in (1, 2):
            raise ValueError(f"unsupported checkpoint format {fmt}")
        acc = z["acc"].astype(np.float32)
        if fmt >= 2:
            lum_sq = z["lum_sq"].astype(np.float32)
            stats_valid = bool(z["stats_valid"]) if "stats_valid" in z else True
        else:  # format 1 predates the moments; zeros would fake convergence
            lum_sq = np.zeros(acc.shape[:2], np.float32)
            stats_valid = False
        return acc, int(z["samples_done"]), z["fingerprint"].tobytes().decode(), lum_sq, stats_valid


class ProgressiveRenderer:
    """Full-frame renderer that accumulates sample passes and can save and
    resume between them. Passes walk the global sample index [0, root²) in
    order; the accumulators live on the host as float32 numpy arrays, added
    to in the same order however the passes were split across processes."""

    def __init__(
        self,
        scene_data: SceneData,
        sample_root: int,
        max_depth: int,
        seed: int = 0,
        device=None,
        rows_per_band: Optional[int] = None,
        accel: Optional[str] = None,
        nee: bool = False,
        physical: bool = False,
        renderer=None,
    ):
        """``renderer`` replaces the default :class:`Renderer` with any
        object that has ``render_rows_sum_range(row0, n_rows, s0, n,
        with_stats=True)``; its (scene, root, depth, seed, nee, physical)
        are read off it for the fingerprint."""
        if renderer is None:
            renderer = Renderer(
                scene_data, sample_root, max_depth, seed=seed, device=device, accel=accel,
                nee=nee, physical=physical,
            )
        self._r = renderer
        self.width = renderer.width
        self.height = renderer.height
        self.root = renderer.root
        self.spp = self.root * self.root
        self.fingerprint = _config_fingerprint(
            scene_data, self.root, renderer.max_depth, renderer.seed,
            nee=renderer.nee, physical=renderer.physical,
        )
        self.acc = np.zeros((self.height, self.width, 3), np.float32)
        self.samples_done = 0
        self._rows_per_band = rows_per_band or min(self.height, 128)
        self.lum_sq = np.zeros((self.height, self.width), np.float32)
        # False after resuming a checkpoint without real moments: the
        # adaptive stop stays off for that render.
        self._stats_valid = True

    @classmethod
    def from_renderer(cls, renderer, rows_per_band: Optional[int] = None):
        """Wrap a built Renderer; its configuration is authoritative."""
        return cls(
            renderer.scene_data, renderer.root, renderer.max_depth, seed=renderer.seed,
            rows_per_band=rows_per_band, renderer=renderer,
        )

    def render_pass(self, n_samples: int) -> int:
        """Accumulate the next ``n_samples`` sample indices over the whole
        frame; returns the samples added (clipped at root²)."""
        n = min(n_samples, self.spp - self.samples_done)
        if n <= 0:
            return 0
        for row0 in range(0, self.height, self._rows_per_band):
            n_rows = min(self._rows_per_band, self.height - row0)
            part = self._r.render_rows_sum_range(row0, n_rows, self.samples_done, n, with_stats=True)
            part = part.cpu().numpy()
            self.acc[row0 : row0 + n_rows] += part[..., :3]
            self.lum_sq[row0 : row0 + n_rows] += part[..., 3]
        self.samples_done += n
        return n

    def max_rel_stderr(self, percentile: float = 99.0) -> Optional[float]:
        """The given percentile over pixels of the relative standard error
        of each pixel's mean luminance (the adaptive stop signal), from the
        exact per-sample moments; None before 2 samples or without valid
        moments."""
        k = self.samples_done
        if k < 2 or not self._stats_valid:
            return None
        mean = luminance(self.acc) / k
        var = np.maximum(self.lum_sq / k - mean * mean, 0.0) * (k / (k - 1))
        stderr = np.sqrt(var / k)
        rel = stderr / np.maximum(mean, 1e-3)
        return float(np.percentile(rel, percentile))

    def peek(self) -> np.ndarray:
        """The current image: the average of the samples so far, tone-mapped."""
        if self.samples_done == 0:
            return np.zeros_like(self.acc)
        img = torch.from_numpy(self.acc) * float(np.float32(1.0 / self.samples_done))
        return max_to_one(img).numpy()

    @property
    def complete(self) -> bool:
        return self.samples_done >= self.spp

    def save(self, path: str) -> None:
        save_checkpoint(path, self.acc, self.samples_done, self.fingerprint, self.lum_sq)

    def resume(self, path: str) -> None:
        acc, done, fp, lum_sq, stats_valid = load_checkpoint(path)
        if fp != self.fingerprint:
            raise ValueError(
                "checkpoint belongs to a different (scene, root, depth, seed, "
                "nee, physical) configuration; refusing to resume"
            )
        if acc.shape != self.acc.shape:
            raise ValueError(f"checkpoint shape {acc.shape} != {self.acc.shape}")
        self.acc = acc
        self.lum_sq = lum_sq
        self._stats_valid = stats_valid
        self.samples_done = done
