"""Renders to a noise target, as ``flux_tpu_torch/cli.py::run_progressive``
drives them: per render a ``Renderer`` on the card wrapped by
``ProgressiveRenderer.from_renderer``, then passes of ``pass_spp`` samples
(``render_pass``), each followed by ``max_rel_stderr``, until the p99
relative standard error is below ``target`` or the root² samples are done.
No checkpoint and no image are written. Renders run back to back.

Afterwards a sample of the window's renders, drawn from the seed, is
judged against the plain reference: the radiance sums and the Σ luminance²
channel at ``pixels`` pixels drawn from the seed, over the samples the
render did; the stop statistic worked out again from the render's own
accumulators; and, for every render of the window, that it stopped at the
first pass whose statistic was under the target.
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field

import numpy as np

from benchmark.drivers.job_frames import keep_index
from benchmark.harness import frame_seed

# Means below this are compared absolutely: a relative gap of a pixel
# near black says nothing.
_FLOOR = 1e-2


@dataclass
class Render:
    index: int
    seed: int
    t_start: float
    t_end: float = 0.0
    errs: list = field(default_factory=list)
    samples_done: int = 0
    acc: np.ndarray = field(default=None, repr=False)
    lum_sq: np.ndarray = field(default=None, repr=False)


def rel_gap(got, want) -> float:
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    d = d / np.maximum(np.abs(np.asarray(want, np.float64)), _FLOOR)
    return float(d.max()) if np.isfinite(d).all() else 1e300


class Driver:
    stats = True

    def __init__(self, *, config, mix, scene_path, device, seed, spans):
        self.config, self.mix, self.scene_path = config, mix, scene_path
        self.device, self.seed, self.spans = device, int(seed), spans
        self.root = int(mix["sample_root"])
        self.pass_spp = int(mix["pass_spp"])
        self.target = float(mix["target"])
        self.percentile = float(mix["percentile"])
        self.renders = []
        self.kept = []
        self.window_s = 0.0

    def setup(self) -> None:
        from flux_tpu_torch.checkpoint import ProgressiveRenderer
        from flux_tpu_torch.render import Renderer
        from flux_tpu_torch.scene import load_scene

        self._renderer, self._progressive = Renderer, ProgressiveRenderer
        self.scene = load_scene(self.scene_path)
        out = self.scene.output_settings
        self.width, self.height = out.image_width, out.image_height
        warm = self._begin(frame_seed(self.seed, "warm"))
        warm.render_pass(self.pass_spp)
        warm.max_rel_stderr(self.percentile)
        self.bands = math.ceil(self.height / warm._rows_per_band)

    def _begin(self, seed):
        r = self._renderer(self.scene, self.root, int(self.config["depth"]), seed=seed, device=self.device,
                           nee=bool(self.mix.get("nee")), physical=bool(self.mix.get("physical")))
        return self._progressive.from_renderer(r)

    def _render(self, index: int, seed: int) -> Render:
        rec = Render(index, seed, time.perf_counter())
        with self.spans("render"):
            pr = self._begin(seed)
            while not pr.complete:
                with self.spans("pass"):
                    pr.render_pass(self.pass_spp)
                with self.spans("stop_check"):
                    err = pr.max_rel_stderr(self.percentile)
                rec.errs.append(err)
                if err is not None and err < self.target:
                    break
        rec.t_end = time.perf_counter()
        rec.samples_done, rec.acc, rec.lum_sq = pr.samples_done, pr.acc, pr.lum_sq
        return rec

    def window(self, seconds: float) -> None:
        """Renders back to back; one starts while the window is open, and
        the window closes when the last of them has stopped."""
        k = int(self.mix["keep_renders"])
        rng = random.Random(f"keep:{self.seed}")
        self.renders, self.kept = [], []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while True:
            rec = self._render(i, frame_seed(self.seed, i))
            slot = keep_index(rng, i, k)
            if slot is None:
                rec.acc = rec.lum_sq = None
            elif slot < len(self.kept):
                self.kept[slot].acc = self.kept[slot].lum_sq = None
                self.kept[slot] = rec
            else:
                self.kept.append(rec)
            self.renders.append(rec)
            i += 1
            if rec.t_end >= deadline:
                break
        self.window_s = self.renders[-1].t_end - t0

    def launches_expected(self) -> int:
        return sum(len(r.errs) for r in self.renders) * self.bands

    @property
    def attempted(self) -> int:
        return len(self.renders)

    @property
    def failed(self) -> int:
        return 0

    def record(self) -> dict:
        return {"renders": self.renders, "window_s": self.window_s, "spans": self.spans}

    def close(self) -> None:
        pass

    def _stop_breaks(self, rec: Render) -> int:
        spp = self.root * self.root
        under = [e is not None and e < self.target for e in rec.errs]
        done = min(len(rec.errs) * self.pass_spp, spp)
        ends_right = under[-1] or done == spp
        return int(not ends_right or any(under[:-1]) or rec.samples_done != done)

    def verify(self, control: bool = False) -> dict:
        """The kept renders against the plain reference; with ``control``
        the reference computed in bfloat16 stands in the program's place:
        its state in bfloat16 for the accumulators, and the stop statistic
        in bfloat16 from the render's accumulators."""
        import torch

        from benchmark.reference.render import Reference, to_bfloat16
        from benchmark.reference.stats import rel_stderr

        kw = dict(root=self.root, depth=int(self.config["depth"]), nee=bool(self.mix.get("nee")),
                  physical=bool(self.mix.get("physical")), device=self.device)
        ref = Reference(self.scene_path, **kw)
        low = Reference(self.scene_path, round_state=to_bfloat16, **kw) if control else None
        n_px = int(self.mix["pixels"])
        acc_gap = lum_gap = stat_gap = 0.0
        bad = 0
        for rec in self.kept:
            k = rec.samples_done
            if not (np.isfinite(rec.acc).all() and np.isfinite(rec.lum_sq).all()):
                bad += 1
                continue
            rng = random.Random(f"pixels:{self.seed}:{rec.index}")
            rows = [rng.randrange(self.height) for _ in range(n_px)]
            cols = [rng.randrange(self.width) for _ in range(n_px)]
            want = ref.sums(rows, cols, rec.seed, 0, k, with_stats=True).cpu().numpy()
            if low is None:
                got = np.concatenate([rec.acc[rows, cols], rec.lum_sq[rows, cols][:, None]], axis=1)
            else:
                got = low.sums(rows, cols, rec.seed, 0, k, with_stats=True).cpu().numpy()
            acc_gap = max(acc_gap, rel_gap(got[:, :3] / k, want[:, :3] / k))
            lum_gap = max(lum_gap, rel_gap(got[:, 3] / k, want[:, 3] / k))
            if rec.errs[-1] is not None:
                stat = rel_stderr(rec.acc, rec.lum_sq, k, self.percentile)
                mine = rec.errs[-1] if low is None else rel_stderr(rec.acc, rec.lum_sq, k, self.percentile,
                                                                    dtype=torch.bfloat16)
                stat_gap = max(stat_gap, abs(mine - stat) / max(stat, 1e-12))
        return {"sum_rel_diff": acc_gap, "lum_sq_rel_diff": lum_gap, "stop_stat_rel_diff": stat_gap,
                "stop_rule_breaks": sum(self._stop_breaks(r) for r in self.renders), "bad_renders": bad}
