"""Whole frames through the job path, as the CLI builds it
(``flux_tpu_torch/cli.py::_run_job_path``): a ``LocalWorker`` with the
default renderer factory, a ``RenderManager`` over it, and one
``schedule_job`` then ``wait`` per frame, with ``rows_per_unit`` rows a
work unit. One client, frames back to back (a closed loop); the
benchmark's own sink puts each frame together in memory from its
``RowsReady`` events, and nothing is written per frame.

Afterwards a sample of the window's frames, drawn from the seed, is judged
pixel by pixel against the plain reference: in every unit of a kept frame,
``pixels_per_unit`` pixels drawn from the seed.
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field

import numpy as np

from benchmark.harness import frame_seed


@dataclass
class Frame:
    index: int
    seed: int
    samples: int
    t_schedule: float
    t_last_unit: float = 0.0
    t_end: float = 0.0
    ok: bool = True
    pixels: np.ndarray = field(default=None, repr=False)


class FrameSink:
    """The event sink of one frame: its rows into one array, and which
    units came, once each and whole."""

    def __init__(self, pixels: np.ndarray):
        from flux_tpu_torch.manager import JobFailed, RowsReady

        self._rows_ready, self._job_failed = RowsReady, JobFailed
        self.width = pixels.shape[1]
        self.pixels = pixels
        self.starts = []
        self.bad = 0
        self.t_last = 0.0

    def put(self, ev) -> None:
        if isinstance(ev, self._rows_ready):
            unit, rows = ev.result.work_unit, ev.result.rows
            if np.shape(rows) == (unit.num_rows, self.width, 3):
                self.pixels[unit.row_start : unit.row_end + 1] = rows
            else:
                self.bad += 1
            self.starts.append(unit.row_start)
            self.t_last = time.perf_counter()
        elif isinstance(ev, self._job_failed):
            self.bad += 1


def keep_index(rng: random.Random, i: int, k: int):
    """Reservoir sampling: the slot frame ``i`` takes among ``k`` kept
    frames, or None."""
    if i < k:
        return i
    j = rng.randrange(i + 1)
    return j if j < k else None


class Driver:
    stats = False

    def __init__(self, *, config, mix, scene_path, device, seed, spans):
        self.config, self.mix, self.scene_path = config, mix, scene_path
        self.device, self.seed, self.spans = device, int(seed), spans
        self.root = int(mix["sample_root"])
        self.rows = int(mix["rows_per_unit"])
        self.frames = []
        self.kept = []
        self.window_s = 0.0
        self._spare = None  # a frame buffer to fill next: a frame not kept hands its buffer on

    def setup(self) -> None:
        from flux_tpu_torch.job import JobConfiguration
        from flux_tpu_torch.manager import RenderManager
        from flux_tpu_torch.scene import load_scene

        self._job_config = JobConfiguration
        self.scene = load_scene(self.scene_path)
        out = self.scene.output_settings
        self.width, self.height = out.image_width, out.image_height
        self.starts = list(range(0, self.height, self.rows))
        self.workers = self._workers()
        self.manager = RenderManager([w.handle() for w in self.workers])
        warm = self._frame(-1, frame_seed(self.seed, "warm"))
        if not warm.ok:
            raise RuntimeError("the warm-up frame failed")
        self._spare = warm.pixels

    def _workers(self) -> list:
        """The workers the manager sends the units to: one ``LocalWorker``,
        whose default factory keeps the scene state across jobs."""
        from flux_tpu_torch.workers import LocalWorker

        return [LocalWorker(device=self.device)]

    def _frame(self, index: int, seed: int) -> Frame:
        cfg = self._job_config(
            sample_root=self.root, max_trace_depth=int(self.config["depth"]), rows_per_work_unit=self.rows,
            seed=seed, nee=bool(self.mix.get("nee")), physical=bool(self.mix.get("physical")),
        )
        if self._spare is None:
            self._spare = np.empty((self.height, self.width, 3), np.float32)
        sink, self._spare = FrameSink(self._spare), None
        rec = Frame(index, seed, self.width * self.height * self.root**2, time.perf_counter())
        with self.spans("frame"):
            handle = self.manager.schedule_job(self.scene, cfg, sink)
            handle.wait()
        rec.t_end = time.perf_counter()
        rec.t_last_unit = sink.t_last
        rec.ok = handle.error is None and sink.bad == 0 and sorted(sink.starts) == self.starts
        rec.pixels = sink.pixels
        return rec

    def window(self, seconds: float) -> None:
        """Frames back to back; a frame starts while the window is open,
        and the window closes when the last of them has ended."""
        k = int(self.mix["keep_frames"])
        rng = random.Random(f"keep:{self.seed}")
        self.frames, self.kept = [], []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while True:
            rec = self._frame(i, frame_seed(self.seed, i))
            slot = keep_index(rng, i, k)
            if slot is None:
                self._spare, rec.pixels = rec.pixels, None
            elif slot < len(self.kept):
                self._spare, self.kept[slot].pixels = self.kept[slot].pixels, None
                self.kept[slot] = rec
            else:
                self.kept.append(rec)
            self.frames.append(rec)
            i += 1
            if rec.t_end >= deadline:
                break
        self.window_s = self.frames[-1].t_end - t0

    def launches_expected(self) -> int:
        return len(self.frames) * len(self.starts)

    @property
    def attempted(self) -> int:
        return len(self.frames)

    @property
    def failed(self) -> int:
        return sum(not f.ok for f in self.frames)

    def record(self) -> dict:
        return {"frames": self.frames, "window_s": self.window_s, "spans": self.spans}

    def close(self) -> None:
        self.manager.stop()
        for w in self.workers:
            w.stop()
        self.manager, self.workers = None, []

    def verify(self, control: bool = False) -> dict:
        """The kept frames against the plain reference, at the pixels drawn
        from the seed. With ``control`` the reference computed with its
        state in bfloat16 stands in the program's place."""
        from benchmark.reference.render import Reference, to_bfloat16

        kw = dict(root=self.root, depth=int(self.config["depth"]), nee=bool(self.mix.get("nee")),
                  physical=bool(self.mix.get("physical")), device=self.device)
        ref = Reference(self.scene_path, **kw)
        low = Reference(self.scene_path, round_state=to_bfloat16, **kw) if control else None
        per_unit = int(self.mix["pixels_per_unit"])
        worst, total, n, bad = 0.0, 0.0, 0, 0
        for rec in self.kept:
            if not np.isfinite(rec.pixels).all():
                bad += 1
                continue
            rng = random.Random(f"pixels:{self.seed}:{rec.index}")
            rows, cols = [], []
            for r0 in self.starts:
                r1 = min(r0 + self.rows, self.height)
                for _ in range(per_unit):
                    rows.append(rng.randrange(r0, r1))
                    cols.append(rng.randrange(self.width))
            want = ref.pixels(rows, cols, rec.seed).cpu().numpy()
            got = rec.pixels[rows, cols] if low is None else low.pixels(rows, cols, rec.seed).cpu().numpy()
            d = np.abs(got.astype(np.float64) - want)
            worst = max(worst, float(d.max()) if np.isfinite(d).all() else math.inf)
            total += float(d.sum())
            n += d.size
        worst = worst if math.isfinite(worst) else 1e300
        return {"max_abs_diff": worst, "mean_abs_diff": total / max(n, 1),
                "bad_frames": self.failed + bad}
