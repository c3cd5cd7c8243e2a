"""Jobs, job IDs, render configuration and work units (``flux_tpu/job.py``;
fluxcore/src/job.rs).

A :class:`Job` bundles a scene with a :class:`JobConfiguration`;
:meth:`Job.work_units` slices the image into row bands that the scheduler
hands to workers. Everything serializes through ``to_dict``/``from_dict`` to
the same dicts as ``flux_tpu.job`` gives, so that a master and a node of
either package understand each other's ``set_job`` frames.

As in ``flux_tpu``: the configuration carries an explicit RNG ``seed``, and
the unit loop covers every row (the reference's ``while i < height - 1``,
job.rs:75, drops a final one-row unit).
"""

from __future__ import annotations

import itertools
import secrets
from dataclasses import dataclass
from typing import List, Tuple

from .scene import SceneData

__all__ = ["JobID", "JobIDAllocator", "JobConfiguration", "WorkUnit", "Job"]


@dataclass(frozen=True)
class JobID:
    """(allocator id, sequence number) — job.rs:12."""

    allocator_id: int
    seq: int

    def to_tuple(self) -> Tuple[int, int]:
        return (self.allocator_id, self.seq)


class JobIDAllocator:
    """Process-unique job-ID source (job.rs:14-34); the allocator id is
    random per instance so that IDs from different masters don't collide."""

    def __init__(self, allocator_id: int = None):
        self.allocator_id = secrets.randbits(48) if allocator_id is None else int(allocator_id)
        self._counter = itertools.count()

    def next_id(self) -> JobID:
        return JobID(self.allocator_id, next(self._counter))


@dataclass(frozen=True)
class JobConfiguration:
    """Render-quality knobs that travel with a job (job.rs:49-53). The
    estimator choices travel too: every worker, local or remote, must render
    a job with the same estimator."""

    sample_root: int
    max_trace_depth: int
    rows_per_work_unit: int
    seed: int = 0
    nee: bool = False
    physical: bool = False

    def to_dict(self) -> dict:
        return {
            "sample_root": self.sample_root,
            "max_trace_depth": self.max_trace_depth,
            "rows_per_work_unit": self.rows_per_work_unit,
            "seed": self.seed,
            "nee": self.nee,
            "physical": self.physical,
        }

    @staticmethod
    def from_dict(d: dict) -> "JobConfiguration":
        return JobConfiguration(
            sample_root=int(d["sample_root"]),
            max_trace_depth=int(d["max_trace_depth"]),
            rows_per_work_unit=int(d["rows_per_work_unit"]),
            seed=int(d.get("seed", 0)),
            nee=bool(d.get("nee", False)),
            physical=bool(d.get("physical", False)),
        )


@dataclass(frozen=True)
class WorkUnit:
    """Inclusive row band [row_start, row_end] of one job (job.rs:42-47)."""

    row_start: int
    row_end: int
    job_id: JobID

    @property
    def num_rows(self) -> int:
        return self.row_end - self.row_start + 1


@dataclass(frozen=True)
class Job:
    """Everything a worker needs to render: id, scene and configuration
    (job.rs:57-63)."""

    id: JobID
    scene_data: SceneData
    config: JobConfiguration

    def work_units(self) -> List[WorkUnit]:
        """Bands of ``rows_per_work_unit`` rows, the last one shorter where
        the height is not a multiple (job.rs:66-88)."""
        if self.config.rows_per_work_unit <= 0:
            raise ValueError(f"rows_per_work_unit invalid: {self.config.rows_per_work_unit}")
        height = self.scene_data.output_settings.image_height
        units = []
        i = 0
        while i < height:
            n = min(self.config.rows_per_work_unit, height - i)
            units.append(WorkUnit(row_start=i, row_end=i + n - 1, job_id=self.id))
            i += n
        return units

    def to_dict(self) -> dict:
        return {
            "id": self.id.to_tuple(),
            "scene_data": self.scene_data.to_dict(),
            "config": self.config.to_dict(),
        }

    @staticmethod
    def from_dict(d: dict) -> "Job":
        return Job(
            id=JobID(*d["id"]),
            scene_data=SceneData.from_dict(d["scene_data"]),
            config=JobConfiguration.from_dict(d["config"]),
        )
