"""Scheduler round: the work-unit dispatch of a job's round
(``flux_tpu/sched.py``).

One ``SchedulerRound`` is a single pull-dispatch round over a list of work
units — the concurrency core the reference builds from crossbeam: the
bounded(1) shared channel that load-balances units across workers
(manager.rs:100,120-141), the ``CancellableIterator`` (manager.rs:365-393),
the ``WaitGroup`` barrier (manager.rs:101,166), and the completion ledger
behind the lost-unit retry (which the reference lacks). Handout is one
cursor under a lock: workers pull the next undispatched unit exactly once.

The round object plays both roles workers expect: it is the *unit queue*
(``get()`` returns the next unit or ``None`` when drained or cancelled) and
the *wait group* (``done()`` / ``wait()``).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

from .job import WorkUnit

__all__ = ["SchedulerRound"]


class SchedulerRound:
    """One dispatch round over ``units`` pulled by ``n_workers`` workers.

    Presents the queue interface workers drain (``get()``) and the barrier
    the manager waits on (``done()``/``wait()``). ``cancel_event`` (a
    ``threading.Event``) is checked at every pull, mirroring the reference's
    producer checking cancellation before each put (manager.rs:127-133).
    """

    def __init__(
        self,
        units: Sequence[WorkUnit],
        n_workers: int,
        cancel_event: Optional[threading.Event] = None,
    ):
        self._units = list(units)
        self._cancel_event = cancel_event
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._next = 0
        self._workers = n_workers
        self._cancelled = False
        self._completed = [False] * len(self._units)
        self._by_row = {u.row_start: i for i, u in enumerate(self._units)}

    # -- unit-queue face (what workers drain) -------------------------------
    def get(self) -> Optional[WorkUnit]:
        with self._lock:
            if self._cancel_event is not None and self._cancel_event.is_set():
                self._cancelled = True
            if self._cancelled or self._next >= len(self._units):
                return None
            self._next += 1
            return self._units[self._next - 1]

    # -- wait-group face (what the manager blocks on) -----------------------
    def done(self) -> None:
        with self._cond:
            self._workers -= 1
            if self._workers <= 0:
                self._cond.notify_all()

    def wait(self, timeout: Optional[float] = None) -> bool:
        with self._cond:
            return self._cond.wait_for(lambda: self._workers <= 0, timeout=timeout)

    # -- ledger --------------------------------------------------------------
    def complete_row(self, row_start: int) -> None:
        i = self._by_row.get(row_start)
        if i is not None:
            with self._lock:
                self._completed[i] = True

    def missing(self) -> List[WorkUnit]:
        with self._lock:
            return [u for u, c in zip(self._units, self._completed) if not c]

    def cancel(self) -> None:
        with self._lock:
            self._cancelled = True

    def cancelled(self) -> bool:
        with self._lock:
            return self._cancelled
