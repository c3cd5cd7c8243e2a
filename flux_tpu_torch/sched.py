"""Scheduler round: native (C++) work-unit dispatch with a Python fallback
(``flux_tpu/sched.py``).

One ``SchedulerRound`` is a single pull-dispatch round over a list of work
units — the concurrency core the reference builds from crossbeam: the
bounded(1) shared channel that load-balances units across workers
(manager.rs:100,120-141), the ``CancellableIterator`` (manager.rs:365-393),
the ``WaitGroup`` barrier (manager.rs:101,166), and the completion ledger
behind the lost-unit retry (which the reference lacks). Those pieces are
native Rust in the reference; here they are native C++ (``csrc/fluxnative.cpp``
``flux_sched_*``) reached over ctypes, with a lock-based Python core for
hosts without a compiler (or ``force_python=True``). Handout is one cursor
under a lock: workers pull the next undispatched unit exactly once.

The round object plays both roles workers expect: it is the *unit queue*
(``get()`` returns the next unit or ``None`` when drained or cancelled) and
the *wait group* (``done()`` / ``wait()``), so worker loops do not know
which core is live. ``close()`` frees the round's native handle; it is
idempotent, and any other call after it raises ``RuntimeError`` on either
core.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence

from .job import WorkUnit
from .native import get_lib

__all__ = ["SchedulerRound", "native_sched_available"]

_CLOSED = "the scheduler round is closed"


def native_sched_available() -> bool:
    """True where the native library loads with its scheduler core."""
    lib = get_lib()
    return lib is not None and hasattr(lib, "flux_sched_create")


def _timeout_ms(timeout: Optional[float]) -> int:
    """A barrier timeout in whole milliseconds, -1 for none: both cores
    wait the same time for the same argument."""
    return -1 if timeout is None else max(0, int(timeout * 1000))


class _PyCore:
    """The round's core in Python (the C++ struct's logic, under one lock).
    Unlike the native core it accepts ``n_workers < 1`` (a barrier that is
    released from the start), as ``flux_tpu``'s does."""

    def __init__(self, n_units: int, n_workers: int):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._n = n_units
        self._next = 0
        self._workers = n_workers
        self._cancelled = False
        self._completed = [False] * n_units
        self._closed = False

    def _check(self) -> None:
        if self._closed:
            raise RuntimeError(_CLOSED)

    def pull(self) -> int:
        with self._lock:
            self._check()
            if self._cancelled or self._next >= self._n:
                return -1
            self._next += 1
            return self._next - 1

    def complete(self, i: int) -> None:
        with self._lock:
            self._check()
            if 0 <= i < self._n:
                self._completed[i] = True

    def cancel(self) -> None:
        with self._lock:
            self._check()
            self._cancelled = True

    def cancelled(self) -> bool:
        with self._lock:
            self._check()
            return self._cancelled

    def worker_done(self) -> None:
        with self._cond:
            self._check()
            self._workers -= 1
            if self._workers <= 0:
                self._cond.notify_all()

    def wait(self, timeout: Optional[float]) -> bool:
        ms = _timeout_ms(timeout)
        with self._cond:
            self._check()
            released = self._cond.wait_for(lambda: self._workers <= 0 or self._closed,
                                           timeout=None if ms < 0 else ms / 1000)
            self._check()
            return released

    def missing(self) -> List[int]:
        with self._lock:
            self._check()
            return [i for i, c in enumerate(self._completed) if not c]

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


class _NativeCore:
    """ctypes shim over the C++ ``flux_sched_*`` ABI.

    Every call holds the handle in flight under ``_gate``; ``close`` takes
    the handle away under the same lock, so no later call can reach C++
    with it, and destroys it once the calls in flight have returned (a
    thread blocked in ``wait`` keeps it alive until the barrier releases)."""

    def __init__(self, lib, n_units: int, n_workers: int):
        self._lib = lib
        self._h = lib.flux_sched_create(n_units, n_workers)
        if not self._h:
            raise RuntimeError(f"flux_sched_create({n_units}, {n_workers}) failed")
        self._n = n_units
        self._gate = threading.Condition()
        self._calls = 0

    def _call(self, fn, *args):
        with self._gate:
            if self._h is None:
                raise RuntimeError(_CLOSED)
            self._calls += 1
            h = self._h
        try:
            return fn(h, *args)
        finally:
            with self._gate:
                self._calls -= 1
                if not self._calls:
                    self._gate.notify_all()

    def pull(self) -> int:
        return self._call(self._lib.flux_sched_pull)

    def complete(self, i: int) -> None:
        self._call(self._lib.flux_sched_complete, i)

    def cancel(self) -> None:
        self._call(self._lib.flux_sched_cancel)

    def cancelled(self) -> bool:
        return bool(self._call(self._lib.flux_sched_cancelled))

    def worker_done(self) -> None:
        self._call(self._lib.flux_sched_worker_done)

    def wait(self, timeout: Optional[float]) -> bool:
        # ctypes (CDLL, not PyDLL) releases the GIL around the call, so the
        # barrier blocks natively without starving other Python threads.
        return bool(self._call(self._lib.flux_sched_wait, _timeout_ms(timeout)))

    def missing(self) -> List[int]:
        out = (ctypes.c_int32 * max(self._n, 1))()
        n = self._call(self._lib.flux_sched_missing, out)
        return list(out[:n])

    def close(self) -> None:
        with self._gate:
            h, self._h = self._h, None
            if h is None:
                return
            self._gate.wait_for(lambda: not self._calls)
            self._lib.flux_sched_destroy(h)


def _register(lib) -> None:
    """Declares the ``flux_sched_*`` signatures, once per library."""
    if getattr(lib, "_flux_sched_registered", False):
        return
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    for name, restype, argtypes in (
        ("flux_sched_create", vp, [i32, i32]),
        ("flux_sched_destroy", None, [vp]),
        ("flux_sched_pull", i32, [vp]),
        ("flux_sched_complete", None, [vp, i32]),
        ("flux_sched_cancel", None, [vp]),
        ("flux_sched_cancelled", i32, [vp]),
        ("flux_sched_worker_done", None, [vp]),
        ("flux_sched_wait", i32, [vp, ctypes.c_int64]),
        ("flux_sched_missing", i32, [vp, ctypes.POINTER(i32)]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    lib._flux_sched_registered = True


class SchedulerRound:
    """One dispatch round over ``units`` pulled by ``n_workers`` workers.

    Presents the queue interface workers drain (``get()``) and the barrier
    the manager waits on (``done()``/``wait()``). ``cancel_event`` (a
    ``threading.Event``) is checked at every pull, mirroring the reference's
    producer checking cancellation before each put (manager.rs:127-133).
    The round runs on the native core whenever the library loads (``.native``
    says which), on the Python core with ``force_python``.
    """

    def __init__(
        self,
        units: Sequence[WorkUnit],
        n_workers: int,
        cancel_event: Optional[threading.Event] = None,
        force_python: bool = False,
    ):
        self._units = list(units)
        self._cancel_event = cancel_event
        lib = None if force_python else get_lib()
        if lib is not None and hasattr(lib, "flux_sched_create"):
            _register(lib)
            self._core = _NativeCore(lib, len(self._units), n_workers)
            self.native = True
        else:
            self._core = _PyCore(len(self._units), n_workers)
            self.native = False
        self._by_row = {u.row_start: i for i, u in enumerate(self._units)}

    # -- unit-queue face (what workers drain) -------------------------------
    def get(self) -> Optional[WorkUnit]:
        if self._cancel_event is not None and self._cancel_event.is_set():
            self._core.cancel()
        i = self._core.pull()
        return None if i < 0 else self._units[i]

    def get_nowait(self) -> Optional[WorkUnit]:
        """:meth:`get`, which never waits: a pull takes the next unit or
        finds the round drained or cancelled."""
        return self.get()

    # -- wait-group face (what the manager blocks on) -----------------------
    def done(self) -> None:
        self._core.worker_done()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._core.wait(timeout)

    # -- ledger --------------------------------------------------------------
    def complete_row(self, row_start: int) -> None:
        i = self._by_row.get(row_start)
        if i is not None:
            self._core.complete(i)

    def missing(self) -> List[WorkUnit]:
        return [self._units[i] for i in self._core.missing()]

    def cancel(self) -> None:
        self._core.cancel()

    def cancelled(self) -> bool:
        return self._core.cancelled()

    def close(self) -> None:
        """Frees the round (its native handle); idempotent."""
        self._core.close()
