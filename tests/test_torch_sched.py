"""The port's scheduler round on both of its cores: the native one
(``csrc/fluxnative.cpp`` ``flux_sched_*``) and the Python one
(``force_python=True``). Each behaviour of ``tests/test_sched.py`` runs on
both; then the round's lifetime (close, and calls after it), the cores'
refusal or acceptance of a round with no worker as in ``flux_tpu``, the
native quantizer, and a manager job that closes every round it made.

Every wait has a timeout, and every thread is joined with one."""

import ctypes
import sys
import threading

import numpy as np
import pytest
import torch

from flux_tpu import job as j_job
from flux_tpu import sched as j_sched
from flux_tpu_torch import native, sched
from flux_tpu_torch.job import JobConfiguration, WorkUnit
from flux_tpu_torch.sched import SchedulerRound, native_sched_available
from flux_tpu_torch.workers import LocalWorker
from tests.test_torch_job import WAIT, band_loop, cpu_factory, run_job, tiny_scene


def _units(n):
    return [WorkUnit(row_start=i * 10, row_end=i * 10 + 9, job_id=None) for i in range(n)]


@pytest.fixture(params=[True, False], ids=["python", "native"])
def force_python(request):
    return request.param


def _drive(rnd, n_workers, body=None):
    """``n_workers`` threads drain ``rnd``, each calling ``body(unit)`` on
    what it pulls, then ``done()``; returns the rows each pulled."""
    pulled = [[] for _ in range(n_workers)]

    def worker(k):
        while (u := rnd.get()) is not None:
            pulled[k].append(u.row_start)
            if body is not None:
                body(u)
        rnd.done()

    threads = [threading.Thread(target=worker, args=(k,), daemon=True) for k in range(n_workers)]
    for t in threads:
        t.start()
    assert rnd.wait(30.0)
    for t in threads:
        t.join(5)
        assert not t.is_alive()
    return pulled


def test_native_core_builds():
    """Where g++ is installed (the test hosts and the card's host), the
    native core must be there, not the Python core in its place."""
    assert native_sched_available(), native.load_error
    assert SchedulerRound([], 1).native and not SchedulerRound([], 1, force_python=True).native


def test_exactly_once_handout(force_python):
    rnd = SchedulerRound(_units(100), 1, force_python=force_python)
    assert rnd.native is not force_python
    seen = []
    while (u := rnd.get()) is not None:
        seen.append(u.row_start)
    assert seen == [i * 10 for i in range(100)]
    assert rnd.get() is None  # drained stays drained
    rnd.close()


def test_concurrent_pulls_are_disjoint_and_complete(force_python):
    """Eight threads, with the interpreter switching threads every
    microsecond: no unit lost or handed out twice."""
    n = 500
    rnd = SchedulerRound(_units(n), 8, force_python=force_python)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pulled = _drive(rnd, 8)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(r for p in pulled for r in p) == [i * 10 for i in range(n)]
    rnd.close()


def test_cancellation_stops_handout(force_python):
    cancel = threading.Event()
    rnd = SchedulerRound(_units(50), 1, cancel_event=cancel, force_python=force_python)
    assert rnd.get() is not None and not rnd.cancelled()
    cancel.set()
    assert rnd.get() is None  # checked at every pull (manager.rs:127-133)
    assert rnd.cancelled()
    rnd.close()


def test_missing_ledger(force_python):
    rnd = SchedulerRound(_units(6), 1, force_python=force_python)
    while rnd.get() is not None:
        pass
    for row in (0, 20, 50):
        rnd.complete_row(row)
    rnd.complete_row(99999)  # unknown rows are ignored
    assert [u.row_start for u in rnd.missing()] == [10, 30, 40]
    rnd.close()


def test_waitgroup_barrier_and_timeout(force_python):
    rnd = SchedulerRound(_units(1), 2, force_python=force_python)
    assert not rnd.wait(0.05)  # no worker finished yet
    assert not rnd.wait(0)
    rnd.done()
    assert not rnd.wait(0.05)  # one of two
    rnd.done()
    assert rnd.wait(1.0) and rnd.wait(0) and rnd.wait()
    rnd.close()


def test_empty_round(force_python):
    rnd = SchedulerRound([], 3, force_python=force_python)
    assert rnd.get() is None
    assert rnd.missing() == []
    for _ in range(3):
        rnd.done()
    assert rnd.wait(1.0)
    rnd.close()


def test_native_and_python_agree_under_contention():
    results = {}
    for force in (False, True):
        rnd = SchedulerRound(_units(200), 4, force_python=force)
        pulled = _drive(rnd, 4, lambda u: rnd.complete_row(u.row_start))
        results[force] = (sorted(r for p in pulled for r in p), [u.row_start for u in rnd.missing()])
        rnd.close()
    assert results[False] == results[True] == ([i * 10 for i in range(200)], [])


@pytest.mark.parametrize("face", ["get", "done", "wait", "complete_row", "missing", "cancel", "cancelled"])
def test_close_is_idempotent_and_a_later_call_raises(force_python, face):
    """After close() every face of either core raises RuntimeError (the
    native core's handle never reaches C++ again); a second close is a
    no-op."""
    rnd = SchedulerRound(_units(3), 1, force_python=force_python)
    assert rnd.get().row_start == 0
    rnd.close()
    rnd.close()
    args = {"wait": (0.01,), "complete_row": (0,)}.get(face, ())
    with pytest.raises(RuntimeError, match="closed"):
        getattr(rnd, face)(*args)
    rnd.close()


def test_a_round_with_no_worker():
    """The native core refuses n_workers < 1 (flux_sched_create returns
    NULL) and the Python core accepts it, a barrier released from the
    start: as in flux_tpu, whose cores do the same."""
    with pytest.raises(RuntimeError, match="flux_sched_create"):
        SchedulerRound(_units(2), 0)
    with pytest.raises(RuntimeError):
        j_sched.SchedulerRound([j_job.WorkUnit(row_start=0, row_end=9, job_id=None)], 0)
    for make in (lambda: SchedulerRound(_units(2), 0, force_python=True),
                 lambda: j_sched.SchedulerRound([j_job.WorkUnit(row_start=0, row_end=9, job_id=None)], 0,
                                                force_python=True)):
        rnd = make()
        assert rnd.wait(0) and rnd.get() is not None
        rnd.close()


def test_quantize_u16_equals_numpy():
    """flux_quantize_u16 truncates v·65535.99 into [0, 65535], as the
    reference's PPM writer does (image.rs:49-52): edge values, values far
    past 1 (the product clamped before its cast) and NaN (0) included."""
    lib = native.get_lib()
    assert lib is not None, native.load_error
    rng = np.random.default_rng(11)
    v = np.concatenate([
        rng.random(1000, dtype=np.float32),
        rng.uniform(-2.0, 3.0, 200).astype(np.float32),
        np.float32([0.0, 1.0, 1.0000001, -0.0, -1e-30, -1.0, 0.9999999, 1e-9, 2.0, np.finfo(np.float32).max,
                    np.inf, -np.inf, np.nan]),
    ])
    out = np.full(v.shape, 7, np.uint16)
    lib.flux_quantize_u16(v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), v.size)
    x = np.nan_to_num(v.astype(np.float64), nan=0.0, posinf=np.inf, neginf=-np.inf)
    want = np.clip(np.floor(x * 65535.99), 0, 65535).astype(np.uint16)
    np.testing.assert_array_equal(out, want)
    assert out[1000 + 200 + 1] == 65535 and out[1000 + 200 + 2] == 65535 and out[1000 + 200 + 5] == 0


def test_a_job_with_a_flaky_worker_closes_every_round(tmp_path, monkeypatch):
    """The manager closes each round it made exactly once: the first round
    and the retry round of a job whose flaky worker lost a unit (the
    scenario of test_torch_job.py's retry test), each on the native core."""
    made, closes = [], []
    close = SchedulerRound.close

    def counted_close(self):
        closes.append(self)
        close(self)

    class Counted(SchedulerRound):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(SchedulerRound, "close", counted_close)
    monkeypatch.setattr(sched, "SchedulerRound", Counted)
    sd = tiny_scene()
    cfg = JobConfiguration(sample_root=2, max_trace_depth=2, rows_per_work_unit=2, seed=3)
    go = threading.Event()

    class Flaky:
        def __init__(self, job):
            self._r, self._n = cpu_factory(job), 0

        def render_rows(self, row0, n_rows):
            self._n += 1
            if self._n == 2:
                raise RuntimeError("injected worker failure")
            go.wait(timeout=WAIT)
            return self._r.render_rows(row0, n_rows)

    class Healthy:
        def __init__(self, job):
            self._r = cpu_factory(job)

        def render_rows(self, row0, n_rows):
            go.set()
            return self._r.render_rows(row0, n_rows)

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    flaky = LocalWorker(renderer_factory=Flaky, name="flaky", device="cpu")
    healthy = LocalWorker(renderer_factory=Healthy, name="healthy", device="cpu")
    try:
        handle, img, _ = run_job([flaky.handle(), healthy.handle()], sd, cfg, tmp_path)
        want = band_loop(sd, cfg)
    finally:
        go.set()
        flaky.stop()
        healthy.stop()
        torch.set_num_threads(n)
    assert handle.ok, handle.error
    assert handle.retry_rounds == 1
    assert len(made) == 2 and all(r.native for r in made)
    assert sorted(map(id, closes)) == sorted(map(id, made))
    assert all(r._core._h is None for r in made)
    assert np.array_equal(img.pixels, want)
