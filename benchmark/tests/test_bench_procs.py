"""The program's device work in child processes (``procs.py``,
``child.py``) and what a run gathers from them: the requests and their
deadlines, a child that exits or is killed, a process group ended whole,
and the reports merged into the result line. Every wait here has a
deadline of its own."""

import json
import os
import shutil
import socket
import time
from pathlib import Path

import pytest

from benchmark import harness, procs
from benchmark.harness import run_cell
from benchmark.procs import ChildFailed, ProcessSpan, ProgramProcess, free_port
from benchmark.trace import TraceSummary

TESTS = Path(__file__).resolve().parent
STUB = "benchmark.tests.entry_stub"
START_S = 60.0  # a child's start: an interpreter, then torch where it is asked for


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def _wait_for(cond, timeout: float) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def test_a_child_answers_and_reports_on_the_cpu():
    port = free_port()
    p = ProgramProcess(0, [STUB, "listen", port], deadline_s=START_S)
    try:
        p.ready(port=port)
        p.window_start(True)
        p.window_end()
        r = p.report()
    finally:
        p.close()
    # With a card the child's profiler takes a context on it, and the child
    # names it; the stand-in allocates nothing there.
    import torch

    card = torch.cuda.get_device_name(0) if torch.cuda.is_available() else None
    assert r["launches"] == {} and r["card"] == card and r["memory_peak_bytes"] == 0
    assert r["forbidden"] == [] and r["spans"] == []
    assert isinstance(r["trace"], TraceSummary) and r["trace"].busy_s == 0.0 and r["trace"].busy_by_card == {}
    assert not p.alive() and _gone(p.pid)
    with pytest.raises(ChildFailed, match="closed"):
        p.report()


def test_a_missed_deadline_and_an_exit_fail_without_hanging():
    port = free_port()
    p = ProgramProcess(0, [STUB, "listen", port], deadline_s=START_S)
    try:
        t0 = time.monotonic()
        with pytest.raises(ChildFailed, match="no answer to ready within 1.5 s"):
            p.ready(port=free_port(), deadline_s=1.5)  # nothing listens there
        assert time.monotonic() - t0 < 10
    finally:
        p.close()
    q = ProgramProcess(0, [STUB, "exit", 7], deadline_s=START_S)
    try:
        with pytest.raises(ChildFailed, match="ended: returned 7|exited"):
            q.ready(port=free_port())
        assert _wait_for(lambda: not q.alive(), 30) and q._popen.returncode == 7
    finally:
        q.close()


def test_another_process_listening_on_the_port_is_not_ready():
    """Ready waits for the child's own listener: a socket of another
    process on the port, as when a port picked free is taken before the
    entry binds it, does not count."""
    with socket.socket() as foreign:
        foreign.bind(("127.0.0.1", 0))
        foreign.listen()
        taken = foreign.getsockname()[1]
        port = free_port()
        p = ProgramProcess(0, [STUB, "listen", port], deadline_s=START_S)
        try:
            p.ready(port=port)
            with pytest.raises(ChildFailed, match="no answer to ready within 1.5 s"):
                p.ready(port=taken, deadline_s=1.5)
        finally:
            p.close()
        # The entry itself cannot bind the taken port: it ends, and ready
        # fails with the entry's error or with the child's exit.
        q = ProgramProcess(0, [STUB, "listen", taken], deadline_s=START_S)
        try:
            with pytest.raises(ChildFailed, match="the entry ended: OSError|exited"):
                q.ready(port=taken)
        finally:
            q.close()


def test_close_ends_the_whole_process_group(tmp_path):
    """A child that ignores SIGTERM, and the process it started, are both
    gone after ``close``."""
    pidfile = tmp_path / "grandchild"
    p = ProgramProcess(0, [STUB, "stubborn", pidfile], deadline_s=START_S)
    try:
        assert _wait_for(lambda: pidfile.is_file() and pidfile.read_text(), START_S)
        p.ready()
    finally:
        p.close(grace_s=0.5)
    assert _gone(p.pid)
    grandchild = int(pidfile.read_text())
    assert _wait_for(lambda: _gone(grandchild), 10)  # reaped by init once killed


def test_a_child_ends_itself_when_the_harness_goes():
    port = free_port()
    p = ProgramProcess(0, [STUB, "listen", port], deadline_s=START_S)
    try:
        p.ready(port=port)
        p._sock.close()  # the harness's end of the channel, as when it dies
        p._sock = None
        assert _wait_for(lambda: not p.alive(), 30)
    finally:
        p.close()


def test_the_card_is_an_index_into_the_harness_cards():
    from benchmark.child import visible_card

    assert visible_card(2) == "2"
    assert visible_card(1, "3, 5,6") == "5"
    with pytest.raises(SystemExit):
        visible_card(4, "0,1")


class _Fake:
    """A child process that answers with a fixed report."""

    def __init__(self, card, busy, launches, fail=None):
        self.card, self.busy, self.launches, self.fail = card, busy, launches, fail
        self.asked, self.closed = [], False

    def _answer(self, op):
        self.asked.append(op)
        if op == self.fail:
            raise ChildFailed(f"fake on card {self.card}: {op}")

    def window_start(self, trace):
        self._answer("window_start")

    def window_end(self):
        self._answer("window_end")

    def report(self):
        self._answer("report")
        s = TraceSummary(busy_s=self.busy, window_s=1.0, kernel_s={"k": self.busy}, busy_by_card={self.card: self.busy},
                         gap_s={"g": 0.01})
        return {"launches": self.launches, "card": "NVIDIA H100 80GB HBM3", "memory_peak_bytes": 1000 + self.card,
                "forbidden": ["jax"] if self.card else [], "trace": s,
                "spans": [ProcessSpan(self.card, 1, "worker.unit", 0, 5, 1, 1, "t", "j", None, {})]}

    def close(self):
        self.closed = True


def _spec_with_metric(spec_all, tiny):
    (tiny / "metrics" / "child_spans.py").write_text(
        "def read(run):\n    return len(run.process_spans) + 0.5 * len({s.card for s in run.process_spans})\n")
    spec = dict(spec_all)
    spec["per_layer"] = spec["per_layer"] + [{"name": "child_spans", "unit": "spans", "better": "lower",
                                              "source": "program_span", "layer": "job path",
                                              "moves": "msamples_per_s.demo2", "workloads": ["demo2.final_16384spp"]}]
    return spec


@pytest.mark.parametrize("trace", [0, 1])
def test_the_reports_of_child_processes_are_merged(spec_all, tiny, monkeypatch, trace):
    fakes = [_Fake(0, 0.5, {"sweep": 3}), _Fake(1, 0.25, {"sweep": 2, "scene": 2})]
    monkeypatch.setattr(harness, "_processes", lambda drv: fakes)
    out = run_cell(_spec_with_metric(spec_all, tiny), "demo2.final_16384spp", 11, 0.2, bool(trace), device="cpu",
                   base=tiny)
    assert all(f.asked == ["window_start", "window_end", "report"] and f.closed for f in fakes)
    # On the CPU no launch is expected: every launch of a child is stray.
    assert out["checks"]["stray_launches"]["value"] == 7 and not out["correct"] and out["failed"] == 0
    assert out["device"]["memory_peak_bytes"] == 1001 and out["device"]["kind"] == "NVIDIA H100 80GB HBM3"
    assert out["forbidden"] == ["jax"] and out["unread"] == []
    if trace:
        assert out["metrics"]["child_spans"]["value"] == 2 + 0.5 * 2
        # Two cards in a one-card cell: the mean over both, the master's
        # window.
        assert out["device"]["busy_s"] == pytest.approx(0.375) and out["device"]["window_s"] < 1.0
        assert out["breakdown"]["device_ops"] == [["k", 0.75]] and out["breakdown"]["idle_gaps"] == [["g", 0.02]]


@pytest.mark.parametrize("op", ["window_start", "window_end", "report"])
def test_a_child_that_fails_a_request_fails_the_run(spec_all, tiny, monkeypatch, op):
    fakes = [_Fake(0, 0.5, {}, fail=op), _Fake(1, 0.25, {})]
    monkeypatch.setattr(harness, "_processes", lambda drv: fakes)
    out = run_cell(spec_all, "demo2.final_16384spp", 12, 0.2, True, device="cpu", base=tiny)
    assert out["failed"] == 1 and not out["correct"] and out["unread"] == [str(fakes[0])]
    assert fakes[0].asked[-1] == op and fakes[1].asked == ["window_start", "window_end", "report"]
    assert all(f.closed for f in fakes)


def test_main_refuses_a_forbidden_module_of_a_child(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {"correct": True, "forbidden": ["jax.numpy"],
                                                              "unread": [], "checks": {}})
    rc = harness.main(["--workload", "demo2.final_16384spp", "--seed", "1", "--seconds", "1", "--trace", "0"])
    got = capsys.readouterr()
    assert rc == 3 and got.out == "" and "jax.numpy" in got.err


def test_main_refuses_a_child_whose_modules_were_not_read(monkeypatch, capsys):
    """A child that failed before its report may hold anything: no result
    line."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {"correct": False, "forbidden": [],
                                                              "unread": ["child on card 1 (pid 7, m)"], "checks": {}})
    rc = harness.main(["--workload", "demo2.final_16384spp", "--seed", "1", "--seconds", "1", "--trace", "0"])
    got = capsys.readouterr()
    assert rc == 3 and got.out == "" and "child on card 1" in got.err


def test_a_master_with_children_traces_no_card():
    import torch
    from torch.profiler import ProfilerActivity

    cuda = torch.device("cuda")
    assert harness.profiler_activities(cuda, children=True, own_cuda=False) == [ProfilerActivity.CPU]
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    assert harness.profiler_activities(cuda, children=True, own_cuda=True) == both
    assert harness.profiler_activities(cuda, children=False, own_cuda=False) == both
    assert harness.profiler_activities(torch.device("cpu"), children=False, own_cuda=False) == [ProfilerActivity.CPU]


def _node_cell(spec, tiny, name, **mix):
    shutil.copy(TESTS / "node_frames.py", tiny / "drivers" / "node_frames.py")
    (tiny / "mixes" / f"{name}.json").write_text(json.dumps(
        {"driver": "node_frames", "nodes": 2, "sample_root": 2, "rows_per_unit": 4, "keep_frames": 3,
         "pixels_per_unit": 4, **mix}))
    shutil.copy(tiny / "limits" / "demo2.final_16384spp.json", tiny / "limits" / f"demo2.{name}.json")
    spec = dict(spec)
    spec["workloads"] = spec["workloads"] + [{"name": f"demo2.{name}", "config": "demo2", "traffic": name,
                                              "chips": 4, "why": "x"}]
    for m in spec["per_layer"]:
        if m["name"] == "child_spans":
            m["workloads"] = [f"demo2.{name}"]
    return spec


@pytest.fixture
def started(monkeypatch):
    """Every ProgramProcess a test starts."""
    got = []
    init = ProgramProcess.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        got.append(self)

    monkeypatch.setattr(procs.ProgramProcess, "__init__", record)
    return got


def test_frames_rendered_by_two_node_children(spec_all, tiny, started):
    """Two ``flux_tpu_torch.node`` children on the CPU behind
    ``NetworkWorker``s: the run is correct, and the spans of both reach the
    run, one ``worker.unit`` per unit of every window frame."""
    spec = _node_cell(_spec_with_metric(spec_all, tiny), tiny, "nodes2")
    units = len(range(0, 12, 4))
    (tiny / "metrics" / "child_spans.py").write_text(
        "def read(run):\n"
        "    units = [s for s in run.process_spans if s.name == 'worker.unit']\n"
        f"    assert len(units) == {units} * len(run.frames), (len(units), len(run.frames))\n"
        "    return len({s.card for s in units})\n")
    out = run_cell(spec, "demo2.nodes2", 2**31 + 5, 1.0, True, device="cpu", base=tiny)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1, out
    assert out["metrics"]["child_spans"]["value"] == 2 and out["forbidden"] == []
    assert out["device"]["busy_s"] == 0.0  # nothing ran on a card
    assert len(started) == 2 and all(_wait_for(lambda: _gone(p.pid), 10) for p in started)


def test_a_child_killed_in_the_window_fails_the_run(spec_all, tiny, started):
    """The first node dies after the first window frame: the other node
    renders the rest, and the run fails, well within its deadlines."""
    spec = _node_cell(spec_all, tiny, "nodes2_kill", kill_after_frames=1)
    t0 = time.monotonic()
    out = run_cell(spec, "demo2.nodes2_kill", 9, 1.5, False, device="cpu", base=tiny)
    assert time.monotonic() - t0 < 120
    assert not out["correct"] and out["failed"] == 1 and out["attempted"] >= 2
    assert out["unread"] == [str(started[0])]
    assert len(started) == 2 and all(_wait_for(lambda: _gone(p.pid), 10) for p in started)

