"""The per-layer metrics that read the program's own spans
(``program_spans.py``): per-frame sums on a filled recorder, and None off
the card, without spans, and for a program without the recorder."""

import sys
import time
import types
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import program_spans
from benchmark.harness import load_module
from flux_tpu_torch import metrics
from flux_tpu_torch.metrics import Span

MS = 1_000_000  # ns
CONFIGS = ("demo2", "cornell")


def _span(name, start_ms, end_ms, parent=None):
    return Span(0, name, start_ms * MS, end_ms * MS, 1, 1, "LocalWorker[local]", "job", parent, {})


# Two frames, from 1000 ms to 1400 ms on perf_counter's clock.
FRAMES = [SimpleNamespace(t_schedule=1.0, t_end=1.2), SimpleNamespace(t_schedule=1.2, t_end=1.4)]
FILLED = [
    _span("manager.queue_wait", 1000, 1001), _span("manager.dispatch", 1001, 1002),
    _span("worker.queue_wait", 1002, 1004), _span("worker.renderer_build", 1004, 1034),
    _span("sched.pull", 1034, 1035), _span("worker.unit", 1035, 1190),
    _span("kernel.launch", 1035, 1045), _span("kernel.pack_tables", 1036, 1044),
    _span("unit.readback", 1045, 1185), _span("unit.deliver", 1185, 1190),
    _span("sched.pull", 1190, 1191), _span("manager.finish", 1191, 1194),
    _span("worker.renderer_build", 1200, 1220), _span("kernel.launch", 1221, 1226),
    _span("manager.finish", 1399, 1402),  # sets the last frame's handle done: ends after the frame
    # Outside the frames: the warm frame, and work after the window.
    _span("worker.renderer_build", 900, 950), _span("kernel.launch", 1401, 1403),
]


def _run(**kw):
    base = dict(frames=FRAMES, device={"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3"})
    base.update(kw)
    return SimpleNamespace(**base)


def read(name, run):
    return load_module("metrics", name).read(run)


@pytest.mark.parametrize("config", CONFIGS)
def test_the_sums_per_frame_on_a_filled_recorder(monkeypatch, config):
    monkeypatch.setattr(metrics, "spans", lambda: list(FILLED))
    run = _run()
    assert read(f"renderer_build_ms.{config}", run) == pytest.approx((30 + 20) / 2)
    assert read(f"launch_host_ms.{config}", run) == pytest.approx((10 + 5) / 2)  # its table pack inside
    assert read(f"handoff_ms.{config}", run) == pytest.approx((1 + 2 + 1 + 1 + 3 + 3) / 2)


def test_the_real_recorder_is_read_by_time():
    metrics.clear()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        with metrics.span("worker.renderer_build", "job"):
            time.sleep(0.002)
        with metrics.span("sched.pull", "job"):
            pass
    t1 = time.perf_counter()
    frames = [SimpleNamespace(t_schedule=t0, t_end=t1)]
    got = metrics.spans()
    build = next(s for s in got if s.name == "worker.renderer_build")
    assert read("renderer_build_ms.cornell", _run(frames=frames)) == pytest.approx(
        (build.end_ns - build.start_ns) / 1e6)
    assert read("handoff_ms.demo2", _run(frames=frames)) > 0
    assert read("launch_host_ms.demo2", _run(frames=frames)) is None  # no launch in the window
    later = [SimpleNamespace(t_schedule=t1 + 1, t_end=t1 + 2)]
    assert read("renderer_build_ms.cornell", _run(frames=later)) is None


@pytest.mark.parametrize("metric", ["renderer_build_ms", "launch_host_ms", "handoff_ms"])
@pytest.mark.parametrize("config", CONFIGS)
def test_none_off_the_card_without_spans_and_without_the_recorder(monkeypatch, metric, config):
    name = f"{metric}.{config}"
    monkeypatch.setattr(metrics, "spans", lambda: list(FILLED))
    assert read(name, _run(device={"platform": "cpu"})) is None
    assert read(name, _run(frames=[])) is None
    monkeypatch.setattr(metrics, "spans", lambda: [])
    assert read(name, _run()) is None
    # A program whose metrics module has no recorder (the parent of this one).
    monkeypatch.setitem(sys.modules, "flux_tpu_torch.metrics", types.ModuleType("flux_tpu_torch.metrics"))
    assert read(name, _run()) is None
    assert program_spans.span_ms(_run(), program_spans.HANDOFF) is None
