"""The metric arithmetic on a fixed trace and fixed spans, and the frozen
operation count."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import roofline, trace
from benchmark.harness import BENCH_DIR, Spans, load_module

MS = 1_000_000  # ns


def _fixed_trace():
    # Two frames of 100 ms each on the host; device: two kernels of 40 ms
    # and a 2-ms copy, overlapping the second kernel by 1 ms.
    dev = [(0, 40 * MS, "void sweep_megakernel<0,0,0,0>(...)"),
           (100 * MS, 140 * MS, "void sweep_megakernel<0,0,0,0>(...)"),
           (139 * MS, 141 * MS, "Memcpy DtoH (Device -> Pageable)")]
    host = [(-5 * MS, 95 * MS, "bench.frame"), (40 * MS, 60 * MS, "aten::copy_"),
            (95 * MS, 200 * MS, "bench.frame"), (141 * MS, 190 * MS, "cudaStreamSynchronize")]
    return dev, host


def test_reduce_a_fixed_trace():
    s = trace.reduce(*_fixed_trace(), window_s=0.2)
    assert s.busy_s == pytest.approx(0.081)
    assert s.kernel_seconds("sweep_megakernel") == pytest.approx(0.080)
    assert s.device_ops[0] == ["void sweep_megakernel<0,0,0,0>(...)", pytest.approx(0.080)]
    # The one gap, 40-100 ms, is named by what covers its middle (70 ms).
    assert s.idle_gaps == [["bench.frame", pytest.approx(0.060)]]
    assert trace.union_ns([(5, 9, "a"), (0, 3, "b"), (2, 4, "c")]) == [[0, 4], [5, 9]]
    # One card: the union's seconds exactly, whether or not the events name
    # their card.
    dev, host = _fixed_trace()
    assert s.busy_s == 81 * MS * 1e-9 and s.busy_by_card == {0: 81 * MS * 1e-9}
    assert trace.reduce([(*e, 0) for e in dev], host, window_s=0.2) == s


def test_two_cards_are_two_cards():
    """Card 0 runs the fixed trace's 81 ms; card 1 runs 30 ms, overlapping
    card 0's, with one 50-ms gap. Busy time is the mean over the cards, not
    their union; kernel seconds and gaps are sums."""
    dev, host = _fixed_trace()
    two = dev + [(10 * MS, 20 * MS, "void sweep_megakernel<0,0,0,0>(...)", 1),
                 (70 * MS, 90 * MS, "void sweep_megakernel<0,0,0,0>(...)", 1)]
    s = trace.reduce(two, host, window_s=0.2, cards=2)
    assert s.busy_by_card == {0: pytest.approx(0.081), 1: pytest.approx(0.030)}
    assert s.busy_s == pytest.approx((0.081 + 0.030) / 2)
    assert s.kernel_seconds("sweep_megakernel") == pytest.approx(0.110)
    # Card 1's gap, 20-70 ms, is named by what covers its middle (45 ms).
    assert s.idle_gaps == [["bench.frame", pytest.approx(0.060)], ["aten::copy_", pytest.approx(0.050)]]
    # A four-card cell whose other two cards ran nothing: idle, in the mean.
    assert trace.reduce(two, host, window_s=0.2, cards=4).busy_s == pytest.approx(0.111 / 4)
    # The same two cards traced by two processes, one card each, as the
    # harness merges them; the master's own trace ran nothing.
    card0 = trace.reduce(dev, host, window_s=0.21, cards=0)
    card1 = trace.reduce([(a, b, n, 1) for a, b, n, _ in two[3:]], host, window_s=0.22, cards=0)
    master = trace.reduce([], host, window_s=0.2, cards=2)
    both = trace.combine([master, card0, card1], cards=2, window_s=0.2)
    assert (both.busy_s, both.window_s, both.kernel_s, both.device_ops) == (s.busy_s, 0.2, s.kernel_s, s.device_ops)
    assert both.busy_by_card == s.busy_by_card and both.idle_gaps == s.idle_gaps
    assert trace.combine([card1], cards=4).busy_s == pytest.approx(0.030 / 4)
    assert trace.combine([card0, card1], cards=1).window_s == 0.22


def _run(**kw):
    frames = [SimpleNamespace(samples=480_000, t_schedule=0.0, t_last_unit=0.1),
              SimpleNamespace(samples=480_000, t_schedule=0.1, t_last_unit=0.3)]
    base = dict(cell={"name": "demo2.final_16384spp"}, base=BENCH_DIR, setup_s=9.5, window_s=0.4,
                frames=frames, spans=Spans(), trace=trace.reduce(*_fixed_trace(), window_s=0.2),
                device={"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3"})
    base.update(kw)
    return SimpleNamespace(**base)


def read(name, run):
    return load_module("metrics", name).read(run)


def test_frame_metrics():
    run = _run()
    assert read("setup_s", run) == 9.5
    for c in ("demo2", "cornell"):
        assert read(f"msamples_per_s.{c}", run) == pytest.approx(2 * 480_000 / 0.4 / 1e6)
        assert read(f"device_idle_pct.{c}", run) == pytest.approx(100 * (1 - 0.081 / 0.2))
        assert read(f"job_overhead_ms.{c}", run) == pytest.approx((0.3 - 0.081) / 2 * 1e3)
    assert read("device_idle_pct.progressive", run) is None and read("pass_ms", run) is None
    assert read("frame_p95_ms", run) is None  # too few frames for a tail
    many = [SimpleNamespace(samples=1, t_schedule=0.0, t_last_unit=(i + 1) / 1000) for i in range(100)]
    assert read("frame_p95_ms", _run(frames=many)) == pytest.approx(95.05)
    assert read("job_overhead_ms.demo2", _run(device={"platform": "cpu"})) is None


def test_roofline_reads_the_frozen_count():
    run = _run()
    frozen = json.loads((BENCH_DIR / "frozen" / "demo2.final_16384spp.json").read_text())
    peak = json.loads((BENCH_DIR / "peaks.json").read_text())["H100"]["fp32_flops"]
    want = 100 * frozen["ops_per_frame"] * 2 / (peak * 0.080)
    assert read("kernel_roofline_pct.demo2", run) == pytest.approx(want)
    assert read("kernel_roofline_pct.demo2", _run(cell={"name": "demo2.preview_1spp"})) is None
    assert read("kernel_roofline_pct.demo2", _run(trace=None)) is None


def test_progressive_metrics():
    spans = Spans()
    spans.spans = [("pass", 0.0, 0.010), ("stop_check", 0.010, 0.014), ("pass", 0.014, 0.026),
                   ("stop_check", 0.026, 0.028)]
    renders = [SimpleNamespace(t_start=i * 0.25, t_end=i * 0.25 + 0.2 + 0.001 * i) for i in range(40)]
    run = _run(frames=None, renders=renders, spans=spans, window_s=10.0)
    assert read("pass_ms", run) == pytest.approx(11.0)
    assert read("stop_check_ms", run) == pytest.approx(3.0)
    assert read("time_to_target_s", run) == pytest.approx(0.25)
    assert read("time_to_target_p90_s", run) == pytest.approx(0.2 + 0.001 * 35.1)
    assert read("device_idle_pct.progressive", run) == pytest.approx(100 * (1 - 0.081 / 0.2))
    assert read("msamples_per_s.demo2", run) is None


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "frozen").glob("*.json")), ids=lambda p: p.stem)
def test_the_frozen_count_is_the_frozen_formula_of_its_counters(path):
    f = json.loads(Path(path).read_text())
    c, facts = f["work_counts"], {k: f["scene"][k] for k in ("n_spheres", "n_planes", "mirror")}
    if f["kernel"] == "sweep_megakernel":
        ops = roofline.sweep_ops(**facts, n_samples=f["samples_per_frame"], bounces=c["bounces"],
                                 **{k: c.get(k, 0) for k in ("light_samples", "shadow_rays", "reverse_densities",
                                                              "glossy_lobes")})
    else:
        ops = roofline.scene_ops(**facts, scans=False, n_samples=f["samples_per_frame"], counts=c,
                                 tri_light_fraction=f["scene"]["tri_light_fraction"])
    assert ops == f["ops_per_frame"] == f["program_bound_at_freeze"]
    assert f["commit"] and f["command"].startswith("python3 benchmark/tools/freeze_counts.py")


def test_the_frozen_formulas_match_the_kernels_bounds_at_the_freeze():
    """At the commit the counts were frozen at, the copies give what the
    program's own bounds give, on demo2's and the Cornell box's scenes."""
    import torch  # noqa: F401

    from flux_tpu_torch.ops import scene_kernel, sweep_kernel
    from flux_tpu_torch.ops.intersect import Intersector
    from flux_tpu_torch.scene import compile_scene, load_scene

    demo2 = compile_scene(load_scene(str(BENCH_DIR / "configs" / "demo2.yml")), "cpu")
    work = dict(light_samples=7, shadow_rays=5, reverse_densities=3, glossy_lobes=11)
    for physical in (False, True):
        assert roofline.sweep_ops(n_spheres=demo2.num_spheres, n_planes=demo2.num_planes, mirror=False,
                                  n_samples=1000, bounces=3700, physical=physical, **work) == \
            sweep_kernel.flops_lower_bound(demo2, 1000, 3700, physical=physical, **work)
    box = compile_scene(load_scene(str(BENCH_DIR / "configs" / "cornell.yml")), "cpu")
    counts = {k: 3 + 7 * i for i, k in enumerate(scene_kernel.COUNT_NAMES)}
    assert roofline.scene_ops(n_spheres=box.num_spheres, n_planes=box.num_planes, mirror=False, scans=False,
                              n_samples=500, counts=counts, tri_light_fraction=1.0) == \
        scene_kernel.flops_lower_bound(box, Intersector(), 500, counts, tri_light_fraction=1.0)
