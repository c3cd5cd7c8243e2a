"""Run one cell of ``BENCHMARK.json`` once and make its result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``configs/<config>.json`` and the scene file it names beside it;
* ``mixes/<traffic>.json``, whose ``driver`` names ``drivers/<driver>.py``;
* ``metrics/<metric>.py``, a reader with ``read(run)``;
* ``limits/<cell>.json``, the limit of each number the check compares;
* ``frozen/<cell>.json``, a cell's frozen operation count (roofline cells).

A driver builds the program's own entry (the job path, or the
progressive renderer), warms the cell's shape, drives the timed window,
and afterwards judges what the window produced against the plain
reference in ``reference/``. A driver whose program does its device work
in child processes, one card each, returns them from ``processes()``
(``procs.py``); the run gathers their launches, peak memory, trace,
spans and modules beside its own.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib.util
import json
import sys
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

__all__ = ["BENCH_DIR", "REPO_DIR", "load_spec", "load_json", "load_module", "frame_seed", "cell_metrics",
           "launch_counters", "profiler_activities", "run_cell", "forbidden_modules", "main"]

BENCH_DIR = Path(__file__).resolve().parent
REPO_DIR = BENCH_DIR.parent
# Top-level module names that no process of the benchmark may hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "flux_tpu")


def load_spec(repo: Path = REPO_DIR) -> dict:
    return json.loads((Path(repo) / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str, base: Path = BENCH_DIR) -> dict:
    return json.loads((Path(base) / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str, base: Path = BENCH_DIR):
    """``<base>/<kind>/<name>.py`` as a module; names may hold dots."""
    path = Path(base) / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def frame_seed(seed: int, i) -> int:
    """The render seed of render ``i`` of a run with ``--seed seed``: 32
    bits of a hash, so that any whole number is a seed."""
    return int.from_bytes(hashlib.sha256(f"{int(seed)}:{i}".encode()).digest()[:4], "little")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``flux_tpu_torch`` is not ``flux_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def _cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: end-to-end without the
    trace, per-layer with it; a metric with ``workloads`` only in those."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


class Spans:
    """The benchmark's own spans around its calls into the program, on the
    host's clock; in a traced run each is also a profiler range, so that
    the trace can name the host's work in an idle gap."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.spans = []  # (name, start, end)

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = contextlib.nullcontext()
        if self.traced:
            from torch.profiler import record_function

            rf = record_function(f"bench.{name}")
        t0 = time.perf_counter()
        with rf:
            yield
        self.spans.append((name, t0, time.perf_counter()))

    def seconds(self, name: str) -> list:
        return [e - s for n, s, e in self.spans if n == name]


def launch_counters() -> tuple:
    """The program's launch counters, each a Counter by kernel
    configuration."""
    from flux_tpu_torch.ops.scene_kernel import render_block_scene
    from flux_tpu_torch.ops.sweep_kernel import render_block_sweep

    return render_block_sweep.launches, render_block_scene.launches


def kernel_config(config: dict, mix: dict, stats: bool) -> str:
    """The kernel configuration every launch of a cell must take, as the
    launch counters name it."""
    nee = bool(mix.get("nee"))
    return (config["kernel_family"] + "+nee" * nee + "+trilight" * (nee and bool(config.get("tri_lights")))
            + "+physical" * bool(mix.get("physical")) + "+stats" * stats)


def _processes(drv) -> list:
    return list(drv.processes()) if hasattr(drv, "processes") else []


def profiler_activities(dev, children: bool, own_cuda: bool) -> list:
    """What the master's profiler traces: the host, and the card where
    the master does device work. A master whose device work runs in its
    children, each tracing its own card, traces the host alone, since
    tracing a card would take a context on it."""
    from torch.profiler import ProfilerActivity

    card = dev.type == "cuda" and (own_cuda or not children)
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])


class _Children:
    """The requests of one run to its driver's child processes: a child
    that fails one is reported on standard error, counted once, and asked
    nothing more."""

    def __init__(self, procs):
        self.procs, self.failed = procs, []

    def ask(self, name: str, *args) -> list:
        from .procs import ChildFailed

        out = []
        for p in self.procs:
            if p in self.failed:
                continue
            try:
                out.append(getattr(p, name)(*args))
            except ChildFailed as e:
                print(f"child failed: {e}", file=sys.stderr)
                self.failed.append(p)
        return out


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             base: Path = BENCH_DIR, t0: float = None) -> dict:
    """One run of a cell: set-up and warm-up, the window, the check
    against the reference, and the metrics. Returns the result line's
    object, with the compared numbers under ``checks`` (last); before it,
    ``forbidden`` lists the forbidden modules the driver's child processes
    held, and ``unread`` the children whose modules were never read, as
    one that failed a request before its report (for ``main``, which takes
    both keys out)."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    cell = _cell(spec, cell_name)
    config = load_json("configs", cell["config"], base)
    mix = load_json("mixes", cell["traffic"], base)
    limits = load_json("limits", cell_name, base)
    driver_mod = load_module("drivers", mix["driver"], base)
    spans = Spans(traced=trace)
    dev = torch.device(device)
    drv = driver_mod.Driver(config=config, mix=mix, scene_path=str(Path(base) / "configs" / config["scene"]),
                            device=dev, seed=seed, spans=spans)
    try:
        drv.setup()
        children = _Children(_processes(drv))
        counters = launch_counters()
        for c in counters:
            c.clear()
        # A master whose device work runs in its children never touches a
        # card, and takes no context on one.
        own_cuda = dev.type == "cuda" and torch.cuda.is_initialized()
        if own_cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        children.ask("window_start", trace)
        summary = None
        if trace:
            from torch.profiler import profile

            from . import trace as tr

            with profile(activities=profiler_activities(dev, bool(children.procs), own_cuda)) as prof:
                w0 = time.perf_counter()
                drv.window(seconds)
                window_traced = time.perf_counter() - w0
            summary = tr.reduce(*tr.events(prof), window_traced, cards=cell["chips"])
            del prof
        else:
            drv.window(seconds)
        children.ask("window_end")
        reports = children.ask("report")
        launched = Counter({k: v for c in counters for k, v in c.items()})
        for r in reports:
            launched.update(r["launches"])
        device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": None, "count": cell["chips"],
                       "memory_peak_bytes": 0}
        if own_cuda:
            device_info["kind"] = torch.cuda.get_device_name(dev)
            device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
        device_info["kind"] = next((r["card"] for r in reports if r["card"]), device_info["kind"])
        device_info["memory_peak_bytes"] = max([device_info["memory_peak_bytes"]]
                                               + [r["memory_peak_bytes"] for r in reports])
        if summary is not None and children.procs:
            summary = tr.combine([summary] + [r["trace"] for r in reports if r["trace"] is not None],
                                 cards=cell["chips"], window_s=window_traced)
        drv.close()
    finally:
        for p in _processes(drv):
            p.close()
    if own_cuda:
        torch.cuda.empty_cache()
    # Every launch of the window takes the cell's one kernel configuration;
    # on the CPU the plain version runs and nothing is launched.
    want = kernel_config(config, mix, drv.stats) if dev.type == "cuda" else None
    expected = drv.launches_expected() if dev.type == "cuda" else 0
    stray = sum(n for k, n in launched.items() if k != want) + abs(launched.get(want, 0) - expected)
    checks = {**drv.verify(), "stray_launches": stray}
    run = SimpleNamespace(cell=cell, config=config, mix=mix, setup_s=setup_s, trace=summary, base=Path(base),
                          device=device_info, launches=dict(launched),
                          process_spans=[s for r in reports for s in r["spans"]], **drv.record())
    metrics = {}
    for m in cell_metrics(spec, cell_name, trace):
        value = load_module("metrics", m["name"], base).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
    missing = set(limits) - set(checks)
    if missing:
        raise KeyError(f"limits/{cell_name}.json names numbers the check does not give: {sorted(missing)}")
    compared = {k: {"value": checks[k], "limit": limits[k]} for k in limits}
    failed = drv.failed + len(children.failed)
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in compared.values())
    out = {"correct": bool(correct), "attempted": drv.attempted, "failed": failed, "metrics": metrics,
           "device": device_info}
    if summary is not None:
        out["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    out["forbidden"] = sorted({m for r in reports for m in r["forbidden"]})
    out["unread"] = [str(p) for p in children.failed]
    out["checks"] = compared
    return out


def _args(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t0: float = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = _args(argv)
    spec = load_spec()
    cell = _cell(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    out = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), t0=t0)
    found = sorted(set(forbidden_modules()) | set(out.pop("forbidden")))
    unread = out.pop("unread")
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    if unread:
        # Whether such a child held a forbidden module is not known.
        print(f"modules not read from: {', '.join(unread)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
