"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by name."""

import json
import re
import sys

import pytest

from benchmark.harness import BENCH_DIR, REPO_DIR, cell_metrics

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def test_top_level_keys_and_limits(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    assert len((REPO_DIR / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    n = 24  # a full check of 24 cells at this length fits the check's clock
    assert (2 + 14 * n) * (spec["run_seconds"] + 60) + n * 2 * 90 + 1200 <= 43200


def four_chip_quota(n_cells: int) -> int:
    """How many cells may ask for four chips: a quarter, rounded down, and
    one always."""
    return max(1, n_cells // 4)


def test_entries_have_exactly_their_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("benchmark/") and (REPO_DIR / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert json.loads((REPO_DIR / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4) and w["config"] in {c["name"] for c in spec["configs"]}
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= four_chip_quota(len(spec["workloads"]))
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in SOURCES_E2E and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and LINE.match(m["layer"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in spec[k]}) == len(spec[k])
    metric_names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert len({(w["config"], w["traffic"]) for w in spec["workloads"]}) == len(spec["workloads"])


def test_every_cell_reports_what_its_metrics_move(spec):
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for w in spec["workloads"]:
        mine = {m["name"] for m in cell_metrics(spec, w["name"], False)}
        assert "setup_s" in mine and len(mine) >= 2
        layer = cell_metrics(spec, w["name"], True)
        assert layer
        for m in layer:
            assert m["moves"] in mine, (w["name"], m["name"])


def test_every_cell_finds_its_files_by_name(spec):
    for w in spec["workloads"]:
        config = json.loads((BENCH_DIR / "configs" / f"{w['config']}.json").read_text())
        assert (BENCH_DIR / "configs" / config["scene"]).is_file()
        mix = json.loads((BENCH_DIR / "mixes" / f"{w['traffic']}.json").read_text())
        assert (BENCH_DIR / "drivers" / f"{mix['driver']}.py").is_file()
        assert (BENCH_DIR / "limits" / f"{w['name']}.json").is_file()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    for m in spec["per_layer"]:
        if m["name"].startswith("kernel_roofline_pct"):
            for cell in m["workloads"]:
                assert (BENCH_DIR / "frozen" / f"{cell}.json").is_file()


def test_the_cells_left_for_later_fit_the_benchmark(spec):
    """``pending.json`` holds BENCHMARK.json entries that can be added as
    they are: their files exist, names are new, and their metrics move what
    their cells report."""
    pending = json.loads((BENCH_DIR / "pending.json").read_text())
    test_entries_have_exactly_their_keys({**spec, **{k: spec[k] + pending[k]
                                                     for k in ("workloads", "end_to_end", "per_layer")}})


def _four_chip_cells(spec, n: int) -> dict:
    """``spec`` with ``n`` made-up cells of demo2 on four chips."""
    extra = [{"name": f"demo2.nodes_{i}", "config": "demo2", "traffic": f"nodes_{i}", "chips": 4,
              "why": "frames over four render nodes, one a card"} for i in range(n)]
    return {**spec, "workloads": spec["workloads"] + extra}


def test_a_four_chip_cell_fits_the_benchmark(spec):
    test_entries_have_exactly_their_keys(_four_chip_cells(spec, 1))


def test_four_chip_cells_past_the_quota_are_refused(spec):
    assert [four_chip_quota(n) for n in (1, 4, 7, 8, 24)] == [1, 1, 1, 2, 6]
    with pytest.raises(AssertionError):
        test_entries_have_exactly_their_keys(_four_chip_cells(spec, 2))  # 2 of 4 cells


def test_a_cut_configuration_states_its_cuts_in_both_places(spec, tmp_path, monkeypatch):
    """A configuration's file and its entry name the same ``reduced``; a
    cut named in one place only is refused."""
    cfg = json.loads((REPO_DIR / "benchmark/configs/demo2.json").read_text())
    (tmp_path / "benchmark").mkdir()
    cut = {**cfg, "reduced": ["sample_root"]}
    (tmp_path / "benchmark" / "cut.json").write_text(json.dumps(cut))
    monkeypatch.setattr(sys.modules[__name__], "REPO_DIR", tmp_path)
    entry = {"name": "demo2_cut", "source": "x", "file": "benchmark/cut.json", "reduced": ["sample_root"],
             "why": "x"}
    test_entries_have_exactly_their_keys({**spec, "configs": [entry], "workloads": []})
    with pytest.raises(AssertionError):
        test_entries_have_exactly_their_keys({**spec, "configs": [{**entry, "reduced": []}], "workloads": []})
