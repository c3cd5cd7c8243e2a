"""On the card (``python -m pytest benchmark/tests -m cuda``): every cell at
its own size through a short window, correct, every launch of its one
kernel configuration; and the control failing each cell's check there."""

import pytest

from benchmark import harness
from benchmark.harness import load_json, load_module, run_cell

CELLS = ["demo2.final_16384spp", "cornell.final_1024spp_nee", "demo2.preview_1spp", "demo2.adaptive_0.12"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(spec_all, card, cell):
    out = run_cell(spec_all, cell, 2**31 + 77, 1.0, False, device=card)
    assert out["correct"], out["checks"]
    assert out["checks"]["stray_launches"]["value"] == 0
    assert out["device"]["platform"] == "gpu" and out["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_the_card(spec_all, card, cell):
    w = next(x for x in spec_all["workloads"] if x["name"] == cell)
    config, mix = load_json("configs", w["config"]), load_json("mixes", w["traffic"])
    drv = load_module("drivers", mix["driver"]).Driver(
        config=config, mix=mix, scene_path=str(harness.BENCH_DIR / "configs" / config["scene"]), device=card,
        seed=31, spans=harness.Spans())
    drv.setup()
    drv.window(1.0)
    drv.close()
    limits = load_json("limits", cell)
    got, low = drv.verify(), drv.verify(control=True)
    assert all(got[k] <= v for k, v in limits.items() if k in got)
    assert any(low[k] > v for k, v in limits.items() if k in low)
