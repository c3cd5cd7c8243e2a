"""Fixtures of the benchmark's own tests: a copy of the benchmark's data
files in a temporary directory, cut to a size the CPU renders in moments
(the plain version runs there), and the card fixture for the tests marked
``cuda``."""

import json
import shutil
from pathlib import Path

import pytest
import yaml

from benchmark.harness import BENCH_DIR, load_spec

# What each mix is cut to on the CPU: a few units of a few rows at a few
# samples; the adaptive render stops at its first or second pass.
TINY_MIX = {"sample_root": 2, "rows_per_unit": 4, "keep_frames": 3, "pixels_per_unit": 4,
            "pass_spp": 2, "target": 0.9, "keep_renders": 2, "pixels": 16}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest benchmark/tests -m cuda)")
    return torch.device("cuda")


def make_tiny(dst: Path, width: int = 16, height: int = 12, root: int = None) -> Path:
    """The benchmark's files under ``dst``, each configuration's scene cut
    to ``width`` x ``height`` and each mix to ``TINY_MIX``."""
    for kind in ("configs", "mixes", "drivers", "metrics", "limits", "frozen"):
        shutil.copytree(BENCH_DIR / kind, dst / kind, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH_DIR / "peaks.json", dst / "peaks.json")
    for cfg in (dst / "configs").glob("*.json"):
        c = json.loads(cfg.read_text())
        scene = yaml.safe_load((dst / "configs" / c["scene"]).read_text())
        scene["output_settings"].update(image_width=width, image_height=height)
        (dst / "configs" / c["scene"]).write_text(yaml.safe_dump(scene))
    for mix in (dst / "mixes").glob("*.json"):
        m = json.loads(mix.read_text())
        for k, v in TINY_MIX.items():
            if k in m and not (k == "sample_root" and m[k] == 1):
                m[k] = v if root is None or k != "sample_root" else root
        mix.write_text(json.dumps(m))
    return dst


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(tmp_path)


@pytest.fixture
def spec():
    return load_spec()


@pytest.fixture
def spec_all(spec):
    """BENCHMARK.json with the entries of the cells left for later
    (``pending.json``) added, so that their drivers stay tested."""
    pending = json.loads((BENCH_DIR / "pending.json").read_text())
    return {**spec, **{k: spec[k] + pending[k] for k in ("workloads", "end_to_end", "per_layer")}}
