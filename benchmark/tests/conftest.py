"""Fixtures of the harness's tests: a copy of the benchmark in a
temporary checkout, cut to a size the CPU runs in seconds."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the CPU sizes: population, batch, generations
TINY = {"population_size": 1500, "batch": 4096, "generations": 3}


def copy_bench(dst: Path) -> Path:
    """``BENCHMARK.json`` and the harness's folder copied under ``dst``."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


@pytest.fixture
def tiny_bench(tmp_path):
    """A ``spec.Bench`` over a copy whose configurations and mixes run
    at ``TINY`` sizes."""
    import spec

    root = copy_bench(tmp_path)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    for c in doc["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        cfg["sampler"] = {"min_batch_size": TINY["batch"],
                          "max_batch_size": TINY["batch"]}
        cfg["generations"] = TINY["generations"]
        path.write_text(json.dumps(cfg))
    for path in (root / "benchmark" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["population_size"] = TINY["population_size"]
        path.write_text(json.dumps(mix))
    return spec.Bench(root, home=root / "benchmark")


@pytest.fixture
def card():
    """Skips without an NVIDIA card (decided here, not at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch
