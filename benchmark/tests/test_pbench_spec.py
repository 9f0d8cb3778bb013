"""The harness finds a cell, a configuration, a traffic mix and a
per-layer metric by name; adding one takes new files and new entries
alone."""

from __future__ import annotations

import hashlib
import json

import pytest

from conftest import copy_bench


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()}


def test_new_files_and_entries_are_found_by_name(tmp_path):
    import spec

    root = copy_bench(tmp_path)
    before = _digests(root)
    home = root / "benchmark"
    cfg = json.loads((home / "configs" / "gmm2.json").read_text())
    cfg["factory_kwargs"]["sigma"] = 0.25
    (home / "configs" / "gmm2s.json").write_text(json.dumps(cfg))
    (home / "traffic" / "seq1e5.json").write_text(json.dumps(
        {"population_size": 100000, "abc": {"ingest_mode": "sequential"}}))
    (home / "metrics" / "gens_per_infer.py").write_text(
        "def read(ctx):\n    return len(ctx['timelines'][0])\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "gmm2s", "source": "a test",
                           "file": "benchmark/configs/gmm2s.json",
                           "reduced": [], "why": "a test"})
    doc["workloads"].append({"name": "gmm2s.seq1e5", "config": "gmm2s",
                             "traffic": "seq1e5", "chips": 1, "why": "x"})
    doc["per_layer"].append({"name": "gens_per_infer", "unit": "count",
                             "better": "lower", "source": "program_counter",
                             "layer": "smc", "moves": "infer_s",
                             "workloads": ["gmm2s.seq1e5"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))

    bench = spec.Bench(root, home=home)
    cell = bench.cell("gmm2s.seq1e5")
    assert bench.config(cell["config"])["factory_kwargs"]["sigma"] == 0.25
    assert bench.traffic(cell["traffic"])["population_size"] == 100000
    names = [m["name"] for m in bench.per_layer("gmm2s.seq1e5")]
    assert "gens_per_infer" in names
    assert "gens_per_infer" not in [m["name"]
                                    for m in bench.per_layer("gmm2.seq1e6")]
    reader = bench.reader("gens_per_infer")
    assert reader.read({"timelines": [[{}, {}, {}]]}) == 3
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_unknown_names_raise(tmp_path):
    import spec

    bench = spec.Bench(copy_bench(tmp_path), home=tmp_path / "benchmark")
    for lookup, name in ((bench.cell, "nope.cell"), (bench.config, "nope"),
                         (bench.traffic, "nope")):
        with pytest.raises(spec.SpecError):
            lookup(name)
    with pytest.raises(spec.SpecError):
        bench.reader("nope")


def test_every_name_in_benchmark_json_has_its_files():
    import spec
    from conftest import ROOT

    bench = spec.Bench(ROOT)
    for w in bench.doc["workloads"]:
        cfg = bench.config(w["config"])
        bench.traffic(w["traffic"])
        bench.builder(cfg)
        for check in cfg["checks_run"]:
            assert hasattr(bench.check(check), "compare")
        for m in bench.per_layer(w["name"]):
            assert hasattr(bench.reader(m["name"]), "read")
        assert {m["name"] for m in bench.end_to_end(w["name"])} == {
            "infer_s", "peak_mem_gb", "setup_s"}
