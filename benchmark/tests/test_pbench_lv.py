"""The cell ``lv.seq1e6`` (BASELINE config #3, the Lotka-Volterra SDE at
d = 4) at a size the CPU runs, and the reader of ``distance_ms_per_gen``.

The configuration's posterior gate holds the last of its 8 generations
to a posterior std of at most 0.75 of the prior's.  ``log_a`` is the
widest: its ratio reads 0.73 at pop 2e4 and spreads over 0.74-0.77 at
the shared fixture's pop 1500, where the KDE's own noise decides it.
So this cell runs its 8 generations at pop 1e4 and batch 2^14, not at
the fixture's 3 generations of 1500."""

from __future__ import annotations

import json

import pytest

CELL = "lv.seq1e6"
#: the CPU sizes of this cell: population, batch, generations
LV_TINY = {"population_size": 10000, "batch": 1 << 14, "generations": 8}


@pytest.fixture
def lv_bench(tiny_bench):
    """``tiny_bench`` with ``lv`` at ``LV_TINY`` (its traffic mix too:
    no other cell runs in these tests)."""
    import spec

    home = tiny_bench.home
    cfg_path = home / "configs" / "lv.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["sampler"] = {"min_batch_size": LV_TINY["batch"],
                      "max_batch_size": LV_TINY["batch"]}
    cfg["generations"] = LV_TINY["generations"]
    cfg_path.write_text(json.dumps(cfg))
    mix = tiny_bench.cell(CELL)["traffic"]
    mix_path = home / "traffic" / f"{mix}.json"
    doc = json.loads(mix_path.read_text())
    doc["population_size"] = LV_TINY["population_size"]
    mix_path.write_text(json.dumps(doc))
    return spec.Bench(tiny_bench.root, home=home)


def test_the_cell_is_correct_and_repeats(lv_bench):
    import run

    result, info = run.run_cell(lv_bench, CELL, 3, 0.1, False, device="cpu")
    assert result["correct"] is True and info["repeat"] is True
    assert set(result["checks"]) == {"accept_over", "weight_gap", "z_max",
                                     "std_ratio"}
    last = info["summaries"][-1]
    assert last["generations"] == LV_TINY["generations"]
    assert last["paths"] == "s" * LV_TINY["generations"]


def test_the_control_fails_and_the_port_passes(lv_bench):
    import control

    cfg = lv_bench.config("lv")
    limit = cfg["checks"]["weights"]["weight_gap"]
    r = control.readings(lv_bench, CELL, 2 ** 31 + 5, "bfloat16",
                         device="cpu")
    assert r["program"]["weight_gap"] < limit / 3
    assert r["control"]["weight_gap"] > limit
    assert r["summary"]["generations"] == cfg["generations"]


@pytest.mark.cuda
def test_card_run(card, lv_bench):
    import run

    result, info = run.run_cell(lv_bench, CELL, 2 ** 31 + 99, 1.0, False)
    assert result["correct"] is True and info["repeat"] is True
    assert result["device"]["kind"] == card.cuda.get_device_name(0)
    assert result["device"]["memory_peak_bytes"] > 0
    assert set(result["metrics"]) == {"infer_s", "peak_mem_gb", "setup_s"}
    traced, _ = run.run_cell(lv_bench, CELL, 2 ** 31 + 99, 1.0, True)
    dev = traced["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert 0 <= traced["metrics"]["device_idle"]["value"] < 100
    assert traced["breakdown"]["device_ops"]
    assert traced["metrics"]["distance_ms_per_gen"]["value"] > 0
    assert 0 < traced["metrics"]["k1_roofline"]["value"] <= 105


def test_distance_reader_on_a_fixture():
    from conftest import ROOT
    import spec

    reader = spec.Bench(ROOT).reader("distance_ms_per_gen")
    rows = [{"t": 0, "distance_s": 0.010}, {"t": 1, "distance_s": 0.030},
            {"t": 2}]
    ctx = {"timelines": [rows, [{"t": 0, "distance_s": 0.020},
                                {"t": 1, "distance_s": None}]]}
    assert reader.read(ctx) == pytest.approx(1e3 * 0.060 / 3)
    # a distance that does not adapt: no row carries the key
    assert reader.read({"timelines": [[{"t": 0}, {"t": 1}]]}) is None
    assert reader.read({"timelines": []}) is None
