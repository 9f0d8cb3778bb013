"""The readers of the round clocks, the phase readings and the pack
seconds against rows written here, and their silence where no row
carries their key."""

from __future__ import annotations

import copy

import pytest

#: two inferences; the first is the profiled one.  A sequential row
#: counts its rounds as evaluations / batch, a block row in ``rounds``
ROWS = [
    [
        {"t": 0, "path": "sequential", "evaluations": 4096, "batch": 1024,
         "count_wait_s": 0.004, "round_host_s": 0.002, "loop_s": 0.0065,
         "pack_s": 0.010,
         "phase_device_s": {"propose": 0.0008, "simulate": 0.0004,
                            "distance": 0.0002, "density": 0.0001,
                            "compact": 0.0003},
         "phase_rounds": 4},
        {"t": 1, "path": "pipelined", "evaluations": 6144, "batch": 1024,
         "rounds": 6, "count_wait_s": 0.006, "round_host_s": 0.003,
         "loop_s": 0.0095,
         "phase_device_s": {"propose": 0.0012, "simulate": 0.0006,
                            "distance": 0.0003, "density": 0.0,
                            "compact": 0.0006},
         "phase_rounds": 6},
        # a row of a sampler that reads no count
        {"t": 2, "path": "sequential", "evaluations": 2048, "batch": 1024,
         "pack_s": 0.030},
    ],
    [
        {"t": 0, "path": "sequential", "evaluations": 8192, "batch": 1024,
         "count_wait_s": 0.008, "round_host_s": 0.001, "loop_s": 0.0095,
         "pack_s": 0.020},
    ],
]


@pytest.fixture
def ctx():
    from conftest import ROOT
    import spec

    bench = spec.Bench(ROOT)
    rows = copy.deepcopy(ROWS)
    return bench, {"timelines": rows, "inferences": len(rows),
                   "trace": {"profiled_rows": rows[0]},
                   "registry_delta": {}}


def _read(bench, name, ctx):
    return bench.reader(name).read(ctx)


def test_phase_readers_are_device_ms_a_read_round(ctx):
    bench, c = ctx
    # the profiled rows only: 10 rounds with readings
    assert _read(bench, "propose_ms_per_round", c) == pytest.approx(
        1e3 * (0.0008 + 0.0012) / 10)
    assert _read(bench, "simulate_ms_per_round", c) == pytest.approx(
        1e3 * (0.0004 + 0.0006) / 10)


def test_clock_readers_are_ms_a_round_over_the_unprofiled_rows(ctx):
    bench, c = ctx
    # the second inference's row alone: the profiled rows are left out
    assert _read(bench, "count_wait_ms_per_round", c) == pytest.approx(
        1e3 * 0.008 / 8)
    assert _read(bench, "round_host_ms_per_round", c) == pytest.approx(
        1e3 * 0.001 / 8)
    # without a trace every window row that carries them counts: rounds
    # 4 + 6 + 8 (the t = 2 row carries none)
    c["trace"] = {}
    assert _read(bench, "count_wait_ms_per_round", c) == pytest.approx(
        1e3 * (0.004 + 0.006 + 0.008) / 18)
    assert _read(bench, "round_host_ms_per_round", c) == pytest.approx(
        1e3 * (0.002 + 0.003 + 0.001) / 18)


def test_clock_readers_are_silent_with_only_the_profiled_inference(ctx):
    bench, c = ctx
    c["timelines"] = c["timelines"][:1]
    c["inferences"] = 1
    for name in ("count_wait_ms_per_round", "round_host_ms_per_round"):
        assert _read(bench, name, c) is None


def test_pack_reader_is_ms_a_carrying_row(ctx):
    bench, c = ctx
    assert _read(bench, "pack_ms_per_gen", c) == pytest.approx(
        1e3 * (0.010 + 0.030 + 0.020) / 3)


@pytest.mark.parametrize("name,key", [
    ("propose_ms_per_round", "phase_device_s"),
    ("simulate_ms_per_round", "phase_device_s"),
    ("count_wait_ms_per_round", "count_wait_s"),
    ("round_host_ms_per_round", "round_host_s"),
    ("pack_ms_per_gen", "pack_s")])
def test_each_reader_is_silent_without_its_key(ctx, name, key):
    bench, c = ctx
    for tl in c["timelines"]:
        for r in tl:
            r.pop(key, None)
    assert _read(bench, name, c) is None


def test_phase_readers_are_silent_without_a_trace(ctx):
    bench, c = ctx
    c["trace"] = {}
    for name in ("propose_ms_per_round", "simulate_ms_per_round"):
        assert _read(bench, name, c) is None
    # a row whose phases lack one: that phase is silent alone
    c["trace"] = {"profiled_rows": [{"phase_device_s": {"propose": 0.1},
                                     "phase_rounds": 2}]}
    assert _read(bench, "propose_ms_per_round", c) == pytest.approx(50.0)
    assert _read(bench, "simulate_ms_per_round", c) is None


def test_the_new_metrics_are_reported_where_they_read_something():
    """The phase and pack metrics in every cell; the round clocks in the
    cell whose traced window runs an inference besides the profiled
    one."""
    from conftest import ROOT
    import spec

    bench = spec.Bench(ROOT)
    every = {"propose_ms_per_round", "simulate_ms_per_round",
             "pack_ms_per_gen"}
    clocks = {"count_wait_ms_per_round", "round_host_ms_per_round"}
    for w in bench.doc["workloads"]:
        names = {m["name"] for m in bench.per_layer(w["name"])}
        assert every <= names
        assert clocks & names == (clocks if w["name"] == "sir.seq1e6"
                                  else set())
