"""The result line and the harness's refusals."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import copy_bench

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


def _keys_ok(result: dict, traced: bool):
    keys = list(result)
    assert keys[:5] == REQUIRED
    assert keys[-1] == "checks"
    assert set(keys[5:-1]) <= ({"breakdown"} if traced else set())
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


def test_untraced_line(tiny_bench):
    import run

    result, info = run.run_cell(tiny_bench, "gmm2.seq1e6", 2 ** 31 + 17,
                                0.5, False, device="cpu")
    _keys_ok(result, traced=False)
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    # peak memory is a card's: on the CPU only the two host clocks
    assert set(result["metrics"]) == {"infer_s", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert info["repeat"] is True
    json.dumps(run._finite(result), allow_nan=False)


def test_traced_line(tiny_bench):
    import run

    result, _ = run.run_cell(tiny_bench, "sir.seq1e6", 5, 0.5, True,
                             device="cpu")
    _keys_ok(result, traced=True)
    names = set(result["metrics"])
    assert {"host_ms_per_gen", "round_ms"} <= names
    assert not names & {"infer_s", "peak_mem_gb", "setup_s"}


def test_breakdown_from_events():
    """Busy and idle time and the labelled gaps of a recorded trace."""
    from devtrace import reduce_events

    def ev(name, a, b, dev=False):
        return name, a, b, dev

    events = [ev("pbench.anchor", 1000.0, 1001.0),
              ev("k", 1100.0, 1300.0, True), ev("k", 1200.0, 1400.0, True),
              ev("m", 2400.0, 2500.0, True), ev("pbench.end", 3000.0, 3001.0)]
    # perf_counter reads 1.0 s at the anchor; the longest gap (1.4 to
    # 2.4 ms of the trace) lies under "gen.append" and "infer"
    host = [("infer", 1.0, 1.002), ("gen.append t=1", 1.0008, 1.0012)]
    red = reduce_events(events, 1.0, host)
    assert red["busy_s"] == pytest.approx(400e-6)
    assert red["window_s"] == pytest.approx(2000e-6)
    assert red["top_ops"] == [["k", pytest.approx(400e-6)],
                              ["m", pytest.approx(100e-6)]]
    assert red["idle_gaps"][0] == ["gen.append t=1", pytest.approx(1000e-6)]
    assert red["idle_gaps"][1] == ["infer", pytest.approx(500e-6)]
    assert [g[0] for g in red["idle_gaps"]][2] == "infer"


def test_no_card_no_result(tmp_path):
    """Without a card the run exits non-zero and prints no result; in a
    directory with only ``BENCHMARK.json`` and the harness too."""
    root = copy_bench(tmp_path)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "gmm2.seq1e6",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_raw_events_with_and_without_their_kind():
    """The raw profiler events read alike whether or not the torch build
    names an event's kind (``activity_type``)."""
    from types import SimpleNamespace as NS

    import torch
    from devtrace import profiler_events

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    class Ev:
        def __init__(self, name, dev, kind=None):
            self._n, self._d = name, dev
            if kind is not None:
                self.activity_type = lambda: kind

        def name(self):
            return self._n

        def start_ns(self):
            return 2000

        def duration_ns(self):
            return 500

        def device_type(self):
            return self._d

    for kinds in ((None, None, None), ("kernel", "gpu_user_annotation",
                                       "user_annotation")):
        evs = [Ev("k", cuda, kinds[0]), Ev("pbench.anchor", cuda, kinds[1]),
               Ev("pbench.anchor", cpu, kinds[2])]
        prof = NS(profiler=NS(kineto_results=NS(events=lambda: evs)))
        got = list(profiler_events(prof, torch))
        assert got == [("k", 2.0, 2.5, True),
                       ("pbench.anchor", 2.0, 2.5, False),
                       ("pbench.anchor", 2.0, 2.5, False)]
