"""Each per-layer reader against a recorded timeline and trace."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

FIXTURE = Path(__file__).parent / "fixtures" / "timeline.json"


@pytest.fixture
def ctx():
    from conftest import ROOT
    import spec

    rec = json.loads(FIXTURE.read_text())
    bench = spec.Bench(ROOT)
    rec["trace"]["profiled_rows"] = rec["timelines"][0]
    rec["inferences"] = len(rec["timelines"])
    rec["config"] = bench.config("gmm2")
    return bench, rec


def _read(bench, name, rec):
    return bench.reader(name).read(rec)


def test_host_append_round_and_reads(ctx):
    bench, rec = ctx
    rows = [r for tl in rec["timelines"] for r in tl]
    host = sum(r["wall_s"] - r["sample_s"] - r.get("append_s", 0.0)
               for r in rows)
    assert _read(bench, "host_ms_per_gen", rec) == pytest.approx(
        1e3 * host / 6)
    assert _read(bench, "append_ms_per_gen", rec) == pytest.approx(
        1e3 * (0.10 + 0.20 + 0.05 + 0.15) / 4)
    # rounds: 4 + 6 + 8 in each inference (evaluations / batch where the
    # row does not count them)
    assert _read(bench, "round_ms", rec) == pytest.approx(
        1e3 * (0.3 + 0.6 + 0.9 + 0.3 + 0.7 + 0.8) / 36)
    assert _read(bench, "host_reads_per_round", rec) == pytest.approx(
        16 / 12)
    assert _read(bench, "capture_ms_per_infer", rec) == pytest.approx(30.0)


def test_trace_readers(ctx):
    bench, rec = ctx
    from reference.k1_bound import bound_seconds

    bound = (bound_seconds(1e6, 8192, 1) + bound_seconds(1e6, 16384, 1)
             + 2 * bound_seconds(1e6, 8192, 1))
    assert _read(bench, "k1_roofline", rec) == pytest.approx(
        100 * bound / 0.012)
    assert _read(bench, "device_idle", rec) == pytest.approx(75.0)


def test_readers_are_silent_without_their_source(ctx):
    bench, rec = ctx
    bare = dict(rec, trace={}, registry_delta={},
                timelines=[[{k: v for k, v in r.items()
                             if k not in ("host_reads", "append_s")}
                            for r in tl] for tl in rec["timelines"]])
    for name in ("append_ms_per_gen", "host_reads_per_round",
                 "capture_ms_per_infer", "k1_roofline", "device_idle"):
        assert _read(bench, name, bare) is None
    rec["trace"]["profiled_rows"][1]["kde_launches"] = 3
    assert _read(bench, "k1_roofline", rec) is None


def test_k1_bound_is_kde_cuda_s():
    """The frozen copy agrees with the port's own arithmetic."""
    from reference.k1_bound import EXP2_FMA_COST, bound_seconds
    from pyabc_tpu_torch.ops import kde_cuda

    assert EXP2_FMA_COST == kde_cuda.EXP2_FMA_COST
    for m, n, d in ((1e6, 8192, 1), (1e5, 1e5, 2), (1e5, 16384, 4)):
        assert bound_seconds(m, n, d) == pytest.approx(
            kde_cuda.bound_seconds(m, n, d, 1.98e9, 132))
