"""The control of ``correct``: the reference's own weights in bfloat16,
the precision below the configurations' float32, put in the port's
place, fail the weight limit; the port's float32 weights pass it."""

from __future__ import annotations

import pytest


@pytest.mark.parametrize("cell", ["gmm2.seq1e6", "sir.seq1e6"])
def test_control_fails_and_the_port_passes(tiny_bench, cell):
    import control

    cfg = tiny_bench.config(tiny_bench.cell(cell)["config"])
    limit = cfg["checks"]["weights"]["weight_gap"]
    for seed in (11, 2 ** 31 + 5):
        r = control.readings(tiny_bench, cell, seed, "bfloat16",
                             device="cpu")
        assert r["program"]["weight_gap"] < limit / 3
        assert r["control"]["weight_gap"] > limit
        assert r["summary"]["generations"] == cfg["generations"]
