"""On the card: a run at the CPU tests' sizes is correct, reports the
card's name and peak, and its traced run reads the device trace."""

from __future__ import annotations

import pytest


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gmm2.seq1e6", "sir.seq1e6"])
def test_card_run(card, tiny_bench, cell):
    import run

    result, info = run.run_cell(tiny_bench, cell, 2 ** 31 + 99, 1.0, False)
    assert result["correct"] is True and info["repeat"] is True
    assert result["device"]["kind"] == card.cuda.get_device_name(0)
    assert result["device"]["memory_peak_bytes"] > 0
    assert set(result["metrics"]) == {"infer_s", "peak_mem_gb", "setup_s"}
    traced, _ = run.run_cell(tiny_bench, cell, 2 ** 31 + 99, 1.0, True)
    dev = traced["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert 0 <= traced["metrics"]["device_idle"]["value"] < 100
    assert traced["breakdown"]["device_ops"]
