"""A run with the timed path broken underneath comes out not correct.

The harness's look for a card is skipped (``run_cell`` on the CPU) and
the rest of a run is driven with one fault planted in the port:

- a step that returns its state unchanged: the proposal is never refit
  after the first generation;
- half of the batch left out, the mean over the rest: each proposal is
  fitted on the first half of its particles, normalized over them;
- an answer altered where it is produced: the proposal density of one
  particle in each call is off by 0.1.

The exchange between chips does not exist here: every cell is on one
card.
"""

from __future__ import annotations

import numpy as np
import pytest


def _stale_refit(monkeypatch):
    from pyabc_tpu_torch import smc

    orig = smc.ABCSMC._fit_transitions

    def fit_once(self, t, population=None):
        if t <= 1:
            return orig(self, t, population)

    monkeypatch.setattr(smc.ABCSMC, "_fit_transitions", fit_once)


def _half_support(monkeypatch):
    from pyabc_tpu_torch.transition import base

    orig = base.Transition.fit

    def fit_half(self, theta, w):
        theta, w = np.atleast_2d(np.asarray(theta)), np.asarray(w)
        half = max(theta.shape[0] // 2, 1)
        return orig(self, theta[:half], w[:half])

    monkeypatch.setattr(base.Transition, "fit", fit_half)


def _altered_density(monkeypatch):
    from pyabc_tpu_torch.transition import multivariatenormal as mvn

    orig = mvn.weighted_kde_logpdf_auto

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs).clone()
        out[0] += 0.1
        return out

    monkeypatch.setattr(mvn, "weighted_kde_logpdf_auto", altered)


@pytest.mark.parametrize("cell", ["gmm2.seq1e6", "sir.seq1e6"])
@pytest.mark.parametrize("plant", [_stale_refit, _half_support,
                                   _altered_density],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
def test_fault_is_not_correct(tiny_bench, monkeypatch, cell, plant):
    import run

    plant(monkeypatch)
    result, _ = run.run_cell(tiny_bench, cell, 3, 0.1, False, device="cpu")
    assert result["correct"] is False
    assert result["checks"]["weight_gap"]["value"] > \
        result["checks"]["weight_gap"]["limit"]


@pytest.mark.parametrize("cell", ["gmm2.seq1e6", "sir.seq1e6"])
def test_unbroken_run_is_correct(tiny_bench, cell):
    import run

    result, _ = run.run_cell(tiny_bench, cell, 3, 0.1, False, device="cpu")
    assert result["correct"] is True
