"""Closed-loop batch autotuner: pick the next generation's candidate batch.

Copied from ``pyabc_tpu/autotune/tuner.py`` (pure host arithmetic).  The
sampler's one sizing decision per generation is the candidate batch
``B``; :class:`BatchAutotuner` keeps an EWMA acceptance-rate estimate
with an EWMA variance, so the oversampling margin widens when the rate
is noisy and relaxes to ``safety_min`` when it is stable; a generation
that needed more than one round boosts the next margin 25 %; and a rung
that would drop by less than ``hysteresis`` stays put.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

#: the acceptance-rate EWMA gain
EWMA_ALPHA = 0.5


class BatchAutotuner:
    """Acceptance-rate estimator + batch-rung policy for one sampler."""

    def __init__(self,
                 alpha: float = EWMA_ALPHA,
                 cv_gain: float = 1.0,
                 hysteresis: float = 0.1,
                 safety_min: float = 1.05,
                 safety_max: float = 4.0,
                 rate_init: float = 1.0):
        self.alpha = float(alpha)
        self.cv_gain = float(cv_gain)
        self.hysteresis = float(hysteresis)
        self.safety_min = float(safety_min)
        self.safety_max = float(safety_max)
        self._rate = max(float(rate_init), 1e-6)
        self._var = 0.0
        self._last_B: Optional[int] = None
        self._undershoot = False
        self._compute_ewma = 0.0
        self._overlap_ewma = 0.0
        self._n_obs = 0

    # ---- estimator -------------------------------------------------------

    @property
    def rate(self) -> float:
        """Current acceptance-rate estimate (EWMA, floored at 1e-6)."""
        return self._rate

    def seed_rate(self, rate: float):
        """Hard-set the estimate (run resume / legacy ``_rate_est``
        writes); clears the variance — a seeded value carries no noise
        history."""
        self._rate = max(float(rate), 1e-6)
        self._var = 0.0
        self._undershoot = False

    def observe(self, accepted: int, total: int,
                rounds: Optional[int] = None,
                compute_s: float = 0.0, overlap_s: float = 0.0):
        """Fold one generation's outcome (timeline row units) into the
        estimator.  ``rounds`` > 1 marks an undershoot — the batch was
        too small and the generation paid an extra device round."""
        if total <= 0:
            return
        r = max(accepted / total, 1e-6)
        d = r - self._rate
        self._rate = max(self._rate + self.alpha * d, 1e-6)
        # EWMA variance of the innovation (West-style): grows on
        # surprise, decays geometrically while predictions hold
        self._var = (1.0 - self.alpha) * (self._var + self.alpha * d * d)
        self._undershoot = rounds is not None and rounds > 1
        if compute_s > 0.0:
            self._compute_ewma += self.alpha * (compute_s
                                                - self._compute_ewma)
            self._overlap_ewma += self.alpha * (overlap_s
                                                - self._overlap_ewma)
        self._n_obs += 1

    def observe_timing(self, compute_s: float, overlap_s: float = 0.0):
        """Fold in a generation's compute/overlap seconds without
        touching the rate estimate — the sequential sampler observes
        its rate per device call, but only the orchestrator sees the
        wire-ledger split."""
        if compute_s > 0.0:
            self._compute_ewma += self.alpha * (compute_s
                                                - self._compute_ewma)
            self._overlap_ewma += self.alpha * (overlap_s
                                                - self._overlap_ewma)

    # ---- policy ----------------------------------------------------------

    def safety(self, base: float) -> float:
        """Oversampling margin for the next generation, clipped to
        ``[safety_min, max(safety_max, base)]``."""
        cv = math.sqrt(max(self._var, 0.0)) / self._rate
        s = base * (1.0 + self.cv_gain * cv)
        if self._undershoot:
            s *= 1.25
        if self._compute_ewma > 1e-9:
            # transfer-bound runs (fetch hidden behind compute) pay ~0
            # for extra candidates; lean generous to stay single-round
            s *= 1.0 + 0.25 * min(self._overlap_ewma
                                  / self._compute_ewma, 1.0)
        return min(max(s, self.safety_min), max(self.safety_max, base))

    def target(self, n: int, base_safety: float) -> float:
        """Raw (un-snapped) candidate-batch target for ``n`` accepted."""
        return n / self._rate * self.safety(base_safety)

    def choose_batch(self, n: int, base_safety: float,
                     round_to_valid: Callable[[float], int]) -> int:
        """Pick the rung for the next generation: snap the target via
        the caller's ladder (``round_to_valid``), with downward
        hysteresis — if bumping the target by ``hysteresis`` would land
        back on the previous rung, stay there."""
        b = self.target(n, base_safety)
        B = round_to_valid(b)
        last = self._last_B
        if last is not None and B < last \
                and round_to_valid(b * (1.0 + self.hysteresis)) == last:
            B = last
        self._last_B = B
        return B

    def predict_next_batch(self, n: int, base_safety: float,
                           round_to_valid: Callable[[float], int]) -> int:
        """The rung the CURRENT stats predict for the next generation —
        read-only (no hysteresis commit): the AOT prewarm hook asks this
        while a generation computes, and precompiles the answer when it
        differs from the rung in flight."""
        return round_to_valid(self.target(n, base_safety))

    def stats(self) -> dict:
        """Scalar snapshot (debugging / bench rows)."""
        return {
            "rate": self._rate,
            "rate_cv": math.sqrt(max(self._var, 0.0)) / self._rate,
            "last_B": self._last_B,
            "undershoot": self._undershoot,
            "compute_s_ewma": self._compute_ewma,
            "overlap_s_ewma": self._overlap_ewma,
            "n_obs": self._n_obs,
        }
