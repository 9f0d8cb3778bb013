"""Joint (K, max_T, rung) occupancy tuning for fused device blocks.

``BatchAutotuner`` picks the batch rung B from the acceptance rate, and
``ABCSMC._block_max_rounds`` picks the per-generation round budget from
the same rate — each INDEPENDENTLY, with the block length K frozen at
``fuse_generations``.  But the three interact: a longer K amortizes
more dispatch overhead yet rides the in-block rate decay further (a
tightening eps schedule accepts less each generation), which inflates
the rounds the LAST generation needs; a bigger max_T absorbs that decay
but pads the compiled scan's worst case; a higher rung B cuts rounds
but pays more per round.  Tuning them one at a time chases local
optima — the classic case is "K=4 undershoots, so the run bounces to
sequential" when (K=3, one rung up) would have been strictly faster.

:class:`OccupancyTuner` closes the loop JOINTLY: it maintains EWMA
estimates of the in-block per-generation rate decay rho, the seconds
per round at each rung, and the per-dispatch overhead, then scores
every candidate shape (K, max_T, B) by predicted accepted/s

    score = K*n / (sum_k ceil(n / (rate * rho^k * B)) * t_round(B)
                   + c_dispatch)

subject to the feasibility constraint that every generation's
predicted rounds (with the undershoot safety margin) fit max_T —
an infeasible shape is worth LESS than its score says, because an
undershot block bounces the run to the sequential path.

Opt-in via ``PYABC_TPU_JOINT_AUTOTUNE=1`` (``ABCSMC`` consults it):
a changed K or rung changes how the run's generator is drawn from, so
the default stays the static shape for reproducibility.

Port of ``pyabc_tpu/autotune/occupancy.py``: plain Python, copied, so
that one telemetry stream gives the same proposals in both packages.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

#: env knob consumed by ``ABCSMC``: "1"/"true" enables joint tuning
JOINT_AUTOTUNE_ENV = "PYABC_TPU_JOINT_AUTOTUNE"

#: round budgets a block may compile with (pow2 ladder, matches the
#: ``_block_max_rounds`` ceiling progression)
DEFAULT_T_CHOICES = (16, 32, 64)


class OccupancyTuner:
    """Closed-loop joint (K, max_T, rung) policy for fused blocks."""

    #: EWMA smoothing for rho / timing estimates (matches BatchAutotuner)
    EWMA_ALPHA = 0.5
    #: a candidate must beat the incumbent shape by this factor to
    #: switch — shape changes cost a compile, so tiny predicted wins
    #: must not thrash the ladder
    HYSTERESIS = 1.10
    #: multiplier on predicted rounds when testing max_T feasibility
    #: (absorbs rate-estimate variance); grows on observed undershoot
    SAFETY_0 = 1.5
    SAFETY_MAX = 4.0
    #: floor on the per-dispatch overhead used in scoring: the residual
    #: estimator is biased low (round seconds are fit from the same
    #: wall), and with a zero dispatch cost K amortizes nothing
    DISPATCH_FLOOR_S = 0.01

    def __init__(self, k_max: int,
                 t_choices: Sequence[int] = DEFAULT_T_CHOICES):
        self.k_max = max(1, int(k_max))
        self.t_choices = tuple(sorted(int(t) for t in t_choices))
        #: in-block per-generation acceptance-rate decay (rho <= 1)
        self._rho: Optional[float] = None
        #: per-rung EWMA seconds per round
        self._round_s: Dict[int, float] = {}
        #: EWMA per-dispatch overhead (block wall minus modeled rounds)
        self._dispatch_s: Optional[float] = None
        self._safety = self.SAFETY_0
        self._shape: Optional[Tuple[int, int, int]] = None

    # ---- telemetry ingestion -------------------------------------------

    def _ewma(self, old: Optional[float], new: float) -> float:
        if old is None or not math.isfinite(old):
            return new
        return (1 - self.EWMA_ALPHA) * old + self.EWMA_ALPHA * new

    def observe_block(self, K: int, B: int, rounds_per_gen: Sequence[int],
                      wall_s: float, written: int):
        """Fold a finished block's telemetry in.

        ``rounds_per_gen``: device rounds each WRITTEN generation used;
        ``written < K`` marks an undershoot (the safety margin grows —
        the shape model was too optimistic)."""
        rounds = [max(int(r), 1) for r in rounds_per_gen if r]
        if len(rounds) >= 2:
            # rate_k ~ n / (rounds_k * B): consecutive ratios estimate rho
            ratios = [rounds[i] / rounds[i + 1]
                      for i in range(len(rounds) - 1)]
            rho = min(1.0, math.exp(
                sum(math.log(max(r, 1e-3)) for r in ratios) / len(ratios)))
            self._rho = self._ewma(self._rho, rho)
        total_rounds = sum(rounds)
        if total_rounds and wall_s > 0:
            per_round = wall_s / total_rounds
            self._round_s[B] = self._ewma(self._round_s.get(B), per_round)
            # overhead: whatever the per-round model cannot explain of
            # the first observation is folded into the dispatch constant
            modeled = total_rounds * self._round_s[B]
            self._dispatch_s = self._ewma(
                self._dispatch_s, max(wall_s - modeled, 0.0))
        if written < K:
            self._safety = min(self._safety * 1.5, self.SAFETY_MAX)
        elif self._safety > self.SAFETY_0:
            # decay back toward baseline on clean blocks
            self._safety = max(self._safety * 0.9, self.SAFETY_0)

    # ---- shape model ----------------------------------------------------

    def rho(self) -> float:
        return self._rho if self._rho is not None else 0.7

    def _round_seconds(self, B: int) -> float:
        """Seconds per round at rung ``B`` — measured when seen, scaled
        linearly in B from the nearest measured rung otherwise (device
        rounds are compute-bound at the fused sizes)."""
        if B in self._round_s:
            return self._round_s[B]
        if not self._round_s:
            return 1e-3 * B / 4096  # cold prior: irrelevant scale,
            # identical across candidates until telemetry arrives
        ref_b = min(self._round_s, key=lambda b: abs(math.log(b / B)))
        return self._round_s[ref_b] * B / ref_b

    def predict_rounds(self, n: int, rate: float, B: int, k: int) -> float:
        """Expected device rounds generation ``k`` of a block needs."""
        eff = max(rate, 1e-6) * (self.rho() ** k)
        return n / (eff * B)

    def score(self, n: int, rate: float, K: int, max_T: int,
              B: int) -> Optional[float]:
        """Predicted accepted/s of shape (K, max_T, B); None if any
        generation's safety-margined rounds overflow ``max_T``."""
        total = 0.0
        for k in range(K):
            r = self.predict_rounds(n, rate, B, k)
            if math.ceil(r * self._safety) > max_T:
                return None
            total += max(math.ceil(r), 1)
        cost = (total * self._round_seconds(B)
                + max(self._dispatch_s or 0.0, self.DISPATCH_FLOOR_S))
        if cost <= 0:
            return None
        return K * n / cost

    def propose(self, n: int, rate: float, B0: int,
                round_to_rung, feasible=None) -> Tuple[int, int, int]:
        """The jointly-best (K, max_T, B) for a block targeting ``n``.

        ``B0``: the rung the independent tuner would pick (the search
        explores it and its pow2 neighbors); ``round_to_rung``: the
        sampler's ladder clamp.  ``feasible(K, max_T, B) -> bool``, when
        given, is the HBM capacity model's admissibility predicate
        (``ABCSMC._capacity_feasible``): candidates outside the budget
        are never scored, so the tuner cannot propose a shape the
        device would OOM on — a tight budget shrinks the chosen rung
        instead.  Falls back to (1, smallest feasible max_T, B0 clamped
        through shrinking rungs) when nothing fits — the caller's
        sequential-path semantics (or its capacity consult's
        CapacityError) are preserved."""
        rungs = sorted({round_to_rung(B0 * f) for f in (0.5, 1.0, 2.0)})
        best, best_score = None, 0.0
        incumbent = self._shape
        for K in range(1, self.k_max + 1):
            for B in rungs:
                for max_T in self.t_choices:
                    if feasible is not None and \
                            not feasible(K, max_T, B):
                        continue
                    s = self.score(n, rate, K, max_T, B)
                    if s is None:
                        continue
                    # shallower round budgets compile smaller scans:
                    # prefer the smallest feasible max_T at equal score
                    if s > best_score:
                        best, best_score = (K, max_T, B), s
        if best is None:
            K_f, T_f = 1, self.t_choices[-1]
            if feasible is not None:
                # clamp the fallback through shrinking rungs until the
                # capacity model admits the minimal shape; if even the
                # smallest rung is out of budget, return it anyway —
                # the caller's own consult raises CapacityError with
                # the full ledger
                B_f = int(B0)
                for _ in range(8):
                    if feasible(K_f, T_f, B_f):
                        break
                    nxt = int(round_to_rung(max(B_f // 2, 1)))
                    if nxt >= B_f:
                        break
                    B_f = nxt
                return K_f, T_f, B_f
            return K_f, T_f, B0
        if incumbent is not None and incumbent != best:
            # an incumbent outside the budget's feasible set cannot be
            # kept, whatever its score says
            inc_ok = (feasible is None
                      or feasible(*_shape_args(incumbent)))
            inc_score = (self.score(n, rate, *_shape_args(incumbent))
                         if inc_ok else None)
            if inc_score is not None and \
                    best_score < inc_score * self.HYSTERESIS:
                return incumbent
        self._shape = best
        return best

    def stats(self) -> dict:
        return {"rho": self.rho(), "safety": self._safety,
                "dispatch_s": self._dispatch_s,
                "round_s": dict(self._round_s), "shape": self._shape}


def _shape_args(shape: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """(K, max_T, B) stored order -> score(...) argument order."""
    K, max_T, B = shape
    return K, max_T, B
