"""Sampler contract and the Sample accumulator.

Port of ``RoundResult``, ``Sample`` and ``Sampler`` from
``pyabc_tpu/sampler/base.py``.  A round function

    round_fn(generator, params, B, ...) -> RoundResult   (B candidates)

runs one fixed-size batch of candidates on the run's device; the sampler
repeats rounds until ``n`` are accepted.  Rounds are ordered, so keeping
the accepted rows in (round, lane) order and truncating to the first
``n`` is the reference's de-biasing protocol.  ``nr_evaluations`` counts
rounds × B.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..population import Population


class RoundResult:
    """One batch of B candidates (tensors on the run's device)."""

    def __init__(self, m, theta, distance, accepted, log_weight, stats):
        self.m = m                    # int64[B]
        self.theta = theta            # float32[B, D]
        self.distance = distance      # float32[B]
        self.accepted = accepted      # bool[B]
        self.log_weight = log_weight  # float32[B]
        self.stats = stats            # float32[B, S]


class SamplingError(Exception):
    pass


_ROW_KEYS = ("m", "theta", "distance", "log_weight", "stats")


class Sample:
    """Host-side accumulator over rounds: accepted rows as numpy batches."""

    def __init__(self):
        self._acc: List[dict] = []
        self.nr_evaluations = 0
        #: ALL acceptances observed, incl. beyond the requested n (for an
        #: acceptance rate unbiased by the batch rounding)
        self.raw_accepted = 0

    def append_round(self, rr: RoundResult):
        """Ingest one round's accepted rows (one host transfer)."""
        acc = rr.accepted.cpu().numpy()
        self.nr_evaluations += int(acc.shape[0])
        self.raw_accepted += int(acc.sum())
        idx = np.nonzero(acc)[0]
        if idx.size:
            self._acc.append({k: getattr(rr, k).cpu().numpy()[idx]
                              for k in _ROW_KEYS})

    def append_device_batch(self, out: dict, n_evals: int, count: int):
        """Ingest a generation's compacted accepted buffers: ``out`` holds
        the first ``min(count, n)`` rows as host numpy."""
        self.nr_evaluations += int(n_evals)
        self.raw_accepted += int(count)
        if out["m"].shape[0]:
            self._acc.append(out)

    @property
    def n_accepted(self) -> int:
        return sum(a["m"].shape[0] for a in self._acc)

    @property
    def acceptance_rate(self) -> float:
        """Raw acceptances (incl. beyond n) / evaluations."""
        return self.raw_accepted / max(self.nr_evaluations, 1)

    def get_accepted_population(self, n: int) -> Population:
        """First n accepted particles in round order, weights normalized
        in log space (float64) and stored as float32."""
        if self.n_accepted < n:
            raise SamplingError(
                f"expected {n} accepted particles, have {self.n_accepted}")
        cols = {k: np.concatenate([a[k] for a in self._acc])[:n]
                for k in _ROW_KEYS}
        logw = cols["log_weight"]
        logw = logw - logw.max() if logw.size else logw
        w = np.exp(np.asarray(logw, dtype=np.float64))
        s = w.sum()
        if not np.isfinite(s) or s <= 0:
            raise SamplingError("all accepted particles have zero weight")
        return Population(
            m=cols["m"].astype(np.int32), theta=cols["theta"],
            weight=(w / s).astype(np.float32), distance=cols["distance"],
            sum_stats={"__flat__": cols["stats"]})


class Sampler:
    """Abstract sampler."""

    def __init__(self):
        self.nr_evaluations_ = 0

    def sample_until_n_accepted(self, n: int, round_fn, generator, params,
                                max_eval: float = np.inf,
                                all_accepted: bool = False) -> Sample:
        raise NotImplementedError
