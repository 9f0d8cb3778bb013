"""Epsilon base contract (port of ``pyabc_tpu/epsilon/base.py``).

Epsilons are control plane: they run once per generation on the host and
emit one scalar that the acceptor hands to the candidate rounds.
"""

from __future__ import annotations

from typing import Callable, Optional


class Epsilon:
    """Acceptance-threshold schedule: ``initialize`` with calibration
    distances, ``update`` each generation, ``__call__(t) -> float``."""

    #: the schedule can advance inside a fused block (a constant, a
    #: weighted quantile of the carried distances, or the device
    #: temperature solve); concrete classes opt in, and
    #: ``ABCSMC._device_chain_eligible`` reads it
    device_schedule_ok = False
    #: the stop test (ε ≤ minimum_epsilon, or T = 1) is exact on the
    #: in-block value (read by the one-dispatch engine, not ported yet)
    device_stop_ok = False
    #: the schedule consents to the sort-free quantile sketch in-block
    #: (``ops.quantile_sketch``); a bounded approximation, so a
    #: per-instance opt-in, vacuously true where nothing is sorted
    device_sketch_ok = False

    def initialize(self, t: int,
                   get_weighted_distances: Optional[Callable] = None,
                   get_all_records: Optional[Callable] = None,
                   max_nr_populations: Optional[int] = None,
                   acceptor_config: Optional[dict] = None):
        pass

    def configure_sampler(self, sampler):
        """Request sampler features (the record stream, for a
        temperature scheme that reads it)."""

    def update(self, t: int,
               get_weighted_distances: Optional[Callable] = None,
               get_all_records: Optional[Callable] = None,
               acceptance_rate: Optional[float] = None,
               acceptor_config: Optional[dict] = None):
        pass

    def __call__(self, t: int) -> float:
        raise NotImplementedError

    def requires_calibration(self) -> bool:
        """Whether ``initialize`` needs a calibration sample at t = 0."""
        return False

    def get_config(self) -> dict:
        return {"name": type(self).__name__}

    def to_json(self) -> str:
        import json
        return json.dumps(self.get_config())


class NoEpsilon(Epsilon):
    """No threshold (NaN): the acceptance is decided elsewhere."""

    def __call__(self, t: int) -> float:
        return float("nan")
