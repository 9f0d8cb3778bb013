"""Threshold schedules (port of ``pyabc_tpu/epsilon/epsilon.py``:
Constant, List, Quantile, Median)."""

from __future__ import annotations

from typing import Callable, List

from ..weighted_statistics import weighted_quantile
from .base import Epsilon


class ConstantEpsilon(Epsilon):
    """Fixed ε for all generations."""

    device_schedule_ok = True
    device_stop_ok = True
    #: vacuous: a constant sorts nothing
    device_sketch_ok = True

    def __init__(self, constant_epsilon_value: float):
        self.constant_epsilon_value = float(constant_epsilon_value)

    def __call__(self, t: int) -> float:
        return self.constant_epsilon_value

    def get_config(self):
        return {"name": type(self).__name__,
                "constant_epsilon_value": self.constant_epsilon_value}


class ListEpsilon(Epsilon):
    """Pre-defined ε per generation."""

    def __init__(self, values: List[float]):
        self.epsilon_values = [float(v) for v in values]

    def __call__(self, t: int) -> float:
        return self.epsilon_values[t]

    def get_config(self):
        return {"name": type(self).__name__,
                "epsilon_values": self.epsilon_values}


class QuantileEpsilon(Epsilon):
    """ε_t = weighted α-quantile of the previous generation's accepted
    distances (times ``quantile_multiplier``), computed on the host — or
    inside a fused block on the device, exactly by default and by the
    sort-free sketch with ``device_sketch=True``."""

    device_schedule_ok = True
    device_stop_ok = True

    def __init__(self, initial_epsilon="from_sample", alpha: float = 0.5,
                 quantile_multiplier: float = 1.0, weighted: bool = True,
                 device_sketch: bool = False):
        if not 0 < alpha <= 1:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = float(alpha)
        self.initial_epsilon = initial_epsilon
        self.quantile_multiplier = float(quantile_multiplier)
        self.weighted = weighted
        self.device_sketch_ok = bool(device_sketch)
        self._look_up: dict = {}

    def initialize(self, t, get_weighted_distances=None, get_all_records=None,
                   max_nr_populations=None, acceptor_config=None):
        if self.initial_epsilon == "from_sample":
            self._update(t, get_weighted_distances)
        else:
            self._look_up[t] = float(self.initial_epsilon)

    def update(self, t, get_weighted_distances=None, get_all_records=None,
               acceptance_rate=None, acceptor_config=None):
        self._update(t, get_weighted_distances)

    def _update(self, t: int, get_weighted_distances: Callable):
        distances, weights = get_weighted_distances()
        if not self.weighted:
            weights = None
        eps = float(weighted_quantile(distances, weights, alpha=self.alpha))
        self._look_up[t] = eps * self.quantile_multiplier

    def __call__(self, t: int) -> float:
        try:
            return self._look_up[t]
        except KeyError:
            # fall back to the greatest known t (reference epsilon.py:188)
            if self._look_up:
                return self._look_up[max(self._look_up)]
            raise

    def get_config(self):
        return {"name": type(self).__name__, "alpha": self.alpha,
                "quantile_multiplier": self.quantile_multiplier,
                "weighted": self.weighted}


class MedianEpsilon(QuantileEpsilon):
    """α = 0.5 quantile — the reference default."""

    def __init__(self, initial_epsilon="from_sample",
                 median_multiplier: float = 1.0, weighted: bool = True,
                 device_sketch: bool = False):
        super().__init__(initial_epsilon=initial_epsilon, alpha=0.5,
                         quantile_multiplier=median_multiplier,
                         weighted=weighted, device_sketch=device_sketch)
