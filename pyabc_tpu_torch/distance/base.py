"""Distance base contract (port of ``pyabc_tpu/distance/base.py``).

A distance splits into host lifecycle state and a pure batched kernel:

- ``get_params(t)`` -> dict of host arrays, moved to the run's device once
  per generation by the sampler;
- ``compute(stats[N, S], obs[S], params) -> [N]`` on tensors.

The adaptation lifecycle mutates only the host state behind
``get_params``: ``initialize`` calibrates from the calibration sample,
``configure_sampler`` requests the record stream (rejected candidates
too) when ``requires_all_sum_stats`` is set, and ``update(t,
get_all_stats)`` refits once per generation and returns whether the
params changed.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Optional

import torch

from ..sumstat import SumStatSpec


class Distance:
    """Abstract distance over flattened summary statistics."""

    #: whether this distance needs every candidate's stats recorded,
    #: rejected ones included (``configure_sampler`` sets the sampler's
    #: ``record_rejected``)
    requires_all_sum_stats: bool = False

    #: fidelity-cascade capability flag: True when low- and
    #: full-fidelity distances under one ``get_params`` are comparable
    #: across a whole run (time-invariant params, a fixed metric over the
    #: flat statistics), so calibration pairs from generation t - 1 stay
    #: on the scale of the screen at t (``ABCSMC._fidelity_eligible``)
    device_screen_ok: bool = False

    def __init__(self):
        self.spec: Optional[SumStatSpec] = None

    def bind(self, spec: SumStatSpec, x_0: Optional[Mapping] = None):
        """Bind the sum-stat layout before any sampling."""
        self.spec = spec
        self._on_bind(x_0)

    def _on_bind(self, x_0):
        pass

    def initialize(self, t: int, get_sample_stats: Optional[Callable],
                   x_0: Mapping, spec: SumStatSpec):
        """Calibrate from the calibration sample: ``get_sample_stats()``
        lazily returns its stats as ``{key: [N, ...]}``."""
        if self.spec is None or spec is not self.spec:
            self.bind(spec, x_0)

    def configure_sampler(self, sampler):
        """Request sampler features."""
        if self.requires_all_sum_stats:
            sampler.record_rejected = True

    def update(self, t: int, get_all_stats: Optional[Callable] = None
               ) -> bool:
        """Per-generation adaptation; True iff the params changed."""
        return False

    def params_time_invariant(self) -> bool:
        """True iff ``get_params(t)`` is the same for every t of the run.
        Conservative: a subclass from outside this package that overrides
        ``get_params`` counts as time-variant."""
        gp = type(self).get_params
        if gp is Distance.get_params:
            return True
        return (getattr(gp, "__module__", "")
                or "").startswith("pyabc_tpu_torch.")

    def get_params(self, t: int) -> dict:
        return {}

    def compute(self, stats: torch.Tensor, obs: torch.Tensor,
                params) -> torch.Tensor:
        raise NotImplementedError

    def get_config(self) -> dict:
        return {"name": type(self).__name__}

    def to_json(self) -> str:
        import json
        return json.dumps(self.get_config())


class NoDistance(Distance):
    """Always NaN: a placeholder where no distance is computed."""

    def compute(self, stats, obs, params):
        return torch.full((stats.shape[0],), math.nan,
                          device=stats.device)


class AcceptAllDistance(Distance):
    """Always -1, so that every ε accepts."""

    def compute(self, stats, obs, params):
        return torch.full((stats.shape[0],), -1.0, device=stats.device)


class IdentityFakeDistance(Distance):
    """The first statistic column as the distance: for a model that
    returns its distance as its (single) statistic."""

    def compute(self, stats, obs, params):
        return stats[:, 0]


class SimpleFunctionDistance(Distance):
    """A user function ``fn(x_dict, x0_dict) -> [N]`` over tensors (the
    flat block unflattened by key)."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def compute(self, stats, obs, params):
        return self.fn(self.spec.unflatten(stats), self.spec.unflatten(obs))

    def get_config(self):
        return {"name": getattr(self.fn, "__name__", type(self).__name__)}


def to_distance(maybe_distance) -> Distance:
    """A :class:`Distance` as is; a callable wrapped as
    :class:`SimpleFunctionDistance`."""
    if isinstance(maybe_distance, Distance):
        return maybe_distance
    return SimpleFunctionDistance(maybe_distance)
