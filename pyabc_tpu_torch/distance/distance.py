"""Concrete distances (port of ``PNormDistance`` from
``pyabc_tpu/distance/distance.py``; the adaptive and aggregated
distances come with a later slice)."""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .base import Distance


class PNormDistance(Distance):
    """Weighted p-norm over sum-stat components:
    ``d(x, x0) = (Σ_s |f_s · w_s · (x_s − x0_s)|^p)^(1/p)``, ``p = inf`` the
    max-norm.  Weights may be time-indexed ``{t: {key: w}}``."""

    def __init__(self, p: float = 2.0,
                 weights: Optional[Mapping] = None,
                 factors: Optional[Mapping] = None):
        super().__init__()
        if p < 1:
            raise ValueError("p must be >= 1")
        self.p = float(p)
        self._weights_in = weights
        self._factors_in = factors
        self.weights: Dict[int, np.ndarray] = {}
        self.factors: Optional[np.ndarray] = None

    def _timed(self, maybe_timed) -> Dict[int, Mapping]:
        if maybe_timed is None:
            return {}
        first = next(iter(maybe_timed.values()), None)
        if isinstance(first, Mapping):
            return dict(maybe_timed)
        return {0: maybe_timed}

    def _on_bind(self, x_0):
        for tt, per_key in self._timed(self._weights_in).items():
            self.weights[tt] = self.spec.expand_key_values(per_key)
        factors = self._timed(self._factors_in)
        if factors:
            self.factors = self.spec.expand_key_values(factors[min(factors)])

    def _weights_for(self, t: int) -> np.ndarray:
        if not self.weights:
            return np.ones(self.spec.total_size, dtype=np.float32)
        ts = [tt for tt in self.weights if tt <= t]
        return self.weights[max(ts) if ts else min(self.weights)]

    def get_params(self, t: int) -> dict:
        w = self._weights_for(t)
        f = self.factors if self.factors is not None else np.ones_like(w)
        return {"w": (w * f).astype(np.float32)}

    def compute(self, stats, obs, params):
        diff = torch.abs(params["w"] * (stats - obs))
        if np.isinf(self.p):
            return torch.max(diff, dim=-1).values
        return torch.sum(diff ** self.p, dim=-1) ** (1.0 / self.p)

    def get_config(self):
        return {"name": type(self).__name__, "p": self.p}
