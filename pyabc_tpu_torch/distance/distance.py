"""Concrete distances: port of ``PNormDistance`` and
``AdaptivePNormDistance`` from ``pyabc_tpu/distance/distance.py`` (the
aggregated, z-score, PCA, range, min-max and percentile distances are
not ported yet).

The adaptive weights are host numpy ``{t: w[S]}``, as in the JAX
package; the scale refit behind them runs on the record block's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from .base import Distance
from .scale import SCALE_FUNCTIONS, median_absolute_deviation


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

    def params_time_invariant(self) -> bool:
        # a time-indexed weight schedule changes get_params across t
        return len(self.weights) <= 1 and super().params_time_invariant()

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


class AdaptivePNormDistance(PNormDistance):
    """p-norm with per-generation inverse-scale weights.

    Each generation the weights are refit as ``w_s = 1 / scale_s`` from
    the stats of every candidate of the previous generation, rejected
    ones included — the record stream, which ``configure_sampler``
    requests.  The weights of generation ``t`` sit in ``weights[t]``;
    ``get_params(t)`` uses the latest entry at or before ``t``.

    A custom ``scale_function(data[R, S], x_0[S]) -> [S]`` gets tensors on
    the record block's device and must be NaN-aware like the built-in
    :data:`~.scale.SCALE_FUNCTIONS`.
    """

    requires_all_sum_stats = True

    def __init__(self, p: float = 2.0,
                 factors: Optional[Mapping] = None,
                 adaptive: bool = True,
                 scale_function: Union[str, Callable]
                 = median_absolute_deviation,
                 normalize_weights: bool = True,
                 max_weight_ratio: Optional[float] = None,
                 log_file: Optional[str] = None):
        super().__init__(p=p, weights=None, factors=factors)
        self.adaptive = adaptive
        if isinstance(scale_function, str):
            scale_function = SCALE_FUNCTIONS[scale_function]
        self.scale_function = scale_function
        self.normalize_weights = normalize_weights
        self.max_weight_ratio = max_weight_ratio
        #: JSON trajectory of the weights, rewritten after every fit
        self.log_file = log_file
        self._x0_flat: Optional[torch.Tensor] = None

    def _on_bind(self, x_0):
        PNormDistance._on_bind(self, x_0)
        if x_0 is not None:
            self._x0_flat = self.spec.flatten_single(x_0)

    def initialize(self, t, get_sample_stats, x_0, spec):
        Distance.initialize(self, t, get_sample_stats, x_0, spec)
        if get_sample_stats is not None:
            self._fit(t, spec.flatten(get_sample_stats()))

    def update(self, t, get_all_stats=None) -> bool:
        if not self.adaptive or get_all_stats is None:
            return False
        if t in self.weights:
            # the schedule for t is already decided; the population's
            # distances are still re-evaluated under it
            return True
        data = self.spec.flatten(get_all_stats())
        if data.shape[0] == 0:
            return False  # nothing recorded: keep the previous weights
        self._fit(t, data)
        return True

    @property
    def device_refit_ok(self) -> bool:
        """The per-generation refit can run inside a fused block:
        adaptation on, a library scale function (a NaN-aware tensor
        reducer of :data:`~.scale.SCALE_FUNCTIONS`; a custom callable may
        use host numpy), no log file, and this exact class (a subclass
        may override ``_fit``)."""
        return (type(self) is AdaptivePNormDistance
                and self.adaptive
                and self.log_file is None
                and any(self.scale_function is f
                        for f in SCALE_FUNCTIONS.values()))

    def params_time_invariant(self) -> bool:
        return (not self.adaptive) and super().params_time_invariant()

    def _fit(self, t: int, data: torch.Tensor):
        """Scales on the data's device; weights on the host."""
        x0 = self._x0_flat.to(data.device)
        scale = self.scale_function(data, x0).detach().cpu().numpy()
        with np.errstate(divide="ignore"):
            w = np.where(scale > 0, 1.0 / np.maximum(scale, 1e-30), 0.0)
        if self.max_weight_ratio is not None:
            pos = w[w > 0]
            if pos.size:
                w = np.minimum(w, pos.min() * self.max_weight_ratio)
        if self.normalize_weights and w.sum() > 0:
            w = w * w.size / w.sum()
        self.weights[t] = w.astype(np.float32)
        if self.log_file:
            from ..storage import save_dict_to_json
            save_dict_to_json(self.weights, self.log_file)

    def get_config(self):
        return {
            "name": type(self).__name__, "p": self.p,
            "scale_function": getattr(self.scale_function, "__name__",
                                      "custom"),
            "max_weight_ratio": self.max_weight_ratio,
        }
