"""Concrete distances: port of ``pyabc_tpu/distance/distance.py`` —
``PNormDistance``, ``AdaptivePNormDistance``, ``AggregatedDistance``,
``AdaptiveAggregatedDistance``, ``ZScoreDistance``, ``PCADistance``,
``DistanceWithMeasureList``, ``RangeEstimatorDistance``,
``MinMaxDistance`` and ``PercentileDistance``.

Weights, ranges and whitening matrices are host numpy state, as in the
JAX package (the range and PCA calibrations run on the host there too);
the adaptive refits over the record stream run on the record block's
device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..convert import to_torch
from ..ops import precision as _precision
from .base import Distance, to_distance
from .scale import SCALE_FUNCTIONS, median_absolute_deviation, span


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

    @property
    def device_screen_ok(self) -> bool:
        """A fixed-weight p-norm scores low- and full-fidelity statistics
        on one time-invariant scale; a weight schedule and every subclass
        (the adaptive refit moves the scale) do not."""
        return (type(self) is PNormDistance
                and self.params_time_invariant())

    def get_params(self, t: int) -> dict:
        w = self._weights_for(t)
        f = self.factors if self.factors is not None else np.ones_like(w)
        return {"w": (w * f).astype(np.float32)}

    def compute(self, stats, obs, params):
        diff = torch.abs(params["w"] * (stats - obs))
        if _precision.lanes("distance") == "bf16":
            # the residual is formed in float32 (the subtraction cancels);
            # the bf16 lane rounds it (relative error 2^-8) and the norm
            # accumulates in float32
            diff = diff.to(torch.bfloat16)
            if np.isinf(self.p):
                return torch.max(diff, dim=-1).values.to(torch.float32)
            diff = diff.to(torch.float32)
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


class AggregatedDistance(Distance):
    """Weighted sum of sub-distances: ``d = Σ_j f_j · w_j · d_j(x, x0)``."""

    def __init__(self, distances: Sequence, weights=None, factors=None):
        super().__init__()
        self.distances: List[Distance] = [to_distance(d) for d in distances]
        self.weights: Dict[int, np.ndarray] = {}
        if weights is not None:
            self.weights[0] = np.asarray(weights, dtype=np.float32)
        self.factors = (np.asarray(factors, dtype=np.float32)
                        if factors is not None
                        else np.ones(len(self.distances), dtype=np.float32))

    def bind(self, spec, x_0=None):
        super().bind(spec, x_0)
        for d in self.distances:
            d.bind(spec, x_0)

    def initialize(self, t, get_sample_stats, x_0, spec):
        super().initialize(t, get_sample_stats, x_0, spec)
        for d in self.distances:
            d.initialize(t, get_sample_stats, x_0, spec)

    def configure_sampler(self, sampler):
        super().configure_sampler(sampler)
        for d in self.distances:
            d.configure_sampler(sampler)

    def params_time_invariant(self) -> bool:
        return (all(d.params_time_invariant() for d in self.distances)
                and len(self.weights) <= 1
                and Distance.params_time_invariant(self))

    def update(self, t, get_all_stats=None) -> bool:
        changed = False
        for d in self.distances:
            changed |= d.update(t, get_all_stats)
        return changed

    def _weights_for(self, t: int) -> np.ndarray:
        if not self.weights:
            return np.ones(len(self.distances), dtype=np.float32)
        ts = [tt for tt in self.weights if tt <= t]
        return self.weights[max(ts) if ts else min(self.weights)]

    def get_params(self, t: int) -> dict:
        return {"w": (self._weights_for(t) * self.factors).astype(np.float32),
                "sub": tuple(d.get_params(t) for d in self.distances)}

    def compute(self, stats, obs, params):
        vals = torch.stack([d.compute(stats, obs, p) for d, p
                            in zip(self.distances, params["sub"])], dim=-1)
        return torch.sum(vals * params["w"], dim=-1)

    def get_config(self):
        return {"name": type(self).__name__,
                "distances": [d.get_config() for d in self.distances]}


class AdaptiveAggregatedDistance(AggregatedDistance):
    """Aggregated distance whose sub-distance weights are refit every
    generation as ``1 / scale`` of the sub-distances' values over the
    record stream (rejected candidates included, as
    :class:`AdaptivePNormDistance` takes them), on the records' device."""

    requires_all_sum_stats = True

    def __init__(self, distances, scale_function: Optional[Callable] = None,
                 adaptive: bool = True):
        super().__init__(distances)
        self.scale_function = scale_function or span
        self.adaptive = adaptive
        self._x0_flat: Optional[torch.Tensor] = None

    def _on_bind(self, x_0):
        if x_0 is not None:
            self._x0_flat = self.spec.flatten_single(x_0)

    def initialize(self, t, get_sample_stats, x_0, spec):
        super().initialize(t, get_sample_stats, x_0, spec)
        if get_sample_stats is not None:
            self._fit(t, spec.flatten(get_sample_stats()))

    def update(self, t, get_all_stats=None) -> bool:
        changed = super().update(t, get_all_stats)
        if self.adaptive and get_all_stats is not None:
            self._fit(t, self.spec.flatten(get_all_stats()))
            changed = True
        return changed

    def params_time_invariant(self) -> bool:
        return (not self.adaptive) and super().params_time_invariant()

    def _fit(self, t: int, data: torch.Tensor):
        obs = self._x0_flat.to(data.device)
        vals = torch.stack(
            [d.compute(data, obs, to_torch(d.get_params(t), data.device))
             for d in self.distances], dim=-1)  # [N, n_dist]
        scale = self.scale_function(vals, None).detach().cpu().numpy()
        with np.errstate(divide="ignore"):
            w = np.where(scale > 0, 1.0 / np.maximum(scale, 1e-30), 1.0)
        self.weights[t] = w.astype(np.float32)


class ZScoreDistance(Distance):
    """Relative error: Σ |(x − x0) / x0| (a zero x0 component counts 0
    where x matches it and inf elsewhere)."""

    def compute(self, stats, obs, params):
        nz = obs.abs() > 0
        denom = torch.where(nz, obs.abs(), torch.ones_like(obs))
        rel = torch.where(nz, ((stats - obs) / denom).abs(),
                          torch.where(stats.abs() > 0,
                                      torch.full_like(stats, float("inf")),
                                      torch.zeros_like(stats)))
        return rel.sum(dim=-1)


class PCADistance(Distance):
    """Whitened euclidean distance ``||W (x − x0)||₂`` with ``W = Λ^(-1/2)
    Vᵀ`` from the calibration sample's covariance (host numpy)."""

    def __init__(self):
        super().__init__()
        self._trafo: Optional[np.ndarray] = None

    def _on_bind(self, x_0):
        # neutral whitening until the calibration sample arrives
        self._trafo = np.eye(self.spec.total_size, dtype=np.float32)

    def initialize(self, t, get_sample_stats, x_0, spec):
        super().initialize(t, get_sample_stats, x_0, spec)
        if get_sample_stats is None:
            return
        data = spec.flatten(get_sample_stats()).detach().cpu().numpy()
        cov = np.cov(data, rowvar=False)
        cov = np.atleast_2d(cov) + 1e-8 * np.eye(data.shape[1])
        evals, evecs = np.linalg.eigh(cov)
        evals = np.maximum(evals, 1e-12)
        self._trafo = (evecs / np.sqrt(evals)).T.astype(np.float32)

    def get_params(self, t):
        return {"W": self._trafo}

    def compute(self, stats, obs, params):
        z = (stats - obs) @ params["W"].T
        return torch.sqrt((z * z).sum(dim=-1))


class DistanceWithMeasureList(PNormDistance):
    """p-norm over a subset of the summary statistics:
    ``measures_to_use`` is "all" or a list of keys; the other keys get
    weight 0."""

    def __init__(self, measures_to_use="all", p: float = 2.0):
        super().__init__(p=p)
        self.measures_to_use = measures_to_use

    def _measure_mask(self) -> np.ndarray:
        if self.measures_to_use == "all":
            return np.ones(self.spec.total_size, dtype=np.float32)
        return self.spec.expand_key_values(
            {k: 1.0 for k in self.measures_to_use}, default=0.0)

    def get_params(self, t):
        params = super().get_params(t)
        params["w"] = params["w"] * self._measure_mask()
        return params

    def get_config(self):
        cfg = super().get_config()
        cfg["measures_to_use"] = (self.measures_to_use
                                  if self.measures_to_use == "all"
                                  else list(self.measures_to_use))
        return cfg


class RangeEstimatorDistance(DistanceWithMeasureList):
    """p-norm normalized by a per-component range calibrated on the
    calibration sample (host numpy): the range's inverse is the p-norm
    weight vector.  Subclasses define ``lower`` / ``upper``."""

    def __init__(self, measures_to_use="all", p: float = 2.0):
        super().__init__(measures_to_use=measures_to_use, p=p)
        self._inv_range: Optional[np.ndarray] = None

    @staticmethod
    def lower(data: np.ndarray) -> np.ndarray:
        return np.min(data, axis=0)

    @staticmethod
    def upper(data: np.ndarray) -> np.ndarray:
        return np.max(data, axis=0)

    def _on_bind(self, x_0):
        super()._on_bind(x_0)
        self._inv_range = np.ones(self.spec.total_size, dtype=np.float32)

    def initialize(self, t, get_sample_stats, x_0, spec):
        super().initialize(t, get_sample_stats, x_0, spec)
        if get_sample_stats is None:
            return
        data = spec.flatten(get_sample_stats()).detach().cpu().numpy()
        rng = self.upper(data) - self.lower(data)
        with np.errstate(divide="ignore"):
            self._inv_range = np.where(rng > 0, 1.0 / np.maximum(rng, 1e-30),
                                       0.0).astype(np.float32)

    def get_params(self, t):
        return {"w": (self._inv_range * self._measure_mask()).astype(
            np.float32)}


class MinMaxDistance(RangeEstimatorDistance):
    """Range = max − min."""


class PercentileDistance(RangeEstimatorDistance):
    """Range between the 10th and 90th percentiles."""

    PERCENTILE = 10

    @classmethod
    def lower(cls, data):
        return np.percentile(data, cls.PERCENTILE, axis=0)

    @classmethod
    def upper(cls, data):
        return np.percentile(data, 100 - cls.PERCENTILE, axis=0)
