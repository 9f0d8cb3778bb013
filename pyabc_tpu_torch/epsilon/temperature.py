"""Temperature schedules for exact stochastic acceptance.

Port of ``pyabc_tpu/epsilon/temperature.py``.  A :class:`TemperatureBase`
epsilon does not threshold distances: it anneals an acceptance
temperature T down to 1, where the stochastic acceptor samples the exact
posterior.  :class:`Temperature` aggregates the proposals of its
``schemes`` (minimum by default), never rises above the previous
temperature and enforces T = 1 in the last generation.

The schemes are host functions of per-generation summaries.  The
acceptance-rate solve runs on the device when the records are device
tensors (:func:`acceptance_rate_solve`, one float32 bisection over the
records, three scalars read back) and on the host with
``scipy.optimize.bisect`` where the records are host arrays (the
calibration sample).

Scheme call signature::

    scheme(t=..., get_weighted_distances=..., get_all_records=...,
           get_device_records=..., max_nr_populations=..., pdf_norm=...,
           kernel_scale=..., prev_temperature=..., acceptance_rate=...)
        -> Optional[float]
"""

from __future__ import annotations

import logging
import math
from typing import Callable, List, Optional

import numpy as np
import torch

from ..distance.kernel import SCALE_LIN, SCALE_LOG
from .base import Epsilon

logger = logging.getLogger("ABC.Epsilon")


class TemperatureBase(Epsilon):
    """Marker base: ``__call__(t)`` returns a temperature, not a
    threshold."""


class ListTemperature(TemperatureBase):
    """Pre-defined temperatures per generation."""

    def __init__(self, values: List[float]):
        self.values = [float(v) for v in values]

    def __call__(self, t: int) -> float:
        return self.values[t]


class Temperature(TemperatureBase):
    """Adaptive temperature: the aggregate of the scheme proposals,
    monotone non-increasing, at least 1, and 1 in the last generation."""

    def __init__(self, schemes: Optional[List[Callable]] = None,
                 aggregate_fun: Callable = min,
                 initial_temperature: Optional[float] = None,
                 enforce_exact_final_temperature: bool = True,
                 log_file: Optional[str] = None):
        if schemes is None:
            schemes = [AcceptanceRateScheme(), ExpDecayFixedIterScheme()]
        self.schemes = schemes
        self.aggregate_fun = aggregate_fun
        self.initial_temperature = initial_temperature
        self.enforce_exact_final_temperature = enforce_exact_final_temperature
        self.log_file = log_file
        self.temperatures: dict = {}
        self.temperature_proposals: dict = {}
        #: temperatures installed by ``convert.install_annealing``: a
        #: generation found here keeps its temperature
        self.installed: dict = {}
        self._max_nr_populations: Optional[int] = None

    def configure_sampler(self, sampler):
        for scheme in self.schemes:
            if getattr(scheme, "requires_all_records", False):
                sampler.record_rejected = True
                # the schemes weigh records by pd/pd_prev, so the records
                # carry their generating proposal's density
                sampler.record_proposal_density = True

    def initialize(self, t, get_weighted_distances=None, get_all_records=None,
                   max_nr_populations=None, acceptor_config=None):
        self._max_nr_populations = max_nr_populations
        self._update(t, get_weighted_distances, get_all_records,
                     acceptance_rate=1.0,
                     acceptor_config=acceptor_config or {})

    def update(self, t, get_weighted_distances=None, get_all_records=None,
               acceptance_rate=None, acceptor_config=None):
        self._update(t, get_weighted_distances, get_all_records,
                     acceptance_rate, acceptor_config or {})

    def _update(self, t, get_weighted_distances, get_all_records,
                acceptance_rate, acceptor_config):
        nr_pop = self._max_nr_populations
        prev_t = self.temperatures.get(t - 1)
        if t in self.installed:
            temp = float(self.installed[t])
            self.temperature_proposals[t] = {"installed": temp}
        elif (nr_pop is not None and t >= nr_pop - 1
                and self.enforce_exact_final_temperature):
            temp = 1.0
            self.temperature_proposals[t] = {"final": 1.0}
        elif prev_t is not None and prev_t <= 1.0:
            temp = 1.0
            self.temperature_proposals[t] = {"clamped": 1.0}
        else:
            if prev_t is None and self.initial_temperature is not None:
                temp = float(self.initial_temperature)
                self.temperature_proposals[t] = {
                    "initial_temperature": temp}
            else:
                proposals = {}
                # a Sample's bound get_records_columns brings its device
                # records along: the schemes that can solve on the device
                # read three scalars instead of the record columns
                sample_obj = getattr(get_all_records, "__self__", None)
                get_device_records = getattr(
                    sample_obj, "get_records_device", None)
                for scheme in self.schemes:
                    try:
                        val = scheme(
                            t=t,
                            get_weighted_distances=get_weighted_distances,
                            get_all_records=get_all_records,
                            get_device_records=get_device_records,
                            max_nr_populations=nr_pop,
                            pdf_norm=acceptor_config.get("pdf_norm", 0.0),
                            kernel_scale=acceptor_config.get(
                                "kernel_scale", SCALE_LOG),
                            prev_temperature=prev_t,
                            acceptance_rate=acceptance_rate)
                    except Exception as e:
                        # a failing scheme must not end the run, but its
                        # error must be visible
                        logger.warning(
                            "temperature scheme %s failed at t=%d: %s",
                            type(scheme).__name__, t, e)
                        val = np.inf
                    if val is not None and np.isfinite(val):
                        proposals[type(scheme).__name__] = float(val)
                self.temperature_proposals[t] = proposals
                if proposals:
                    temp = float(self.aggregate_fun(proposals.values()))
                else:
                    temp = prev_t if prev_t is not None else np.inf
            # monotone annealing: never above the previous temperature
            if prev_t is not None:
                temp = min(temp, prev_t)
            temp = max(temp, 1.0)
        self.temperatures[t] = temp
        if self.log_file:
            from ..storage.json import save_dict_to_json
            save_dict_to_json(self.temperature_proposals, self.log_file)

    def __call__(self, t: int) -> float:
        return self.temperatures[t]

    # ---- fused-engine capability flags ------------------------------------

    @property
    def device_solve_ok(self) -> bool:
        """The whole update is the fused engine's in-block acceptance-rate
        solve: exactly one :class:`AcceptanceRateScheme` without
        ``min_rate`` (that guard reads the realized acceptance rate,
        which the block does not thread), min aggregation, no log file,
        and this exact class (a subclass may override ``_update``)."""
        return (type(self) is Temperature
                and len(self.schemes) == 1
                and type(self.schemes[0]) is AcceptanceRateScheme
                and self.schemes[0].min_rate is None
                and self.aggregate_fun is min
                and self.log_file is None)

    @property
    def device_schedule_ok(self) -> bool:
        return self.device_solve_ok

    @property
    def device_stop_ok(self) -> bool:
        # the stop test (T == 1) reads the in-block solve's own output
        return self.device_solve_ok

    @property
    def device_sketch_ok(self) -> bool:
        # vacuous: the bisection solve sorts nothing
        return self.device_solve_ok

    def get_config(self):
        return {"name": type(self).__name__,
                "schemes": [type(s).__name__ for s in self.schemes]}


# ---------------------------------------------------------------------------
# Schemes
# ---------------------------------------------------------------------------


def _records_to_arrays(get_all_records, kernel_scale):
    """(log densities, normalized importance weights) of the records:
    column arrays (``Sample.get_records_columns``) or a list of dicts,
    with keys ``distance``, ``transition_pd_prev``, ``transition_pd``
    and ``accepted``."""
    records = get_all_records()
    if records is None:
        records = []
    if isinstance(records, dict):
        logdens = np.asarray(records["distance"], dtype=np.float64)
        pd_prev = np.asarray(records.get("transition_pd_prev", 1.0),
                             dtype=np.float64) * np.ones_like(logdens)
        pd = np.asarray(records.get("transition_pd", 1.0),
                        dtype=np.float64) * np.ones_like(logdens)
    else:
        logdens = np.asarray([r["distance"] for r in records],
                             dtype=np.float64)
        pd_prev = np.asarray([r.get("transition_pd_prev", 1.0)
                              for r in records], dtype=np.float64)
        pd = np.asarray([r.get("transition_pd", 1.0) for r in records],
                        dtype=np.float64)
    if kernel_scale == SCALE_LIN:
        with np.errstate(divide="ignore"):
            logdens = np.log(np.maximum(logdens, 1e-290))
    with np.errstate(divide="ignore", invalid="ignore"):
        w = np.where(pd_prev > 0, pd / pd_prev, 0.0)
    if w.sum() <= 0:
        w = np.ones_like(w)
    return logdens, w / w.sum()


class TemperatureScheme:
    """Base of the temperature-proposal schemes: a callable proposing the
    next temperature, or ``None`` to abstain.  Schemes that read every
    candidate set ``requires_all_records``."""

    requires_all_records = False

    def __call__(self, t, **kwargs):
        raise NotImplementedError


#: bisection steps of the device solve and its interval for b = log β
SOLVE_STEPS = 60
SOLVE_MIN_B = -100.0


def acceptance_rate_solve(log_dens: torch.Tensor, log_ratio: torch.Tensor,
                          pdf_norm: float, target: float, lin_scale: bool):
    """The acceptance-rate temperature solve on the records' device, in
    float32: importance weights ``exp(log_ratio)`` (normalized), and the
    b = log β in [-100, 0] at which the weighted mean of ``min(1,
    exp((log_dens − pdf_norm)·β))`` meets ``target``, by 60 bisection
    steps.  Returns the tensors ``(b_opt, rate_at_b0, rate_at_bmin)``.

    A NaN row (in either column) is no record and is masked out.  A −inf
    log density is a real record of zero likelihood: it keeps its weight
    and accepts with probability 0.  A +inf ratio (generating density 0)
    weighs 0.  When no weight is positive the valid rows weigh equally;
    with no valid row every rate is 0."""
    f32 = torch.float32
    log_dens = log_dens.to(f32)
    log_ratio = log_ratio.to(f32)
    dev = log_dens.device
    valid = ~torch.isnan(log_dens) & ~torch.isnan(log_ratio)
    w_ok = valid & (log_ratio < math.inf)
    neg_inf = torch.full_like(log_ratio, -math.inf)
    shift = torch.where(w_ok & torch.isfinite(log_ratio), log_ratio,
                        neg_inf).max()
    shift = torch.where(torch.isfinite(shift), shift,
                        torch.zeros_like(shift))
    zeros = torch.zeros_like(log_ratio)
    w = torch.where(w_ok, torch.exp(log_ratio - shift), zeros)
    w = torch.where(w.sum() > 0, w, valid.to(f32))
    w = w / torch.clamp(w.sum(), min=1e-30)
    ld = log_dens
    if lin_scale:
        # the host's log(max(d, 1e-290)): a density that float32 stored
        # as 0 maps to the host's floor, not to -inf
        ld = torch.where(ld > 0, torch.log(torch.clamp(ld, min=1e-38)),
                         torch.full_like(ld, math.log(1e-290)))
    logvals = torch.where(valid, ld - pdf_norm, neg_inf)
    positive = w > 0

    def rate(b):
        # beta floored at the smallest float32 normal: exp(b) must not
        # flush to 0, where -inf·0 would be NaN
        beta = torch.clamp(torch.exp(b), min=1e-37)
        acc = torch.exp(torch.clamp(logvals * beta, max=0.0))
        return torch.where(positive, w * acc, zeros).sum()

    lo = torch.tensor(SOLVE_MIN_B, dtype=f32, device=dev)
    hi = torch.tensor(0.0, dtype=f32, device=dev)
    for _ in range(SOLVE_STEPS):
        # rate(b) falls as b rises; rate(lo) > target > rate(hi)
        mid = 0.5 * (lo + hi)
        too_cold = rate(mid) < target
        lo, hi = torch.where(too_cold, lo, mid), torch.where(too_cold, mid,
                                                             hi)
    return (0.5 * (lo + hi), rate(torch.zeros((), dtype=f32, device=dev)),
            rate(torch.full((), SOLVE_MIN_B, dtype=f32, device=dev)))


class AcceptanceRateScheme(TemperatureScheme):
    """T such that the expected acceptance rate over the records meets
    ``target_rate``: bisection over b = log β on the importance-weighted
    mean of ``min(1, exp((log density − c)/T))``.  On device records the
    solve is :func:`acceptance_rate_solve`; on host records it is
    ``scipy.optimize.bisect``."""

    requires_all_records = True

    def __init__(self, target_rate: float = 0.3,
                 min_rate: Optional[float] = None):
        self.target_rate = float(target_rate)
        self.min_rate = min_rate

    def __call__(self, t, get_all_records=None, get_device_records=None,
                 pdf_norm=0.0, kernel_scale=SCALE_LOG,
                 prev_temperature=None, acceptance_rate=None, **kwargs):
        if get_all_records is None and get_device_records is None:
            return None
        if (self.min_rate is not None and acceptance_rate is not None
                and acceptance_rate < self.min_rate):
            return np.inf

        min_b = SOLVE_MIN_B
        dev = get_device_records() if get_device_records else None
        if dev is not None:
            b_opt, rate0, rate_min = (
                float(v) for v in torch.stack(acceptance_rate_solve(
                    dev["log_dens"], dev["log_ratio"], pdf_norm,
                    self.target_rate, kernel_scale == SCALE_LIN)).cpu())
            if rate0 > self.target_rate:
                return 1.0  # beta = 1 already exceeds the target rate
            if rate_min < self.target_rate:
                logger.info(
                    "AcceptanceRateScheme: numerics limit temperature")
                return float(1.0 / np.exp(min_b))
            return float(1.0 / np.exp(b_opt))

        from scipy import optimize

        logdens, w = _records_to_arrays(get_all_records, kernel_scale)
        logvals = logdens - pdf_norm

        def rate_minus_target(b):
            beta = np.exp(b)
            acc = np.exp(np.minimum(logvals * beta, 0.0))
            return float(np.sum(w * acc)) - self.target_rate

        if rate_minus_target(0.0) > 0:
            return 1.0
        if rate_minus_target(min_b) < 0:
            logger.info("AcceptanceRateScheme: numerics limit temperature")
            return float(1.0 / np.exp(min_b))
        b_opt = optimize.bisect(rate_minus_target, min_b, 0.0,
                                maxiter=100000)
        return float(1.0 / np.exp(b_opt))


class ExpDecayFixedIterScheme(TemperatureScheme):
    """Geometric decay to T = 1 over the remaining generations:
    ``T_t = T_prev^((n_to_go − 1)/n_to_go)``."""

    def __call__(self, t, max_nr_populations=None, prev_temperature=None,
                 **kwargs):
        if prev_temperature is None or max_nr_populations is None:
            return None
        if not np.isfinite(max_nr_populations):
            return None
        t_to_go = max(max_nr_populations - 1 - t + 1, 1)
        return float(prev_temperature ** ((t_to_go - 1) / t_to_go))


class ExpDecayFixedRatioScheme(TemperatureScheme):
    """``T_t = alpha · T_prev``, at least 1; the decay slows below
    ``min_rate`` acceptance and speeds up above ``max_rate``."""

    def __init__(self, alpha: float = 0.5, min_rate: float = 1e-4,
                 max_rate: float = 0.5):
        self.alpha = float(alpha)
        self.min_rate = min_rate
        self.max_rate = max_rate
        self.alphas: dict = {}

    def __call__(self, t, prev_temperature=None, acceptance_rate=None,
                 **kwargs):
        if prev_temperature is None:
            return None
        alpha = self.alphas.get(t - 1, self.alpha)
        if acceptance_rate is not None:
            if acceptance_rate < self.min_rate:
                alpha = min(np.sqrt(alpha), 0.95)
            elif acceptance_rate > self.max_rate:
                alpha = max(alpha ** 2, 1e-3)
        self.alphas[t] = alpha
        return float(max(alpha * prev_temperature, 1.0))


class PolynomialDecayFixedIterScheme(TemperatureScheme):
    """Polynomial decay to 1 over the remaining generations:
    ``T = 1 + (T_prev − 1)·x^exponent``, ``x = (n_to_go − 1)/n_to_go``."""

    def __init__(self, exponent: float = 3.0):
        self.exponent = float(exponent)

    def __call__(self, t, max_nr_populations=None, prev_temperature=None,
                 **kwargs):
        if prev_temperature is None or max_nr_populations is None:
            return None
        if not np.isfinite(max_nr_populations):
            return None
        t_to_go = max(max_nr_populations - 1 - t + 1, 1)
        x = (t_to_go - 1) / t_to_go
        return float(1.0 + (prev_temperature - 1.0) * x ** self.exponent)


class DalyScheme(TemperatureScheme):
    """Daly et al. 2017: a step k_t that shrinks with the temperature and
    halves (by ``alpha``) when the acceptance rate drops below
    ``min_rate``."""

    def __init__(self, alpha: float = 0.5, min_rate: float = 1e-4):
        self.alpha = float(alpha)
        self.min_rate = float(min_rate)
        self.k: dict = {}

    def __call__(self, t, prev_temperature=None, acceptance_rate=None,
                 **kwargs):
        if prev_temperature is None:
            return None
        beta = 1.0 / prev_temperature
        k_prev = self.k.get(t - 1, prev_temperature)
        if acceptance_rate is not None and acceptance_rate < self.min_rate:
            k = self.alpha * k_prev
        else:
            k = k_prev
        if beta < 1:
            k = min(k, self.alpha * (1.0 / beta - 1.0) + 1e-12)
        self.k[t] = k
        return float(max(prev_temperature - k, 1.0))


class FrielPettittScheme(TemperatureScheme):
    """Power-posterior schedule ``β_t = ((t + 1)/n)²``."""

    def __call__(self, t, max_nr_populations=None, prev_temperature=None,
                 **kwargs):
        if max_nr_populations is None or not np.isfinite(max_nr_populations):
            return None
        beta = ((t + 1) / max_nr_populations) ** 2
        return float(1.0 / max(beta, 1e-8))


class EssScheme(TemperatureScheme):
    """β in [β_prev, 1] at which the ESS of ``w_i · exp(Δβ · log
    density_i)`` over the last population meets ``target_relative_ess ·
    N``."""

    requires_all_records = False

    def __init__(self, target_relative_ess: float = 0.8):
        self.target_relative_ess = float(target_relative_ess)

    def __call__(self, t, get_weighted_distances=None, pdf_norm=0.0,
                 kernel_scale=SCALE_LOG, prev_temperature=None, **kwargs):
        if get_weighted_distances is None:
            return None
        from scipy import optimize

        values, weights = get_weighted_distances()
        logdens = np.asarray(values, dtype=np.float64)
        if kernel_scale == SCALE_LIN:
            with np.errstate(divide="ignore"):
                logdens = np.log(np.maximum(logdens, 1e-290))
        w = np.asarray(weights, dtype=np.float64)
        w = w / w.sum()
        beta_prev = (0.0 if prev_temperature is None
                     else 1.0 / prev_temperature)
        target = self.target_relative_ess * len(w)

        def ess(beta):
            lw = np.log(np.maximum(w, 1e-290)) + (beta - beta_prev) * logdens
            lw -= lw.max()
            ww = np.exp(lw)
            return np.sum(ww) ** 2 / np.sum(ww ** 2)

        if ess(1.0) >= target:
            return 1.0
        sol = optimize.bisect(lambda b: ess(b) - target, beta_prev + 1e-8,
                              1.0, xtol=1e-6, maxiter=100)
        return float(1.0 / max(sol, 1e-8))
