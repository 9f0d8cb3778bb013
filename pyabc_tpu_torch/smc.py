"""ABCSMC orchestrator: the sequential generation loop.

Port of the sequential path of ``pyabc_tpu/smc.py``: ``new`` / ``load``,
calibration, the per-generation transition fit with power-of-two padding
buckets, the classic ``while t < t_max`` loop of ``_run_master`` with the
same stop-reason strings, and ``_prepare_next_iteration``.  The control
plane (fits, epsilon, model probabilities, History) is host numpy, as in
the JAX package; the candidate rounds and the KDE run on the run's device
with one ``torch.Generator`` seeded from ``seed``.

An adaptive distance (``AdaptivePNormDistance``) requests the record
stream at the start of every ``run``; each generation it refits its
weights over the previous generation's records (rejected candidates
included) on the device, and the population's distances are re-evaluated
under the new weights before the acceptor and epsilon see them — at
calibration, at every generation and on resume.

The stochastic triple (``StochasticAcceptor``, a ``TemperatureBase``
epsilon and a ``StochasticKernel``) runs exact Bayesian ABC: a
``Temperature`` reads the record stream with its proposal densities (the
calibration sample with density ratio 1, then each generation's records
under the newly fitted proposal, on the device), the acceptor's pdf norm
follows the population, and the run stops once the temperature reaches 1.

Not ported yet (ROADMAP): the fused, one-dispatch, pipelined and
lazy-History engines — the JAX package takes the pipelined and lazy
branches at pop 1e6 by default, this port always runs the classic loop —
and the multi-fidelity components.
"""

from __future__ import annotations

import functools
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .acceptor import Acceptor, StochasticAcceptor, UniformAcceptor
from .convert import to_numpy, to_torch
from .device import make_generator, resolve_device
from .distance import Distance, PNormDistance, StochasticKernel
from .epsilon import Epsilon, MedianEpsilon, TemperatureBase
from .model import Model, SimpleModel
from .ops.kde_cuda import weighted_kde_logpdf_cuda
from .population import Population
from .populationstrategy import ConstantPopulationSize, PopulationStrategy
from .random_variables import Distribution, ModelPerturbationKernel
from .sampler.base import Sampler
from .sampler.rounds import RoundKernel
from .sampler.vectorized import VectorizedSampler, _pow2_at_least
from .storage.history import PRE_TIME, History
from .sumstat import SumStatSpec
from .transition import MultivariateNormalTransition, Transition
from .weighted_statistics import effective_sample_size

logger = logging.getLogger("ABC")

STOP_EPS = "Stopping: minimum epsilon reached"
STOP_SINGLE_MODEL = "Stopping: single model alive"
STOP_ACC_RATE = "Stopping: acceptance rate too low"
STOP_BUDGET = "Stopping: simulation budget exhausted"
STOP_TEMPERATURE = "Stopping: temperature reached 1"


def _pdf_support_rows(params: dict) -> dict:
    """Rows of the KDE support the proposal density runs against: the
    grid-compressed cells when the fit produced them."""
    if "c_support" in params:
        return {"rows": int(params["c_support"].shape[0]),
                "compressed": True}
    return {"rows": int(params["support"].shape[0]), "compressed": False}


class ABCSMC:
    """ABC-SMC with candidate rounds on the device."""

    def __init__(self,
                 models: Union[Model, Callable, Sequence],
                 parameter_priors: Union[Distribution,
                                         Sequence[Distribution]],
                 distance_function: Optional[Distance] = None,
                 population_size: Union[int, PopulationStrategy] = 100,
                 summary_statistics: Optional[Callable] = None,
                 model_prior=None,
                 model_perturbation_kernel:
                 Optional[ModelPerturbationKernel] = None,
                 transitions: Optional[Sequence[Transition]] = None,
                 eps: Optional[Epsilon] = None,
                 acceptor: Optional[Acceptor] = None,
                 sampler: Optional[Sampler] = None,
                 stop_if_only_single_model_alive: bool = False,
                 stores_sum_stats: bool = True,
                 max_nr_recorded_particles: int = 1 << 21,
                 seed: int = 0,
                 device=None):
        if not isinstance(models, (list, tuple)):
            models = [models]
        self.models = [SimpleModel.assert_model(m) for m in models]
        if isinstance(parameter_priors, Distribution):
            parameter_priors = [parameter_priors]
        self.parameter_priors = list(parameter_priors)
        if len(self.models) != len(self.parameter_priors):
            raise ValueError("#models != #parameter_priors")
        self.M = len(self.models)
        self.dim = max(p.dim for p in self.parameter_priors)
        if sampler is not None and device is None:
            self.device = sampler.device
        else:
            self.device = resolve_device(device)
        if sampler is None:
            sampler = VectorizedSampler(device=self.device)
        elif sampler.device != self.device:
            raise ValueError(f"sampler runs on {sampler.device}, the run on "
                             f"{self.device}")
        self.sampler = sampler
        self.distance_function = (distance_function
                                  if distance_function is not None
                                  else PNormDistance(p=2))
        self.summary_statistics = summary_statistics
        if model_prior is None:
            model_prior = np.zeros(self.M)  # uniform logits
        self.model_prior_logits = np.asarray(model_prior, dtype=np.float32)
        self.model_perturbation_kernel = (
            model_perturbation_kernel
            or ModelPerturbationKernel(self.M, probability_to_stay=0.7))
        if transitions is None:
            transitions = [MultivariateNormalTransition()
                           for _ in range(self.M)]
        self.transitions: List[Transition] = list(transitions)
        if isinstance(population_size, int):
            population_size = ConstantPopulationSize(population_size)
        self.population_strategy = population_size
        self.eps = eps if eps is not None else MedianEpsilon()
        self.acceptor = acceptor if acceptor is not None else UniformAcceptor()
        self.stop_if_only_single_model_alive = stop_if_only_single_model_alive
        self._sanity_check()
        self.stores_sum_stats = bool(stores_sum_stats)
        #: per-generation cap on recorded candidates (the sampler's
        #: max_records when a component requests records)
        self.max_nr_recorded_particles = int(max_nr_recorded_particles)
        #: the run's one random stream, on the run's device
        self.generator = make_generator(self.device, seed)
        #: per-generation rows: t, wall_s (append to append), sample_s,
        #: eps, n, evaluations, acceptance_rate, ess, batch, kde_launches
        #: (KDE kernel launches in the generation), kde_support (per
        #: model: pdf support rows, grid-compressed or not), records
        #: (candidates recorded), record_batches (sampler calls that kept
        #: records: each evaluates the proposal density over its records
        #: when a temperature reads them), refit_s (seconds of the
        #: distance fit whose params the generation used), peak_mem_gb
        #: (peak device memory allocated in the generation, on the card;
        #: None on the CPU)
        self.timeline: List[dict] = []
        self._refit_s = 0.0
        self.stop_reason: Optional[str] = None

        self.history: Optional[History] = None
        self.x_0: Optional[Dict] = None
        self.spec: Optional[SumStatSpec] = None
        self._obs_flat: Optional[torch.Tensor] = None
        self._kernel: Optional[RoundKernel] = None
        self._trans_params: Optional[tuple] = None
        self._pad_buckets: Dict[int, int] = {}
        self.max_nr_populations = np.inf

    def _sanity_check(self):
        """The stochastic triple goes together or not at all."""
        stoch = [isinstance(self.acceptor, StochasticAcceptor),
                 isinstance(self.eps, TemperatureBase),
                 isinstance(self.distance_function, StochasticKernel)]
        if any(stoch) and not all(stoch):
            raise ValueError(
                "StochasticAcceptor, Temperature and a StochasticKernel "
                "must be used together")

    # ---- run registration / resume ------------------------------------

    @staticmethod
    def _coerce_stats(observed: Dict) -> Dict:
        """Observed values as float32 numpy (history stores the raw
        object; compute uses this view)."""
        out = {}
        for k, v in observed.items():
            if torch.is_tensor(v):
                v = v.detach().cpu().numpy()
            out[k] = np.asarray(v, dtype=np.float32)
        return out

    def new(self, db: str, observed_sum_stat: Dict,
            gt_model: Optional[int] = None, gt_par: Optional[dict] = None,
            meta_info: Optional[dict] = None) -> History:
        if self.summary_statistics is not None:
            observed_sum_stat = self.summary_statistics(observed_sum_stat)
        self.x_0 = self._coerce_stats(observed_sum_stat)
        self.history = History(db, stores_sum_stats=self.stores_sum_stats)
        self.history.store_initial_data(
            gt_model, meta_info or {}, observed_sum_stat, gt_par,
            [m.name for m in self.models],
            self.distance_function.to_json(), self.eps.to_json(),
            self.population_strategy.to_json())
        self._bind()
        return self.history

    def load(self, db: str, abc_id: int = 1) -> History:
        """Resume a stored run: the loop continues at ``max_t + 1``."""
        self.history = History(db, abc_id=abc_id,
                               stores_sum_stats=self.stores_sum_stats)
        self.x_0 = self._coerce_stats(self.history.observed_sum_stat())
        self._bind()
        return self.history

    def _bind(self):
        self.spec = SumStatSpec.from_example(self.x_0)
        self._obs_flat = self.spec.flatten_single(self.x_0,
                                                  device=self.device)
        self.distance_function.bind(self.spec, self.x_0)
        self._kernel = RoundKernel(
            models=self.models,
            parameter_priors=self.parameter_priors,
            model_prior_logits=self.model_prior_logits,
            model_perturbation_kernel=self.model_perturbation_kernel,
            transitions=self.transitions,
            distance=self.distance_function,
            acceptor=self.acceptor,
            spec=self.spec,
            obs_flat=self._obs_flat,
            dim=self.dim)

    # ---- transition fitting with padding buckets ----------------------

    def _dummy_trans_params(self, m: int, n_pad: int) -> dict:
        tr = self.transitions[m]
        tr.fit(np.zeros((1, self.parameter_priors[m].dim), np.float32),
               np.ones((1,), np.float32))
        return tr.pad_params(tr.get_params(), n_pad)

    def _pad_bucket(self, m: int, count: int, n_pad: int) -> int:
        """Per-model power-of-two support bucket with hysteresis: a bucket
        only shrinks when the count falls below a quarter of it."""
        need = min(max(_pow2_at_least(count), 256), n_pad)
        prev = self._pad_buckets.get(m)
        if prev is not None and prev <= n_pad and count <= prev \
                and count > prev // 4:
            return prev
        self._pad_buckets[m] = need
        return need

    def _fit_transitions(self, t: int, population: Optional[Population]
                         = None):
        """KDE refit from generation ``t - 1``, each model's support padded
        to its bucket with -1e30 log weights (``pad_params``)."""
        if t == 0:
            return
        pop = (population if population is not None
               else self.history.get_population(t - 1))
        n_pad = len(pop)
        m_arr = np.asarray(pop.m)
        params = []
        for m in range(self.M):
            idx = np.nonzero(m_arr == m)[0]
            if idx.size == 0:
                params.append(self._dummy_trans_params(
                    m, self._pad_bucket(m, 1, n_pad)))
                continue
            dim_m = self.parameter_priors[m].dim
            self.transitions[m].fit(pop.theta[idx, :dim_m], pop.weight[idx])
            bucket = self._pad_bucket(m, idx.size, n_pad)
            params.append(self.transitions[m].pad_params(
                self.transitions[m].get_params(), bucket))
        self._trans_params = tuple(params)

    def _model_probabilities(self, t: int) -> np.ndarray:
        probs = np.zeros(self.M)
        for m, p in self.history.get_model_probabilities(t).items():
            probs[int(m)] = float(p)
        return probs

    def _param_names(self) -> list:
        return [list(p.get_parameter_names()) for p in self.parameter_priors]

    def _distance_is_adaptive(self) -> bool:
        """True when the distance may consume candidate stats in
        ``update``: it says so by an ``adaptive`` flag, or it is a class
        from outside this package that overrides ``update``."""
        d = self.distance_function
        if getattr(d, "adaptive", False):
            return True
        upd = type(d).update
        if upd is Distance.update:
            return False
        return not getattr(upd, "__module__",
                           "").startswith("pyabc_tpu_torch.")

    def _distances_under(self, t: int, stats) -> np.ndarray:
        """The distances of ``stats[N, S]`` under the distance's params
        for generation ``t`` (on the run's device; host result)."""
        stats = torch.as_tensor(stats, device=self.device)
        params = to_torch(self.distance_function.get_params(t), self.device)
        return self.distance_function.compute(
            stats, self._obs_flat, params).cpu().numpy().astype(np.float32)

    # ---- calibration and resume ----------------------------------------

    def _calibrate(self, t0: int):
        n = self.population_strategy(t0)
        params = {"distance": self.distance_function.get_params(t0),
                  "acceptor": {}}
        sample = self.sampler.sample_until_n_accepted(
            n, self._kernel.prior_round, self.generator, params,
            all_accepted=True)
        pop = sample.get_accepted_population(n)
        stats_dev = torch.as_tensor(pop.sum_stats["__flat__"],
                                    device=self.device)
        refit_mark = time.perf_counter()
        self.distance_function.initialize(
            t0, lambda: self.spec.unflatten(stats_dev), self.x_0, self.spec)
        self._refit_s = time.perf_counter() - refit_mark
        # the round's distances were provisional (an adaptive distance is
        # calibrated only now): re-evaluate under the initialized distance
        pop = Population(pop.m, pop.theta, pop.weight,
                         self._distances_under(t0, stats_dev), pop.sum_stats)

        def get_weighted_distances():
            return np.asarray(pop.distance), np.asarray(pop.weight)

        self.acceptor.initialize(
            t0, get_weighted_distances, self.distance_function, self.x_0)
        # the calibration round records nothing: a temperature scheme reads
        # the calibration population as records of density ratio 1
        d0 = np.asarray(pop.distance, dtype=np.float64)

        def get_records():
            ones = np.ones(d0.shape[0])
            return {"distance": d0, "transition_pd_prev": ones,
                    "transition_pd": ones,
                    "accepted": np.ones(d0.shape[0], dtype=bool)}

        self.eps.initialize(t0, get_weighted_distances, get_records,
                            self.max_nr_populations,
                            self.acceptor.get_epsilon_config(t0))
        self.history.append_population(
            PRE_TIME, np.inf, pop, sample.nr_evaluations,
            [m.name for m in self.models], self._param_names(),
            stat_spec=self.spec.shapes)
        logger.info("Calibration sample t=-1 done (n=%d)", n)

    def _initialize_from_history(self, t0: int):
        """Resume: re-initialize the adaptive components from the last
        stored generation."""
        pop = self.history.get_population(t0 - 1)

        def get_weighted_distances():
            return (np.asarray(pop.distance),
                    np.asarray(pop.normalized_weights()))

        get_stats = None
        if "__flat__" in pop.sum_stats:
            flat = torch.as_tensor(pop.sum_stats["__flat__"],
                                   device=self.device)
            get_stats = lambda: self.spec.unflatten(flat)  # noqa: E731
        refit_mark = time.perf_counter()
        self.distance_function.initialize(t0, get_stats, self.x_0, self.spec)
        self._refit_s = time.perf_counter() - refit_mark
        if get_stats is not None:
            # as at calibration and every generation: the acceptor and
            # epsilon see the distances under the (re)fitted weights
            pop = Population(pop.m, pop.theta, pop.weight,
                             self._distances_under(t0, flat), pop.sum_stats)
        self.acceptor.initialize(
            t0, get_weighted_distances, self.distance_function, self.x_0)
        # a temperature continues from the stored one (the populations'
        # epsilon column), not from T = inf
        pops = self.history.get_all_populations()
        row = pops[pops.t == t0 - 1]
        if len(row) and hasattr(self.eps, "temperatures"):
            self.eps.temperatures[t0 - 1] = float(row.epsilon.iloc[0])
        self.eps.initialize(t0, get_weighted_distances, lambda: [],
                            self.max_nr_populations,
                            self.acceptor.get_epsilon_config(t0))

    # ---- the master loop -------------------------------------------------

    def run(self, minimum_epsilon: float = 0.0,
            max_nr_populations: Union[int, float] = np.inf,
            min_acceptance_rate: float = 0.0,
            max_total_nr_simulations: Union[int, float] = np.inf
            ) -> History:
        if self.history is None:
            raise RuntimeError("call new(db, observed) or load(db) first")
        self.max_nr_populations = max_nr_populations
        self.stop_reason = None

        t0 = self.history.max_t + 1
        self._fit_transitions(t0)
        if t0 == 0:
            self._calibrate(t0)
        else:
            self._initialize_from_history(t0)
        # fresh feature requests each run: a previous run's components
        # must not leave stale record flags on a reused sampler
        self.sampler.record_rejected = False
        self.sampler.record_proposal_density = False
        self.distance_function.configure_sampler(self.sampler)
        self.eps.configure_sampler(self.sampler)
        self.sampler.max_records = self.max_nr_recorded_particles
        # the accepted stats go to the host only for a reader there: the
        # History blob, or an adaptive refit that has no record stream
        records_cover_refit = (self.sampler.record_rejected
                               and self.max_nr_recorded_particles > 0)
        self.sampler.fetch_stats = (
            self.stores_sum_stats
            or (self._distance_is_adaptive() and not records_cover_refit))

        t = t0
        t_max = (t0 + max_nr_populations
                 if np.isfinite(max_nr_populations) else np.inf)
        total_sims = 0
        gen_mark = time.perf_counter()
        launches_mark = weighted_kde_logpdf_cuda.launches
        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats(self.device)
        model_names = [m.name for m in self.models]
        while t < t_max:
            current_eps = float(self.eps(t))
            n = self.population_strategy(t)
            max_eval = (n / min_acceptance_rate
                        if min_acceptance_rate > 0 else np.inf)
            params = {"distance": self.distance_function.get_params(t),
                      "acceptor": self.acceptor.get_params(t, self.eps)}
            if t == 0:
                round_fn = self._kernel.prior_round
            else:
                round_fn = self._kernel.generation_round
                probs = self._model_probabilities(t - 1)
                with np.errstate(divide="ignore"):
                    params["model_log_probs"] = np.log(
                        np.maximum(probs, 1e-300)).astype(np.float32)
                params["transition"] = self._trans_params
            logger.info("t: %d, eps: %.8g", t, current_eps)
            sample_mark = time.perf_counter()
            sample = self.sampler.sample_until_n_accepted(
                n, round_fn, self.generator, params, max_eval=max_eval)
            sample_s = time.perf_counter() - sample_mark
            if sample.n_accepted < n:
                self.stop_reason = (
                    "Stopping: acceptance rate fell below "
                    "min_acceptance_rate (%d/%d accepted)"
                    % (sample.n_accepted, n))
                logger.info(self.stop_reason)
                break
            population = sample.get_accepted_population(n)
            total_sims += sample.nr_evaluations
            acceptance_rate = sample.acceptance_rate
            self.history.append_population(
                t, current_eps, population, sample.nr_evaluations,
                model_names, self._param_names(), stat_spec=self.spec.shapes)
            ess = float(effective_sample_size(population.weight))
            now = time.perf_counter()
            self.timeline.append({
                "t": t, "wall_s": now - gen_mark, "sample_s": sample_s,
                "eps": current_eps, "n": n,
                "evaluations": sample.nr_evaluations,
                "acceptance_rate": acceptance_rate, "ess": ess,
                "batch": getattr(self.sampler, "last_batch", None),
                "kde_launches": (weighted_kde_logpdf_cuda.launches
                                 - launches_mark),
                "kde_support": ([_pdf_support_rows(p)
                                 for p in params["transition"]]
                                if t > 0 else []),
                "records": sample.n_recorded,
                "record_batches": sample.n_record_batches,
                "refit_s": self._refit_s,
                "peak_mem_gb": (torch.cuda.max_memory_allocated(self.device)
                                / 1e9 if on_card else None)})
            gen_mark = now
            launches_mark = weighted_kde_logpdf_cuda.launches
            if on_card:
                torch.cuda.reset_peak_memory_stats(self.device)
            logger.info("t: %d, acceptance rate: %.4g, ESS: %.4g, evals: %d",
                        t, acceptance_rate, ess, sample.nr_evaluations)

            # ---- stopping criteria (same strings as the JAX package) ----
            temperature = isinstance(self.eps, TemperatureBase)
            if not temperature and current_eps <= minimum_epsilon:
                self.stop_reason = STOP_EPS
            elif temperature and current_eps <= 1.0:
                self.stop_reason = STOP_TEMPERATURE
            elif (self.stop_if_only_single_model_alive
                  and population.nr_of_models_alive() <= 1 and self.M > 1):
                self.stop_reason = STOP_SINGLE_MODEL
            elif acceptance_rate < min_acceptance_rate:
                self.stop_reason = STOP_ACC_RATE
            elif total_sims >= max_total_nr_simulations:
                self.stop_reason = STOP_BUDGET
            if self.stop_reason is not None:
                logger.info(self.stop_reason)
                break
            if t + 1 >= t_max:
                break
            self._prepare_next_iteration(t + 1, sample, population,
                                         acceptance_rate)
            t += 1
        self.history.done()
        return self.history

    def _prepare_next_iteration(self, t: int, sample, population: Population,
                                acceptance_rate: float):
        """Refit the transitions and the distance, and advance acceptor
        and epsilon, from generation ``t - 1``.  When the distance's params
        change, the population's distances are re-evaluated under them —
        from the accepted stats still on the device — before the acceptor
        and epsilon see them."""
        self._fit_transitions(t, population=population)

        def get_all_stats():
            flat = sample.get_all_stats()
            if (flat.ndim != 2 or flat.shape[0] == 0
                    or flat.shape[-1] != self.spec.total_size):
                flat = np.zeros((0, self.spec.total_size), np.float32)
            return self.spec.unflatten(flat)

        refit_mark = time.perf_counter()
        changed = self.distance_function.update(t, get_all_stats)
        self._refit_s = time.perf_counter() - refit_mark
        if changed:
            dev = sample.device_population
            if dev is not None:
                stats = dev["stats"][:len(population)]
            else:
                stats = population.sum_stats.get("__flat__")
            if stats is not None:
                population = Population(
                    population.m, population.theta, population.weight,
                    self._distances_under(t, stats), population.sum_stats)
            else:
                logger.debug("distance changed at t=%d but the population "
                             "has no stats; keeping stored distances", t)

        def get_weighted_distances():
            return (np.asarray(population.distance),
                    np.asarray(population.normalized_weights()))

        prev_temp = (float(self.eps(t - 1))
                     if isinstance(self.eps, TemperatureBase) else None)
        self.acceptor.update(t, get_weighted_distances, prev_temp,
                             acceptance_rate)
        # the records carry their generating proposal's density; the new
        # proposal's, at the same records, gives the temperature schemes
        # their importance ratios (evaluated only when a scheme reads them)
        params = functools.cache(lambda: self._proposal_params(
            self._model_probabilities(t - 1)))
        sample.transition_log_pdf = (
            lambda m, theta: self._proposal_log_pdf(params(), m, theta))
        sample.transition_log_pdf_device = (
            lambda m, theta: self._kernel.proposal_log_density(
                m, theta, params()))
        self.eps.update(t, get_weighted_distances,
                        sample.get_records_columns, acceptance_rate,
                        self.acceptor.get_epsilon_config(t))

    def _proposal_params(self, probs: np.ndarray) -> dict:
        """The fitted proposal's params on the run's device: model
        probabilities and transitions."""
        with np.errstate(divide="ignore"):
            log_probs = np.log(np.maximum(probs, 1e-300)).astype(np.float32)
        return to_torch({"model_log_probs": log_probs,
                         "transition": self._trans_params}, self.device)

    def _proposal_log_pdf(self, params: dict, m, theta) -> np.ndarray:
        """Host arrays in and out: ``log[Σ_s p_s·jump_pmf(s→m)] + log
        q_m(θ)`` under ``params``, evaluated on the run's device."""
        m = torch.as_tensor(np.asarray(m), dtype=torch.int64,
                            device=self.device)
        theta = torch.as_tensor(np.asarray(theta, dtype=np.float32),
                                device=self.device)
        return to_numpy(self._kernel.proposal_log_density(m, theta, params))
