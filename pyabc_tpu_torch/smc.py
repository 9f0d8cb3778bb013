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

With ``fuse_generations=K`` (K >= 2) and a configuration whose whole
adaptation chain has a device form (``_fused_eligible``), the loop runs
K generations at a time as a fused block (:mod:`.sampler.fused`) from
the previous generation's population, which stays on the device: no
host adaptation and no population copy between the block's generations.
Each generation is copied to the host and appended to History after the
block.  The first generation, the tail that no longer holds a whole
block, and any generation a block fell short of run sequentially.  Above
``PROBE_MIN_POP`` the first block's seconds per generation are weighed
against the sequential ones and the slower engine is retired for the run.

With ``run_mode="onedispatch"`` as well (``_onedispatch_eligible``: the
epsilon's stop test must have a device form, ``device_stop_ok``), the
rest of the run after the first generation goes down as one dispatch
(:func:`.sampler.fused.build_onedispatch_run`): the same per-generation
body with the stop chain evaluated on the device after each generation,
the host reading one packed control tensor per generation.  A dispatch
covers at most ``onedispatch_max_t`` generations; a longer run dispatches
again from the carried population.  A generation that falls short of
the population is redone sequentially, as after a fused block.

The device-to-host wire (:mod:`.wire`) runs under every engine: each
generation's population leaves the card through one chokepoint
(``sampler.base.fetch_to_host``) booked to the transfer ledger, and a
fused block or one-dispatch run streams its generations' fetches on a
:class:`~.wire.StreamingIngest` worker (``ingest_depth``) while the
caller appends the previous one.  The ledger's ``compute_s`` and
``overlap_s`` feed the batch autotuner's margin, per generation, as in
the JAX package.

``ingest_mode="auto"`` (the default) runs a device-eligible configuration
at pop >= ``OVERLAP_MIN_POP`` = 2^17 through :meth:`ABCSMC._run_pipelined`:
device blocks are dispatched ahead of the ingest frontier while a worker
fetches the blocks before them, History appends and stop criteria run on
the caller thread in generation order, and blocks dispatched past a stop
or an undershoot are abandoned (``rewinds``).  ``"sequential"`` keeps the
classic loop, ``"overlap"`` pipelines any eligible configuration.

``history_mode="lazy"`` (the default, or ``$PYABC_TPU_HISTORY_MODE``)
keeps each device engine's generations in a
:class:`~.wire.store.DeviceRunStore` on the card and appends a summary
row; History hydrates a population when it is read, and ``done()``
writes every resident one, so the database holds the eager bits.
``"eager"`` fetches and writes every population as it comes.

``fidelity="screen"`` (or a :class:`~.fidelity.FidelityConfig`) runs the
device engines' rounds as the multi-fidelity cascade when the
configuration is screen-eligible (``_fidelity_eligible``): each round
simulates every candidate's cheap surrogate, screens it against a
threshold calibrated on the card from the previous generation's paired
distances, and simulates only the survivors at full fidelity.  An
ineligible configuration runs the exact unscreened engine.

Before a device engine runs, the capacity model (:mod:`.capacity`) plans
its memory against ``$PYABC_TPU_HBM_BUDGET`` (or the card's memory less
``$PYABC_TPU_HBM_HEADROOM``): it may narrow the at-rest carry
(``$PYABC_TPU_CARRY_PRECISION=auto``, :mod:`.ops.precision`), shrink the
batch, K or the dispatch's generations, or raise a
:class:`~.capacity.CapacityError` with its ledger; the plan is
``timeline.capacity``.  ``$PYABC_TPU_JOINT_AUTOTUNE=1`` chooses each
fused block's (K, round cap, batch) jointly (:mod:`.autotune.occupancy`).

Run infrastructure (:mod:`.telemetry`, :mod:`.resilience`): ``run()``
is one ``run`` span with the JAX package's spans inside it (tracing on
with ``trace_path=`` or ``$PYABC_TPU_TRACE``), each generation is a row
of :class:`~.telemetry.GenerationTimeline` and a
``metrics.record_generation`` call, the fused and one-dispatch engines
carry ``tl_*`` telemetry lanes (``$PYABC_TPU_TELEMETRY_LANES``, default
on) whose work units attribute each row's wall to phases, and a crash
dumps the flight recorder and anchors the lazy tail.  Every dispatch runs
under a retry policy with the run's generator put back before a retry
(the same draws); a retry-exhausted dispatch degrades as in the JAX
package: the sequential engine halves the batch ceiling
(``degrade_rung``) and restarts the generation, a fused or one-dispatch
engine latches itself off for the run, and the pipelined engine falls
back to the sequential loop.  ``checkpoint_every_rounds`` (or
``$PYABC_TPU_CKPT_ROUNDS``) flushes a sequential generation's accepted
rows to History at that cadence and on SIGTERM, and a resumed run splices
them back.  A lazy History write-aheads a spill journal that ``load``
replays after a kill.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import math
import os
import time
import traceback
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .acceptor import Acceptor, StochasticAcceptor, UniformAcceptor
from .autotune import compile_counters, compile_delta
from .autotune import configure_compile_cache
from .autotune import occupancy as _occupancy
from .capacity import model as _capacity
from .convert import to_numpy, to_torch
from .device import make_generator, resolve_device
from .distance import Distance, PNormDistance, StochasticKernel
from .distance.kernel import SCALE_LIN
from .epsilon import (ConstantEpsilon, Epsilon, MedianEpsilon,
                      TemperatureBase)
from .fidelity import FidelityConfig
from .model import Model, SimpleModel
from .ops import precision as _precision
from .ops.kde_cuda import weighted_kde_logpdf_cuda
from .parallel.health import stop_requested
from .parallel.mesh import deterministic_kernels, world_size
from .platform_factory import DefaultSampler
from .population import Population
from .populationstrategy import ConstantPopulationSize, PopulationStrategy
from .random_variables import Distribution, ModelPerturbationKernel
from .resilience import checkpoint as _ckpt
from .resilience import faults as _faults
from .resilience import retry as _retry
from .resilience.journal import IntegrityError
from .sampler import fused as _fused
from .sampler.base import Sample, Sampler, fetch_to_host
from .sampler.rounds import RoundKernel
from .sampler.sharded import ShardedSampler
from .sampler.vectorized import VectorizedSampler, _pow2_at_least
from .storage.history import PRE_TIME, History
from .sumstat import SumStatSpec
from .telemetry import aggregate as _aggregate
from .telemetry import flight as _flight
from .telemetry import lanes as _lanes
from .telemetry import metrics as _metrics
from .telemetry import profile_generation
from .telemetry import spans as _spans
from .telemetry.timeline import GenerationTimeline
from .transition import MultivariateNormalTransition, Transition
from .transition.multivariatenormal import _COMPRESS_MIN_N
from .weighted_statistics import effective_sample_size
from .wire import StreamingIngest, transfer
from .wire import store as _wire_store
from .wire.ingest import (SCALAR_KEYS, GenStream, batch_to_population,
                          split_single_wire)

logger = logging.getLogger("ABC")

#: what a population-size adaptation may fail with and still leave the
#: run going (the size is kept); anything else, a device fault included,
#: propagates
_ADAPTATION_FAILURES = (ValueError, ArithmeticError, np.linalg.LinAlgError,
                        torch.linalg.LinAlgError)

#: with "1", a one-dispatch call on the card measures its peak device
#: memory (``timeline.capacity["measured_bytes"]``: the allocator's peak
#: and the CUDA-graph pool's free blocks), as it does under an
#: explicit ``PYABC_TPU_HBM_BUDGET``; the auto-detected budget alone
#: measures nothing
CAPACITY_MEASURE_ENV = "PYABC_TPU_CAPACITY_MEASURE"
#: the engine and the one-dispatch window when the constructor leaves
#: ``run_mode`` / ``onedispatch_max_t`` at None, as in the JAX package
RUN_MODE_ENV = "PYABC_TPU_RUN_MODE"
ONEDISPATCH_MAX_T_ENV = "PYABC_TPU_ONEDISPATCH_MAX_T"

STOP_EPS = "Stopping: minimum epsilon reached"
STOP_SINGLE_MODEL = "Stopping: single model alive"
STOP_ACC_RATE = "Stopping: acceptance rate too low"
STOP_BUDGET = "Stopping: simulation budget exhausted"
STOP_TEMPERATURE = "Stopping: temperature reached 1"
#: the fused engine's stop codes -> the sequential loop's strings
STOP_REASONS = {_fused.STOP_EPS: STOP_EPS,
                _fused.STOP_TEMPERATURE: STOP_TEMPERATURE,
                _fused.STOP_SINGLE_MODEL: STOP_SINGLE_MODEL,
                _fused.STOP_ACC_RATE: STOP_ACC_RATE,
                _fused.STOP_BUDGET: STOP_BUDGET}


#: the round clock's keys in a device engine's per-generation info
_CLOCK_KEYS = ("count_wait_s", "round_host_s", "loop_s", "phase_device_s",
               "phase_rounds", "finalize_device_s")


def _pdf_support_rows(params: dict) -> dict:
    """Rows of the KDE support the proposal density runs against: the
    grid-compressed cells when the fit produced them; an aggregated
    transition's params give ``{"blocks": [...]}``, one entry per block."""
    if params and all(isinstance(v, dict) for v in params.values()):
        return {"blocks": [_pdf_support_rows(v) for v in params.values()]}
    if "c_support" in params:
        return {"rows": int(params["c_support"].shape[0]),
                "compressed": True}
    return {"rows": int(params["support"].shape[0]), "compressed": False}


def _obs_equal(a: Optional[Dict], b: Optional[Dict]) -> bool:
    """Bit-exact equality of two coerced observed-stat dicts: the gate of
    :meth:`ABCSMC.renew` (the round kernel holds the observed stats)."""
    if a is None or b is None or set(a) != set(b):
        return False
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
               for k in a)


def _clear_failed_frames(err: BaseException) -> None:
    """Drop the locals of the finished frames of ``err``'s traceback and
    of the errors it chains."""
    seen = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        if err.__traceback__ is not None:
            traceback.clear_frames(err.__traceback__)
        err = err.__cause__ or err.__context__


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
                 fuse_generations: int = 1,
                 fused_support_cap: Optional[int] = 1 << 14,
                 run_mode: Optional[str] = None,
                 onedispatch_max_t: Optional[int] = None,
                 ingest_mode: str = "auto",
                 ingest_depth: int = 2,
                 history_mode: Optional[str] = None,
                 fidelity=None,
                 checkpoint_every_rounds: Optional[int] = None,
                 trace_path: Optional[str] = None,
                 show_progress: bool = False,
                 compile_cache: Optional[str] = None,
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
            sampler = DefaultSampler(device=self.device)
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
        if not isinstance(transitions, (list, tuple)):
            transitions = [transitions]
        self.transitions: List[Transition] = list(transitions)
        if isinstance(population_size, int):
            population_size = ConstantPopulationSize(population_size)
        self.population_strategy = population_size
        # components that compute on a device of their own (the adaptive
        # size's bootstrap, LocalTransition's fit) default to the run's
        for comp in [population_size, *self.transitions]:
            if getattr(comp, "device", False) is None:
                comp.device = self.device
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
        #: run up to this many generations as one fused block when the
        #: configuration's adaptation chain has a device form
        #: (``_fused_eligible``); 1 = always sequential
        self.fuse_generations = int(fuse_generations)
        #: above this many particles a fused block resamples each model's
        #: population to this many uniform-weight support rows before the
        #: KDE refit (systematic inverse CDF); None refits on every row
        self.fused_support_cap = fused_support_cap
        if run_mode is None:
            run_mode = os.environ.get(RUN_MODE_ENV, "auto")
        if run_mode not in ("auto", "classic", "onedispatch"):
            raise ValueError("run_mode must be 'auto', 'classic' or "
                             f"'onedispatch' (got {run_mode!r})")
        #: "onedispatch" runs the rest of a run as one dispatch with the
        #: stop chain on the device (``_onedispatch_eligible``); "auto"
        #: behaves as "classic" (fused blocks with host stop checks).
        #: None defers to ``$PYABC_TPU_RUN_MODE`` (default "auto")
        self.run_mode = run_mode
        #: generations one dispatch may write; a longer run dispatches
        #: again from the carried population.  None defers to
        #: ``$PYABC_TPU_ONEDISPATCH_MAX_T`` (default 32)
        if onedispatch_max_t is None:
            onedispatch_max_t = os.environ.get(ONEDISPATCH_MAX_T_ENV, "32")
        self.onedispatch_max_t = max(1, int(onedispatch_max_t))
        if ingest_mode not in ("auto", "overlap", "sequential"):
            raise ValueError("ingest_mode must be 'auto', 'overlap' or "
                             f"'sequential' (got {ingest_mode!r})")
        #: "overlap" runs an eligible configuration through the pipelined
        #: engine, "auto" does so from OVERLAP_MIN_POP, "sequential" never
        self.ingest_mode = ingest_mode
        #: blocks in flight in the pipelined engine, and tickets in
        #: flight on every streaming-ingest engine; 0 runs the same calls
        #: inline on the caller thread
        self.ingest_depth = int(ingest_depth)
        if history_mode is None:
            history_mode = os.environ.get(_wire_store.HISTORY_MODE_ENV,
                                          "lazy")
        if history_mode not in ("lazy", "eager"):
            raise ValueError("history_mode must be 'lazy' or 'eager' "
                             f"(got {history_mode!r})")
        #: "lazy" keeps device engines' generations in the run's
        #: DeviceRunStore and appends summary rows; "eager" writes every
        #: population as it comes
        self.history_mode = history_mode
        #: the multi-fidelity cascade: None ("off", the default) or the
        #: resolved FidelityConfig, used where ``_fidelity_eligible``;
        #: ``$PYABC_TPU_FIDELITY=off`` turns a request off
        self.fidelity = FidelityConfig.resolve(fidelity)
        #: the carry's at-rest precision ($PYABC_TPU_CARRY_PRECISION):
        #: "auto" is resolved by the first capacity plan and then kept
        cp = _precision.resolve_carry_precision()
        self._carry_mode: Optional[str] = None if cp == "auto" else cp
        self._carry_auto = cp == "auto"
        #: joint (K, max_T, rung) tuning of fused blocks, opt-in
        #: ($PYABC_TPU_JOINT_AUTOTUNE=1): a changed shape draws the run's
        #: generator differently, so the default keeps the static shape
        self._occupancy: Optional[_occupancy.OccupancyTuner] = None
        if os.environ.get(_occupancy.JOINT_AUTOTUNE_ENV,
                          "0") in ("1", "true", "yes"):
            self._occupancy = _occupancy.OccupancyTuner(
                k_max=max(self.fuse_generations, 1))
        self._store: Optional[_wire_store.DeviceRunStore] = None
        #: Chrome-trace JSONL sink of this run's spans (None: the
        #: ``$PYABC_TPU_TRACE`` variable, else tracing off)
        self.trace_path = trace_path
        #: a per-generation progress bar on stderr over the accepted
        #: count, from values the engines already read (the sampler's for
        #: the sequential loop; see :meth:`_progress_generation`)
        self.show_progress = bool(show_progress)
        #: where the kernels' nvcc output persists: this argument, else
        #: ``$PYABC_TPU_COMPILE_CACHE``, else ``build/kernels/``
        #: (``autotune/cache.py``; None: the directory is left as it
        #: is). Process-wide: it repoints ``ops._build.BUILD_DIR`` for
        #: every engine of the process, as the JAX package's setting
        #: repoints JAX's global cache
        self.compile_cache = compile_cache
        self.compile_cache_dir = configure_compile_cache(compile_cache)
        #: ``tl_*`` telemetry lanes (and the progress word) in the fused
        #: and one-dispatch engines ($PYABC_TPU_TELEMETRY_LANES, default
        #: on); the populations are the same bits either way
        self.telemetry_lanes = _lanes.lanes_enabled()
        #: the fleet snapshot publisher ($PYABC_TPU_RUN_DIR), armed by
        #: run(); None costs one attribute check per generation
        self._fleet = None
        #: sub-checkpoint cadence of a sequential generation in device
        #: rounds, checked after each sampler call (0: off; None:
        #: $PYABC_TPU_CKPT_ROUNDS)
        self.checkpoint_every_rounds = (
            _ckpt.default_every_rounds() if checkpoint_every_rounds is None
            else max(int(checkpoint_every_rounds), 0))
        #: the retry policy of the engines' dispatches ($PYABC_TPU_RETRIES,
        #: $PYABC_TPU_RETRY_BASE_S)
        self._retry = _retry.RetryPolicy.from_env()
        #: degradation latches: set after a retry-exhausted fused block,
        #: a failed one-dispatch run or drain, a failed pipelined dispatch
        self._fault_fused_off = False
        self._fault_onedispatch_off = False
        self._fault_sequential_only = False
        #: per-generation transfer-ledger deltas (wire/transfer.py), by t
        self.generation_transfer: Dict[int, dict] = {}
        #: per run(): one-dispatch calls made, and the seconds of their
        #: per-generation control reads (after a device sync)
        self.run_dispatches = 0
        self.control_roundtrip_s = 0.0
        #: the last generation's population on the device: the next
        #: block's starting carry (None: the next generation is
        #: sequential)
        self._fused_carry: Optional[dict] = None
        #: above PROBE_MIN_POP: "fused" or "sequential" once the first
        #: block was timed against ``_seq_probe_s`` (seconds per
        #: sequential generation)
        self._engine_choice: Optional[str] = None
        self._seq_probe_s: Optional[float] = None
        self.minimum_epsilon = 0.0
        self.min_acceptance_rate = 0.0
        #: per-generation rows: t, path ("sequential", "fused",
        #: "onedispatch" or "pipelined"), engine (the probe's choice above
        #: PROBE_MIN_POP, "onedispatch" on a one-dispatch row, else
        #: None), wall_s (append to append; a fused block's wall over
        #: its written generations; in the pipelined engine harvest to
        #: harvest), sample_s (a fused block: its generations' device
        #: loop, before the host copies), eps, n, evaluations,
        #: acceptance_rate, ess, batch, compute_s / d2h_s / overlap_s (its
        #: share of the wire ledger), history_mode ("lazy" when a device
        #: store was attached), kde_launches (KDE kernel launches
        #: in the generation), kde_support (per model: pdf support rows,
        #: grid-compressed or not), cdf_builds (resampling CDFs built for
        #: the generation's proposal draws: M + 1 by the prepare step of
        #: a generation after the first, none in its rounds; 0 at
        #: t = 0), records (candidates recorded),
        #: record_batches (sampler calls that kept records: each
        #: evaluates the proposal density over its records when a
        #: temperature reads them), refit_s (seconds of the distance fit
        #: whose params the generation used), distance_s (sequential
        #: rows of an adaptive distance: seconds of that refit's span
        #: ``distance.refit``, the fit and the population's distances
        #: under it; a device block refits in the block), adapt_s (sequential rows:
        #: host seconds of the population-size adaptation that sized the
        #: generation), peak_mem_gb (peak device
        #: memory allocated in the generation — in a fused block, in the
        #: block; in the pipelined engine, since the previous harvest — on
        #: the card; None on the CPU); fused, pipelined and one-dispatch
        #: rows also carry rounds, host_reads (values the host read in the
        #: generation) and grids_resolved (None without a grid-compressed
        #: support), and screened rows sims_low (low-fidelity simulations:
        #: rounds x B), sims_full (full-fidelity slots: rounds x n_full),
        #: screen_pass (candidates that survived the screen), screen_tau
        #: (the threshold; +inf: no screen), cal_pairs and cal_corr (the
        #: acceptable calibration pairs and the correlation it was set
        #: from), round_cap and max_rounds (the generation's round cap
        #: and its ceiling); rows of a device engine with telemetry lanes
        #: also tl_sims (the lane's simulations, rounds x B) and
        #: ph_<phase>_s (telemetry.lanes.attribute_phases of the row's
        #: wall); rows whose sampler read a round's count carry the
        #: clocks of those reads (telemetry.phases.RoundClock.row:
        #: count_wait_s, round_host_s, loop_s; traced on the card also
        #: phase_device_s, phase_rounds and finalize_device_s); pack_s
        #: (History.pack_s: seconds of the generation's PTW1 pack and
        #: CRC, set at the end of run() once the blobs are written).
        #: ``timeline.to_rows()`` / ``summary()`` read the
        #: JAX package's stage table of the same generations
        self.timeline = GenerationTimeline()
        #: one entry per fused block run: t (its first generation), K,
        #: written (generations kept; fewer than K after an undershoot or
        #: a stop), batch, rounds (of every generation it ran, discarded
        #: ones included), host_reads, kde_launches, wall_s, stop; a
        #: screened block also round_caps (each generation's) and
        #: max_rounds
        self.blocks: List[dict] = []
        self._refit_s = 0.0
        #: the last adaptive refit's row key, ``{"distance_s": seconds}``
        #: (empty: no refit span, a distance that does not adapt)
        self._distance_row: dict = {}
        #: the build counters at the last timeline row (its stage row's
        #: compile_s / n_compiles are the delta since)
        self._compile_mark = compile_counters()
        #: host seconds of the last population-size adaptation
        self._adapt_s = 0.0
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

    def renew(self, db: str, observed_sum_stat: Dict,
              gt_model: Optional[int] = None, gt_par: Optional[dict] = None,
              meta_info: Optional[dict] = None, eps: Optional[Epsilon] = None,
              seed: Optional[int] = None) -> History:
        """Register a new study on a warm binding (``serve/worker.py``).

        ``new()`` always rebinds: a fresh :class:`RoundKernel` (a new
        ``_uid``, which keys every engine in the sampler's ladder), so a
        second study through it builds its engines again.  When the
        incoming observed stats are bit-equal to the bound ``x_0``,
        ``renew`` keeps the kernel and resets only the run-scoped state:
        a fresh History, no carried population, a fresh device store in
        lazy mode, a clean quantile look-up (or ``eps``), the generator
        reseeded from ``seed``, a fresh acceptance tuner (its rate keys
        the first block's round cap), and an empty timeline and block
        list.  Different observed stats fall back to ``new()``."""
        incoming = (observed_sum_stat if self.summary_statistics is None
                    else self.summary_statistics(observed_sum_stat))
        if self._kernel is None or not _obs_equal(
                self._coerce_stats(incoming), self.x_0):
            hist = self.new(db, observed_sum_stat, gt_model=gt_model,
                            gt_par=gt_par, meta_info=meta_info)
        else:
            self.history = History(db, stores_sum_stats=self.stores_sum_stats)
            self.history.store_initial_data(
                gt_model, meta_info or {}, observed_sum_stat, gt_par,
                [m.name for m in self.models],
                self.distance_function.to_json(), self.eps.to_json(),
                self.population_strategy.to_json())
            self._fused_carry = None
            if self.history_mode == "lazy":
                self._store = _wire_store.DeviceRunStore()
                self.history.attach_store(self._store)
            hist = self.history
        if eps is not None:
            self.eps = eps
        elif hasattr(self.eps, "_look_up"):
            # study 1's thresholds must not reach study 2's calibration
            self.eps._look_up = {}
        if seed is not None:
            self.generator = make_generator(self.device, seed)
        if hasattr(self.sampler, "_tuner"):
            self.sampler._tuner = type(self.sampler._tuner)()
        self.timeline = GenerationTimeline()
        self.blocks = []
        self.generation_transfer = {}
        return hist

    def load(self, db: str, abc_id: int = 1) -> History:
        """Resume a stored run: the loop continues at ``max_t + 1``."""
        self.history = History(db, abc_id=abc_id,
                               stores_sum_stats=self.stores_sum_stats)
        self.x_0 = self._coerce_stats(self.history.observed_sum_stat())
        self._bind()
        # replay what a killed lazy run left in its spill journal, then
        # purge the summary rows nothing can hydrate: max_t anchors on
        # the last durable generation
        self.history.recover_lazy()
        return self.history

    def _bind(self):
        # a new or loaded run never starts from another run's population
        self._fused_carry = None
        # lazy History: one device store per bound run; History drains its
        # spill queue on the caller thread, ingest workers deposit
        if self.history_mode == "lazy":
            self._store = _wire_store.DeviceRunStore()
            self.history.attach_store(self._store)
        else:
            self._store = None
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

    @property
    def _lazy_active(self) -> bool:
        """Device engines keep their generations in the store and append
        summary rows."""
        return self._store is not None and self.history is not None

    #: "auto" ingest pipelines from this population up: below it the
    #: fetch is short and the fused engine owns the regime
    OVERLAP_MIN_POP = 1 << 17

    def _overlap_enabled(self) -> bool:
        """Route ``run()`` through :meth:`_run_pipelined`?  Never with
        ``ingest_mode="sequential"`` or a one-dispatch run; with an
        eligible device chain always for "overlap", from
        ``OVERLAP_MIN_POP`` for "auto"."""
        if self._fault_sequential_only:
            return False  # degraded after a pipelined dispatch failure
        if self.run_mode == "onedispatch" or self.ingest_mode == "sequential":
            return False
        if not self._device_chain_eligible():
            if self.ingest_mode == "overlap":
                logger.warning(
                    "ingest_mode='overlap' requested but the component "
                    "chain has no device form; using the sequential loop")
            return False
        return (self.ingest_mode == "overlap"
                or self.population_strategy(0) >= self.OVERLAP_MIN_POP)

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

    def _adapt_population_size(self, t: int):
        """Let the population strategy see the transitions fitted for
        generation ``t`` and the model probabilities of ``t - 1``.  A
        numerical failure of the adaptation (a power law that cannot be
        fitted, a singular covariance) is logged and the size kept; a
        fault of the device or of the KDE kernel (a ``RuntimeError``)
        propagates, so that no launch failure passes as a kept size."""
        self._adapt_s = 0.0
        if t == 0:
            return
        mark = time.perf_counter()
        probs = self._model_probabilities(t - 1)
        alive = [m for m in range(self.M) if probs[m] > 0]
        try:
            self.population_strategy.update(
                [self.transitions[m] for m in alive],
                np.asarray([probs[m] for m in alive]), t=t)
        except _ADAPTATION_FAILURES as e:
            logger.warning("population size adaptation failed: %s", e,
                           exc_info=True)
        self._adapt_s = time.perf_counter() - mark

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

    def _end_distance_refit(self, t: int, mark: float):
        """End the span ``distance.refit`` of an adaptive distance's
        refit for generation ``t``, begun at the ``perf_counter`` reading
        ``mark``: the fit of its params and the population's distances
        under them.  Its seconds become the rows' ``distance_s``.  Tracer
        off it costs one clock reading; a distance that does not adapt
        has no span."""
        if not self._distance_is_adaptive():
            self._distance_row = {}
            return
        end = time.perf_counter()
        self._distance_row = {"distance_s": end - mark}
        if _spans.TRACER.enabled:
            _spans.TRACER.add("distance.refit", mark, end, gen=t)

    # ---- fused multi-generation blocks (sampler/fused.py) ---------------

    #: above this population the fused-vs-sequential choice is probed:
    #: the first block's seconds per generation against the sequential
    #: baseline, the slower engine retired for the run
    PROBE_MIN_POP = 1 << 17
    #: record-ring rows carried through a block for the temperature solve
    _RECORD_ROWS_MAX = 1 << 12

    def _device_chain_eligible(self) -> bool:
        """The whole propose → accept → refit → new-ε chain has a device
        form, decided from the components' own capability flags
        (``device_accept_ok``, ``device_schedule_ok``,
        ``device_refit_ok``, ``device_support_ok``); anything else runs
        sequentially."""
        s = self.sampler
        if not isinstance(s, VectorizedSampler):
            return False
        if isinstance(s, ShardedSampler) and world_size() > 1:
            # pod posture (``pyabc_tpu/smc.py:755-767``): the device
            # engines run across ranks only as one dispatch with the lazy
            # store armed, over a mesh spanning every rank; every other
            # multi-rank run takes the sequential loop
            if self.run_mode != "onedispatch" or self._store is None:
                return False
            if s.mesh.world_size != world_size():
                return False
        if not getattr(self.acceptor, "device_accept_ok", False):
            return False
        if not getattr(self.eps, "device_schedule_ok", False):
            return False
        temp = isinstance(self.eps, TemperatureBase)
        stoch = isinstance(self.distance_function, StochasticKernel)
        adaptive = self._distance_is_adaptive()
        if temp != stoch:
            return False  # the stochastic triple is all or none
        if adaptive:
            if stoch:
                return False  # no in-block refit of a stochastic kernel
            if not getattr(self.distance_function, "device_refit_ok",
                           False):
                return False
        elif not self.distance_function.params_time_invariant():
            return False
        # the block stands in for the record stream (the last round's
        # stats for an adaptive refit, the R-row ring for the temperature
        # solve); any other reader of records needs the host loop
        if s.record_rejected and not (adaptive or temp):
            return False
        if s.record_proposal_density and not temp:
            return False
        if type(self.population_strategy) is not ConstantPopulationSize:
            return False
        if getattr(self.population_strategy,
                   "nr_samples_per_parameter", 1) != 1:
            return False
        if not all(type(tr) is MultivariateNormalTransition
                   and getattr(tr, "device_support_ok", False)
                   for tr in self.transitions):
            return False
        # bound the per-generation proposal density: n queries x every
        # model's support rows (the cap above fused_support_cap, the
        # device grid for a large 1-D model, else n)
        n = self.population_strategy(0)
        cap = self.fused_support_cap

        def support_rows(dim: int) -> int:
            if cap is not None and n > cap:
                return cap
            if dim == 1 and n >= _COMPRESS_MIN_N:
                return _fused._DEVICE_GRID
            return n

        rows = sum(support_rows(p.dim) for p in self.parameter_priors)
        return float(n) * rows <= float(1 << 35)

    def _fused_eligible(self) -> bool:
        """Run ``fuse_generations`` generations per block?  Needs K >= 2,
        the device chain, and — above PROBE_MIN_POP — no measured loss of
        the fused engine, and no retry-exhausted block this run."""
        if self._fault_fused_off or self.fuse_generations < 2:
            return False
        if (self.population_strategy(0) > self.PROBE_MIN_POP
                and self._engine_choice == "sequential"):
            return False
        return self._device_chain_eligible()

    def _onedispatch_eligible(self) -> bool:
        """Run the rest of the run as one dispatch with the stop chain on
        the device?  Opt-in (``run_mode="onedispatch"``) on top of the
        fused engine's conditions, and the epsilon's stop test must be
        exact on the device (``device_stop_ok``); a failed one-dispatch
        run or drain latches it off for the run."""
        return (self.run_mode == "onedispatch"
                and not self._fault_onedispatch_off
                and getattr(self.eps, "device_stop_ok", False)
                and self._fused_eligible())

    def _fidelity_eligible(self) -> bool:
        """Run the device engines' rounds as the fidelity cascade?  Opt-in
        (``fidelity=``) on top of the device chain, with the screen's own
        capability flags: the distance and the acceptor declare
        ``device_screen_ok``, every model ships a ``low_fidelity()`` that
        is ``screen_stats_compatible``, and neither the adaptive nor the
        stochastic chain is on (their per-generation scale or temperature
        is what a screen must not perturb).  An ineligible configuration
        runs the exact unscreened engine."""
        if self.fidelity is None:
            return False
        mode = self._block_mode()
        if mode["adaptive"] or mode["stoch"]:
            return False
        if not getattr(self.distance_function, "device_screen_ok", False):
            return False
        if not getattr(self.acceptor, "device_screen_ok", False):
            return False
        for m in self.models:
            if m.low_fidelity() is None:
                return False
            if not getattr(m, "screen_stats_compatible", False):
                return False
        return self._device_chain_eligible()

    def _fidelity_block_cfg(self, B: int) -> dict:
        """The ``fidelity_cfg`` of the block builders at batch ``B``
        (``n_full``: a round's full-fidelity slots)."""
        fid = self.fidelity
        return {"q": fid.false_reject_q, "margin": fid.margin,
                "min_corr": fid.min_corr, "min_pairs": fid.min_pairs,
                "cal_rows": fid.cal_rows, "n_full": fid.n_full(B)}

    def _fidelity_nan_seed(self, rows: int):
        """Fresh, all-NaN calibration rings: a fresh run, a resumed one,
        or any carry whose rings do not match the configuration starts
        here, and ``fidelity.screen_threshold`` maps them to +inf — the
        first screened generation runs unscreened."""
        return (torch.full((rows,), math.nan, device=self.device),
                torch.full((rows,), math.nan, device=self.device))

    def _note_sequential_gen_s(self, wall_s: float):
        """A sequential generation's seconds: the engine probe's
        baseline."""
        if wall_s > 1e-9:
            self._seq_probe_s = wall_s

    def _decide_engine(self, fused_s_per_gen: float) -> str:
        """One-shot fused-vs-sequential choice at scale from the first
        block's seconds per generation, with a 5 % band; with no
        sequential baseline the fused engine stays."""
        if self._engine_choice is None:
            seq = self._seq_probe_s
            if seq is None or fused_s_per_gen <= seq * 1.05:
                self._engine_choice = "fused"
            else:
                self._engine_choice = "sequential"
            logger.info(
                "engine probe: fused %.4g s/gen vs sequential %s s/gen "
                "-> %s", fused_s_per_gen,
                "n/a" if seq is None else f"{seq:.4g}", self._engine_choice)
        return self._engine_choice

    def _eps_device_config(self):
        """``(mode, alpha, multiplier, weighted, sketch)`` of the block's
        epsilon schedule; ``sketch`` only where a quantile is sorted."""
        if isinstance(self.eps, ConstantEpsilon):
            return "constant", 0.5, 1.0, True, False
        if isinstance(self.eps, TemperatureBase):
            return "temperature", 0.5, 1.0, True, False
        return ("quantile", self.eps.alpha, self.eps.quantile_multiplier,
                self.eps.weighted,
                bool(getattr(self.eps, "device_sketch_ok", False)))

    def _block_mode(self) -> dict:
        """Which in-block adaptation chains a block carries."""
        return {"adaptive": self._distance_is_adaptive(),
                "stoch": isinstance(self.acceptor, StochasticAcceptor)}

    def _block_record_rows(self, B: int) -> int:
        """Record-ring rows of a stochastic-triple block (at most one
        round's candidates)."""
        return min(self._RECORD_ROWS_MAX, B)

    def _final_mask(self, t: int, K: int) -> List[bool]:
        """Which generations of a block starting at ``t`` are the run's
        last (``Temperature`` pins their temperature to 1)."""
        nr_pop = self.max_nr_populations
        if not np.isfinite(nr_pop):
            return [False] * K
        return [(t + k) >= nr_pop - 1 for k in range(K)]

    def _block_max_rounds(self, n: int, B: int,
                          rate_est: Optional[float] = None) -> int:
        """A block generation's round ceiling: 16, doubled up to 64 while
        the rate estimate (with a 4x margin for the in-block decay)
        predicts more; clamped below by ``min_acceptance_rate``'s budget,
        past which the sequential loop would have stopped anyway.

        A screened block budgets against its full-fidelity slots, not the
        batch: a round accepts at most ``n_full`` candidates (at worst the
        self-disabled screen, where every valid candidate competes for
        them), so its ceiling starts at ``16·r`` and grows to ``64·r``,
        ``r = B / n_full``: the full-fidelity simulations an unscreened
        block's ceiling allows.  The JAX package scales only the 64; with
        16 rounds a screened block of a tightening schedule undershoots
        once the in-block rate has fallen past the 4x margin (the SIR
        screen at pop 5e4, batch 2^18: at t = 3 of a block from t = 1)."""
        hi, hi_cap, B_eff = 16, 64, B
        if self._fidelity_eligible():
            B_eff = self.fidelity.n_full(B)
            r = max(1, int(round(B / max(B_eff, 1))))
            hi, hi_cap = 16 * r, 64 * r
        if rate_est is not None and rate_est > 0:
            need = int(np.ceil(
                n / (max(float(rate_est), 1e-6) * B_eff) * 4.0)) + 1
            while hi < need and hi < hi_cap:
                hi *= 2
        if self.min_acceptance_rate > 0:
            return int(np.clip(
                np.ceil(n / (self.min_acceptance_rate * B_eff)), 1, hi))
        return hi

    def _seed_block_carry(self, t: int, carry: dict, B: int,
                          rate_est: float, safety: float):
        """A block's full carry from the previous block's (all lanes:
        passed through) or from a sequential generation's
        ``Sample.device_population`` (the population lanes: the rest are
        seeded here).  None when the seed cannot reproduce the sequential
        chain's state for ``t``."""
        mode = self._block_mode()
        eps_mode = self._eps_device_config()[0]
        dev = self.device
        # a previous block's carry rests at the carry precision: the seed
        # is built in float32 and narrowed again on exit
        carry = _precision.decode_carry(carry, self._carry_precision())
        n = carry["theta"].shape[0]

        def scalar(v):
            return torch.full((), float(v), dtype=torch.float32, device=dev)

        out = {k: carry[k] for k in ("m", "theta", "log_weight",
                                     "distance")}
        out["count"] = (carry["count"] if "count" in carry else
                        torch.full((), n, dtype=torch.int64, device=dev))
        out["stats"] = (carry["stats"] if "stats" in carry else
                        torch.zeros(n, self.spec.total_size, device=dev))
        if eps_mode == "constant":
            out["eps"] = scalar(self.eps(t))
        elif "eps" in carry:
            out["eps"] = carry["eps"]
        elif eps_mode == "temperature":
            # the newest host temperature <= t caps the block's first
            # solve: at a sequential boundary the solved T_t itself
            known = [tt for tt in self.eps.temperatures if tt <= t]
            if not known:
                return None
            out["eps"] = scalar(self.eps.temperatures[max(known)])
        else:
            out["eps"] = scalar(self.eps(t))  # recomputed in the block
        out["rate"] = (carry["rate"] if "rate" in carry
                       else scalar(max(rate_est, 1e-6)))
        out["safety"] = (carry["safety"] if "safety" in carry
                         else scalar(safety))
        if mode["adaptive"]:
            if "dist_w" in carry:
                out["dist_w"] = carry["dist_w"]
            else:
                # from a sequential generation: the host refit for t ran
                # already — carry its raw weights and the distances under
                # them (the first in-block quantile must see w_t)
                if "stats" not in carry:
                    return None
                w_host = self.distance_function._weights_for(t)
                out["dist_w"] = torch.as_tensor(
                    np.asarray(w_host, np.float32), device=dev)
                out["distance"] = self.distance_function.compute(
                    carry["stats"], self._obs_flat,
                    to_torch(self.distance_function.get_params(t), dev))[:n]
        if mode["stoch"]:
            R = self._block_record_rows(B)
            if "rec_m" in carry and carry["rec_m"].shape[0] == R:
                out.update({k: carry[k] for k in _fused.RING_LANES})
            else:
                # NaN ring: the first in-block solve degrades to +inf and
                # the clamp keeps the host's T_t; real records follow
                out["rec_m"] = torch.zeros(R, dtype=torch.int64, device=dev)
                out["rec_theta"] = torch.full((R, self.dim), math.nan,
                                              device=dev)
                out["rec_dist"] = torch.full((R,), math.nan, device=dev)
                out["rec_loggen"] = torch.zeros(R, device=dev)
        if self._fidelity_eligible():
            # the calibration-assembly fault site: a kill here dies with
            # the previous generations durable; the restart seeds NaN
            # rings and its first screened generation self-disables
            _faults.fault_point(_faults.SITE_FIDELITY_CALIBRATE,
                                data={"t": t})
            rows = self.fidelity.cal_rows
            if all(k in carry and carry[k].shape[0] == rows
                   for k in _fused.CAL_LANES):
                out.update({k: carry[k] for k in _fused.CAL_LANES})
            else:
                out["cal_lo"], out["cal_full"] = self._fidelity_nan_seed(rows)
        return _precision.encode_carry(out, self._carry_precision())

    def _get_block_fn(self, t: int, n: int, B: int, K: int,
                      summary: bool = False,
                      max_rounds: Optional[int] = None):
        """The K-generation block of this configuration (``summary``: with
        the ``sm_*`` summary lanes, for the lazy History; ``max_rounds``:
        the occupancy tuner's round cap)."""
        return self._get_engine_fn(_fused.build_fused_generations, t, n, B,
                                   max_rounds=max_rounds, K=K,
                                   summary_lanes=summary)

    def _get_run_fn(self, t: int, n: int, B: int, K: int, max_T: int,
                    summary: bool = False):
        """The one-dispatch run of this configuration: its K-generation
        blocks, at most ``max_T`` generations per dispatch."""
        return self._get_engine_fn(
            _fused.build_onedispatch_run, t, n, B, K=K, max_T=max_T,
            single_model_stop=(self.stop_if_only_single_model_alive
                               and self.M > 1), summary_lanes=summary)

    def _get_engine_fn(self, build: Callable, t: int, n: int, B: int,
                       max_rounds: Optional[int] = None, **static):
        """``build``'s engine for this configuration with the arguments a
        fused block and a one-dispatch run share, plus ``static`` (built
        once per shape, schedule, fidelity configuration and carry
        precision), served by the sampler's :class:`CompiledLadder` —
        keyed by the round kernel's ``_uid``, so a renewed run reuses it
        and a rebound one never does."""
        samp = self.sampler
        d, s_width = self.dim, self.spec.total_size
        eps_mode, alpha, mult, weighted, eps_sketch = \
            self._eps_device_config()
        if max_rounds is None:
            max_rounds = self._block_max_rounds(n, B,
                                                rate_est=samp.rate_est)
        mode = self._block_mode()
        fid_on = self._fidelity_eligible()
        fid_key = self.fidelity.digest_key() if fid_on else None
        carry_prec = self._carry_precision()
        wire_stats = bool(samp.fetch_stats)
        lanes_on = bool(self.telemetry_lanes)
        sup_cap = self.fused_support_cap
        record_rows = self._block_record_rows(B) if mode["stoch"] else 0
        pdf_norm = 0.0
        if mode["stoch"]:
            # constant for the run under pdf_norm_from_kernel (the
            # device_accept_ok condition); keyed all the same
            norms = self.acceptor.pdf_norms
            pdf_norm = float(norms.get(t, norms[max(norms)]
                                       if norms else 0.0))
        key = (build.__name__, tuple(sorted(static.items())),
               self._kernel._uid, B, n, d, s_width, eps_mode, alpha, mult,
               weighted, eps_sketch, max_rounds, sup_cap, mode["adaptive"],
               mode["stoch"], record_rows, pdf_norm, fid_key, carry_prec,
               wire_stats, lanes_on)
        return samp._ladder.get(key, lambda: self._build_engine_fn(
            build, t, B, mode, fid_on, static, record_rows, pdf_norm,
            n_target=n, max_rounds=max_rounds, d=d, s=s_width,
            eps_mode=eps_mode, eps_alpha=alpha, eps_multiplier=mult,
            eps_weighted=weighted, eps_sketch=eps_sketch,
            support_cap=sup_cap, carry_precision=carry_prec,
            wire_stats=wire_stats, telemetry_lanes=lanes_on))

    def _build_engine_fn(self, build: Callable, t: int, B: int, mode: dict,
                         fid_on: bool, static: dict, record_rows: int,
                         pdf_norm: float, **shared):
        """Build one engine of :meth:`_get_engine_fn`'s key (a ladder
        miss); ``shared`` are the builder arguments that key names."""
        adaptive_cfg = None
        if mode["adaptive"]:
            dist = self.distance_function
            adaptive_cfg = {"scale_fn": dist.scale_function,
                            "distance_fn": dist.compute,
                            "obs_flat": self._obs_flat,
                            "max_weight_ratio": dist.max_weight_ratio,
                            "normalize_weights": dist.normalize_weights,
                            "factors": dist.factors}
        stoch_cfg = None
        if mode["stoch"]:
            stoch_cfg = {"pdf_norm": pdf_norm,
                         "target_rate": float(
                             self.eps.schemes[0].target_rate),
                         "lin_scale": self.acceptor.kernel_scale == SCALE_LIN,
                         "record_rows": record_rows}
        round_fn = self._kernel.generation_round
        fidelity_cfg = None
        round_kwargs = {}
        if fid_on:
            # the staged screen-then-verify round
            round_fn = self._kernel.staged_generation_round
            round_kwargs = {"full_fraction": self.fidelity.full_fraction}
            fidelity_cfg = self._fidelity_block_cfg(B)
        # the round is captured as a CUDA graph where the sampler's rounds
        # stay on one card (not across ranks), into its ladder's pool
        graphs_on = getattr(self.sampler, "graphs_on", None)
        round_graphs = bool(graphs_on()) if graphs_on is not None else False
        return build(
            kernel=self._kernel,
            bandwidth_selectors=[tr.bandwidth_selector
                                 for tr in self.transitions],
            scalings=[tr.scaling for tr in self.transitions],
            dims=[p.dim for p in self.parameter_priors], B=B,
            # an adaptive distance's weights ride the carry
            distance_params=(None if mode["adaptive"] else to_torch(
                self.distance_function.get_params(t), self.device)),
            raw_round=self.sampler.raw_round(round_fn, B, **round_kwargs),
            # a quantile schedule tightens ε every generation: the carried
            # rate over-predicts by about alpha
            rate_pred_factor=(shared["eps_alpha"]
                              if shared["eps_mode"] == "quantile" else 1.0),
            adaptive_cfg=adaptive_cfg, stoch_cfg=stoch_cfg,
            fidelity_cfg=fidelity_cfg, round_graphs=round_graphs,
            graph_pool=(self.sampler._ladder.pool_source() if round_graphs
                        else None), **shared, **static)

    # ---- capacity planning (capacity/model.py) --------------------------

    def _carry_precision(self) -> str:
        """The concrete at-rest carry mode of the engines built now: an
        unresolved ``auto`` reads as f32 until the first capacity plan
        pins it, and stays pinned so every block of a run shares one
        carry layout."""
        return self._carry_mode or "f32"

    def _capacity_kwargs(self, engine: str, n: int, B: int) -> dict:
        """The ledger's lanes of this configuration at batch ``B``."""
        mode = self._block_mode()
        return dict(
            population=n, param_dim=self.dim,
            stat_dim=self.spec.total_size, engine=engine,
            wire_stats=bool(self.sampler.fetch_stats), models=self.M,
            support_cap=self.fused_support_cap,
            record_rows=(self._block_record_rows(B) if mode["stoch"]
                         else 0),
            cal_rows=(self.fidelity.cal_rows if self._fidelity_eligible()
                      else 0),
            # the lazy store's generations resident when the engine starts
            # (the engine's own land in its wire slots)
            store_gens=(len(self._store.resident_ts()) if self._lazy_active
                        else 0),
            # the rounds' CUDA-graph pool, where the sampler captures them
            graph_pool=bool(getattr(self.sampler, "graphs_on",
                                    lambda: False)()))

    def _capacity_feasible(self, engine: str, n: int):
        """``feasible(K, max_T, B) -> bool`` over the capacity model for
        the occupancy tuner, or None without a budget."""
        budget = _capacity.resolved_budget_bytes(self.device)
        if budget <= 0:
            return None
        prec = self._carry_precision()

        def feasible(K: int, max_T: int, B: int) -> bool:
            return _capacity.predict_peak_bytes(
                batch=B, K=K, max_T=max_T, carry_precision=prec,
                **self._capacity_kwargs(engine, n, B)) <= budget

        return feasible

    def _capacity_consult(self, engine: str, n: int, B: int, K: int,
                          max_T: int, **lanes) -> _capacity.CapacityPlan:
        """Plan a device engine's memory before it runs: resolve an
        ``auto`` carry precision, shrink (B, K, max_T) to the budget where
        needed, record the plan in ``timeline.capacity``, or raise
        :class:`~.capacity.CapacityError` with the full ledger.  Without a
        budget the plan comes back unconstrained and nothing changes.
        ``lanes`` adds ledger lanes (a one-dispatch run's
        ``wire_slots``)."""
        prec = ("auto" if (self._carry_auto and self._carry_mode is None)
                else self._carry_precision())
        plan = _capacity.plan(
            batch=B, K=K, max_T=max_T, carry_precision=prec,
            round_to_batch=self.sampler._round_to_valid_batch,
            device=self.device, **self._capacity_kwargs(engine, n, B),
            **lanes)
        if self._carry_auto and self._carry_mode is None:
            self._carry_mode = plan.carry_precision
        self.timeline.capacity = {
            "engine": engine, "precision": plan.carry_precision,
            "batch": plan.batch, "K": plan.K, "max_T": plan.max_T,
            "devices": plan.devices,
            "predicted_bytes": plan.predicted_bytes,
            "budget_bytes": plan.budget_bytes, "note": plan.note,
            "ledger": dict(plan.ledger)}
        if plan.note == "clamped to fit budget":
            logger.info(
                "Capacity: clamped to fit a budget of %.1f MB -> batch=%d "
                "K=%d max_T=%d carry_precision=%s (predicted %.1f MB)",
                plan.budget_bytes / 2 ** 20, plan.batch, plan.K,
                plan.max_T, plan.carry_precision, plan.predicted_mb)
        return plan

    def _lazy_gen_fetch(self, t0: int):
        """A :class:`GenStream` fetch for the lazy History: deposit
        generation ``t0 + k``'s wire in the store and fetch only its
        summary lanes and scalars, under ``egress("summary")``.  Runs on
        the ingest worker."""
        store = self._store

        def fetch(k, gen_wire, n_rows, ready):
            small = {key: gen_wire[key] for key in
                     _wire_store.SUMMARY_LANE_KEYS + SCALAR_KEYS
                     if key in gen_wire}
            with transfer.egress("summary"):
                out = fetch_to_host(small, ready)
            count, rounds = int(out["count"]), int(out["rounds"])
            eps = (float(np.asarray(out["eps"], dtype=np.float64))
                   if "eps" in out else None)
            store.deposit(t0 + k, gen_wire, n=n_rows, count=count, eps=eps,
                          norm="stream", ready=ready)
            return _wire_store.summary_from_lanes(out), count, rounds, eps

        return fetch

    def _progress_generation(self, n: int, count: int):
        """With ``show_progress``, one generation of a device engine as a
        finished bar: the engines read each generation's accepted count
        anyway (a fused block at its rounds, a one-dispatch run in its
        control read), so the bar adds no host read."""
        if self.show_progress:
            from .utils.progress import ProgressBar
            with ProgressBar(n, desc="sampling") as bar:
                bar.update(min(int(count), n))

    def _append_device_generation(self, t_k: int, payload, count: int,
                                  rounds: int, eps_raw, B: int, n: int,
                                  info: dict, path: str, lazy: bool):
        """Append generation ``t_k`` of a device engine to History from
        its fetched ``payload`` (the population batch, or with ``lazy``
        the summary packet of a generation left in the store):
        ``(population or None, models alive, timeline row)`` (the row
        without its times), or None when its weights are degenerate."""
        label = {"fused": "fused block", "pipelined": "pipelined block",
                 "onedispatch": "one-dispatch run"}[path]
        if path != "onedispatch":
            # a one-dispatch run shows each generation at its control read
            self._progress_generation(n, count)
        eps_mode = self._eps_device_config()[0]
        evals = rounds * B
        pop = None
        if lazy:
            ess = float(payload["ess"])
            alive = sum(1 for x in payload["model_w"] if x > 0)
            ok = np.isfinite(ess) and ess > 0
        else:
            pop = batch_to_population(payload)
            ok = pop is not None
        if not ok:
            logger.warning("%s produced degenerate weights at t=%d: "
                           "sequential fallback", label, t_k)
            if lazy:
                self._store.drop(t_k)
            return None
        if not lazy:
            ess = float(effective_sample_size(pop.weight))
            alive = pop.nr_of_models_alive()
        # a constant ε is the host's value: the float32 round trip would
        # defeat `eps <= minimum_epsilon`
        eps = (float(self.eps(t_k)) if eps_mode == "constant"
               else float(eps_raw))
        acc_rate = count / max(evals, 1)
        names = [m.name for m in self.models]
        append_mark = time.perf_counter()
        with _spans.span("gen.append", gen=t_k):
            if lazy:
                self.history.append_population_lazy(
                    t_k, eps, evals, summary=payload, model_names=names,
                    param_names=self._param_names(),
                    stat_spec=self.spec.shapes)
            else:
                self.history.append_population(
                    t_k, eps, pop, evals, names, self._param_names(),
                    stat_spec=self.spec.shapes)
        append_s = time.perf_counter() - append_mark
        # the engine's ε/T is the durable schedule entry
        if eps_mode == "quantile":
            self.eps._look_up[t_k] = eps
        elif eps_mode == "temperature":
            self.eps.temperatures[t_k] = eps
        logger.info("t: %d, eps: %.8g (%s), acceptance rate: %.4g, ESS: "
                    "%.4g, evals: %d", t_k, eps, path, acc_rate, ess, evals)
        row = {
            "t": t_k, "path": path, "eps": eps, "n": n, "accepted": count,
            "evaluations": evals, "acceptance_rate": acc_rate, "ess": ess,
            "batch": B, "rounds": rounds, "host_reads": info["host_reads"],
            "grids_resolved": info["grids_resolved"],
            "round_graph": info["round_graph"],
            "round_replays": info["round_replays"],
            "cdf_builds": info["cdf_builds"],
            "kde_launches": info["kde_launches"],
            "kde_support": info["kde_support"], "records": 0,
            "record_batches": 0, "refit_s": 0.0, "append_s": append_s,
            **{k: info[k] for k in _CLOCK_KEYS if k in info}}
        if "screen_pass" in info:
            # the cascade's simulations: every candidate at low fidelity,
            # every slot at full fidelity
            row.update({"sims_low": evals,
                        "sims_full": rounds * self.fidelity.n_full(B),
                        "screen_pass": int(info["screen_pass"]),
                        "screen_tau": float(info["screen_tau"]),
                        "cal_pairs": int(info["cal_pairs"]),
                        "cal_corr": float(info["cal_corr"]),
                        "round_cap": int(info["round_cap"]),
                        "max_rounds": info["max_rounds"]})
        return pop, alive, row

    def _stop_after(self, eps: float, alive: int, acc_rate: float,
                    sims: int, max_total_nr_simulations) -> Optional[str]:
        """The sequential loop's stop criteria, in its order, after a
        device engine's generation (None: go on)."""
        if isinstance(self.eps, TemperatureBase):
            if eps <= 1.0:
                return STOP_TEMPERATURE
        elif eps <= self.minimum_epsilon:
            return STOP_EPS
        if (self.stop_if_only_single_model_alive and alive <= 1
                and self.M > 1):
            return STOP_SINGLE_MODEL
        if acc_rate < self.min_acceptance_rate:
            return STOP_ACC_RATE
        if sims >= max_total_nr_simulations:
            return STOP_BUDGET
        return None

    def _record(self, row: dict, tr: Optional[dict] = None,
                accepted: Optional[int] = None,
                lanes: Optional[dict] = None):
        """Append a timeline row with its wire-ledger share ``tr``; book
        the generation's stage row (``timeline.record``) and its
        registry counters (``metrics.record_generation``).  ``lanes``:
        the generation's fetched ``tl_*`` lanes, whose work units
        attribute the row's wall to phases (``ph_<phase>_s``)."""
        tr = tr or {}
        row.update({"compute_s": tr.get("compute_s", 0.0),
                    "d2h_s": tr.get("d2h_s", 0.0),
                    "overlap_s": tr.get("overlap_s", 0.0),
                    "history_mode": ("lazy" if self._lazy_active
                                     else "eager")})
        phases = None
        if lanes and "tl_phase" in lanes:
            phases = _lanes.attribute_phases(lanes["tl_phase"],
                                             row["wall_s"])
            row.update({f"ph_{k}_s": v for k, v in phases.items()})
            row["tl_sims"] = int(lanes["tl_sims"])
        self.generation_transfer[row["t"]] = tr
        self.timeline.append(row)
        # the program builds and captures since the previous row
        built = compile_delta(self._compile_mark)
        self._compile_mark = compile_counters()
        compute = row["compute_s"]
        fetch = tr.get("fetch_s", 0.0)
        decode = tr.get("decode_s", 0.0)
        if accepted is None:
            accepted = int(round(row["acceptance_rate"]
                                 * row["evaluations"]))
        self.timeline.record(
            row["t"], path=row["path"], wall_s=row["wall_s"],
            stages={"adapt": row.get("adapt_s", 0.0) + row["refit_s"],
                    "dispatch": max(0.0, row.get("sample_s", 0.0)
                                    - compute - fetch - decode),
                    "compute": compute, "fetch": fetch, "decode": decode,
                    "append": row.get("append_s", 0.0)},
            eps=row["eps"], accepted=accepted, total=row["evaluations"],
            overlap_s=row["overlap_s"], compile_s=built["compile_s"],
            n_compiles=built["n_compiles"], engine=row.get("engine"),
            phases=phases)
        fid = {}
        if "sims_low" in row:
            fid = {"sims_low": row["sims_low"],
                   "sims_full": row["sims_full"],
                   "screen_pass": row["screen_pass"]}
        _metrics.record_generation(
            row["evaluations"], accepted, row["acceptance_rate"],
            rounds=row.get("rounds"), wall_s=row["wall_s"], **fid)

    def _observe_device_rows(self, rows: List[dict], tr: dict,
                             lanes: Optional[List[dict]] = None):
        """Time-stamped rows of a device engine into the timeline and the
        autotuner, each with its share of the ledger delta ``tr`` and its
        telemetry lanes."""
        share = {k: v / len(rows) for k, v in tr.items()}
        for i, row in enumerate(rows):
            accepted = row.pop("accepted")
            self._record(row, share, accepted=accepted,
                         lanes=lanes[i] if lanes else None)
            self.sampler.observe_generation(
                accepted, row["evaluations"], rounds=row["rounds"],
                compute_s=share["compute_s"], overlap_s=share["overlap_s"])
        self._publish_fleet()

    def _publish_fleet(self, force: bool = False):
        """A fleet snapshot of the timeline into the run directory, when
        one is advertised (throttled by the publisher unless forced)."""
        if self._fleet is not None:
            self._fleet.publish(self.timeline, force=force)

    def _run_fused_block(self, t: int, t_max, total_sims: int,
                         max_total_nr_simulations):
        """One fused block from ``t``: ``(written, sims_added,
        stop_reason)``, ``written`` generations appended to History (0:
        the sequential engine takes ``t``).  The generations' fetches
        stream on an ingest worker while the caller appends.  A failed
        block raises."""
        carry = self._fused_carry
        self._fused_carry = None
        if carry is None:
            return 0, 0, None
        K = self.fuse_generations
        n = self.population_strategy(t)
        samp = self.sampler
        if carry["theta"].shape[0] != n:
            return 0, 0, None
        B = samp.choose_batch(n)
        occ_max_rounds = None
        if self._occupancy is not None:
            # K, the round cap and the batch chosen together, inside the
            # capacity model's feasible set when a budget is active
            K_j, max_T_j, B_j = self._occupancy.propose(
                n, max(float(samp.rate_est or 0.0), 1e-6), B,
                samp._round_to_valid_batch,
                feasible=self._capacity_feasible("fused", n))
            K = max(1, min(int(K_j), self.fuse_generations))
            B = int(B_j)
            occ_max_rounds = int(max_T_j)
        mode = self._block_mode()
        lazy = self._lazy_active
        with _spans.span("fused.seed", gen=t, k=K):
            plan = self._capacity_consult(
                "fused", n, B, K,
                occ_max_rounds or self._block_max_rounds(
                    n, B, rate_est=samp.rate_est))
            if plan.note == "clamped to fit budget":
                B = int(plan.batch)
                K = max(1, min(int(plan.K), K))
                if occ_max_rounds is not None:
                    occ_max_rounds = int(plan.max_T)
            carry_in = self._seed_block_carry(t, carry, B, samp.rate_est,
                                              samp.safety())
            if carry_in is None:
                return 0, 0, None
            fn = self._get_block_fn(t, n, B, K, summary=lazy,
                                    max_rounds=occ_max_rounds)
        on_card = self.device.type == "cuda"

        t0 = time.perf_counter()
        tr0 = transfer.snapshot()
        try:
            with profile_generation(t), \
                    _spans.span("fused.dispatch", gen=t, k=K):
                carry_out, wires, infos = self._retry.call(
                    fn, _faults.SITE_DISPATCH, carry_in, self.generator,
                    self._final_mask(t, K) if mode["stoch"] else None,
                    rng=self.generator)
        except _retry.RetryExhausted as err:
            # the block's inputs are untouched (it allocates its own
            # buffers): the sequential engine redoes t from host state
            logger.warning(
                "fused block dispatch failed after retries (%s): "
                "disabling generation fusion for this run", err)
            self._fault_fused_off = True
            _retry.record_degrade("fused_off")
            return 0, 0, None
        dispatch_s = time.perf_counter() - t0
        engine = StreamingIngest(depth=self.ingest_depth)
        stream = GenStream(engine, wires, K, n,
                           label=f"fused@t={t}",
                           fetch=self._lazy_gen_fetch(t) if lazy else None)
        written = 0
        stop_reason = None
        rounds_seen = 0
        rows = []
        lanes = []
        pop_k = None
        try:
            for k in range(K):
                t_k = t + k
                if t_k >= t_max:
                    break
                with _spans.span("fused.ingest", gen=t_k):
                    payload, count_k, rounds_k, eps_raw = stream.result()
                rounds_seen += rounds_k
                if count_k < n:
                    logger.info("fused block undershot at t=%d (%d/%d "
                                "accepted): falling back to the sequential "
                                "path", t_k, count_k, n)
                    break
                got = self._append_device_generation(
                    t_k, payload, count_k, rounds_k, eps_raw, B, n,
                    infos[k], "fused", lazy)
                if got is None:
                    break
                pop_k, alive, row = got
                rows.append(row)
                lanes.append(stream.lanes)
                written += 1
                stop_reason = self._stop_after(
                    row["eps"], alive, row["acceptance_rate"],
                    total_sims + rounds_seen * B, max_total_nr_simulations)
                if stop_reason is not None:
                    break
        finally:
            stream.abandon()
            engine.close()
        # every generation the block ran counts against the budget,
        # discarded ones included
        sims_added = sum(info["rounds"] for info in infos) * B
        samp.nr_evaluations_ += sims_added
        if lazy:
            # deposits past the last written generation have no row
            self._store.drop_from(t + written)
        block_s = time.perf_counter() - t0
        self.blocks.append({
            "t": t, "K": K, "written": written, "batch": B,
            "rounds": [info["rounds"] for info in infos],
            # a screened block's caps: which one ended a short generation
            **({"round_caps": [int(info["round_cap"]) for info in infos],
                "max_rounds": infos[0]["max_rounds"]}
               if "round_cap" in infos[0] else {}),
            "host_reads": sum(info["host_reads"] for info in infos),
            "kde_launches": sum(info["kde_launches"] for info in infos),
            "wall_s": block_s, "stop": stop_reason})
        if not written:
            return 0, sims_added, None
        if self._occupancy is not None:
            self._occupancy.observe_block(
                K, B, [info["rounds"] for info in infos[:written]], block_s,
                written)
        at_scale = n > self.PROBE_MIN_POP
        if at_scale and self._engine_choice is None:
            self._decide_engine(block_s / written)
        peak = (torch.cuda.max_memory_allocated(self.device) / 1e9
                if on_card else None)
        for row in rows:
            row.update({"engine": self._engine_choice if at_scale else None,
                        "wall_s": block_s / written,
                        "sample_s": dispatch_s / written,
                        "peak_mem_gb": peak})
        self._observe_device_rows(rows, transfer.delta(tr0), lanes)
        if stop_reason is None and t + written < t_max:
            with _spans.span("fused.prepare", gen=t + written):
                if pop_k is None:
                    # lazy: the host continuation needs the last
                    # generation's rows; the block's earlier ones stay on
                    # the card
                    pop_k = self.history.hydrate_population(t + written - 1)
                # the device carry only after a whole block
                self._hand_over(t + written, pop_k,
                                carry_out if written == K else None)
        return written, sims_added, stop_reason

    def _hand_over(self, t: int, population: Population,
                   carry: Optional[dict]):
        """Keep the chain hot after a device engine wrote up to ``t - 1``:
        its ``carry`` (None after an undershoot) seeds the next block or
        dispatch, and the host components advance for ``t`` as after a
        sequential generation (span ``handover.decode``: the carry's
        decode and the weights' read)."""
        prep = Sample()
        if carry is not None:
            with _spans.span("handover.decode", gen=t):
                # the carry rests narrowed; the host continuation reads
                # float32
                self._fused_carry = carry
                prep.device_population = _precision.decode_carry(
                    carry, self._carry_precision())
                if self._block_mode()["adaptive"]:
                    # the in-engine refit's weights for t: update() then
                    # keeps them and the ε update sees distances under them
                    self.distance_function.weights[t] = \
                        carry["dist_w"].cpu().numpy().astype(np.float32)
        self._prepare_next_iteration(t, prep, population,
                                     self.sampler.rate_est)

    def _run_onedispatch(self, t: int, t_max, total_sims: int,
                         max_total_nr_simulations):
        """The rest of the run from ``t`` (at most ``onedispatch_max_t``
        generations) as one dispatch with the stop chain on the device:
        ``(written, sims_added, stop_reason)`` like
        :meth:`_run_fused_block`, ``written`` generations appended to
        History (0: the sequential engine takes ``t``).  The written
        generations drain through a :class:`GenStream`.  A failed
        dispatch raises."""
        carry = self._fused_carry
        self._fused_carry = None
        if carry is None:
            return 0, 0, None
        K = self.fuse_generations
        n = self.population_strategy(t)
        samp = self.sampler
        if carry["theta"].shape[0] != n:
            return 0, 0, None
        B = samp.choose_batch(n)
        max_T = self.onedispatch_max_t

        def generations_left(cap: int) -> int:
            return (int(np.clip(t_max - t, 1, cap)) if np.isfinite(t_max)
                    else cap)

        # the dispatch allocates a wire slot per generation it may write
        plan = self._capacity_consult("onedispatch", n, B, K, max_T,
                                      wire_slots=generations_left(max_T))
        if plan.note == "clamped to fit budget":
            B = int(plan.batch)
            K = max(1, min(int(plan.K), K))
            max_T = int(plan.max_T)
        carry_in = self._seed_block_carry(t, carry, B, samp.rate_est,
                                          samp.safety())
        if carry_in is None:
            return 0, 0, None
        lazy = self._lazy_active
        i32max = int(np.iinfo(np.int32).max)
        t_limit = generations_left(max_T)
        # integer-exact budget: total_sims + rounds * B >= max_total
        # <=> rounds >= ceil((max_total - total_sims) / B)
        budget_rounds = (int(np.clip(np.ceil(
            (max_total_nr_simulations - total_sims) / B), 0, i32max))
            if np.isfinite(max_total_nr_simulations) else i32max)
        ctl = {"min_eps": self.minimum_epsilon,
               "min_rate": self.min_acceptance_rate,
               "budget_rounds": budget_rounds, "t_limit": t_limit,
               "final_rel": (max(int(t_max) - 1 - t, 0)
                             if np.isfinite(t_max) else i32max)}
        fn = self._get_run_fn(t, n, B, K, max_T, summary=lazy)
        on_card = self.device.type == "cuda"
        # the measured side of the capacity model, on request (an explicit
        # budget or the measure switch): the card's peak allocation over
        # the dispatch, with everything resident before it
        measure = on_card and (
            bool(os.environ.get(_capacity.HBM_BUDGET_ENV, "").strip())
            or os.environ.get(CAPACITY_MEASURE_ENV, "0")
            in ("1", "true", "yes"))
        if measure:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

        lanes_on = bool(self.telemetry_lanes)
        run_tag = None
        poller = None
        if lanes_on:
            # this call's progress word, advanced after each written
            # generation's control read
            run_tag = _lanes.PROGRESS.begin(
                t0=t, t_limit=t_limit,
                run_id=getattr(self.history, "id", None))
            ctl["run_tag"] = run_tag
            if self._fleet is not None:
                # the fleet snapshot follows the word while the call runs
                poller = _lanes.ProgressPoller(
                    lambda: self._fleet.publish(self.timeline,
                                                force=True)).start()
        if self.show_progress:
            ctl["on_generation"] = lambda t_rel, count: \
                self._progress_generation(n, count)

        t0 = time.perf_counter()
        tr0 = transfer.snapshot()
        try:
            with profile_generation(t), \
                    _spans.span("onedispatch.dispatch", gen=t,
                                max_t=t_limit):
                carry_out, ctl_out, wires = self._retry.call(
                    fn, _faults.SITE_DISPATCH, carry_in, self.generator,
                    ctl, rng=self.generator)
        except _retry.RetryExhausted as err:
            logger.warning(
                "one-dispatch run failed after retries (%s): degrading "
                "to the per-block paths for this run", err)
            self._fault_onedispatch_off = True
            _retry.record_degrade("onedispatch_off")
            if lanes_on:
                _lanes.PROGRESS.finish(run_tag)
            return 0, 0, None
        finally:
            if poller is not None:
                poller.stop()
        dispatch_s = time.perf_counter() - t0
        if measure:
            torch.cuda.synchronize(self.device)
            # the graph pool's free blocks are held by the run too, and
            # the allocator's peak does not see them
            ladder = getattr(self.sampler, "_ladder", None)
            pool = (ladder.pool_bytes() if ladder is not None
                    else {"reserved": 0, "allocated": 0})
            self.timeline.capacity["graph_pool_bytes"] = pool["reserved"]
            self.timeline.capacity["measured_bytes"] = int(
                torch.cuda.max_memory_allocated(self.device)
                + pool["reserved"] - pool["allocated"])
        self.run_dispatches += 1
        self.control_roundtrip_s += ctl_out["control_s"]
        gens = ctl_out["gens"]
        stop_code = ctl_out["stop"]
        written = 0
        rows = []
        lanes = []
        pop_k = None
        drain_error = None
        interrupted = None
        try:
            if ctl_out["t"]:
                engine = StreamingIngest(depth=self.ingest_depth)
                stream = GenStream(engine, wires, ctl_out["t"],
                                   n, label=f"onedispatch@t={t}",
                                   fetch=(self._lazy_gen_fetch(t) if lazy
                                          else None))
                try:
                    for k in range(ctl_out["t"]):
                        # an operator stop abandons the remaining slots
                        # (the budget below still counts their rounds);
                        # the run resumes from the last drained one
                        if stop_requested():
                            interrupted = "Stopping: operator stop requested"
                            break
                        if _ckpt.preempt_requested():
                            interrupted = ("Stopping: preemption requested "
                                           "(SIGTERM)")
                            break
                        _faults.fault_point(_faults.SITE_DRAIN,
                                            data={"t": t + k})
                        with _spans.span("onedispatch.ingest", gen=t + k):
                            payload, count_k, rounds_k, eps_raw = \
                                stream.result()
                        got = self._append_device_generation(
                            t + k, payload, count_k, rounds_k, eps_raw, B,
                            n, gens[k], "onedispatch", lazy)
                        if got is None:
                            break
                        pop_k, _, row = got
                        rows.append({**row, "engine": "onedispatch",
                                     "sample_s": gens[k]["sample_s"]})
                        lanes.append(stream.lanes)
                        written += 1
                finally:
                    stream.abandon()
                    engine.close()
        except Exception as err:  # noqa: BLE001 — degrade, don't die
            if _retry.is_sticky_cuda_error(err):
                raise  # the context is gone: no engine can go on
            drain_error = err
        finally:
            if lanes_on:
                _lanes.PROGRESS.finish(run_tag)
        if drain_error is not None:
            logger.warning(
                "one-dispatch drain failed at t=%d (%s): degrading to the "
                "per-block paths for this run", t + written, drain_error)
            self._fault_onedispatch_off = True
            _retry.record_degrade("onedispatch_off")
        if lazy:
            self._store.drop_from(t + written)
        # every generation the dispatch ran counts against the budget,
        # an undershot one included
        sims_added = ctl_out["rounds"] * B
        samp.nr_evaluations_ += sims_added
        stop_reason = None
        clean = (written == ctl_out["t"] and drain_error is None
                 and interrupted is None)
        if interrupted is not None:
            stop_reason = interrupted
        elif clean and stop_code == _fused.STOP_UNDERSHOOT:
            logger.info("one-dispatch run undershot at t=%d (%d/%d "
                        "accepted): falling back to the sequential path",
                        t + ctl_out["stop_t"], ctl_out["stop_count"], n)
        elif clean and stop_code in STOP_REASONS:
            stop_reason = STOP_REASONS[stop_code]
        if not written:
            return 0, sims_added, None
        # the host's work after the dispatch (copies, History), shared out
        host_s = (time.perf_counter() - t0 - dispatch_s) / written
        peak = (torch.cuda.max_memory_allocated(self.device) / 1e9
                if on_card else None)
        for row in rows:
            row.update({"wall_s": row["sample_s"] + host_s,
                        "peak_mem_gb": peak})
        self._observe_device_rows(rows, transfer.delta(tr0), lanes)
        if stop_reason is None and t + written < t_max:
            if pop_k is None:
                pop_k = self.history.hydrate_population(t + written - 1)
            # t_limit reached: the carry seeds the next dispatch; after an
            # undershoot the sequential engine redoes the next generation
            self._hand_over(t + written, pop_k,
                            carry_out if clean and stop_code
                            == _fused.STOP_NONE else None)
        return written, sims_added, stop_reason

    # ---- the pipelined engine (wire/) -----------------------------------

    def _run_pipelined(self, t0: int, t_max, max_total_nr_simulations):
        """The overlapped generation loop (``pyabc_tpu/smc.py:2330``).

        Device blocks (K = ``fuse_generations`` when the fused engine is
        eligible, else 1) are dispatched ahead of the ingest frontier, up
        to ``max(ingest_depth, 1)`` in flight: block i + 1 runs from
        block i's carry, which never leaves the card, while an ingest
        worker fetches block i's generations on its own CUDA stream.  A
        port block is a host-driven loop, so what overlaps the fetch is
        the next block's loop.  History appends and the stop criteria run
        here, in generation order, as each block is harvested.

        A stop, an undershoot or degenerate weights found behind blocks
        already dispatched abandons them (``rewind_to_frontier``): their
        simulations are not counted, nothing of them reaches History, and
        the ledger counts their generations as ``rewinds``.  Their draws
        from the run's generator are spent, as the JAX package's
        speculative blocks spend their keys.  ``ingest_depth=0`` runs the
        same calls inline.  The first generation, and any generation after
        a rewind, runs sequentially with its fetch deferred to the
        engine; the batch of every block is sized from the rate estimate
        frozen at the last sequential generation, so the results do not
        depend on the depth.  An error on the worker raises on the next
        harvest."""
        samp = self.sampler
        mode = self._block_mode()
        lazy = self._lazy_active
        on_card = self.device.type == "cuda"
        ingest = StreamingIngest(depth=self.ingest_depth)
        inflight = deque()
        st = {"t": t0,           # ingest frontier: next generation to append
              "t_disp": t0,      # dispatch frontier
              "total_sims": 0,
              "carry": self._fused_carry,  # latest dispatched device carry
              "stop": None,
              "last_pop": None,  # population of the last appended generation
              "last_dp": None,   # its device view
              "prepared_t": t0,  # host components are fitted up to here
              # dispatch batch sizing, frozen between sequential generations
              # so that the depth cannot change what is dispatched
              "rate_disp": samp.rate_est, "safety_disp": samp.safety(),
              "gen_mark": time.perf_counter(),
              "tr_mark": transfer.snapshot()}
        self._fused_carry = None
        names = [m.name for m in self.models]

        def rewind_to_frontier():
            with _spans.span("pipeline.rewind", gen=st["t"]):
                abandoned = 0
                while inflight:
                    blk = inflight.pop()
                    if blk.get("stream") is not None:
                        blk["stream"].abandon()
                    elif blk["ticket"] is not None:
                        blk["ticket"].abandon()
                    abandoned += blk["K"]
                if abandoned:
                    transfer.record_rewind(abandoned)
                st["carry"] = None
                st["t_disp"] = st["t"]
                if lazy:
                    self._store.drop_from(st["t"])

        def dispatch_block() -> bool:
            carry, t_d = st["carry"], st["t_disp"]
            n = self.population_strategy(t_d)
            if carry["theta"].shape[0] != n:
                st["carry"] = None
                return False
            fused_K = (self.fuse_generations if self._fused_eligible()
                       else 1)
            K = fused_K if fused_K > 1 and t_d + fused_K <= t_max else 1
            if t_d + K > t_max:
                return False
            B = samp._round_to_valid_batch(
                n / max(st["rate_disp"], 1e-6) * st["safety_disp"])
            with _spans.span("pipeline.seed", gen=t_d, k=K):
                plan = self._capacity_consult(
                    "fused", n, B, K,
                    self._block_max_rounds(n, B, rate_est=samp.rate_est))
                if plan.note == "clamped to fit budget":
                    B = int(plan.batch)
                    K = max(1, min(int(plan.K), K))
                carry_in = self._seed_block_carry(
                    t_d, carry, B, st["rate_disp"], st["safety_disp"])
                if carry_in is None:
                    st["carry"] = None
                    return False
                fn = self._get_block_fn(t_d, n, B, K, summary=lazy)
            mark = time.perf_counter()
            # RetryExhausted propagates to run(), which falls back to the
            # sequential loop from the History frontier
            with profile_generation(t_d), \
                    _spans.span("pipeline.dispatch", gen=t_d, k=K):
                carry_out, wires, infos = self._retry.call(
                    fn, _faults.SITE_DISPATCH, carry_in, self.generator,
                    self._final_mask(t_d, K) if mode["stoch"] else None,
                    rng=self.generator)
            stream = GenStream(ingest, wires, K, n,
                               label=f"block@t={t_d}",
                               fetch=(self._lazy_gen_fetch(t_d) if lazy
                                      else None))
            inflight.append({"kind": "block", "ticket": None,
                             "stream": stream, "lazy": lazy, "t0": t_d,
                             "K": K, "B": B, "n": n, "infos": infos,
                             "carry_out": carry_out,
                             "dispatch_s": time.perf_counter() - mark})
            st["carry"] = carry_out
            st["t_disp"] = t_d + K
            return True

        def sequential_gen() -> bool:
            t = st["t"]
            if t > st["prepared_t"]:
                # the host components skipped the blocks' generations:
                # refit them from the last appended one
                with _spans.span("pipeline.prepare", gen=t):
                    prep = Sample()
                    prep.device_population = st["last_dp"]
                    if st["last_pop"] is None:
                        st["last_pop"] = self.history.hydrate_population(
                            t - 1)
                    self._prepare_next_iteration(t, prep, st["last_pop"],
                                                 samp.rate_est)
                st["prepared_t"] = t
            current_eps = float(self.eps(t))
            n = self.population_strategy(t)
            max_eval = (n / self.min_acceptance_rate
                        if self.min_acceptance_rate > 0 else np.inf)
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
            launches0 = weighted_kde_logpdf_cuda.launches
            mark = time.perf_counter()
            with profile_generation(t), _spans.span("gen.sample", gen=t):
                sample = self._sample_generation(
                    n, round_fn, params, max_eval, defer=True)
            if sample.n_accepted < n:
                st["stop"] = ("Stopping: acceptance rate fell below "
                              "min_acceptance_rate (%d/%d accepted)"
                              % (sample.n_accepted, n))
                return False
            st["total_sims"] += sample.nr_evaluations
            st["rate_disp"] = samp.rate_est
            st["safety_disp"] = samp.safety()
            dp = sample.device_population
            st["carry"] = dp if dp is not None and "distance" in dp else None
            entry = {"kind": "seq", "ticket": None, "t0": t, "K": 1, "n": n,
                     "dp": st["carry"], "row": {
                         "t": t, "path": "sequential", "eps": current_eps,
                         "n": n, "evaluations": sample.nr_evaluations,
                         "acceptance_rate": sample.acceptance_rate,
                         "batch": samp.last_batch,
                         "round_graph": sample.round_graph,
                         "round_replays": sample.round_replays,
                         "cdf_builds": sample.cdf_builds,
                         "sample_s": time.perf_counter() - mark,
                         "kde_launches": (weighted_kde_logpdf_cuda.launches
                                          - launches0),
                         "kde_support": ([_pdf_support_rows(p)
                                          for p in params["transition"]]
                                         if t > 0 else []),
                         "records": sample.n_recorded,
                         "record_batches": sample.n_record_batches,
                         "refit_s": self._refit_s, **self._distance_row,
                         **sample.round_clock}}
            wire = sample.take_pending_wire()
            if wire is not None:
                ready = sample.pending_ready
                entry["ticket"] = ingest.submit(
                    lambda: split_single_wire(fetch_to_host(wire, ready), n),
                    label=f"gen@t={t}")
            else:
                # the records needed the rows on the host already
                entry["kind"] = "pop"
                entry["pop"] = sample.get_accepted_population(n)
            inflight.append(entry)
            st["t_disp"] = t + 1
            return True

        def harvest_block(blk: dict) -> List[dict]:
            rows = []
            blk["lanes"] = []
            rounds_seen = 0
            base_sims = st["total_sims"]
            try:
                for k in range(blk["K"]):
                    t_k = blk["t0"] + k
                    with _spans.span("pipeline.harvest", gen=t_k, k=k):
                        payload, count_k, rounds_k, eps_raw = \
                            blk["stream"].result()
                    rounds_seen += rounds_k
                    if count_k < blk["n"]:
                        logger.info("pipelined block undershot at t=%d "
                                    "(%d/%d accepted): sequential fallback",
                                    t_k, count_k, blk["n"])
                        st["fallback"] = True
                        break
                    got = self._append_device_generation(
                        t_k, payload, count_k, rounds_k, eps_raw, blk["B"],
                        blk["n"], blk["infos"][k], "pipelined", blk["lazy"])
                    if got is None:
                        st["fallback"] = True
                        break
                    pop_k, alive, row = got
                    rows.append(row)
                    blk["lanes"].append(blk["stream"].lanes)
                    st["t"] = t_k + 1
                    st["last_pop"] = pop_k
                    st["stop"] = self._stop_after(
                        row["eps"], alive, row["acceptance_rate"],
                        base_sims + rounds_seen * blk["B"],
                        max_total_nr_simulations)
                    if st["stop"]:
                        break
            finally:
                # every generation of a harvested block ran: its rounds
                # count (an abandoned speculative block's never do)
                blk["stream"].abandon()
                sims = sum(i["rounds"] for i in blk["infos"]) * blk["B"]
                st["total_sims"] += sims
                samp.nr_evaluations_ += sims
            if rows:
                complete = len(rows) == blk["K"]
                with _spans.span("pipeline.decode", gen=st["t"]):
                    st["last_dp"] = (_precision.decode_carry(
                        blk["carry_out"], self._carry_precision())
                        if complete else None)
                    if complete and mode["adaptive"]:
                        # pre-seed the host weight schedule with the
                        # in-block refit for t0 + K: a later sequential
                        # generation runs under the fused chain's weights
                        self.distance_function.weights[
                            blk["t0"] + blk["K"]] = \
                            blk["carry_out"]["dist_w"].cpu().numpy().astype(
                                np.float32)
            return rows

        def harvest_sequential(blk: dict) -> List[dict]:
            row = blk["row"]
            if blk["kind"] == "seq":
                with _spans.span("pipeline.harvest", gen=row["t"], k=1):
                    gens, _, _, _ = blk["ticket"].result()
                pop = batch_to_population(gens[0])
                if pop is None:
                    logger.warning("pipelined sequential generation at t=%d "
                                   "produced degenerate weights", row["t"])
                    st["fallback"] = True
                    return []
            else:
                pop = blk["pop"]
            append_mark = time.perf_counter()
            with _spans.span("gen.append", gen=row["t"]):
                self.history.append_population(
                    row["t"], row["eps"], pop, row["evaluations"], names,
                    self._param_names(), stat_spec=self.spec.shapes)
            row["append_s"] = time.perf_counter() - append_mark
            row["ess"] = float(effective_sample_size(pop.weight))
            logger.info("t: %d, acceptance rate: %.4g, ESS: %.4g, evals: %d",
                        row["t"], row["acceptance_rate"], row["ess"],
                        row["evaluations"])
            st["t"] = row["t"] + 1
            st["last_pop"] = pop
            st["last_dp"] = blk["dp"]
            st["stop"] = self._stop_after(
                row["eps"], pop.nr_of_models_alive(), row["acceptance_rate"],
                st["total_sims"], max_total_nr_simulations)
            return [row]

        def harvest_one():
            blk = inflight.popleft()
            st["fallback"] = False
            rows = (harvest_block(blk) if blk["kind"] == "block"
                    else harvest_sequential(blk))
            if rows:
                now = time.perf_counter()
                wall = (now - st["gen_mark"]) / len(rows)
                st["gen_mark"] = now
                tr = transfer.delta(st["tr_mark"])
                st["tr_mark"] = transfer.snapshot()
                at_scale = blk["n"] > self.PROBE_MIN_POP
                if blk["kind"] != "block":
                    if blk["t0"] > 0:
                        self._note_sequential_gen_s(wall)
                elif (at_scale and blk["K"] > 1
                        and self._engine_choice is None):
                    self._decide_engine(wall)
                peak = None
                if on_card:
                    peak = torch.cuda.max_memory_allocated(self.device) / 1e9
                    torch.cuda.reset_peak_memory_stats(self.device)
                for row in rows:
                    row.update({"engine": (self._engine_choice if at_scale
                                           else None),
                                "wall_s": wall, "peak_mem_gb": peak})
                    if blk["kind"] == "block":
                        row["sample_s"] = blk["dispatch_s"] / len(rows)
                if blk["kind"] == "block":
                    self._observe_device_rows(rows, tr, blk["lanes"])
                else:
                    # the sampler observed its own rate
                    self._record(rows[0], tr)
                    self._publish_fleet()
            if st["fallback"] or st["stop"]:
                rewind_to_frontier()

        depth_cap = max(self.ingest_depth, 1)
        if on_card:
            torch.cuda.reset_peak_memory_stats(self.device)
        try:
            while st["t"] < t_max and st["stop"] is None:
                if stop_requested():
                    # drain what is in flight (its device work is done),
                    # then exit between generations
                    while inflight and st["stop"] is None:
                        harvest_one()
                    if st["stop"] is None:
                        st["stop"] = "Stopping: operator stop requested"
                    break
                if st["carry"] is None and not inflight:
                    if not sequential_gen():
                        break
                    continue
                while (st["carry"] is not None
                       and len(inflight) < depth_cap
                       and st["total_sims"] < max_total_nr_simulations
                       and dispatch_block()):
                    pass
                if inflight:
                    harvest_one()
                elif st["carry"] is not None:
                    break  # the dispatch frontier reached t_max
        finally:
            ingest.close()  # abandons anything still in flight
        if st["stop"]:
            logger.info(st["stop"])
            self.stop_reason = st["stop"]
        # keep the device chain hot for a later run() continuation
        self._fused_carry = st["carry"] if st["stop"] is None else None

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
        self._end_distance_refit(t0, refit_mark)

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
        self._end_distance_refit(t0, refit_mark)
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

    def _configure_telemetry(self):
        """Arm the span tracer for this run: an explicit ``trace_path``
        wins, else ``$PYABC_TPU_TRACE`` (no-op when neither is set — the
        tracer stays a one-boolean no-op).  With ``$PYABC_TPU_RUN_DIR``
        set, the run publishes fleet snapshots and spans there
        (``telemetry/aggregate.py``); else ``self._fleet`` is None.  The
        flight recorder is pointed at this run's identity and timeline
        so a dump from any trigger site carries the run context."""
        if self.trace_path:
            _spans.TRACER.configure(trace_path=self.trace_path)
        else:
            _spans.TRACER.configure_from_env()
        self._fleet = _aggregate.publisher_from_env()
        _flight.RECORDER.set_timeline(self.timeline)
        if self.history is not None:
            _flight.RECORDER.set_run_id(getattr(self.history, "id", None))

    def run(self, minimum_epsilon: float = 0.0,
            max_nr_populations: Union[int, float] = np.inf,
            min_acceptance_rate: float = 0.0,
            max_total_nr_simulations: Union[int, float] = np.inf
            ) -> History:
        if self.history is None:
            raise RuntimeError("call new(db, observed) or load(db) first")
        self._configure_telemetry()
        # every rank of a multi-rank run computes the replicated carry
        # itself, so every rank must compute the same bits: kernels with
        # an order-dependent float reduction (``index_add_`` on the card)
        # take their deterministic forms for the run
        determinism = contextlib.ExitStack()
        if world_size() > 1:
            determinism.enter_context(deterministic_kernels())
        # the run span covers everything (calibration included); flushed
        # in the finally so a crashed run still leaves a loadable trace
        run_span = _spans.run_span(path=self.ingest_mode)
        try:
            with run_span:
                return self._run_master(
                    minimum_epsilon, max_nr_populations,
                    min_acceptance_rate, max_total_nr_simulations)
        except BaseException as err:
            # crash evidence before unwind (RetryExhausted already dumped
            # at its raise site; this adds the run-level context)
            _flight.RECORDER.dump(reason=type(err).__name__)
            raise
        finally:
            if self._lazy_active:
                # error-unwind safety net: anchor resident summary rows
                # newest-first (no-op after a clean done())
                try:
                    self.history.persist_lazy_tail()
                except Exception:
                    logger.exception("lazy-tail persist at run exit "
                                     "failed")
            determinism.close()
            self._attach_pack_s()
            _spans.TRACER.flush()
            self._publish_fleet(force=True)
            if len(self.timeline):
                logger.debug("generation timeline:\n%s",
                             self.timeline.render_ascii())

    def _attach_pack_s(self):
        """Each timeline row's ``pack_s``: the seconds of its generation's
        PTW1 pack and CRC on the writer's path (``History.pack_s``), once
        its blobs are written (a lazy generation's at its
        materialization); ``prepacked_share`` and ``prepack_s`` where an
        eager write took blobs packed ahead of it."""
        h = self.history
        for row in self.timeline:
            for key, by_t in (("pack_s", h.pack_s),
                              ("prepacked_share", h.prepacked_share),
                              ("prepack_s", h.prepack_s)):
                if row.get("t") in by_t:
                    row[key] = by_t[row["t"]]

    def _run_master(self, minimum_epsilon, max_nr_populations,
                    min_acceptance_rate, max_total_nr_simulations
                    ) -> History:
        self.max_nr_populations = max_nr_populations
        self.minimum_epsilon = minimum_epsilon
        self.min_acceptance_rate = min_acceptance_rate
        self.stop_reason = None
        self.timeline.stop_reason = None
        self.timeline.history_mode = self.history_mode
        self.run_dispatches = 0
        self.control_roundtrip_s = 0.0
        self._compile_mark = compile_counters()

        t0 = self.history.max_t + 1
        with _spans.span("calibrate", gen=t0):
            self._fit_transitions(t0)
            self._adapt_population_size(t0)
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
        # (a multi-rank run keeps the stats on the wire, as the JAX
        # package's multi-host runs do: ``pyabc_tpu/smc.py:3064-3067``)
        records_cover_refit = (self.sampler.record_rejected
                               and self.max_nr_recorded_particles > 0
                               and world_size() == 1)
        self.sampler.fetch_stats = (
            self.stores_sum_stats
            or (self._distance_is_adaptive() and not records_cover_refit))
        # the sequential loop's bar is the sampler's: it reads the count
        self.sampler.show_progress = self.show_progress

        t = t0
        t_max = (t0 + max_nr_populations
                 if np.isfinite(max_nr_populations) else np.inf)
        if self._overlap_enabled():
            try:
                self._run_pipelined(t0, t_max, max_total_nr_simulations)
            except _retry.RetryExhausted as err:
                # everything durable is per generation: drop to the
                # sequential loop and resume from the History frontier
                logger.warning(
                    "pipelined dispatch failed after retries (%s): "
                    "falling back to the sequential ingest path", err)
                self._fault_sequential_only = True
                _retry.record_degrade("sequential_only")
                self._fused_carry = None
                if self._lazy_active:
                    # summary rows whose generations the failed pipeline
                    # still held are anchored before the restart reads
                    # max_t
                    self.history.flush_lazy()
                # the restart runs what is left of this run's generations
                # (the JAX package's restart asks for all of them again)
                left = max_nr_populations - (self.history.max_t + 1 - t0)
                return self._run_master(
                    minimum_epsilon, left, min_acceptance_rate,
                    max_total_nr_simulations)
            self.timeline.stop_reason = self.stop_reason
            self.history.done()
            return self.history
        total_sims = 0
        gen_mark = time.perf_counter()
        tr_mark = transfer.snapshot()
        launches_mark = weighted_kde_logpdf_cuda.launches
        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats(self.device)
        model_names = [m.name for m in self.models]
        # the lazy History's sequential deposit needs the rows on the
        # card; an adaptive refit reads them on the host
        defer = self._lazy_active and not self._distance_is_adaptive()
        ckpt_every = self.checkpoint_every_rounds
        if ckpt_every:
            # SIGTERM -> flag; the sampler flushes its ledger at the next
            # call boundary and raises Preempted
            _ckpt.install_signal_handlers()
        while t < t_max:
            # operator clean-stop (parallel.health.request_stop): exit
            # between generations; the History frontier is durable, so a
            # later run() resumes here
            if stop_requested():
                self.stop_reason = "Stopping: operator stop requested"
                logger.info(self.stop_reason)
                break
            if _ckpt.preempt_requested():
                # the signal arrived between generations: nothing is in
                # flight and the History frontier is durable
                self.stop_reason = "Stopping: preemption requested (SIGTERM)"
                logger.info(self.stop_reason)
                break
            # one dispatch for the rest of the run: the device checks the
            # stop chain itself and t_limit clips the dispatch
            if (self._onedispatch_eligible()
                    and self._fused_carry is not None):
                written, sims, stop_reason = self._run_onedispatch(
                    t, t_max, total_sims, max_total_nr_simulations)
                total_sims += sims
                launches_mark = weighted_kde_logpdf_cuda.launches
                if written:
                    t += written
                    gen_mark = time.perf_counter()
                    tr_mark = transfer.snapshot()
                    if on_card:
                        torch.cuda.reset_peak_memory_stats(self.device)
                if stop_reason is not None:
                    self.stop_reason = stop_reason
                    logger.info(stop_reason)
                    break
                if written:
                    continue
                # nothing written: the sequential engine takes t
            # a fused block only when all K generations fit before t_max:
            # a block always runs K, the tail would be discarded work
            if (self._fused_eligible() and self._fused_carry is not None
                    and t + self.fuse_generations <= t_max):
                written, sims, stop_reason = self._run_fused_block(
                    t, t_max, total_sims, max_total_nr_simulations)
                total_sims += sims
                # the block's launches are on its `blocks` entry (a block
                # that wrote nothing leaves its wall in the next
                # generation's: the time was spent)
                launches_mark = weighted_kde_logpdf_cuda.launches
                if written:
                    t += written
                    gen_mark = time.perf_counter()
                    tr_mark = transfer.snapshot()
                    if on_card:
                        torch.cuda.reset_peak_memory_stats(self.device)
                    if stop_reason is not None:
                        self.stop_reason = stop_reason
                        logger.info(stop_reason)
                        break
                    continue
                # nothing written: the sequential engine takes t
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
            # resume splice: rows a preempted process flushed for THIS
            # generation (only at the resume frontier)
            splice = (self._load_splice(t, current_eps)
                      if ckpt_every and t == t0 else None)
            n_req = n - (splice["n_accepted"] if splice else 0)
            sample_mark = time.perf_counter()
            if ckpt_every:
                ck = _ckpt.GenCheckpointer(self.history, t, ckpt_every,
                                           eps=current_eps)
                if splice:
                    ck.set_base(splice["batch"], splice["nr_evaluations"])
                if self._lazy_active:
                    # steady-state flushes are manifest-only rows; the raw
                    # rows ship on a preemption or with a splice base
                    ck.manifest_source = self._store.manifest
                self.sampler.checkpointer = ck
            if splice is None:
                # the eager append below is this generation's writer: a
                # sampler that fetches the rows eagerly hands over those
                # the finalize does not change, and their blobs pack
                # while the card computes the weights
                self.sampler.prepacker = functools.partial(
                    self.history.prepack, t)
            try:
                with profile_generation(t), _spans.span("gen.sample", gen=t):
                    if n_req > 0:
                        sample = self._sample_generation(
                            n_req, round_fn, params, max_eval,
                            defer=defer and splice is None)
                    else:
                        sample = Sample()  # the splice covers n already
            finally:
                self.sampler.checkpointer = None
                self.sampler.prepacker = None
            if splice is not None:
                # both halves are draws from the same proposal at the same
                # eps; the weights normalize once over the joined rows
                sample.splice_front(splice["batch"],
                                    splice["nr_evaluations"])
            sample_s = time.perf_counter() - sample_mark
            if sample.n_accepted < n:
                self.stop_reason = (
                    "Stopping: acceptance rate fell below "
                    "min_acceptance_rate (%d/%d accepted)"
                    % (sample.n_accepted, n))
                logger.info(self.stop_reason)
                break
            total_sims += sample.nr_evaluations
            acceptance_rate = sample.acceptance_rate
            append_mark = time.perf_counter()
            lazy_gen = self._lazy_active and sample.pending_wire is not None
            with _spans.span("gen.append", gen=t):
                if lazy_gen:
                    # the rows stay on the card and a summary row is
                    # appended
                    self._store.deposit(
                        t, sample.take_pending_wire(), n=n,
                        count=sample.n_accepted, eps=current_eps,
                        norm="sample", ready=sample.pending_ready)
                    self.history.append_population_lazy(
                        t, current_eps, sample.nr_evaluations,
                        summary=_wire_store.summarize_device_population(
                            sample.device_population, self.M),
                        model_names=model_names,
                        param_names=self._param_names(),
                        stat_spec=self.spec.shapes,
                        summary_grid=_wire_store.maybe_summary_grid(
                            sample.device_population))
                else:
                    with _spans.span("history.collect", gen=t):
                        population = sample.get_accepted_population(n)
                    self.history.append_population(
                        t, current_eps, population, sample.nr_evaluations,
                        model_names, self._param_names(),
                        stat_spec=self.spec.shapes,
                        prepacked=sample.prepacked)
            append_s = time.perf_counter() - append_mark
            if lazy_gen:
                # the host adaptation still needs the rows: hydrate (the
                # eager decode; the durable blobs are written on the way)
                try:
                    with _spans.span("gen.hydrate", gen=t):
                        population = self.history.hydrate_population(t)
                except IntegrityError:
                    # the recovery ladder is exhausted: degrade to eager
                    # mode and redo this generation
                    self._degrade_lazy(t)
                    defer = False
                    continue
            ess = float(effective_sample_size(population.weight))
            now = time.perf_counter()
            tr_t = transfer.delta(tr_mark)
            tr_mark = transfer.snapshot()
            self._record({
                "t": t, "path": "sequential",
                "engine": (self._engine_choice
                           if n > self.PROBE_MIN_POP else None),
                "wall_s": now - gen_mark, "sample_s": sample_s,
                "eps": current_eps, "n": n,
                "evaluations": sample.nr_evaluations,
                "acceptance_rate": acceptance_rate, "ess": ess,
                "batch": getattr(self.sampler, "last_batch", None),
                "round_graph": sample.round_graph,
                "round_replays": sample.round_replays,
                "cdf_builds": sample.cdf_builds,
                "kde_launches": (weighted_kde_logpdf_cuda.launches
                                 - launches_mark),
                "kde_support": ([_pdf_support_rows(p)
                                 for p in params["transition"]]
                                if t > 0 else []),
                "records": sample.n_recorded,
                "record_batches": sample.n_record_batches,
                "refit_s": self._refit_s, **self._distance_row,
                "adapt_s": self._adapt_s,
                "append_s": append_s, **sample.round_clock,
                "peak_mem_gb": (torch.cuda.max_memory_allocated(self.device)
                                / 1e9 if on_card else None)}, tr_t,
                accepted=sample.raw_accepted)
            self._publish_fleet()
            # the sampler observed its rate per call; the ledger's
            # compute / overlap split is seen only here
            observe_timing = getattr(self.sampler, "observe_timing", None)
            if observe_timing is not None:
                observe_timing(tr_t["compute_s"], tr_t["overlap_s"])
            # the engine probe's baseline (t = 0's prior round has no
            # refit or proposal work and would bias it low)
            if t > 0:
                self._note_sequential_gen_s(now - gen_mark)
            gen_mark = now
            launches_mark = weighted_kde_logpdf_cuda.launches
            if on_card:
                torch.cuda.reset_peak_memory_stats(self.device)
            if self._fused_eligible():
                # this generation's accepted rows stay on the device as
                # the next fused block's carry (None after a splice)
                self._fused_carry = sample.device_population
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
            with _spans.span("gen.adapt", gen=t + 1):
                self._prepare_next_iteration(t + 1, sample, population,
                                             acceptance_rate)
            t += 1
        self.timeline.stop_reason = self.stop_reason
        self.history.done()
        return self.history

    #: generation restarts allowed under graceful degradation before a
    #: retry-exhausted dispatch failure is considered fatal
    _MAX_GEN_RESTARTS = 2

    def _sample_generation(self, n_req: int, round_fn, params, max_eval,
                           defer: bool = False) -> Sample:
        """One generation's sampling with graceful degradation: a
        retry-exhausted dispatch drops the sampler one batch rung
        (``degrade_rung``) and restarts the generation from the
        generator's current state — a strictly smaller round for a
        memory-pressure failure.  At the rung floor (or after
        ``_MAX_GEN_RESTARTS`` restarts) the error propagates.  An
        abandoned attempt's evaluations are not counted."""
        restarts = 0
        while True:
            try:
                return self.sampler.sample_until_n_accepted(
                    n_req, round_fn, self.generator, params,
                    max_eval=max_eval, defer_wire_fetch=defer)
            except _retry.RetryExhausted as err:
                degrade = getattr(self.sampler, "degrade_rung", None)
                if degrade is None or restarts >= self._MAX_GEN_RESTARTS:
                    raise
                # the failed attempt's frames hold its rung's buffers and
                # graphs: let them go before the smaller round allocates
                _clear_failed_frames(err)
                new_cap = degrade()
                if new_cap is None:
                    raise  # already at the floor
                restarts += 1
                logger.warning(
                    "generation dispatch failed after retries (%s): "
                    "restarting with batch ceiling %d (restart %d/%d)",
                    err, new_cap, restarts, self._MAX_GEN_RESTARTS)

    def _load_splice(self, t: int, current_eps: float):
        """The sub-checkpoint ledger a preempted process flushed for
        generation ``t``, validated: the splice is only exact when this
        process derived the SAME eps (the schedule is deterministic from
        the last durable generation); a stale ledger is discarded."""
        row = self.history.load_sub_checkpoint(t)
        if row is None:
            return None
        eps_ck = row.get("eps")
        if eps_ck is not None and not np.isclose(
                float(eps_ck), float(current_eps), rtol=1e-6, atol=1e-12):
            logger.warning(
                "discarding the sub-checkpoint for t=%d: its eps %.8g "
                "does not match the derived schedule (%.8g)",
                t, eps_ck, current_eps)
            self.history.clear_sub_checkpoint(t)
            return None
        logger.info(
            "resuming generation %d from a sub-checkpoint: %d accepted "
            "rows (%d rounds, %d evaluations) survived the preemption",
            t, row["n_accepted"], row["rounds"], row["nr_evaluations"])
        return row

    def _degrade_lazy(self, t: int):
        """The last rung of the hydration recovery ladder: drop lazy mode
        for the rest of the run (the store's other generations are
        anchored first) and delete generation ``t``'s summary row so the
        loop redoes it eagerly."""
        logger.warning("generation %d failed checksummed hydration beyond "
                       "recovery: degrading to eager History", t)
        _retry.record_degrade("lazy_to_eager")
        try:
            self.history.flush_lazy()
        except IntegrityError:
            logger.exception("anchoring the lazy store while degrading "
                             "failed")
        self.history.drop_generation(t)
        self.history.detach_store()
        self._store = None
        self._fused_carry = None

    def _prepare_next_iteration(self, t: int, sample, population: Population,
                                acceptance_rate: float):
        """Refit the transitions and the distance, and advance acceptor
        and epsilon, from generation ``t - 1``.  When the distance's params
        change, the population's distances are re-evaluated under them —
        from the accepted stats still on the device — before the acceptor
        and epsilon see them."""
        self._fit_transitions(t, population=population)
        self._adapt_population_size(t)

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
        self._end_distance_refit(t, refit_mark)

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
