"""The study axis: many small studies driven as one batch on one card.

Port of ``pyabc_tpu/serve/multiplex.py``.  A serving fleet's traffic is
dominated by small studies: one simulator applied to many tenants'
observed data, each with its own seed and stop budget.  The JAX package
stacks such studies along a leading study axis and ``vmap``\\ s one
self-contained ABC-SMC engine over it.  Here the batch is the same
carry — every leaf with the study axis first — and the program is a
built *window* closure that advances each live lane by up to
:data:`cb_window` generations, lane by lane:

- **Draws keyed by the lane alone.**  Every draw of a lane comes from a
  ``torch.Generator`` seeded from ``(lane seed, lane generation, round,
  stream)`` through a fixed integer mix (:func:`lane_seed`), never from
  the slot, the rung or the peers.  The model is called per live lane
  with that lane's generator (a batched call with one generator would
  make a lane's draws depend on its co-tenants).  A fresh lane's
  generation-0 draw uses generation 0 of its own chain.
- **The importance-weight denominator through K1.**  The JAX package
  writes ``log Σ_j w_j N(θ_i; θ_j, diag σ²)`` inline as an ``[n, n, d]``
  expression; here it is :func:`..ops.kde.weighted_kde_logpdf_auto` with
  ``chol = diag σ`` and ``log_norm = −d/2·log 2π − Σ log σ_k`` — the
  kernel on the card, its plain version on the CPU — called once per
  live lane, so no ``[S, n, n, d]`` tensor exists.  (K1 centres both
  point sets on the support's weighted mean; the centring cancels in the
  pairwise difference.)
- **Order-stable reductions.**  The resampling CDF and the quantile's
  cumulative weights are :func:`..ops.choice.ordered_cumsum`; the
  weighted quantile sorts each lane with a stable ``argsort``.  Every op
  runs on one lane's rows, copied to a fresh allocation first, so no
  result depends on the batch's leading extent: a lane is bit-identical
  to the same study in a batch of one, on any rung.
- **Dead and retired lanes do no work.**  A padded or retired lane
  (``alive=False``) and a stopped lane are skipped.  A lane's rounds
  stop once its population is full (one count read per round); round
  ``r``'s draws depend on ``r`` alone, so this keeps the bits of the
  JAX package's ``max_rounds`` masked rounds.  The importance weights
  are computed only for a generation that filled (an undershot one is
  discarded, as in the JAX package), so K1 runs once per lane and
  successful generation.

Between windows the host retires lanes that stopped, publishes them, and
admits queued same-``batch_key`` studies into the freed slots; a fresh
lane (``gens == 0``) runs its generation-0 init inside the window, so
admission at any boundary re-enters the same built program.
``program_cache`` maps ``(batch_key, rung, window, max_rounds, device)``
to that program; a build counts ``xla_compiles_total`` (``autotune.ladder``), a
turnover counts nothing.  :class:`ShapeHysteresis` keeps an underfilled
batch on its rung until it has fit a smaller one for N windows, and
:meth:`StudyBatch.shrink` transplants live lanes through
:func:`..sampler.fused.lane_extract` / ``lane_splice``.

Those three — the rung in the program key, the worker's program pool
and the hysteresis with its shrink — are parity shims here.  In the JAX
package they save XLA compiles of a ``vmap``\\ ped program whose cost
grows with the rung; here a build is a Python closure that does not
depend on the rung, and a padded lane is skipped, so a shrink changes
no work and "zero builds" counts dictionary hits.  They keep the JAX
package's interface and counters until a lane-batched window (ROADMAP
Queue 2b) makes the rung matter.

The carry: ``theta [S, n, d]``, ``w [S, n]``, ``dist [S, n]`` on the
batch's device; the lane control ``eps, gens, live, code, acc_tot,
rounds_tot`` (``[S]`` each) on the host, where the window loop reads
them.

Knobs: ``PYABC_TPU_SERVE_MULTIPLEX`` (max studies per batch, default 8;
``1`` disables the study axis), ``PYABC_TPU_SERVE_MULTIPLEX_MAX_POP``
(largest population on the study axis, default 4096),
``PYABC_TPU_SERVE_CB`` (the worker's continuous batching, default on),
``PYABC_TPU_SERVE_CB_WINDOW`` (generations per window, default 8) and
``PYABC_TPU_SERVE_CB_SHRINK_AFTER`` (underfilled windows before a
shrink, default 4).  :func:`lane_eligible` routes a spec from its
content and the worker's environment alone.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, List, MutableMapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..autotune.ladder import record_build
from ..device import resolve_device
from ..ops.choice import ordered_cumsum
from ..ops.kde import NEG_BIG, weighted_kde_logpdf_auto
from ..sampler.fused import lane_extract, lane_splice
from .spec import (StudySpec, _callable_fingerprint, _digest_of,
                   _prior_config)

#: max studies fused per batch (1 disables the study axis)
MULTIPLEX_ENV = "PYABC_TPU_SERVE_MULTIPLEX"

#: largest population_size routed onto the study axis
MULTIPLEX_MAX_POP_ENV = "PYABC_TPU_SERVE_MULTIPLEX_MAX_POP"

#: the worker's continuous-batching window loop (default on; "0"
#: restores drain-at-batch-end static batching)
CB_ENV = "PYABC_TPU_SERVE_CB"

#: generations per window: the lane join/leave granularity
CB_WINDOW_ENV = "PYABC_TPU_SERVE_CB_WINDOW"

#: consecutive underfilled windows before the batch shrinks its rung
CB_SHRINK_AFTER_ENV = "PYABC_TPU_SERVE_CB_SHRINK_AFTER"

_DEFAULT_MULTIPLEX = 8
_DEFAULT_MAX_POP = 4096
_DEFAULT_CB_WINDOW = 8
_DEFAULT_CB_SHRINK_AFTER = 4

#: rejection rounds per generation before a lane declares undershoot
_MAX_ROUNDS = 16

#: stop codes, mirrored in result dicts
STOP_RUNNING = 0
STOP_MIN_EPS = 1
STOP_BUDGET = 2
STOP_UNDERSHOOT = 3

#: stop-code -> reason string (summary schema parity with solo runs)
STOP_NAMES = ("running", "min_eps", "budget", "undershoot")

#: the draw streams of a lane: per generation and round the ancestor
#: uniforms, the perturbation normals and the model; at generation 0 the
#: prior draw and its model call
STREAM_UNIFORM, STREAM_NORMAL, STREAM_MODEL = 0, 1, 2
STREAM_PRIOR0, STREAM_MODEL0 = 3, 4

_MASK64 = (1 << 64) - 1


def multiplex_width() -> int:
    try:
        return max(int(os.environ.get(MULTIPLEX_ENV,
                                      str(_DEFAULT_MULTIPLEX))), 1)
    except ValueError:
        return _DEFAULT_MULTIPLEX


def multiplex_max_pop() -> int:
    try:
        return max(int(os.environ.get(MULTIPLEX_MAX_POP_ENV,
                                      str(_DEFAULT_MAX_POP))), 1)
    except ValueError:
        return _DEFAULT_MAX_POP


def cb_enabled() -> bool:
    """``$PYABC_TPU_SERVE_CB`` — default ON."""
    return os.environ.get(CB_ENV, "1").lower() not in (
        "0", "false", "no", "off")


def cb_window() -> int:
    """``$PYABC_TPU_SERVE_CB_WINDOW`` — generations per window."""
    try:
        return max(int(os.environ.get(CB_WINDOW_ENV,
                                      str(_DEFAULT_CB_WINDOW))), 1)
    except ValueError:
        return _DEFAULT_CB_WINDOW


def cb_shrink_after() -> int:
    """``$PYABC_TPU_SERVE_CB_SHRINK_AFTER`` — hysteresis depth."""
    try:
        return max(int(os.environ.get(CB_SHRINK_AFTER_ENV,
                                      str(_DEFAULT_CB_SHRINK_AFTER))),
                   1)
    except ValueError:
        return _DEFAULT_CB_SHRINK_AFTER


def lane_eligible(spec: StudySpec) -> bool:
    """Does this spec's content route it onto the study axis?  True when
    multiplexing is enabled and the population fits the lane engine.
    Reads only the spec and the worker's environment."""
    return (multiplex_width() > 1
            and int(spec.population_size) <= multiplex_max_pop())


def _pow2_ceil(x: int) -> int:
    r = 1
    while r < x:
        r *= 2
    return r


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def lane_seed(seed: int, gen: int, rnd: int, stream: int) -> int:
    """The seed of one lane's draw stream: a fixed integer mix of the
    lane's seed, its generation, the round and the stream."""
    h = 0
    for v in (seed, gen, rnd, stream):
        h = _splitmix64(h ^ (int(v) & _MASK64))
    return h & ((1 << 63) - 1)


def lane_generator(device: torch.device, seed: int, gen: int, rnd: int,
                   stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(lane_seed(seed, gen, rnd, stream))
    return g


def _stat_layout(observed: Dict) -> Tuple[Tuple[str, int], ...]:
    """Flattened stat layout in canonical (sorted-key) order."""
    return tuple(
        (k, int(np.asarray(observed[k]).size)) for k in sorted(observed))


def batch_key(spec: StudySpec) -> str:
    """What the built batch program depends on: the grouping key for
    :func:`multiplex_eligible`.  Observed values are per-study operands;
    only their flattened layout is shape."""
    return _digest_of({
        "model": _callable_fingerprint(spec.model),
        "prior": _prior_config(spec.prior),
        "layout": list(_stat_layout(spec.observed)),
        "population_size": int(spec.population_size),
        "distance_p": float(spec.distance_p),
        "alpha": float(spec.alpha),
        "min_acceptance_rate": float(spec.min_acceptance_rate),
    })


def multiplex_eligible(specs: Sequence[StudySpec],
                       max_batch: Optional[int] = None
                       ) -> List[List[StudySpec]]:
    """Group studies into batches that can share one program, in
    submission order, capped at the multiplex width (singleton groups
    included)."""
    cap = multiplex_width() if max_batch is None else max(int(max_batch), 1)
    groups: "Dict[str, List[StudySpec]]" = {}
    order: List[str] = []
    for s in specs:
        k = batch_key(s)
        if k not in groups:
            groups[k] = []
            order.append(k)
        groups[k].append(s)
    out: List[List[StudySpec]] = []
    for k in order:
        g = groups[k]
        for i in range(0, len(g), cap):
            out.append(g[i:i + cap])
    return out


def _flatten_stats(stats: Dict, layout, n: int) -> torch.Tensor:
    cols = [torch.reshape(torch.as_tensor(stats[k]), (n, -1))
            for k, _w in layout]
    return torch.cat(cols, dim=-1).to(torch.float32)


def _flatten_observed(observed: Dict, layout) -> np.ndarray:
    cols = [np.asarray(observed[k], dtype=np.float32).reshape(-1)
            for k, _w in layout]
    return np.concatenate(cols) if cols else np.zeros((0,), np.float32)


class ShapeHysteresis:
    """Batch-shape hysteresis for the continuous-batching loop: the
    worker calls :meth:`observe` once per window after a refill; only
    when the occupancy has fit a strictly smaller rung for
    ``shrink_after`` consecutive windows does it return True."""

    def __init__(self, shrink_after: Optional[int] = None):
        self.shrink_after = (cb_shrink_after() if shrink_after is None
                             else max(int(shrink_after), 1))
        self.streak = 0

    def observe(self, occupied: int, rung: int) -> bool:
        """Record one post-refill window; True == shrink now."""
        if rung > 1 and occupied > 0 and _pow2_ceil(occupied) < rung:
            self.streak += 1
        else:
            self.streak = 0
        if self.streak >= self.shrink_after:
            self.streak = 0
            return True
        return False


class _LaneEngine:
    """The per-lane SMC engine of one batch key: generation 0 and one
    generation of a lane, on that lane's rows alone."""

    def __init__(self, batch: "StudyBatch"):
        self.model = batch.model
        self.prior = batch.prior
        self.n, self.d = batch.n, batch.d
        self.layout = batch.layout
        self.p, self.alpha = batch.p, batch.alpha
        self.max_rounds = batch.max_rounds
        self.device = batch.device
        self.log_norm0 = -0.5 * self.d * math.log(2.0 * math.pi)

    def distance(self, x, y_obs):
        diff = torch.abs(x - y_obs)
        if self.p == 2.0:
            return torch.sqrt(torch.sum(diff * diff, dim=-1))
        return torch.sum(diff ** self.p, dim=-1) ** (1.0 / self.p)

    def weighted_quantile(self, dist, w):
        order = torch.argsort(dist, stable=True)
        cw = ordered_cumsum(w[order])
        idx = torch.searchsorted(cw, self.alpha * cw[-1:])
        return dist[order[torch.clamp(idx, max=self.n - 1)]][0]

    def init(self, seed: int, y_obs):
        """Generation 0: a prior draw, uniform weights."""
        n, dev = self.n, self.device
        theta0 = self.prior.rvs_array(
            lane_generator(dev, seed, 0, 0, STREAM_PRIOR0), n)
        x0 = _flatten_stats(self.model(
            lane_generator(dev, seed, 0, 0, STREAM_MODEL0), theta0),
            self.layout, n)
        dist0 = self.distance(x0, y_obs)
        w0 = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
        return theta0.to(torch.float32), w0, dist0

    def gen_step(self, seed: int, t: int, theta, w, dist, y_obs):
        """One generation: shrink eps to the weighted alpha-quantile of
        the previous distances, then fill n slots by importance
        resampling and Gaussian perturbation over at most ``max_rounds``
        rounds of n candidates.  Returns ``(success, eps_t, theta, w,
        dist, rounds)`` (the population only on success)."""
        n, d, dev = self.n, self.d, self.device
        eps_t = self.weighted_quantile(dist, w)
        sigma = self.kernel_scale(theta, w)
        cw = ordered_cumsum(w)
        o_theta = torch.zeros(n + 1, d, dtype=torch.float32, device=dev)
        o_dist = torch.zeros(n + 1, dtype=torch.float32, device=dev)
        filled = torch.zeros((), dtype=torch.int64, device=dev)
        rounds = 0
        for r in range(self.max_rounds):
            if rounds and int(filled) >= n:
                break
            u = torch.rand(n, generator=lane_generator(
                dev, seed, t, r, STREAM_UNIFORM), device=dev)
            anc = torch.clamp(torch.searchsorted(cw, u * cw[-1], right=True),
                              max=n - 1)
            step = torch.randn(n, d, generator=lane_generator(
                dev, seed, t, r, STREAM_NORMAL), device=dev) * sigma
            theta_star = theta[anc] + step
            ok_prior = self.prior.log_pdf_array(theta_star) > -math.inf
            x = _flatten_stats(self.model(lane_generator(
                dev, seed, t, r, STREAM_MODEL), theta_star), self.layout, n)
            dist_star = self.distance(x, y_obs)
            acc = ok_prior & (dist_star <= eps_t)
            acc_i = acc.to(torch.int64)
            pos = filled + torch.cumsum(acc_i, 0) - 1
            slot = torch.where(acc & (pos < n), pos, torch.full_like(pos, n))
            o_theta[slot] = theta_star
            o_dist[slot] = dist_star
            filled = torch.clamp(filled + acc_i.sum(), max=n)
            rounds += 1
        success = int(filled) >= n
        if not success:
            return False, eps_t, None, None, None, rounds
        new_theta, new_dist = o_theta[:n], o_dist[:n]
        new_w = self.importance_weights(new_theta, theta, w, sigma)
        return True, eps_t, new_theta, new_w, new_dist, rounds

    @staticmethod
    def kernel_scale(theta, w):
        """The perturbation kernel's per-dimension scale: twice the
        weighted variance, square-rooted."""
        mu = torch.sum(w[:, None] * theta, dim=0)
        var = torch.sum(w[:, None] * (theta - mu) ** 2, dim=0)
        return torch.sqrt(torch.clamp(2.0 * var, min=1e-12))

    def importance_weights(self, new_theta, theta, w, sigma):
        """Normalized weights ``prior(θ_i) / Σ_j w_j N(θ_i; θ_j, σ²)``
        (σ diagonal) in log space, the denominator through K1 (one
        launch on the card)."""
        log_prior = self.prior.log_pdf_array(new_theta)
        log_den = weighted_kde_logpdf_auto(
            new_theta, theta, torch.clamp(torch.log(w), min=NEG_BIG),
            torch.diag(sigma), self.log_norm0 - torch.log(sigma).sum())
        log_w = log_prior - log_den
        return torch.exp(log_w - torch.logsumexp(log_w, dim=0))


def build_window(batch: "StudyBatch"):
    """The window program of ``batch``'s key, rung and window: a closure
    ``(seeds, y_obs, min_eps, t_limit, alive, carry) -> carry`` that runs
    each live lane's generation-0 init (fresh lanes) and up to
    ``window`` generations.  Lanes never share an op."""
    eng = _LaneEngine(batch)
    n, window = batch.n, batch.window

    def run_window(seeds, y_obs, min_eps, t_limit, alive, carry):
        theta, w, dist = (leaf.clone() for leaf in carry[:3])
        eps, gens, live, code, acc_tot, rounds_tot = (
            leaf.clone() for leaf in carry[3:])
        for s in range(theta.shape[0]):
            if not alive[s]:
                continue
            seed = int(seeds[s])
            # each lane computes on fresh copies of its own rows
            th, ww, dd = theta[s].clone(), w[s].clone(), dist[s].clone()
            yo = y_obs[s].clone()
            if int(gens[s]) == 0:
                th, ww, dd = eng.init(seed, yo)
                live_f = int(t_limit[s]) > 1
                eps[s] = math.inf
                gens[s] = 1
                live[s] = live_f
                code[s] = STOP_RUNNING if live_f else STOP_BUDGET
                acc_tot[s] = n
                rounds_tot[s] = 0
            for _ in range(window):
                if not bool(live[s]):
                    break
                success, eps_t, n_th, n_w, n_d, rounds = eng.gen_step(
                    seed, int(gens[s]), th, ww, dd, yo)
                rounds_tot[s] += rounds
                if not success:
                    code[s] = STOP_UNDERSHOOT
                    live[s] = False
                    break
                th, ww, dd = n_th, n_w, n_d
                eps[s] = eps_t.to("cpu")
                gens[s] += 1
                acc_tot[s] += n
                if bool(eps[s] <= min_eps[s]):
                    code[s], live[s] = STOP_MIN_EPS, False
                elif int(gens[s]) >= int(t_limit[s]):
                    code[s], live[s] = STOP_BUDGET, False
            theta[s], w[s], dist[s] = th, ww, dd
        return (theta, w, dist, eps, gens, live, code, acc_tot, rounds_tot)

    return run_window


class StudyBatch:
    """One batch of eligible studies driven by one built window program
    (module docstring for the engine and its determinism contract).

    The unit of dispatch is a window of :attr:`window` generations; lanes
    are retired (:meth:`retire`) and admitted (:meth:`admit`) between
    windows.  :meth:`run` is the static driver.  ``program_cache``
    (caller-owned; the worker passes its LRU) maps :attr:`program_key` to
    the built window program, so a warm worker re-serves a seen (batch
    key, rung, window) without building.  ``device`` is the card unless
    the caller passes ``"cpu"``."""

    def __init__(self, specs: Sequence[StudySpec],
                 max_rounds: int = _MAX_ROUNDS,
                 program_cache: Optional[MutableMapping] = None,
                 window: Optional[int] = None, device=None):
        if not specs:
            raise ValueError("empty study batch")
        keys = {batch_key(s) for s in specs}
        if len(keys) > 1:
            raise ValueError("studies are not batch-eligible together")
        self.key = keys.pop()
        self.specs = list(specs)
        spec = self.specs[0]
        self.device = resolve_device(device)
        self.model = spec.model
        self.prior = spec.prior
        self.n = int(spec.population_size)
        self.d = int(spec.prior.dim)
        self.layout = _stat_layout(spec.observed)
        self.k = sum(w for _k, w in self.layout)
        self.p = float(spec.distance_p)
        self.alpha = float(spec.alpha)
        self.max_rounds = int(max_rounds)
        self.rung = _pow2_ceil(len(self.specs))
        self.window = (cb_window() if window is None
                       else max(int(window), 1))
        # the largest generation budget admitted so far: the static
        # driver's window-count bound (never shapes the program)
        self.max_t = max(max(int(s.max_generations), 1)
                         for s in self.specs)
        self.program_key = (self.key, self.rung, self.window,
                            self.max_rounds, str(self.device))
        self.program_cache_hit = False
        fn = (None if program_cache is None
              else program_cache.get(self.program_key))
        if fn is None:
            t0 = time.perf_counter()
            fn = build_window(self)
            record_build(time.perf_counter() - t0)
            if program_cache is not None:
                program_cache[self.program_key] = fn
        else:
            self.program_cache_hit = True
        self._fn = fn
        # ---- lane state: per-slot operands on the host, the carry
        S = self.rung
        self.slots: List[Optional[StudySpec]] = [None] * S
        self._seeds = np.zeros((S,), np.int64)
        self._y_obs = torch.zeros((S, self.k), dtype=torch.float32,
                                  device=self.device)
        self._min_eps = torch.zeros((S,), dtype=torch.float32)
        self._t_limit = np.ones((S,), np.int64)
        self._alive = np.zeros((S,), bool)
        self._carry = self._zero_carry()
        self.windows = 0
        self.turnovers = 0
        self.admitted = 0
        for s in self.specs:
            self.admit(s)

    def trace_info(self) -> dict:
        """The batch attributes a lifecycle ``batched`` event carries."""
        return {
            "batch_key": str(self.key)[:12],
            "width": self.occupied(),
            "rung": self.rung,
            "window": self.window,
            "program_cache_hit": self.program_cache_hit,
        }

    # ---- lane surgery (between windows) ---------------------------------

    def _zero_carry(self) -> tuple:
        S, n, d, dev = self.rung, self.n, self.d, self.device
        f32, i32 = torch.float32, torch.int32
        return (torch.zeros((S, n, d), dtype=f32, device=dev),  # theta
                torch.zeros((S, n), dtype=f32, device=dev),     # w
                torch.zeros((S, n), dtype=f32, device=dev),     # dist
                torch.zeros((S,), dtype=f32),                   # eps
                torch.zeros((S,), dtype=i32),                   # gens
                torch.zeros((S,), dtype=torch.bool),            # live
                torch.zeros((S,), dtype=i32),                   # stop code
                torch.zeros((S,), dtype=i32),                   # accepted
                torch.zeros((S,), dtype=i32))                   # rounds

    def occupied(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def occupancy(self) -> float:
        """Occupied fraction of the rung: the batch-utilization gauge."""
        return self.occupied() / self.rung

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def unfinished(self) -> List[int]:
        """Occupied slots that have not stopped yet (not dispatched, or
        still live)."""
        gens, live = self._carry[4], self._carry[5]
        return [i for i, s in enumerate(self.slots)
                if s is not None and (int(gens[i]) == 0 or bool(live[i]))]

    def admit(self, spec: StudySpec, slot: Optional[int] = None) -> int:
        """Seat a study in a free lane: its seed and operands, carry rows
        zeroed so the next window runs its generation-0 init.  Returns the
        slot index."""
        if batch_key(spec) != self.key:
            raise ValueError("spec is not batch-eligible here")
        if slot is None:
            free = self.free_slots()
            if not free:
                raise ValueError("no free lane")
            slot = free[0]
        elif self.slots[slot] is not None:
            raise ValueError(f"slot {slot} is occupied")
        self.slots[slot] = spec
        self._seeds[slot] = int(spec.seed)
        self._y_obs[slot] = torch.as_tensor(
            _flatten_observed(spec.observed, self.layout),
            device=self.device)
        self._min_eps[slot] = float(spec.minimum_epsilon)
        self._t_limit[slot] = max(int(spec.max_generations), 1)
        self._alive[slot] = True
        self.max_t = max(self.max_t, int(self._t_limit[slot]))
        zero_row = tuple(torch.zeros_like(leaf[0]) for leaf in self._carry)
        self._carry = lane_splice(self._carry, slot, zero_row)
        self.admitted += 1
        return slot

    def retire(self, slot: int) -> None:
        """Free a finished lane (read :meth:`result` first)."""
        if self.slots[slot] is None:
            raise ValueError(f"slot {slot} is not occupied")
        self.slots[slot] = None
        self._alive[slot] = False
        self.turnovers += 1

    def step_window(self) -> List[int]:
        """Run one window and return the occupied slots that have now
        stopped (retire or re-admit them before the next call)."""
        self._carry = self._fn(self._seeds, self._y_obs, self._min_eps,
                               self._t_limit, self._alive, self._carry)
        self.windows += 1
        gens, live = self._carry[4], self._carry[5]
        return [i for i, s in enumerate(self.slots)
                if s is not None and int(gens[i]) > 0 and not bool(live[i])]

    def result(self, slot: int) -> dict:
        """One lane's result dict (host numpy), sliced from the carry."""
        if self.slots[slot] is None:
            raise ValueError(f"slot {slot} is not occupied")
        (theta, w, dist, eps, gens, live, code, acc_tot,
         rounds_tot) = (leaf.cpu().numpy()
                        for leaf in lane_extract(self._carry, slot))
        # a lane cut off while still live stopped on the driver's window
        # budget, not its own: a budget stop
        code = np.int32(STOP_BUDGET) if live else code
        return {
            "theta": theta, "w": w, "dist": dist, "eps": eps,
            "gens": gens, "stop_code": code, "accepted": acc_tot,
            "rounds": rounds_tot,
        }

    def shrink(self, program_cache: Optional[MutableMapping] = None
               ) -> Tuple["StudyBatch", Dict[int, int]]:
        """A new batch at the pow2 rung of the current occupancy, every
        occupied lane's carry transplanted row by row, so in-flight lanes
        re-enter mid-run.  Returns ``(new_batch, {old_slot: new_slot})``."""
        occ = [(i, s) for i, s in enumerate(self.slots)
               if s is not None]
        if not occ:
            raise ValueError("nothing to shrink")
        nb = StudyBatch([s for _i, s in occ],
                        max_rounds=self.max_rounds,
                        program_cache=program_cache,
                        window=self.window, device=self.device)
        slot_map: Dict[int, int] = {}
        for j, (i, _s) in enumerate(occ):
            nb._carry = lane_splice(nb._carry, j,
                                    lane_extract(self._carry, i))
            slot_map[i] = j
        nb.windows = self.windows
        nb.turnovers = self.turnovers
        nb.admitted = self.admitted
        return nb, slot_map

    # ---- static batch driver --------------------------------------------

    def run(self) -> List[dict]:
        """Static driver: run windows until every admitted lane stops;
        one result dict per constructor study (padding lanes dropped)."""
        budget = (self.max_t + self.window - 1) // self.window + 1
        for _ in range(budget):
            self.step_window()
            if not self.unfinished():
                break
        return [self.result(i) for i in range(len(self.specs))]
