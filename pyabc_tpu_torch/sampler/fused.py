"""Fused multi-generation blocks: K generations with no host adaptation.

Port of ``build_fused_generations`` and its per-generation body
``_build_one_gen`` from ``pyabc_tpu/sampler/fused.py``.  For a
configuration whose whole adaptation chain has a device form — the KDE
refit, a constant or weighted-quantile epsilon, the model probabilities,
an adaptive p-norm's scale refit, the acceptance-rate temperature solve
— K generations run back to back from a population carried on the
device; the orchestrator (``ABCSMC._run_fused_block``) copies each
generation to the host and writes History after the block.

The JAX package runs a block as one ``lax.scan`` program.  Eager PyTorch
has no scan, so here a block is a Python loop over generations whose
state never leaves the device: the population, ε or T, the EWMA
acceptance-rate estimate and its safety margin, the distance weights and
the candidate-record ring are tensors from one generation to the next,
and nothing is adapted on the host in between.  The host reads only

- the rejection loop's condition ``count < n_target & rounds <
  dyn_rounds`` (``fused.py:520-522``), once after every round — the first
  round always runs, so it is not read before it;
- ``grids_resolved`` (``fused.py:593``), once per generation when a
  model's support is grid-compressed, to choose the compressed or the
  exact support for the proposal density (the JAX package's
  ``lax.cond``).

Each generation reports these reads as ``host_reads``.  The semantics of
the JAX loop are kept: a round runs only while the condition holds; the
"extras" (the last round's candidate stats for the adaptive refit, its
first R candidates for the record ring) come from the last round that
ran; the EWMA update follows ``fused.py:562-568`` and the round cap
``dyn_rounds`` follows ``:469-486``.  A block always runs its K
generations; the orchestrator discards those after an undershoot.

The proposal density is deferred to once per generation over the
accepted buffer (one KDE launch per model — K1 on the card); for the
stochastic triple the same launch also covers the record ring, and the
temperature solve at the start of the generation adds one launch per
model over the ring (:func:`kde_launches_per_gen`).

:func:`build_onedispatch_run` runs the same body up to the end of the
run with the JAX package's device stop chain (:func:`stop_code`) after
each generation: the host reads one packed control tensor (the stop code
and the accepted count) per generation and stops the loop on its code.

With ``summary_lanes=True`` (the lazy History) each generation's wire
also carries the ``sm_*`` lanes of its posterior summary packet
(``wire.store.summary_wire_lanes``), computed on the card, so the host
can fetch those O(KB) and leave the population on the device.  A block
writes each generation's wire into slot buffers allocated once for the
block (K slots; a one-dispatch run, one per generation it may write), so
a generation's accept buffers are freed once the carry leaves them;
``wire_stats=False`` leaves the statistics off the wire when no host
reader needs them.

``carry_precision`` (``ops/precision.py``) narrows the carry's bulk lanes
at rest: each generation decodes them to float32 for its refit and
epsilon, drops the promotion before its rounds, and encodes the next
carry on exit; at ``f32`` the codec is the identity.

``fidelity_cfg`` switches the rounds to the multi-fidelity cascade
(``RoundKernel.staged_generation_round``): the carry grows NaN-seeded
calibration rings ``cal_lo``/``cal_full``, each generation calibrates its
screen threshold from them before its first round
(``fidelity.screen_threshold``), budgets its rounds against the
full-fidelity slots, and pushes the last round's (low, full) pairs in at
the front of the rings, cut to ``cal_rows``.

``telemetry_lanes`` adds each generation's ``tl_*`` lanes
(``telemetry/lanes.py``) to its wire, and a one-dispatch run advances its
progress word after each generation's control read.

The rounds of a generation are one program (``device_loop.RoundProgram``)
over accept buffers the engine keeps across generations, refilled at the
start of each: with ``round_graphs`` (the card, a sampler whose rounds
stay on it) the program is captured as a CUDA graph into ``graph_pool``
and each round is one replay.  The population a generation hands on —
its carry and its wire — is copied out of those buffers, so no later
generation writes into a tensor that a fetch or the device store still
holds.  The rest of a generation (``schedule``, the deferred density,
the weights) runs eagerly.

:func:`lane_extract` and :func:`lane_splice` are row surgery on a batched
carry whose every leaf has the batch axis first (the study axis of
``serve/multiplex.py``): they copy rows out and in, and never write a
leaf in place.

Not ported (ROADMAP): the pod constraint and the ``narrow_wire`` codec: a
generation's output is float32 tensors (the model index int64).
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, Optional, Sequence

import torch

from ..autotune.tuner import EWMA_ALPHA
from ..epsilon.temperature import acceptance_rate_solve
from ..fidelity import screen_calibration
from ..ops.choice import ordered_cumsum, systematic_weighted_choice
from ..ops.kde_cuda import weighted_kde_logpdf_cuda
from ..ops.precision import decode_carry, encode_carry
from ..ops.quantile_sketch import sketch_weighted_quantile
from ..telemetry.lanes import (device_progress_update, phase_cost_model,
                               phase_wire_lanes)
from ..transition.multivariatenormal import (_COMPRESS_MIN_N,
                                             regularized_kde_cov)
from ..wire.store import summary_wire_lanes
from .device_loop import RoundProgram

# Stop codes of the JAX package's device stop chain, in the order the
# host loop checks them; ``smc.STOP_REASONS`` maps each to its string.
# ``STOP_UNDERSHOOT`` is no run stop: a generation short of n_target,
# which the sequential engine redoes.
STOP_NONE = 0
STOP_EPS = 1
STOP_TEMPERATURE = 2
STOP_SINGLE_MODEL = 3
STOP_ACC_RATE = 4
STOP_BUDGET = 5
STOP_UNDERSHOOT = 6

#: cells of the device pdf grid of a large 1-D support: ~100+ cells per
#: bandwidth at any annealing stage (range and bandwidth contract
#: together)
_DEVICE_GRID = 1 << 14

#: the carry's population lanes (leading axis n_target)
POP_LANES = ("m", "theta", "log_weight", "distance", "stats")
#: the carry's record-ring lanes (stochastic triple)
RING_LANES = ("rec_m", "rec_theta", "rec_dist", "rec_loggen")
#: the carry's calibration-ring lanes (fidelity cascade)
CAL_LANES = ("cal_lo", "cal_full")


def kde_launches_per_gen(n_models: int, temperature: bool) -> int:
    """KDE launches of one fused generation: the deferred proposal
    density, one per model (covering the record ring too), plus the
    temperature solve's density at the ring, one per model."""
    return n_models * (2 if temperature else 1)


def _first_rows(sel: torch.Tensor, size: int) -> torch.Tensor:
    """``jnp.nonzero(sel, size=size, fill_value=len(sel))[0]`` without a
    host read: the indices of the first ``size`` True rows in order,
    padded with ``len(sel)``."""
    n = sel.shape[0]
    pos = torch.cumsum(sel.to(torch.int64), 0) - 1
    dst = torch.where(sel & (pos < size), pos, torch.full_like(pos, size))
    out = torch.full((size + 1,), n, dtype=torch.int64, device=sel.device)
    out.scatter_(0, dst, torch.arange(n, device=sel.device))
    return out[:size]


def _compress_support_device(sup: torch.Tensor, w: torch.Tensor,
                             ok: torch.Tensor, chol: torch.Tensor):
    """Per-cell (mass, weighted centroid) of a 1-D support over a
    ``_DEVICE_GRID``-cell grid spanning the masked rows' range — the
    device form of ``MultivariateNormalTransition._compress_support``.

    Returns ``(c_support [G, 1], c_log_w [G], resolved)``.  ``resolved``
    is False when the grid has fewer than 32 cells per bandwidth (an
    outlier-stretched range): the caller must then evaluate the exact
    support.  A dead model (no ok rows) gives finite centres with -1e30
    masses, never NaN."""
    x = sup[:, 0]
    inf = torch.full_like(x, math.inf)
    lo = torch.where(ok, x, inf).min()
    hi = torch.where(ok, x, -inf).max()
    dead = ~torch.isfinite(lo) | ~torch.isfinite(hi)
    lo = torch.where(dead, torch.zeros_like(lo), lo)
    hi = torch.where(dead, torch.ones_like(hi), hi)
    rng = torch.clamp(hi - lo, min=1e-30)
    g = _DEVICE_GRID
    dx = rng / g
    idx = torch.clamp(((x - lo) / dx).to(torch.int64), 0, g - 1)
    # the cell sums in float64: a card adds them atomically in no fixed
    # order, which moves a float64 sum far below float32's precision, so
    # the float32 cell masses (and with them the run) repeat exactly
    wm = torch.where(ok, w, torch.zeros_like(w)).to(torch.float64)
    mass = torch.zeros(g, dtype=torch.float64, device=w.device).index_add_(
        0, idx, wm)
    first = torch.zeros(g, dtype=torch.float64, device=w.device).index_add_(
        0, idx, wm * x.to(torch.float64))
    centers = lo + (torch.arange(g, dtype=x.dtype, device=x.device)
                    + 0.5) * dx
    live = mass > 0
    safe = torch.clamp(mass, min=1e-38)
    centroid = torch.where(live, (first / safe).to(x.dtype), centers)
    log_mass = torch.where(live, torch.log(safe).to(w.dtype),
                           torch.full((g,), -1e30, dtype=w.dtype,
                                      device=w.device))
    resolved = dead | (rng <= (g / 32.0) * chol[0, 0])
    return centroid[:, None], log_mass, resolved


def _kde_params(sup: torch.Tensor, w: torch.Tensor, log_w: torch.Tensor,
                bandwidth_selector, scaling: float) -> dict:
    """support / log_w / chol / log_norm of a KDE over ``sup`` with
    normalized weights ``w`` (the host fit's recipe)."""
    dim = sup.shape[-1]
    cov = regularized_kde_cov(sup, w, bandwidth_selector, scaling)
    # cholesky_ex: no host read of the status (a degenerate covariance
    # gives NaN rows, as jnp.linalg.cholesky does)
    chol = torch.linalg.cholesky_ex(cov).L
    log_norm = (-0.5 * dim * math.log(2 * math.pi)
                - torch.log(torch.diagonal(chol)).sum())
    return {"support": sup, "log_w": log_w, "chol": chol,
            "log_norm": log_norm}


def _refit_model(theta: torch.Tensor, log_w: torch.Tensor,
                 valid: torch.Tensor, m_col: torch.Tensor, j: int,
                 dim_j: int, n_target: int, bandwidth_selector,
                 scaling: float, support_cap: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 u0: Optional[torch.Tensor] = None):
    """Model j's KDE refit from the carried population: ``(params,
    resolved)`` with the params ``MultivariateNormalTransition`` would
    give (support padded to ``n_target`` rows at log weight -1e30, plus
    the grid-compressed ``c_support``/``c_log_w`` of a large 1-D model).

    Above ``support_cap`` rows the model's weighted rows are first
    resampled to ``support_cap`` uniform-weight rows by systematic
    inverse CDF (one uniform from ``generator``, or ``u0``), and the same
    recipe runs on them: O(cap) refit and cap-row densities at any
    population size, no grid."""
    n_rows = theta.shape[0]
    sel = valid & (m_col == j)
    neg_inf = torch.full_like(log_w, -math.inf)
    if support_cap is not None and n_target > support_cap:
        any_sel = sel.any()
        lw_sel = torch.where(sel & torch.isfinite(log_w), log_w, neg_inf)
        # dead model: a point mass on row 0 keeps the inverse CDF finite;
        # its log weights are forced to -1e30 below
        row0 = torch.arange(n_rows, device=theta.device) == 0
        lw_safe = torch.where(any_sel, lw_sel,
                              torch.where(row0, torch.zeros_like(log_w),
                                          neg_inf))
        idx = systematic_weighted_choice(generator, lw_safe, support_cap,
                                         u0=u0)
        sup = theta[idx, :dim_j]
        w = torch.full((support_cap,), 1.0 / support_cap,
                       dtype=torch.float32, device=theta.device)
        lw = torch.full((support_cap,), -math.log(support_cap),
                        dtype=torch.float32, device=theta.device)
        params = _kde_params(
            sup, w, torch.where(any_sel, lw, torch.full_like(lw, -1e30)),
            bandwidth_selector, scaling)
        return params, torch.ones((), dtype=torch.bool, device=theta.device)

    idx = _first_rows(sel, n_target)
    ok = idx < n_rows
    idxc = torch.clamp(idx, max=n_rows - 1)
    sup = theta[idxc, :dim_j]
    lw = torch.where(ok, log_w[idxc], torch.full_like(ok, -math.inf,
                                                      dtype=log_w.dtype))
    lw = lw - torch.logsumexp(lw, 0)
    w = torch.where(ok, torch.exp(lw), torch.zeros_like(lw))
    params = _kde_params(sup, w,
                         torch.where(ok, lw, torch.full_like(lw, -1e30)),
                         bandwidth_selector, scaling)
    resolved = torch.ones((), dtype=torch.bool, device=theta.device)
    if dim_j == 1 and n_target >= _COMPRESS_MIN_N:
        # the proposal density runs against ~2^14 cells instead of
        # n_target rows (rvs stays on the full support, as the host fit)
        params["c_support"], params["c_log_w"], resolved = \
            _compress_support_device(sup, w, ok, params["chol"])
    return params, resolved


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
            ) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for a scalar ``x``: constant beyond
    both ends, ``fp[i-1]`` where the interval is (numerically) empty."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.reshape(1), right=True)[0],
                    1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    # np.spacing(np.finfo(float32).eps), as jnp.interp
    dx0 = torch.abs(dx) <= 1.4210855e-14
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(
                        dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _weighted_quantile_device(x: torch.Tensor, w: torch.Tensor,
                              valid: torch.Tensor, alpha: float,
                              sketch: bool = False) -> torch.Tensor:
    """``weighted_statistics.weighted_quantile`` on masked device rows:
    invalid rows sort to +inf with zero weight.  ``sketch=True`` (the
    schedule's ``device_sketch_ok``) takes the sort-free histogram
    sketch, within ``sketch_error_bound`` of the inverse CDF."""
    if sketch:
        return sketch_weighted_quantile(x, w, alpha, valid=valid)
    xs = torch.where(valid, x, torch.full_like(x, math.inf))
    ws = torch.where(valid, w, torch.zeros_like(w))
    order = torch.argsort(xs, stable=True)
    pts = xs[order]
    w_s = ws[order] / torch.clamp(ws.sum(), min=1e-38)
    cum = ordered_cumsum(w_s)
    return _interp(torch.full((), alpha, dtype=x.dtype, device=x.device),
                   cum - 0.5 * w_s, pts)


def ewma_update(rate0: torch.Tensor, safety0: torch.Tensor,
                count1: torch.Tensor, rounds1: int, B: int, n_target: int):
    """The next generation's ``(rate, safety)`` (``fused.py:562-568``):
    the EWMA acceptance-rate estimate (the host autotuner's gain) and the
    undershoot-escalated safety margin (×1.25 up to 4)."""
    obs = count1.to(torch.float32) / float(max(rounds1 * B, 1))
    rate1 = torch.clamp(rate0 + EWMA_ALPHA * (obs - rate0), min=1e-6)
    safety1 = torch.where(count1 < n_target,
                          torch.clamp(safety0 * 1.25, max=4.0), safety0)
    return rate1, safety1


def round_cap(rate0: torch.Tensor, safety0: torch.Tensor, n_target: int,
              B: int, max_rounds: int, rate_pred_factor: float
              ) -> torch.Tensor:
    """This generation's round cap ``dyn_rounds`` (``fused.py:469-486``):
    rounds the carried rate estimate predicts, with the safety margin,
    +1, in [min(2, max_rounds), max_rounds]."""
    pred = torch.clamp(rate0, min=1e-6) * rate_pred_factor
    # a tensor numerator: `float / tensor` would multiply by a reciprocal
    n = torch.full_like(pred, float(n_target))
    need = torch.ceil(n / (pred * B) * safety0) + 1.0
    lo = min(2.0, float(max_rounds))
    return torch.clamp(need, lo, float(max_rounds)).to(torch.int64)


def build_one_gen(kernel, bandwidth_selectors: Sequence[Callable],
                  scalings: Sequence[float], dims: Sequence[int],
                  n_target: int, B: int, max_rounds: int, d: int, s: int,
                  eps_mode: str, eps_alpha: float, eps_multiplier: float,
                  eps_weighted: bool, distance_params,
                  raw_round: Callable, support_cap: Optional[int] = None,
                  rate_pred_factor: float = 1.0,
                  adaptive_cfg: Optional[dict] = None,
                  stoch_cfg: Optional[dict] = None,
                  eps_sketch: bool = False, summary_lanes: bool = False,
                  fidelity_cfg: Optional[dict] = None,
                  carry_precision: str = "f32", wire_stats: bool = True,
                  telemetry_lanes: bool = False, round_graphs: bool = False,
                  graph_pool=None):
    """The per-generation body behind :func:`build_fused_generations`.

    ``eps_mode`` is ``"constant"``, ``"quantile"`` or ``"temperature"``
    (the last requires ``stoch_cfg``: ``pdf_norm``, ``target_rate``,
    ``lin_scale``, ``record_rows``); ``adaptive_cfg`` (``scale_fn``,
    ``distance_fn``, ``obs_flat``, ``max_weight_ratio``,
    ``normalize_weights``, ``factors``) switches on the in-block scale
    refit.  ``raw_round(generator, params)`` is the sampler's deferred
    round at batch ``B``.

    ``fidelity_cfg`` (``q``, ``margin``, ``min_corr``, ``min_pairs``,
    ``cal_rows``, ``n_full``: the full-fidelity slots of one round)
    requires ``raw_round`` to be the staged round, returning
    ``(RoundResult, (plo, pfull, npass))``; it excludes ``adaptive_cfg``
    and ``stoch_cfg``.  ``carry_precision`` is the carry's at-rest mode.

    Returns ``one_gen(carry, generator, final=False) -> (carry, wire,
    info)``: the next carry, the generation's population (``m``,
    ``theta``, ``distance`` at acceptance, corrected ``log_weight``, and
    ``stats`` with ``wire_stats``) with ``count``, ``rounds`` and ``eps``
    (and the ``sm_*`` summary lanes with ``summary_lanes``), and host
    facts (``rounds``, ``host_reads``, ``grids_resolved`` — None without
    a grid — ``kde_support``, the clocks of its count reads
    (``telemetry.phases.RoundClock.row``), and with ``fidelity_cfg``
    ``screen_pass``, the round survivors, ``screen_tau``, the threshold, ``cal_pairs`` and
    ``cal_corr``, the acceptable pairs and the correlation it was set
    from, and ``round_cap``, the generation's round cap, as 0-d device
    tensors, and ``max_rounds``, the ceiling of that cap).  ``final`` pins
    the temperature to 1 (``Temperature``'s last-generation rule).
    ``telemetry_lanes`` adds the ``tl_*`` lanes (``telemetry.lanes.
    phase_wire_lanes`` of the generation's ``rounds`` tensor, and
    ``tl_screen_pass`` under the screen) to the wire: arithmetic on the
    round counter, no draw and no host read, so the population is the
    same bits with and without them.  ``round_graphs``: capture the
    round into ``graph_pool`` (each generation's ``info`` says whether
    its rounds replayed a graph: ``round_graph``)."""
    M = kernel.M
    stoch = stoch_cfg is not None
    adaptive = adaptive_cfg is not None
    fidelity = fidelity_cfg is not None
    if eps_mode == "temperature" and not stoch:
        raise ValueError("temperature eps_mode requires stoch_cfg")
    if fidelity:
        if adaptive or stoch:
            raise ValueError("fidelity_cfg is mutually exclusive with "
                             "adaptive_cfg/stoch_cfg")
        fid_q = float(fidelity_cfg["q"])
        fid_margin = float(fidelity_cfg["margin"])
        fid_min_corr = float(fidelity_cfg["min_corr"])
        fid_min_pairs = int(fidelity_cfg["min_pairs"])
        fid_cal_rows = int(fidelity_cfg["cal_rows"])
        # a screened round accepts at most its slots, so the round cap
        # budgets against them (the carried rate is per proposal)
        eff_B = min(B, max(int(fidelity_cfg["n_full"]), 1))
    else:
        eff_B = B
    if stoch:
        pdf_norm = float(stoch_cfg["pdf_norm"])
        target = float(stoch_cfg["target_rate"])
        lin_scale = bool(stoch_cfg["lin_scale"])
        R = int(stoch_cfg["record_rows"])
        if not 0 < R <= B:
            raise ValueError("record_rows must be in (0, B]")
    if adaptive:
        scale_fn = adaptive_cfg["scale_fn"]
        dist_fn = adaptive_cfg["distance_fn"]
        obs_flat = adaptive_cfg["obs_flat"]
        max_weight_ratio = adaptive_cfg.get("max_weight_ratio")
        normalize_weights = bool(adaptive_cfg.get("normalize_weights",
                                                  True))
        factors = adaptive_cfg.get("factors")
        if factors is not None:
            factors = torch.as_tensor(factors, dtype=torch.float32,
                                      device=obs_flat.device)
    capped = support_cap is not None and n_target > support_cap
    models = ", ".join(type(m).__name__ for m in getattr(kernel, "models", ()))
    program = RoundProgram(
        raw_round, B, n_target, staged=fidelity, graphs=round_graphs,
        pool=graph_pool,
        label=f"{'staged ' if fidelity else ''}round[{models}] at B={B}")
    tl_cost = None
    if telemetry_lanes:
        tl_cost = phase_cost_model(
            B=B, n_target=n_target, d=d, s=s, M=M, eps_mode=eps_mode,
            support_rows=(support_cap if capped else n_target),
            adaptive=adaptive, fidelity=fidelity)

    def schedule(carry: dict, generator: torch.Generator, final: bool):
        """This generation's ``(params, eps, grids_resolved, screen)``
        from the carried population, its bulk lanes promoted to float32
        here: the promotion dies with this call, before the rounds
        allocate.  ``screen``: the screen's calibration facts (None
        without ``fidelity_cfg``)."""
        carry = decode_carry(carry, carry_precision)
        m0, theta0, lw0 = carry["m"], carry["theta"], carry["log_weight"]
        dist0, count0, eps0 = (carry["distance"], carry["count"],
                               carry["eps"])
        dev = theta0.device
        n_rows = m0.shape[0]
        valid0 = torch.arange(n_rows, device=dev) < count0
        neg_inf = torch.full_like(lw0, -math.inf)

        # normalized weights of the carried population (log-space shift)
        lw_max = torch.where(valid0 & torch.isfinite(lw0), lw0,
                             neg_inf).max()
        w_un = torch.where(valid0, torch.exp(lw0 - lw_max),
                           torch.zeros_like(lw0))
        w = w_un / torch.clamp(w_un.sum(), min=1e-38)

        # model probabilities -> the proposal's model mix
        one_hot = m0[:, None] == torch.arange(M, device=dev)[None, :]
        probs = torch.where(one_hot, w[:, None],
                            torch.zeros_like(w)[:, None]).sum(0)
        model_log_probs = torch.log(torch.clamp(probs, min=1e-300))

        # per-model KDE refit
        refits = [_refit_model(theta0, lw0, valid0, m0, j, dims[j],
                               n_target, bandwidth_selectors[j],
                               scalings[j], support_cap=support_cap,
                               generator=generator if capped else None)
                  for j in range(M)]
        trans = tuple(p for p, _ in refits)
        grids_resolved = refits[0][1]
        for _, r in refits[1:]:
            grids_resolved = grids_resolved & r

        # this generation's epsilon
        if eps_mode == "constant":
            eps_t = eps0
        elif eps_mode == "quantile":
            qw = w if eps_weighted else valid0.to(w.dtype)
            eps_t = _weighted_quantile_device(
                dist0, qw, valid0, eps_alpha, sketch=eps_sketch) \
                * eps_multiplier
        else:
            # the acceptance-rate solve over the record ring, under this
            # generation's proposal
            log_new = kernel.proposal_log_density(
                carry["rec_m"], carry["rec_theta"],
                {"model_log_probs": model_log_probs, "transition": trans})
            b_opt, rate_at_1, rate_min = acceptance_rate_solve(
                carry["rec_dist"], log_new - carry["rec_loggen"], pdf_norm,
                target, lin_scale)
            # already hot -> T = 1; target out of reach -> +inf (the
            # clamp then keeps the previous T: the NaN-seeded first ring)
            one = torch.ones_like(eps0)
            t_prop = torch.where(
                rate_at_1 > target, one,
                torch.where(rate_min < target, torch.full_like(eps0,
                                                               math.inf),
                            torch.exp(-b_opt)))
            # Temperature._update: monotone, at least 1; a previous T <= 1
            # or the run's last generation pins T = 1
            t_new = torch.clamp(torch.minimum(t_prop, eps0), min=1.0)
            eps_t = one if final else torch.where(eps0 <= 1.0, one, t_new)

        if stoch:
            acc_params = {"pdf_norm": pdf_norm, "temp": eps_t}
        else:
            acc_params = {"eps": eps_t}
        if adaptive:
            w_eff0 = (carry["dist_w"] * factors if factors is not None
                      else carry["dist_w"])
            dparams = {"w": w_eff0}
        else:
            dparams = distance_params
        params = {"distance": dparams, "acceptor": acc_params,
                  "model_log_probs": model_log_probs, "transition": trans}
        screen = None
        if fidelity:
            # this generation's screen threshold from the carried pairs
            # against its epsilon: a NaN-seeded ring (a fresh carry) or a
            # weakly correlated surrogate gives +inf, no screen
            tau, n_acc, corr = screen_calibration(
                carry["cal_lo"], carry["cal_full"], eps_t, q=fid_q,
                margin=fid_margin, min_corr=fid_min_corr,
                min_pairs=fid_min_pairs)
            params["fidelity"] = {"tau": tau}
            screen = {"screen_tau": tau, "cal_pairs": n_acc,
                      "cal_corr": corr}
        return params, eps_t, grids_resolved, screen

    def one_gen(carry: dict, generator: torch.Generator,
                final: bool = False):
        params, eps_t, grids_resolved, screen = schedule(carry, generator,
                                                         final)
        trans = params["transition"]
        rate0, safety0 = carry["rate"], carry["safety"]
        dev = carry["log_weight"].device

        dyn_rounds = round_cap(rate0, safety0, n_target, eff_B, max_rounds,
                               rate_pred_factor)

        # rejection rounds, compacted in (round, lane) order into the
        # engine's buffers, refilled here; row `cap` takes every dropped
        # write
        clock = program.new_clock()
        program.reset()
        replays0 = program.replays
        rounds = 0
        reads = 0
        while True:
            out = program.run(generator, params)
            rounds += 1
            # the last round's candidates feed the refit / the rings
            last, pairs = out if fidelity else (out, None)
            reads += 1
            if not clock.read(bool, (program.state["count"] < n_target)
                              & (rounds < dyn_rounds)):
                break
        st = program.state
        count = st["count"].clone()
        if fidelity:
            npass = st["npass"].clone()

        rate1, safety1 = ewma_update(rate0, safety0, count, rounds, B,
                                     n_target)

        # the generation's population, copied out of the buffers the
        # next generation refills; the deferred proposal density over it
        # (and the record ring's generating density: one evaluation
        # serves both)
        bufs = st["bufs"]
        m1 = bufs["m"][:n_target].clone()
        theta1 = bufs["theta"][:n_target].clone()
        dist1 = bufs["distance"][:n_target].clone()
        stats1 = bufs["stats"][:n_target].clone()
        lw1 = bufs["log_weight"][:n_target]
        if stoch:
            ring = {"rec_m": last.m[:R].clone(),
                    "rec_theta": last.theta[:R].clone(),
                    "rec_dist": last.distance[:R].clone()}
            m_q = torch.cat([m1, ring["rec_m"]])
            th_q = torch.cat([theta1, ring["rec_theta"]])
        else:
            m_q, th_q = m1, theta1
        resolved = None
        if any("c_support" in p for p in trans):
            reads += 1
            resolved = bool(grids_resolved)
        if resolved is False:
            trans_used = tuple({k: v for k, v in p.items()
                                if k not in ("c_support", "c_log_w")}
                               for p in trans)
        else:
            trans_used = trans
        log_den_q = kernel.proposal_log_density(
            m_q, th_q, {**params, "transition": trans_used})
        log_denom = log_den_q[:n_target]
        lw1 = torch.where(torch.isfinite(lw1), lw1 - log_denom, lw1)

        if adaptive:
            # the last round's candidate stats stand in for the host
            # fit's records: scale -> invert -> ratio clamp -> normalize
            scale = scale_fn(last.stats, obs_flat)
            w_new = torch.where(scale > 0,
                                1.0 / torch.clamp(scale, min=1e-30),
                                torch.zeros_like(scale))
            if max_weight_ratio is not None:
                pos_min = torch.where(w_new > 0, w_new,
                                      torch.full_like(w_new, math.inf)).min()
                w_new = torch.where(torch.isfinite(pos_min),
                                    torch.minimum(w_new,
                                                  pos_min * max_weight_ratio),
                                    w_new)
            if normalize_weights:
                wsum = w_new.sum()
                w_new = torch.where(wsum > 0, w_new * s / wsum, w_new)
            w_new = w_new.to(torch.float32)
            w_eff1 = w_new * factors if factors is not None else w_new
            # the next quantile sees the carried distances under the new
            # weights; the generation's output keeps the accepted ones
            dist_carry = dist_fn(stats1, obs_flat, {"w": w_eff1})
        else:
            dist_carry = dist1

        new_carry = {"m": m1, "theta": theta1, "log_weight": lw1,
                     "distance": dist_carry, "stats": stats1,
                     "count": count, "eps": eps_t, "rate": rate1,
                     "safety": safety1}
        if adaptive:
            new_carry["dist_w"] = w_new
        if stoch:
            new_carry.update(ring)
            new_carry["rec_loggen"] = log_den_q[n_target:]
        if fidelity:
            # the last round's pairs go in at the front, the oldest rows
            # fall off: the next threshold sees the newest stage
            for key, new in zip(CAL_LANES, pairs[:2]):
                new_carry[key] = torch.cat(
                    [new.to(torch.float32), carry[key]])[:fid_cal_rows]
        wire = {"m": m1, "theta": theta1, "distance": dist1,
                "log_weight": lw1, "count": count,
                "rounds": torch.full((), rounds, dtype=torch.int64,
                                     device=dev),
                "eps": eps_t}
        if wire_stats:
            wire["stats"] = stats1
        if summary_lanes:
            valid1 = torch.arange(n_target, device=dev) < count
            wire.update(summary_wire_lanes(m1, theta1, dist1, lw1, valid1,
                                           M))
        if telemetry_lanes:
            wire.update(phase_wire_lanes(wire["rounds"], B, tl_cost))
            if fidelity:
                wire["tl_screen_pass"] = npass
        info = {"rounds": rounds, "host_reads": reads,
                "grids_resolved": resolved,
                "round_graph": program.route == "graph",
                "round_replays": program.replays - replays0,
                **clock.row(),
                "kde_support": [
                    {"rows": int((p["c_support"] if "c_support" in p
                                  else p["support"]).shape[0]),
                     "compressed": "c_support" in p}
                    for p in trans_used]}
        if fidelity:
            info.update(screen, screen_pass=npass, round_cap=dyn_rounds,
                        max_rounds=max_rounds)
        return encode_carry(new_carry, carry_precision), wire, info

    return one_gen


class _WireSlots:
    """The wire slots of one block or run: each generation's wire is
    copied into slot ``k`` of buffers allocated at the first write (the
    JAX package's stacked block outputs), so no generation's accept
    buffers outlive its carry."""

    def __init__(self, slots: int):
        self.slots = int(slots)
        self.bufs: Optional[dict] = None
        self.written = 0

    def write(self, wire: dict):
        if self.bufs is None:
            self.bufs = {k: torch.empty((self.slots,) + tuple(v.shape),
                                        dtype=v.dtype, device=v.device)
                         for k, v in wire.items()}
        for k, v in wire.items():
            self.bufs[k][self.written].copy_(v)
        self.written += 1

    def stacked(self) -> Optional[dict]:
        """The written slots (leading axis = generations), or None."""
        if not self.written:
            return None
        return {k: v[:self.written] for k, v in self.bufs.items()}


def build_fused_generations(kernel, bandwidth_selectors, scalings, dims,
                            n_target: int, B: int, max_rounds: int, K: int,
                            d: int, s: int, eps_mode: str, eps_alpha: float,
                            eps_multiplier: float, eps_weighted: bool,
                            distance_params, raw_round: Callable,
                            support_cap: Optional[int] = None,
                            rate_pred_factor: float = 1.0,
                            adaptive_cfg: Optional[dict] = None,
                            stoch_cfg: Optional[dict] = None,
                            eps_sketch: bool = False,
                            summary_lanes: bool = False,
                            fidelity_cfg: Optional[dict] = None,
                            carry_precision: str = "f32",
                            wire_stats: bool = True,
                            telemetry_lanes: bool = False,
                            round_graphs: bool = False, graph_pool=None):
    """``fused(carry, generator, final_mask=None) -> (carry, wires,
    infos)`` for K generations.

    ``carry`` is the previous generation's accepted population on the
    device: ``m`` [n] int64, ``theta`` [n, d], ``log_weight``,
    ``distance`` [n], ``stats`` [n, s] (write-only in the block; it
    leaves as the last generation's stats), ``count`` int64, and the
    float32 scalars ``eps`` (ε or T), ``rate`` and ``safety`` (the
    autotuner's state: an EWMA acceptance-rate estimate and a margin that
    size each generation's round cap below ``max_rounds``); an adaptive
    distance adds ``dist_w`` [s] (the raw inverse-scale weights), the
    stochastic triple the record ring ``rec_m``, ``rec_theta``,
    ``rec_dist``, ``rec_loggen`` (R rows) for the temperature solve, the
    fidelity cascade the calibration rings ``cal_lo``, ``cal_full``
    (``cal_rows`` rows, NaN = empty).  The carry enters and leaves at its
    ``carry_precision``.

    ``wires`` holds the K generations' outputs on the device (leading
    axis K); ``infos`` holds each generation's host facts, with its KDE
    launches (``kde_launches``).  ``final_mask`` [K] (stochastic triple)
    marks the run's last generation, whose temperature is 1.
    ``summary_lanes`` adds each generation's ``sm_*`` summary lanes to
    its wire, ``telemetry_lanes`` its ``tl_*`` lanes; ``round_graphs``
    captures the round as a CUDA graph into ``graph_pool``
    (:func:`build_one_gen`).

    Every carry and wire tensor a block returns is freshly allocated (the
    population is copied out of the engine's rejection buffers, the wire
    slots are new per block): no later block writes into a tensor an
    in-flight fetch or the device store still holds."""
    one_gen = build_one_gen(
        kernel, bandwidth_selectors, scalings, dims, n_target, B,
        max_rounds, d, s, eps_mode, eps_alpha, eps_multiplier,
        eps_weighted, distance_params, raw_round, support_cap=support_cap,
        rate_pred_factor=rate_pred_factor, adaptive_cfg=adaptive_cfg,
        stoch_cfg=stoch_cfg, eps_sketch=eps_sketch,
        summary_lanes=summary_lanes, fidelity_cfg=fidelity_cfg,
        carry_precision=carry_precision, wire_stats=wire_stats,
        telemetry_lanes=telemetry_lanes, round_graphs=round_graphs,
        graph_pool=graph_pool)

    def fused(carry: dict, generator: torch.Generator,
              final_mask: Optional[List[bool]] = None):
        slots = _WireSlots(K)
        infos = []
        for k in range(K):
            launches0 = weighted_kde_logpdf_cuda.launches
            carry, wire, info = one_gen(
                carry, generator,
                final=bool(final_mask[k]) if final_mask is not None
                else False)
            info["kde_launches"] = (weighted_kde_logpdf_cuda.launches
                                    - launches0)
            slots.write(wire)
            infos.append(info)
        return carry, slots.stacked(), infos

    return fused


def stop_code(count, rounds, rounds_tot, eps, log_weight: torch.Tensor,
              m: torch.Tensor, n_target: int, B: int, min_eps, min_rate,
              budget_rounds, n_models: int, temperature: bool,
              single_model_stop: bool) -> torch.Tensor:
    """One generation's ``STOP_*`` code as a 0-d int64 tensor, with no
    host read: the device stop chain of the JAX package's one-dispatch
    run (``pyabc_tpu/sampler/fused.py:934-970``).

    ``count`` accepted of ``n_target`` after ``rounds`` rounds of ``B``
    candidates (``rounds_tot`` in the dispatch so far, this generation's
    included), ε or T ``eps``, the new population's ``log_weight`` and
    model index ``m``.  In the sequential loop's priority order: the
    threshold (``eps <= min_eps`` in float32, or T <= 1 with
    ``temperature``), a single model with weight mass (with
    ``single_model_stop``), the float32 acceptance rate below
    ``min_rate``, the budget in whole rounds (``rounds_tot >=
    budget_rounds``).  A generation short of ``n_target`` is
    ``STOP_UNDERSHOOT`` before all of them."""
    dev = log_weight.device
    count = torch.as_tensor(count, dtype=torch.int64, device=dev)
    rounds = torch.as_tensor(rounds, dtype=torch.int64, device=dev)
    rounds_tot = torch.as_tensor(rounds_tot, dtype=torch.int64, device=dev)
    eps = torch.as_tensor(eps, dtype=torch.float32, device=dev)
    if temperature:
        thresh = eps <= 1.0
        thresh_code = STOP_TEMPERATURE
    else:
        thresh = eps <= torch.as_tensor(min_eps, dtype=torch.float32,
                                        device=dev)
        thresh_code = STOP_EPS
    if single_model_stop:
        # Population.nr_of_models_alive on the device: models whose
        # normalized weight sum is strictly positive
        valid = torch.arange(log_weight.shape[0], device=dev) < count
        lw_max = torch.where(valid & torch.isfinite(log_weight), log_weight,
                             torch.full_like(log_weight, -math.inf)).max()
        w = torch.where(valid, torch.exp(log_weight - lw_max),
                        torch.zeros_like(log_weight))
        w = w / torch.clamp(w.sum(), min=1e-38)
        one_hot = m[:, None] == torch.arange(n_models, device=dev)[None, :]
        mass = torch.where(one_hot, w[:, None],
                           torch.zeros_like(w)[:, None]).sum(0)
        single = (mass > 0).sum() <= 1
    else:
        single = torch.zeros((), dtype=torch.bool, device=dev)
    acc_rate = (count.to(torch.float32)
                / torch.clamp(rounds * B, min=1).to(torch.float32))
    low_rate = acc_rate < torch.as_tensor(min_rate, dtype=torch.float32,
                                          device=dev)
    spent = rounds_tot >= torch.as_tensor(budget_rounds, dtype=torch.int64,
                                          device=dev)

    def code(c):
        return torch.full((), c, dtype=torch.int64, device=dev)

    chain = torch.where(
        thresh, code(thresh_code),
        torch.where(single, code(STOP_SINGLE_MODEL),
                    torch.where(low_rate, code(STOP_ACC_RATE),
                                torch.where(spent, code(STOP_BUDGET),
                                            code(STOP_NONE)))))
    return torch.where(count < n_target, code(STOP_UNDERSHOOT), chain)


def build_onedispatch_run(kernel, bandwidth_selectors, scalings, dims,
                          n_target: int, B: int, max_rounds: int, K: int,
                          d: int, s: int, eps_mode: str, eps_alpha: float,
                          eps_multiplier: float, eps_weighted: bool,
                          distance_params, raw_round: Callable, max_T: int,
                          single_model_stop: bool,
                          support_cap: Optional[int] = None,
                          rate_pred_factor: float = 1.0,
                          adaptive_cfg: Optional[dict] = None,
                          stoch_cfg: Optional[dict] = None,
                          eps_sketch: bool = False,
                          summary_lanes: bool = False,
                          fidelity_cfg: Optional[dict] = None,
                          carry_precision: str = "f32",
                          wire_stats: bool = True,
                          telemetry_lanes: bool = False,
                          round_graphs: bool = False, graph_pool=None):
    """``onedispatch(carry, generator, ctl) -> (carry, ctl_out, wires)``:
    the rest of a run (at most ``ctl["t_limit"]`` <= ``max_T``
    generations) from ``carry``, with the stop chain after every
    generation.

    The JAX package's ``lax.while_loop`` over K-generation scans becomes
    a Python loop over K-generation blocks of :func:`build_one_gen`'s
    body, drawing from ``generator`` as consecutive
    :func:`build_fused_generations` blocks do.  After each generation the
    host reads one packed tensor (:func:`stop_code`, the accepted count
    and ε) and the loop ends on a code other than ``STOP_NONE`` or at
    ``t_limit``; a generation short of ``n_target`` (``STOP_UNDERSHOOT``)
    is not written and leaves the carry as it was.

    ``ctl``: ``min_eps``, ``min_rate``, ``budget_rounds`` (whole rounds
    left in the simulation budget), ``t_limit`` and ``final_rel`` (the
    relative index from which the temperature is pinned to 1, stochastic
    triple), and optionally ``run_tag``: the progress word
    (``telemetry.lanes.PROGRESS``) this call advances after each written
    generation's control read, from the values that read returned, and
    ``on_generation(t, count)``, called at the same point with the same
    host values (the progress bar).
    ``carry`` is the fused engine's; the returned one is the last written
    generation's.  ``ctl_out``: ``t`` (generations written),
    ``stop``, ``stop_t`` (relative index of the generation that set the
    code, -1 without one), ``stop_count`` (its accepted count),
    ``rounds`` (every round run, the undershot generation's included),
    ``control_s`` (seconds of the control reads, after a device sync)
    and ``gens`` (each generation's host facts as in the fused engine,
    with ``count``, ``kde_launches`` and ``sample_s``, its seconds up to
    its control read; the undershot one last).
    ``wires`` holds the written generations' outputs (leading axis ``t``;
    with ``summary_lanes`` their ``sm_*`` lanes too) in ``t_limit`` slots
    allocated at the first write, or is None when none was written."""
    if max_T < 1:
        raise ValueError("max_T must be >= 1")
    one_gen = build_one_gen(
        kernel, bandwidth_selectors, scalings, dims, n_target, B,
        max_rounds, d, s, eps_mode, eps_alpha, eps_multiplier,
        eps_weighted, distance_params, raw_round, support_cap=support_cap,
        rate_pred_factor=rate_pred_factor, adaptive_cfg=adaptive_cfg,
        stoch_cfg=stoch_cfg, eps_sketch=eps_sketch,
        summary_lanes=summary_lanes, fidelity_cfg=fidelity_cfg,
        carry_precision=carry_precision, wire_stats=wire_stats,
        telemetry_lanes=telemetry_lanes, round_graphs=round_graphs,
        graph_pool=graph_pool)
    stoch = stoch_cfg is not None
    temperature = eps_mode == "temperature"

    def onedispatch(carry: dict, generator: torch.Generator, ctl: dict):
        t_limit = min(int(ctl["t_limit"]), max_T)
        final_rel = int(ctl["final_rel"])
        run_tag = ctl.get("run_tag")
        on_generation = ctl.get("on_generation")
        t, stop, stop_t, stop_count, rounds_tot = 0, STOP_NONE, -1, 0, 0
        control_s = 0.0
        slots = _WireSlots(t_limit)
        gens = []
        while stop == STOP_NONE and t < t_limit:
            for _ in range(K):
                gen_mark = time.perf_counter()
                launches0 = weighted_kde_logpdf_cuda.launches
                new_carry, wire, info = one_gen(
                    carry, generator, final=stoch and t >= final_rel)
                info["kde_launches"] = (weighted_kde_logpdf_cuda.launches
                                        - launches0)
                rounds_tot += info["rounds"]
                code = stop_code(
                    wire["count"], info["rounds"], rounds_tot, wire["eps"],
                    new_carry["log_weight"], new_carry["m"], n_target, B,
                    ctl["min_eps"], ctl["min_rate"], ctl["budget_rounds"],
                    kernel.M, temperature, single_model_stop)
                # float64 holds the code, the count and the float32 ε
                # exactly: one read
                packed = torch.stack([code.to(torch.float64),
                                      wire["count"].to(torch.float64),
                                      wire["eps"].to(torch.float64)])
                if packed.is_cuda:
                    torch.cuda.synchronize(packed.device)
                mark = time.perf_counter()
                code, count, eps_host = packed.tolist()
                code, count = int(code), int(count)
                control_s += time.perf_counter() - mark
                info["host_reads"] += 1
                info["count"] = count
                info["sample_s"] = time.perf_counter() - gen_mark
                gens.append(info)
                if code != STOP_NONE:
                    stop, stop_t, stop_count = code, t, count
                if code == STOP_UNDERSHOOT:
                    break
                carry = new_carry
                slots.write(wire)
                t += 1
                if run_tag is not None:
                    device_progress_update(t, eps_host, count, rounds_tot,
                                           True, run_tag)
                if on_generation is not None:
                    on_generation(t, count)
                if stop != STOP_NONE or t >= t_limit:
                    break
        ctl_out = {"t": t, "stop": stop, "stop_t": stop_t,
                   "stop_count": stop_count, "rounds": rounds_tot,
                   "control_s": control_s, "gens": gens}
        return carry, ctl_out, slots.stacked()

    return onedispatch


# ---------------------------------------------------------------------------
# lane surgery on a batched carry (pyabc_tpu/sampler/fused.py:1042-1060)
# ---------------------------------------------------------------------------


def lane_extract(carry: tuple, row: int) -> tuple:
    """One lane's rows of a batched carry: ``leaf[row]`` of every leaf,
    copied, so the result does not alias a buffer that later work may
    rewrite."""
    return tuple(leaf[row].clone() for leaf in carry)


def lane_splice(carry: tuple, row: int, values: tuple) -> tuple:
    """A new carry with ``values`` (one lane's rows, as from
    :func:`lane_extract`) written at ``row`` of every leaf.  Leaves are
    copied, never written in place: the input carry may still back work
    in flight."""
    out = []
    for leaf, val in zip(carry, values):
        new = leaf.clone()
        new[row] = torch.as_tensor(val, dtype=leaf.dtype, device=leaf.device)
        out.append(new)
    return tuple(out)
