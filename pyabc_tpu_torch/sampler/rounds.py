"""Per-generation candidate rounds.

Port of ``RoundKernel`` from ``pyabc_tpu/sampler/rounds.py``: the prior
round, the generation round, the staged multi-fidelity round and the
proposal density.  One round proposes B candidates,
simulates every model on the whole batch and selects by model index
(an ``IntegratedModel`` gets the round's epsilon and may reject
candidates early), computes distances, accepts, and forms the log
importance weight

    log prior + log acceptance weight − log proposal density

where the proposal density is ``log Σ_s p_s · jump_pmf(s → m) + log
q_m(θ)`` with ``q_m`` the model's KDE.  Everything runs on the device of
the params and the generator; per-generation values arrive in
``params`` (tensors), so nothing here changes between generations.

Each round also marks the candidates that count as records (``valid``:
inside the prior support) and their generating proposal's log density
(``log_proposal``: the prior at t = 0, NaN where the density is
deferred).

A round marks its phases (``telemetry.phases``: ``propose``,
``simulate``, ``distance``, ``density``); the marks record CUDA events
only while a round program traces them.

A generation's resampling CDFs — the model mix's and each model's
support's, fixed for the generation — are built once, before its rounds
(:meth:`RoundKernel.prepare`): a round then only draws its uniforms and
inverts the CDFs.  A round whose params carry none builds them itself,
with the same ops, and draws the same indices.

Draw order of one round from the run's generator: the proposal (model
source, jump, each model's transition draw), the simulations, then the
acceptor's uniforms.  The staged round draws the proposal exactly as the
generation round does, then the low-fidelity simulations on all B rows,
the full-fidelity simulations on the slots, then the accept uniforms.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional, Sequence

import torch

from ..acceptor import Acceptor
from ..distance.base import Distance
from ..fidelity import compact_survivors, scatter_back, screen_mask
from ..fidelity.config import FidelityConfig
from ..model import IntegratedModel, Model
from ..ops.choice import choice_from_cdf, resampling_cdf
from ..random_variables import Distribution, ModelPerturbationKernel
from ..sumstat import SumStatSpec
from ..telemetry import phases as _phases
from ..telemetry import spans as _spans
from .base import RoundResult


def _cdf_into(log_w: torch.Tensor, own: Optional[torch.Tensor]
              ) -> torch.Tensor:
    """``resampling_cdf(log_w)``, written into ``own`` in place where
    ``own`` is a tensor of its shape, dtype and device, else into a new
    tensor of ``log_w``'s size (``ordered_cumsum`` leaves its sum in a
    buffer padded to whole scan rows)."""
    cdf = resampling_cdf(log_w)
    if (own is None or own.shape != cdf.shape or own.dtype != cdf.dtype
            or own.device != cdf.device):
        own = torch.empty_like(cdf)
    return own.copy_(cdf)


class RoundKernel:
    """Builds the prior-round and generation-round functions.

    Static configuration (models, priors, spec, observed stats) is held
    here; per-generation values flow through ``params``.
    """

    _uid_counter = itertools.count()

    def __init__(self,
                 models: Sequence[Model],
                 parameter_priors: Sequence[Distribution],
                 model_prior_logits,
                 model_perturbation_kernel: ModelPerturbationKernel,
                 transitions,
                 distance: Distance,
                 acceptor: Acceptor,
                 spec: SumStatSpec,
                 obs_flat: torch.Tensor,
                 dim: int):
        self.models = list(models)
        self.priors = list(parameter_priors)
        self.device = obs_flat.device
        self.model_prior_logits = torch.as_tensor(
            model_prior_logits, dtype=torch.float32, device=self.device)
        #: the model prior's log pmf and resampling CDF, fixed for the
        #: run: built once here, not in every round
        self.log_model_prior = torch.log_softmax(self.model_prior_logits,
                                                 dim=0)
        self.model_prior_cdf = resampling_cdf(self.model_prior_logits)
        self.pert = model_perturbation_kernel
        self.transition_fns = [tr.static_fns() for tr in transitions]
        self.distance = distance
        self.acceptor = acceptor
        self.spec = spec
        self.obs_flat = obs_flat
        self.dim = int(dim)
        self.M = len(self.models)
        #: identity for the sampler's buffer cache (an id() can be reused)
        self._uid = next(RoundKernel._uid_counter)

    # ---- shared helpers --------------------------------------------------

    def _simulate_all(self, generator, theta: torch.Tensor,
                      m: torch.Tensor, eps):
        """Simulate every model on the full batch, select by model index
        (flops are spent on masked lanes — the fixed-shape trade):
        ``(stats, early_reject)``.  An :class:`~..model.IntegratedModel`
        gets the round's epsilon and may mark candidates it rejected
        early."""
        B = theta.shape[0]
        stats = torch.zeros(B, self.spec.total_size,
                            dtype=torch.float32, device=theta.device)
        early = torch.zeros(B, dtype=torch.bool, device=theta.device)
        for j, model in enumerate(self.models):
            theta_j = theta[:, :self.priors[j].dim]
            sel = m == j
            if isinstance(model, IntegratedModel):
                res = model.integrated_simulate(generator, theta_j, eps)
                s_j = self.spec.flatten(res.sum_stats)
                if res.early_reject is not None:
                    early = torch.where(sel, res.early_reject, early)
            else:
                s_j = self.spec.flatten(model.simulate(generator, theta_j))
            stats = torch.where(sel[:, None], s_j, stats)
        return stats, early

    def low_models(self):
        """Each model's low-fidelity variant (``Model.low_fidelity``),
        built once; a None entry is a model with no surrogate (the
        orchestrator's eligibility keeps such a run unscreened)."""
        cached = getattr(self, "_low_models", None)
        if cached is None:
            cached = self._low_models = [model.low_fidelity()
                                         for model in self.models]
        return cached

    def _simulate_all_low(self, generator, theta: torch.Tensor,
                          m: torch.Tensor) -> torch.Tensor:
        """:meth:`_simulate_all` with each model's low-fidelity variant,
        which keeps the statistic layout (``screen_stats_compatible``);
        no early-reject channel: the screen is the early rejection."""
        stats = torch.zeros(theta.shape[0], self.spec.total_size,
                            dtype=torch.float32, device=theta.device)
        for j, model in enumerate(self.low_models()):
            s_j = self.spec.flatten(model.simulate(
                generator, theta[:, :self.priors[j].dim]))
            stats = torch.where((m == j)[:, None], s_j, stats)
        return stats

    def _evaluate(self, generator, theta, m, params, all_accepted=False):
        """Simulate + distance + accept: ``(stats, distance, accepted,
        log_acc_term)``.  Calibration (``all_accepted``) accepts every
        finite distance; otherwise an early-rejected candidate is not
        accepted."""
        eps = params.get("acceptor", {}).get("eps", math.inf)
        stats, early = self._simulate_all(generator, theta, m, eps)
        _phases.mark("simulate")
        d = self.distance.compute(stats, self.obs_flat, params["distance"])
        if all_accepted:
            out = stats, d, torch.isfinite(d), torch.zeros_like(d)
        else:
            acc, acc_w = self.acceptor.accept(generator, d,
                                              params["acceptor"])
            accepted = acc & ~early & torch.isfinite(d)
            out = (stats, d, accepted,
                   torch.log(torch.clamp(acc_w, min=1e-38)))
        _phases.mark("distance")
        return out

    def _log_prior(self, m: torch.Tensor, theta: torch.Tensor
                   ) -> torch.Tensor:
        """Joint log prior: model prior pmf × parameter prior pdf."""
        log_prior = torch.full((theta.shape[0],), -math.inf,
                               device=theta.device)
        for j, prior in enumerate(self.priors):
            lp_j = prior.log_pdf_array(theta[:, :prior.dim])
            log_prior = torch.where(m == j, lp_j, log_prior)
        return log_prior + self.log_model_prior[m]

    def _padded(self, th: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(th, (0, self.dim - th.shape[-1]))

    # ---- prior (calibration) round --------------------------------------

    def prior_round(self, generator, params: dict, B: int,
                    all_accepted: bool = False) -> RoundResult:
        _phases.start()
        m = choice_from_cdf(generator, self.model_prior_cdf, B)
        theta = torch.zeros(B, self.dim, device=self.device)
        for j, prior in enumerate(self.priors):
            th_j = self._padded(prior.rvs_array(generator, B))
            theta = torch.where((m == j)[:, None], th_j, theta)
        _phases.mark("propose")
        stats, d, accepted, log_acc_term = self._evaluate(
            generator, theta, m, params, all_accepted=all_accepted)
        # every prior draw is a record; its generating density is the prior
        log_proposal = self._log_prior(m, theta)
        _phases.mark("density")
        return RoundResult(m=m, theta=theta, distance=d, accepted=accepted,
                           log_weight=log_acc_term, stats=stats,
                           valid=torch.ones_like(accepted),
                           log_proposal=log_proposal)

    # ---- generation round -------------------------------------------------

    def proposal_log_density(self, m: torch.Tensor, theta: torch.Tensor,
                             params: dict) -> torch.Tensor:
        """log density of the generation proposal at ``(m, theta)``:
        ``log[Σ_s p_s·jump_pmf(s→m)] + log q_m(theta)``.  Each model's KDE
        runs over all rows (one kernel launch per model) and is selected
        by model index."""
        lp_target = torch.full((theta.shape[0],), -math.inf,
                               device=theta.device)
        for j in range(self.M):
            q_j = self.transition_fns[j][1](
                theta[:, :self.priors[j].dim], params["transition"][j])
            lp_target = torch.where(m == j, q_j, lp_target)
        all_m = torch.arange(self.M, device=theta.device)
        log_jump = self.pert.log_pmf(m[None, :], all_m[:, None])   # [M, B]
        log_mix = torch.logsumexp(
            params["model_log_probs"][:, None] + log_jump, dim=0)  # [B]
        return log_mix + lp_target

    def prepare(self, params: dict, into: Optional[dict] = None) -> dict:
        """A generation's device params as its deferred rounds read them
        (``with_proposal=False``: they never evaluate the proposal
        density): the model mix's resampling CDF (``model_cdf``) in place
        of ``model_log_probs``, and each transition's, of its padded
        ``log_w`` (``cdf``), in place of ``log_w``; built once for all of
        the generation's rounds (span ``sampler.prepare``).  ``into``:
        the params a captured round holds as its inputs
        (``RoundProgram.own_params``); a CDF whose tensor there has its
        shape and dtype is written into it in place, so the replay
        copies nothing in and no second copy is kept.  Params without
        ``transition`` (the prior round's) come back as they are."""
        if "transition" not in params:
            return params
        into = into or {}
        own_trans = into.get("transition") or [{}] * len(params["transition"])
        with _spans.span("sampler.prepare"):
            trans = []
            for j, p in enumerate(params["transition"]):
                if "log_w" not in p:
                    # an aggregated transition: its blocks build their own
                    trans.append(p)
                    continue
                q = {k: v for k, v in p.items() if k != "log_w"}
                q["cdf"] = _cdf_into(p["log_w"], own_trans[j].get("cdf"))
                trans.append(q)
            out = {k: v for k, v in params.items()
                   if k != "model_log_probs"}
            out["transition"] = type(params["transition"])(trans)
            out["model_cdf"] = _cdf_into(params["model_log_probs"],
                                         into.get("model_cdf"))
        return out

    def _propose(self, generator, params: dict, B: int):
        """Model jump, transition draw, prior validity.  The draws read
        the CDFs of :meth:`prepare` where ``params`` carry them, and
        otherwise build their own."""
        model_cdf = params.get("model_cdf")
        if model_cdf is None:
            model_cdf = resampling_cdf(params["model_log_probs"])
        m_s = choice_from_cdf(generator, model_cdf, B)
        m = self.pert.rvs(generator, m_s)
        theta = torch.zeros(B, self.dim, device=self.device)
        for j in range(self.M):
            th_j = self._padded(self.transition_fns[j][0](
                generator, params["transition"][j], B))
            theta = torch.where((m == j)[:, None], th_j, theta)
        log_prior = self._log_prior(m, theta)
        return m, theta, log_prior, torch.isfinite(log_prior)

    def generation_round(self, generator, params: dict, B: int,
                         with_proposal: bool = True) -> RoundResult:
        """One batch of B candidates from the fitted proposal.  With
        ``with_proposal=False`` the proposal density — the KDE, the hot op
        — is skipped and the weights are partial; the sampler subtracts
        the density once over the accepted buffer (device_loop
        finalize)."""
        _phases.start()
        m, theta, log_prior, valid = self._propose(generator, params, B)
        _phases.mark("propose")
        stats, d, sim_accepted, log_acc_term = self._evaluate(
            generator, theta, m, params)
        accepted = sim_accepted & valid
        log_weight = log_prior + log_acc_term
        if with_proposal:
            log_proposal = self.proposal_log_density(m, theta, params)
            log_weight = log_weight - log_proposal
        else:
            # deferred: the records carry NaN, never a wrong density
            log_proposal = torch.full_like(log_weight, math.nan)
        log_weight = torch.where(accepted, log_weight, -math.inf)
        _phases.mark("density")
        return RoundResult(m=m, theta=theta, distance=d, accepted=accepted,
                           log_weight=log_weight, stats=stats, valid=valid,
                           log_proposal=log_proposal)

    # read by the sampler (through the bound method) to decide deferral
    generation_round.supports_deferred_proposal = True

    # ---- staged (multi-fidelity) generation round ------------------------

    def staged_generation_round(self, generator, params: dict, B: int,
                                full_fraction: float = 0.5,
                                with_proposal: bool = True):
        """Two stages: the cheap low-fidelity screen, then full fidelity
        on the survivors only.

        The proposal is :meth:`_propose`'s, as in
        :meth:`generation_round`; then every candidate runs its model's
        ``low_fidelity()`` variant, its distance is screened against
        ``params["fidelity"]["tau"]`` (``fidelity.screen_threshold``,
        computed by the block before the rounds), the first ``n_full =
        ceil(B * full_fraction)`` survivors are compacted into slots,
        simulated at full fidelity and put through the real accept test,
        and the results scatter back to batch shape: a screened-out row
        carries ``distance=+inf``, ``log_weight=-inf``, ``accepted=False``.

        Returns ``(RoundResult, (plo[n_full], pfull[n_full], npass[1]))``:
        the round's paired (low, full) distances (NaN in unused slots), the
        next generation's calibration samples, and the survivor count
        (int64).  No op reads the card."""
        m, theta, log_prior, valid = self._propose(generator, params, B)

        # low-fidelity stage on the whole batch
        stats_lo = self._simulate_all_low(generator, theta, m)
        d_lo = self.distance.compute(stats_lo, self.obs_flat,
                                     params["distance"])
        survive = screen_mask(d_lo, params["fidelity"]["tau"], valid)

        # the survivors' slots, simulated at full fidelity
        n_full = FidelityConfig.static_n_full(B, full_fraction)
        idx, slot_ok, idx_c = compact_survivors(survive, n_full)
        theta_f, m_f = theta[idx_c], m[idx_c]
        eps = params.get("acceptor", {}).get("eps", math.inf)
        stats_f, early_f = self._simulate_all(generator, theta_f, m_f, eps)
        d_f = self.distance.compute(stats_f, self.obs_flat,
                                    params["distance"])
        acc_f, acc_w_f = self.acceptor.accept(generator, d_f,
                                              params["acceptor"])
        accepted_f = acc_f & ~early_f & torch.isfinite(d_f) & slot_ok

        # the generation round's weight, on the slots
        lw_f = log_prior[idx_c] + torch.log(torch.clamp(acc_w_f, min=1e-38))
        if with_proposal:
            log_denom_f = self.proposal_log_density(m_f, theta_f, params)
            lw_f = lw_f - log_denom_f
            log_proposal = scatter_back(idx, log_denom_f, B, math.nan)
        else:
            log_proposal = torch.full((B,), math.nan, device=theta.device)
        lw_f = torch.where(accepted_f, lw_f, torch.full_like(lw_f,
                                                             -math.inf))

        nan = torch.full_like(d_f, math.nan)
        pairs = (torch.where(slot_ok, d_lo[idx_c], nan),
                 torch.where(slot_ok, d_f, nan), survive.sum()[None])
        rr = RoundResult(
            m=m, theta=theta,
            distance=scatter_back(idx, d_f, B, math.inf),
            accepted=scatter_back(idx, accepted_f, B, False),
            log_weight=scatter_back(idx, lw_f, B, -math.inf),
            stats=scatter_back(idx, stats_f, B, 0.0), valid=valid,
            log_proposal=log_proposal)
        return rr, pairs

    staged_generation_round.supports_deferred_proposal = True
