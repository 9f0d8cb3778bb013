"""Per-generation candidate rounds.

Port of ``RoundKernel`` from ``pyabc_tpu/sampler/rounds.py`` (the prior
round, the generation round and the proposal density; the staged
multi-fidelity round comes later).  One round proposes B candidates,
simulates every model on the whole batch and selects by model index,
computes distances, accepts, and forms the log importance weight

    log prior + log acceptance weight − log proposal density

where the proposal density is ``log Σ_s p_s · jump_pmf(s → m) + log
q_m(θ)`` with ``q_m`` the model's KDE.  Everything runs on the device of
the params and the generator; per-generation values arrive in
``params`` (tensors), so nothing here changes between generations.

Each round also marks the candidates that count as records (``valid``:
inside the prior support) and their generating proposal's log density
(``log_proposal``: the prior at t = 0, NaN where the density is
deferred).
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import torch

from ..acceptor import Acceptor
from ..distance.base import Distance
from ..model import Model
from ..ops.choice import fast_weighted_choice
from ..random_variables import Distribution, ModelPerturbationKernel
from ..sumstat import SumStatSpec
from .base import RoundResult


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
                      m: torch.Tensor) -> torch.Tensor:
        """Simulate every model on the full batch, select by model index
        (flops are spent on masked lanes — the fixed-shape trade)."""
        stats = torch.zeros(theta.shape[0], self.spec.total_size,
                            dtype=torch.float32, device=theta.device)
        for j, model in enumerate(self.models):
            s_j = self.spec.flatten(
                model.simulate(generator, theta[:, :self.priors[j].dim]))
            stats = torch.where((m == j)[:, None], s_j, stats)
        return stats

    def _evaluate(self, generator, theta, m, params, all_accepted=False):
        """Simulate + distance + accept: ``(stats, distance, accepted,
        log_acc_term)``.  Calibration (``all_accepted``) accepts every
        finite distance."""
        stats = self._simulate_all(generator, theta, m)
        d = self.distance.compute(stats, self.obs_flat, params["distance"])
        if all_accepted:
            return stats, d, torch.isfinite(d), torch.zeros_like(d)
        acc, acc_w = self.acceptor.accept(generator, d, params["acceptor"])
        accepted = acc & torch.isfinite(d)
        return stats, d, accepted, torch.log(torch.clamp(acc_w, min=1e-38))

    def _log_prior(self, m: torch.Tensor, theta: torch.Tensor
                   ) -> torch.Tensor:
        """Joint log prior: model prior pmf × parameter prior pdf."""
        log_prior = torch.full((theta.shape[0],), -math.inf,
                               device=theta.device)
        for j, prior in enumerate(self.priors):
            lp_j = prior.log_pdf_array(theta[:, :prior.dim])
            log_prior = torch.where(m == j, lp_j, log_prior)
        log_model_prior = torch.log_softmax(self.model_prior_logits, dim=0)
        return log_prior + log_model_prior[m]

    def _padded(self, th: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(th, (0, self.dim - th.shape[-1]))

    # ---- prior (calibration) round --------------------------------------

    def prior_round(self, generator, params: dict, B: int,
                    all_accepted: bool = False) -> RoundResult:
        m = fast_weighted_choice(generator, self.model_prior_logits, B)
        theta = torch.zeros(B, self.dim, device=self.device)
        for j, prior in enumerate(self.priors):
            th_j = self._padded(prior.rvs_array(generator, B))
            theta = torch.where((m == j)[:, None], th_j, theta)
        stats, d, accepted, log_acc_term = self._evaluate(
            generator, theta, m, params, all_accepted=all_accepted)
        # every prior draw is a record; its generating density is the prior
        return RoundResult(m=m, theta=theta, distance=d, accepted=accepted,
                           log_weight=log_acc_term, stats=stats,
                           valid=torch.ones_like(accepted),
                           log_proposal=self._log_prior(m, theta))

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

    def _propose(self, generator, params: dict, B: int):
        """Model jump, transition draw, prior validity."""
        m_s = fast_weighted_choice(generator, params["model_log_probs"], B)
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
        m, theta, log_prior, valid = self._propose(generator, params, B)
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
        return RoundResult(m=m, theta=theta, distance=d, accepted=accepted,
                           log_weight=log_weight, stats=stats, valid=valid,
                           log_proposal=log_proposal)

    # read by the sampler (through the bound method) to decide deferral
    generation_round.supports_deferred_proposal = True
