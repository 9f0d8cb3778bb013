"""SIR stochastic epidemic by tau-leaping — BASELINE config #4.

Port of ``pyabc_tpu/models/sir.py``: a fixed number of Poisson jump
steps with the whole candidate batch advanced in lockstep.  Per step and
candidate, ``n_inf ~ Poisson(β·S·I/N_pop·dt)`` infections and ``n_rec ~
Poisson(γ·I·dt)`` recoveries, clamped in that order (``n_inf ≤ S``, then
``n_rec ≤ I + n_inf``).  :meth:`SIRTauLeap.integrate` takes the Poisson
draw as an argument, so a test can replace it with a deterministic one
in both packages and compare the update exactly.  The peak and its time
come from a running maximum with a strict ``>``, so a plateau keeps its
first step, as ``jnp.argmax`` does.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..distance import AdaptivePNormDistance
from ..model import Model
from ..random_variables import RV, Distribution
from .lotka_volterra import obs_index


def sir_step(s: torch.Tensor, i: torch.Tensor, n_inf: torch.Tensor,
             n_rec: torch.Tensor):
    """One tau-leap update from raw Poisson counts: ``(s, i)`` after."""
    n_inf = torch.minimum(n_inf, s)
    n_rec = torch.minimum(n_rec, i + n_inf)
    return s - n_inf, i + n_inf - n_rec


class SIRTauLeap(Model):
    """S → I at rate β·S·I/N_pop, I → R at rate γ·I.

    ``theta = [log_beta, log_gamma]``; statistics ``infected`` at
    ``n_obs`` steps ``[N, n_obs]``, ``peak`` and ``peak_time`` ``[N]``.
    """

    #: the low-fidelity variant keeps the summary-stat layout
    screen_stats_compatible = True

    def __init__(self, n_pop: int = 1000, i0: int = 10,
                 t_max: float = 30.0, n_steps: int = 150,
                 n_obs: int = 10, name: str = "sir_tau_leap"):
        super().__init__(name)
        self.n_pop = int(n_pop)
        self.i0 = int(i0)
        self.t_max = float(t_max)
        self.n_steps = int(n_steps)
        self.dt = self.t_max / self.n_steps
        self.n_obs = int(n_obs)
        self.obs_idx = obs_index(self.n_steps, self.n_obs)

    def sample(self, generator, theta: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        return self.integrate(
            theta, lambda lam: torch.poisson(lam, generator=generator))

    def integrate(self, theta: torch.Tensor,
                  draw: Callable[[torch.Tensor], torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """The epidemic for ``theta[N, 2]``; ``draw(rate)`` returns one
        Poisson count per element of ``rate`` (float)."""
        beta = torch.exp(theta[:, 0])
        gamma = torch.exp(theta[:, 1])
        dt = self.dt
        s = torch.full_like(beta, float(self.n_pop - self.i0))
        i = torch.full_like(beta, float(self.i0))
        peak = torch.full_like(beta, float("-inf"))
        peak_k = torch.zeros_like(beta)
        keep = set(self.obs_idx.tolist())
        kept = {}
        for k in range(self.n_steps):
            n_inf = draw(beta * s * i / self.n_pop * dt)
            n_rec = draw(gamma * i * dt)
            s, i = sir_step(s, i, n_inf, n_rec)
            higher = i > peak
            peak = torch.where(higher, i, peak)
            peak_k = torch.where(higher, float(k), peak_k)
            if k in keep:
                kept[k] = i
        return {"infected": torch.stack([kept[k] for k in self.obs_idx], -1),
                "peak": peak, "peak_time": peak_k * dt}

    def low_fidelity(self) -> "SIRTauLeap":
        """4x coarser tau-leap over the same horizon and observations."""
        coarse = max(self.n_steps // 4, self.n_obs, 1)
        return SIRTauLeap(n_pop=self.n_pop, i0=self.i0, t_max=self.t_max,
                          n_steps=coarse, n_obs=self.n_obs,
                          name=self.name + "_lofi")


#: the generating parameters of the factory's observed data
SIR_TRUTH = (0.8, 0.2)


def make_sir_problem(generator=None):
    """(models, priors, distance, observed) with synthetic ground truth
    ``SIR_TRUTH``; the observed data come from ``generator`` (default: a
    CPU generator seeded with 11, the JAX package's key), so they are the
    same on every machine."""
    model = SIRTauLeap()
    prior = Distribution(
        log_beta=RV("uniform", -2.0, 3.0),
        log_gamma=RV("uniform", -3.0, 3.0),
    )
    if generator is None:
        generator = torch.Generator()
        generator.manual_seed(11)
    theta_true = torch.log(torch.tensor([SIR_TRUTH], dtype=torch.float32,
                                        device=generator.device))
    obs = model.simulate(generator, theta_true)
    observed = {k: v[0].cpu().numpy() for k, v in obs.items()}
    return [model], [prior], AdaptivePNormDistance(p=2), observed
