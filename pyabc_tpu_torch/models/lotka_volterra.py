"""Lotka-Volterra stochastic predator-prey model — BASELINE config #3.

Port of ``pyabc_tpu/models/lotka_volterra.py``: Euler-Maruyama
integration with the whole candidate batch advanced in lockstep, one
``[N]`` update per time step.  The Gaussian noise of every step is drawn
up front as one ``[n_steps, N, 2]`` block and :meth:`LotkaVolterraSDE.
integrate` is a deterministic function of ``(theta, noises)``, so a test
can feed it the JAX model's exact noise.  Only the observed steps are
kept, not the whole trajectory.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..distance import AdaptivePNormDistance
from ..model import Model
from ..random_variables import RV, Distribution


def obs_index(n_steps: int, n_obs: int) -> np.ndarray:
    """``int32[n_obs]`` observation steps: ``linspace(0, n_steps − 1,
    n_obs)`` in float32 as ``jnp.linspace`` forms it (``stop · i/div``,
    the endpoint appended exactly), truncated toward zero."""
    stop = np.float32(n_steps - 1)
    if n_obs <= 1:
        return np.zeros(max(n_obs, 0), np.int32)
    div = n_obs - 1
    frac = np.arange(div, dtype=np.float32) / np.float32(div)
    pts = np.float32(0.0) * (np.float32(1.0) - frac) + stop * frac
    return np.append(pts, stop).astype(np.float32).astype(np.int32)


class LotkaVolterraSDE(Model):
    """dX = (a·X − b·X·Y)dt + σ√X dW₁ ; dY = (c·b·X·Y − d·Y)dt + σ√Y dW₂.

    ``theta = [log_a, log_b, log_c, log_d]``; statistics ``prey`` and
    ``predator`` at ``n_obs`` steps, ``[N, n_obs]`` each.
    """

    #: the low-fidelity variant keeps the summary-stat layout
    screen_stats_compatible = True

    def __init__(self, x0: float = 10.0, y0: float = 5.0,
                 t_max: float = 15.0, n_steps: int = 300,
                 sigma: float = 0.1, n_obs: int = 10,
                 name: str = "lotka_volterra_sde"):
        super().__init__(name)
        self.x0, self.y0 = float(x0), float(y0)
        self.t_max, self.n_steps = float(t_max), int(n_steps)
        self.dt = self.t_max / self.n_steps
        self.sigma = float(sigma)
        self.n_obs = int(n_obs)
        self.obs_idx = obs_index(self.n_steps, self.n_obs)

    def sample(self, generator, theta: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        noises = torch.randn((self.n_steps, theta.shape[0], 2),
                             generator=generator, device=theta.device)
        return self.integrate(theta, noises)

    def integrate(self, theta: torch.Tensor, noises: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        """The trajectories for ``theta[N, 4]`` under ``noises[n_steps,
        N, 2]`` standard normal increments."""
        a, b, c, d = (torch.exp(theta[:, i]) for i in range(4))
        dt, sig = self.dt, self.sigma
        # sqrt in float32, as jnp.sqrt of the float32 dt
        sqrt_dt = float(np.sqrt(np.float32(dt)))
        x = torch.full_like(a, self.x0)
        y = torch.full_like(a, self.y0)
        keep = set(self.obs_idx.tolist())
        kept = {}
        for k in range(self.n_steps):
            dx = (a * x - b * x * y) * dt + sig * torch.sqrt(
                torch.clamp(x, min=0.0)) * sqrt_dt * noises[k, :, 0]
            dy = (c * b * x * y - d * y) * dt + sig * torch.sqrt(
                torch.clamp(y, min=0.0)) * sqrt_dt * noises[k, :, 1]
            x = torch.clamp(x + dx, min=0.0)
            y = torch.clamp(y + dy, min=0.0)
            if k in keep:
                kept[k] = (x, y)
        return {
            "prey": torch.stack([kept[k][0] for k in self.obs_idx], -1),
            "predator": torch.stack([kept[k][1] for k in self.obs_idx], -1),
        }

    def low_fidelity(self) -> "LotkaVolterraSDE":
        """4x coarser grid over the same horizon and observation count."""
        coarse = max(self.n_steps // 4, self.n_obs, 1)
        return LotkaVolterraSDE(x0=self.x0, y0=self.y0, t_max=self.t_max,
                                n_steps=coarse, sigma=self.sigma,
                                n_obs=self.n_obs, name=self.name + "_lofi")


#: the generating parameters of the factory's observed data
LV_TRUTH = (1.1, 0.4, 1.0, 0.4)


def make_lotka_volterra_problem(generator=None):
    """(models, priors, distance, observed) with synthetic ground truth
    ``LV_TRUTH``; the observed data come from ``generator`` (default: a
    CPU generator seeded with 7, the JAX package's key), so they are the
    same on every machine."""
    model = LotkaVolterraSDE()
    prior = Distribution(
        log_a=RV("uniform", -1.0, 2.0),
        log_b=RV("uniform", -3.0, 2.0),
        log_c=RV("uniform", -2.0, 2.0),
        log_d=RV("uniform", -1.0, 2.0),
    )
    if generator is None:
        generator = torch.Generator()
        generator.manual_seed(7)
    theta_true = torch.log(torch.tensor([LV_TRUTH], dtype=torch.float32,
                                        device=generator.device))
    obs = model.simulate(generator, theta_true)
    observed = {k: v[0].cpu().numpy() for k, v in obs.items()}
    return [model], [prior], AdaptivePNormDistance(p=2), observed
