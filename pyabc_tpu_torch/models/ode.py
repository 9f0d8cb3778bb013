"""Deterministic ODE models by fixed-step RK4.

Port of ``pyabc_tpu/models/ode.py``: the whole candidate batch advances in
lockstep, one RK4 step per iteration of a Python loop over the grid, and
only the observed steps are kept.  :meth:`ODEModel.integrate` is the
noise-free trajectory at the observed steps, a deterministic function of
``theta``; ``sample`` adds measurement noise from the generator when
``noise_scale > 0``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..model import Model


class ODEModel(Model):
    """Fixed-step RK4 for ``dy/dt = rhs(y, theta)``.

    ``rhs(y[N, S], theta[N, D]) -> [N, S]`` must be batched; ``observe``
    maps the observed states ``[T_obs, N, S]`` to a sum-stat dict, by
    default one stat ``y<i>`` of ``[N, T_obs]`` per state.
    """

    #: the low-fidelity variant keeps the summary-stat layout
    screen_stats_compatible = True

    def __init__(self, rhs: Callable, y0, t_max: float, n_steps: int,
                 observe: Optional[Callable] = None,
                 obs_idx=None, noise_scale: float = 0.0,
                 name: str = "ode"):
        super().__init__(name)
        self.rhs = rhs
        self.y0 = np.asarray(y0, dtype=np.float32)
        self.t_max = float(t_max)
        self.n_steps = int(n_steps)
        self.dt = self.t_max / self.n_steps
        self.observe = observe
        self.obs_idx = (np.asarray(obs_idx, dtype=np.int32)
                        if obs_idx is not None
                        else np.arange(self.n_steps, dtype=np.int32))
        self.noise_scale = float(noise_scale)

    def integrate(self, theta: torch.Tensor) -> torch.Tensor:
        """The states after each observed step, ``[T_obs, N, S]``."""
        n = theta.shape[0]
        y = torch.as_tensor(self.y0, device=theta.device).expand(
            (n,) + self.y0.shape).clone()
        dt = self.dt
        keep = set(self.obs_idx.tolist())
        kept = {}
        for k in range(self.n_steps):
            k1 = self.rhs(y, theta)
            k2 = self.rhs(y + 0.5 * dt * k1, theta)
            k3 = self.rhs(y + 0.5 * dt * k2, theta)
            k4 = self.rhs(y + dt * k3, theta)
            y = y + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
            if k in keep:
                kept[k] = y
        return torch.stack([kept[k] for k in self.obs_idx.tolist()])

    def sample(self, generator, theta: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        obs = self.integrate(theta)
        if self.noise_scale > 0:
            obs = obs + self.noise_scale * torch.randn(
                obs.shape, generator=generator, device=obs.device)
        if self.observe is not None:
            return self.observe(obs)
        return {f"y{i}": torch.movedim(obs[..., i], 0, -1)
                for i in range(obs.shape[-1])}

    def low_fidelity(self) -> "ODEModel":
        """4x coarser grid over the same horizon; the observation indices
        are rescaled onto it with their count kept, so every summary
        statistic keeps its shape."""
        coarse = max(self.n_steps // 4, 1)
        idx = np.asarray(self.obs_idx, dtype=np.float64)
        scaled = np.clip(np.round(idx * coarse / self.n_steps), 0,
                         coarse - 1).astype(np.int32)
        return ODEModel(rhs=self.rhs, y0=self.y0, t_max=self.t_max,
                        n_steps=coarse, observe=self.observe,
                        obs_idx=scaled, noise_scale=self.noise_scale,
                        name=self.name + "_lofi")
