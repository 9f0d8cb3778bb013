"""BASELINE config #3's simulator: the stochastic Lotka-Volterra model.

Plain float64 PyTorch, the published Euler-Maruyama update of

    dX = (a X - b X Y) dt + sigma sqrt(X) dW1
    dY = (c b X Y - d Y) dt + sigma sqrt(Y) dW2

with theta = (log a, log b, log c, log d), X and Y clamped at 0 after
every step, from X0 = 10, Y0 = 5 over t_max = 15 in 300 steps, sigma
0.1, the states kept at 10 observation steps.  Given theta and the
standard-normal increments ``noise[n_steps, N, 2]`` the trajectories are
a deterministic function of them, so the port's simulator can be fed
the same block and compared.

Departures from the port (``pyabc_tpu_torch/models/lotka_volterra.py``):

- float64 throughout; the port integrates in float32.
- sqrt(dt) is taken in float64; the port rounds it to float32 first
  (as the JAX package does), a relative difference below 3e-8.
- The observation steps are floor((n_steps - 1) i / (n_obs - 1)) in
  integers; the port forms them by a float32 ``linspace`` and
  truncates.  They agree at the published sizes (0, 33, 66, 99, 132,
  166, 199, 232, 265, 299).
- As in the port, observation step k is the state after the update of
  step k (k + 1 updates from the start); the start is not observed.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

# a float32 matmul on the card may run in TF32; nothing here may
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: the published sizes (``LotkaVolterraSDE``'s defaults)
X0, Y0, T_MAX, N_STEPS, SIGMA, N_OBS = 10.0, 5.0, 15.0, 300, 0.1, 10


def obs_steps(n_steps: int = N_STEPS, n_obs: int = N_OBS) -> list:
    """The steps whose states are kept, evenly spread over the run
    (``n_obs`` >= 2)."""
    return [(n_steps - 1) * i // (n_obs - 1) for i in range(n_obs)]


def integrate(theta: torch.Tensor, noise: torch.Tensor,
              x0: float = X0, y0: float = Y0, t_max: float = T_MAX,
              sigma: float = SIGMA, n_obs: int = N_OBS
              ) -> Dict[str, torch.Tensor]:
    """``prey`` and ``predator``, ``[N, n_obs]`` each (float64), of
    ``theta[N, 4]`` under ``noise[n_steps, N, 2]``."""
    theta = theta.to(torch.float64)
    noise = noise.to(torch.float64)
    n_steps = noise.shape[0]
    a, b, c, d = (torch.exp(theta[:, i]) for i in range(4))
    dt = t_max / n_steps
    sqrt_dt = math.sqrt(dt)
    x = torch.full_like(a, x0)
    y = torch.full_like(a, y0)
    keep = obs_steps(n_steps, n_obs)
    kept = {}
    for k in range(n_steps):
        dx = ((a * x - b * x * y) * dt
              + sigma * torch.sqrt(x.clamp(min=0.0)) * sqrt_dt
              * noise[k, :, 0])
        dy = ((c * b * x * y - d * y) * dt
              + sigma * torch.sqrt(y.clamp(min=0.0)) * sqrt_dt
              * noise[k, :, 1])
        x = (x + dx).clamp(min=0.0)
        y = (y + dy).clamp(min=0.0)
        if k in keep:
            kept[k] = (x, y)
    return {"prey": torch.stack([kept[k][0] for k in keep], -1),
            "predator": torch.stack([kept[k][1] for k in keep], -1)}
