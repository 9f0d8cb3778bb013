"""PEtab ODE bridge: deterministic ODE simulation with the measurement
log-likelihood as the one summary statistic.

Port of ``pyabc_tpu/petab/ode.py``.  The whole candidate batch integrates
in one fixed-step RK4 loop (:class:`~pyabc_tpu_torch.models.ODEModel`) and
the Gaussian measurement log-likelihood ``llh`` is one reduction over the
observed steps; ``create_kernel`` reads it back as a log-scale
``SimpleFunctionKernel``.  With ``StochasticAcceptor`` and ``Temperature``
this is exact Bayesian inference on the ODE model (BASELINE config #5).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..distance.kernel import SCALE_LOG, SimpleFunctionKernel
from ..models.ode import ODEModel
from .base import PetabImporter

LLH = "llh"


class LikelihoodODEModel(ODEModel):
    """ODE model whose only summary statistic is the measurement
    log-likelihood ``{'llh': [N]}``.

    ``measurements`` maps observable keys (those of ``observe``, or the
    default ``y<i>``) to observed arrays; ``sigma`` is the Gaussian
    measurement noise, one scalar or one per observable.
    """

    def __init__(self, rhs: Callable, y0, t_max: float, n_steps: int,
                 measurements: Dict[str, np.ndarray],
                 sigma: Union[float, Dict[str, float]] = 1.0,
                 observe: Optional[Callable] = None,
                 obs_idx=None, name: str = "petab_ode"):
        super().__init__(rhs, y0, t_max, n_steps, observe=observe,
                         obs_idx=obs_idx, noise_scale=0.0, name=name)
        self.measurements = {k: np.asarray(v, dtype=np.float32)
                             for k, v in measurements.items()}
        if not isinstance(sigma, dict):
            sigma = {k: float(sigma) for k in self.measurements}
        self.sigma = {k: float(v) for k, v in sigma.items()}

    def sample(self, generator, theta: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        sim = super().sample(generator, theta)   # deterministic {key: [N, T]}
        n = theta.shape[0]
        llh = torch.zeros(n, dtype=torch.float32, device=theta.device)
        for k, y_obs in self.measurements.items():
            y_sim = sim[k].reshape(n, -1)
            s = self.sigma[k]
            resid = y_sim - torch.as_tensor(y_obs, device=theta.device)
            llh = llh + (-0.5 * (resid / s) ** 2
                         - 0.5 * math.log(2 * math.pi * s ** 2)).sum(-1)
        return {LLH: llh}


def _read_llh(x, x_0):
    return x[LLH].reshape(-1)


class ODEPetabImporter(PetabImporter):
    """Prior from the PEtab parameter table, a batched RK4 model returning
    the llh, and the kernel that reads it.

    ``rhs(y[N, S], theta[N, D]) -> [N, S]`` takes theta's columns in the
    prior's parameter order; ``y0``, ``t_max``, ``n_steps``, ``observe``
    and ``obs_idx`` set the grid and the observables (see
    :class:`~pyabc_tpu_torch.models.ODEModel`); ``measurements`` and
    ``sigma`` are the measurement table's content.
    """

    def __init__(self, problem, rhs: Callable, y0, t_max: float,
                 n_steps: int, measurements: Dict[str, np.ndarray],
                 sigma: Union[float, Dict[str, float]] = 1.0,
                 observe: Optional[Callable] = None, obs_idx=None):
        super().__init__(problem)
        self.rhs = rhs
        self.y0 = y0
        self.t_max = t_max
        self.n_steps = n_steps
        self.measurements = measurements
        self.sigma = sigma
        self.observe = observe
        self.obs_idx = obs_idx

    def create_model(self) -> LikelihoodODEModel:
        return LikelihoodODEModel(
            self.rhs, self.y0, self.t_max, self.n_steps,
            measurements=self.measurements, sigma=self.sigma,
            observe=self.observe, obs_idx=self.obs_idx)

    def create_kernel(self) -> SimpleFunctionKernel:
        """The log-scale kernel that reads the model's llh back."""
        return SimpleFunctionKernel(_read_llh, ret_scale=SCALE_LOG)

    def get_observed(self) -> Dict[str, float]:
        """The observed stats for ``ABCSMC.new``: the kernel ignores x_0
        (the data live in the measurement table), so a zero placeholder."""
        return {LLH: 0.0}
