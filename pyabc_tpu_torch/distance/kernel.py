"""Stochastic kernels: likelihood densities for exact stochastic acceptance.

Port of ``pyabc_tpu/distance/kernel.py``.  A :class:`StochasticKernel` is
a "distance" that returns the (log-)density of the observed data ``x_0``
under a noise model centred on the simulated statistics ``x``; it is
consumed by ``StochasticAcceptor`` and ``Temperature`` (the stochastic
triple, guarded in ``ABCSMC``).  Every kernel evaluates the whole batch
in log space on the device (``gammaln`` is ``torch.lgamma``); the
``pdf_max`` helpers of the count kernels are host scipy, once per run.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .base import Distance

SCALE_LIN = "SCALE_LIN"
SCALE_LOG = "SCALE_LOG"


class StochasticKernel(Distance):
    """Density of ``x_0`` given simulated ``x``.

    ``ret_scale``: whether :meth:`compute` returns the density
    (SCALE_LIN) or the log-density (SCALE_LOG).  ``pdf_max``: an upper
    bound on the density, on the ``ret_scale``, used by the acceptor's
    normalization; computed at bind time when not given.
    """

    def __init__(self, ret_scale: str = SCALE_LIN,
                 keys: Optional[Sequence[str]] = None,
                 pdf_max: Optional[float] = None):
        super().__init__()
        if ret_scale not in (SCALE_LIN, SCALE_LOG):
            raise ValueError(
                f"ret_scale must be SCALE_LIN/SCALE_LOG: {ret_scale}")
        self.ret_scale = ret_scale
        self.keys = list(keys) if keys is not None else None
        self.pdf_max = pdf_max
        self._x0_flat: Optional[np.ndarray] = None

    def _on_bind(self, x_0):
        if self.keys is None:
            self.keys = list(self.spec.keys)
        if x_0 is not None:
            self._x0_flat = self.spec.flatten_single(x_0).numpy()
            if self.pdf_max is None:
                self.pdf_max = self._compute_pdf_max()

    def _compute_pdf_max(self) -> Optional[float]:
        """Default: the density at ``x = x_0``."""
        x0 = torch.as_tensor(self._x0_flat)
        logd = float(self.log_density(x0[None, :], x0)[0])
        return logd if self.ret_scale == SCALE_LOG else float(np.exp(logd))

    def log_density(self, stats: torch.Tensor, obs: torch.Tensor
                    ) -> torch.Tensor:
        """Batched log-density ``[N, S], [S] -> [N]``."""
        raise NotImplementedError

    def compute(self, stats, obs, params) -> torch.Tensor:
        logd = self.log_density(stats, obs)
        return logd if self.ret_scale == SCALE_LOG else torch.exp(logd)


class SimpleFunctionKernel(StochasticKernel):
    """Wrap a user density ``fn(x_dict, x0_dict) -> [N]`` on the
    ``ret_scale``."""

    def __init__(self, fn: Callable, ret_scale: str = SCALE_LIN,
                 pdf_max=None):
        super().__init__(ret_scale=ret_scale, pdf_max=pdf_max)
        self.fn = fn

    def _compute_pdf_max(self):
        return None

    def compute(self, stats, obs, params) -> torch.Tensor:
        return self.fn(self.spec.unflatten(stats), self.spec.unflatten(obs))


class NormalKernel(StochasticKernel):
    """Multivariate normal kernel with a full covariance."""

    def __init__(self, cov=None, ret_scale: str = SCALE_LOG, keys=None,
                 pdf_max=None):
        super().__init__(ret_scale=ret_scale, keys=keys, pdf_max=pdf_max)
        self._cov_in = cov
        self._chol: Optional[np.ndarray] = None
        self._log_det: Optional[float] = None

    def _on_bind(self, x_0):
        dim = self.spec.total_size
        cov = self._cov_in if self._cov_in is not None else np.eye(dim)
        cov = np.atleast_2d(np.asarray(cov, dtype=np.float64))
        if cov.shape != (dim, dim):
            cov = np.diag(np.broadcast_to(np.diag(cov) if cov.ndim == 2
                                          else cov, (dim,)))
        chol = np.linalg.cholesky(cov)
        self._chol = chol.astype(np.float32)
        self._log_det = float(2.0 * np.sum(np.log(np.diag(chol))))
        super()._on_bind(x_0)

    def log_density(self, stats, obs):
        diff = stats - obs
        chol = torch.as_tensor(self._chol, device=stats.device)
        # L z = diff^T, the Mahalanobis distance is ||z||^2
        z = torch.linalg.solve_triangular(chol, diff.T, upper=False).T
        dim = diff.shape[-1]
        return -0.5 * ((z * z).sum(-1) + dim * math.log(2 * math.pi)
                       + self._log_det)


class IndependentNormalKernel(StochasticKernel):
    """Diagonal normal kernel (no covariance matrix is formed)."""

    def __init__(self, var=None, ret_scale: str = SCALE_LOG, keys=None,
                 pdf_max=None):
        super().__init__(ret_scale=ret_scale, keys=keys, pdf_max=pdf_max)
        self._var_in = var
        self._var: Optional[np.ndarray] = None

    def _on_bind(self, x_0):
        dim = self.spec.total_size
        var = self._var_in if self._var_in is not None else np.ones(dim)
        self._var = np.broadcast_to(
            np.asarray(var, dtype=np.float32).reshape(-1), (dim,)).copy()
        super()._on_bind(x_0)

    def log_density(self, stats, obs):
        var = torch.as_tensor(self._var, device=stats.device)
        return (-0.5 * ((stats - obs) ** 2 / var
                        + torch.log(2 * math.pi * var))).sum(-1)


class IndependentLaplaceKernel(StochasticKernel):
    """Diagonal Laplace kernel."""

    def __init__(self, scale=None, ret_scale: str = SCALE_LOG, keys=None,
                 pdf_max=None):
        super().__init__(ret_scale=ret_scale, keys=keys, pdf_max=pdf_max)
        self._scale_in = scale
        self._scale: Optional[np.ndarray] = None

    def _on_bind(self, x_0):
        dim = self.spec.total_size
        scale = (self._scale_in if self._scale_in is not None
                 else np.ones(dim))
        self._scale = np.broadcast_to(
            np.asarray(scale, dtype=np.float32).reshape(-1), (dim,)).copy()
        super()._on_bind(x_0)

    def log_density(self, stats, obs):
        b = torch.as_tensor(self._scale, device=stats.device)
        return (-(stats - obs).abs() / b - torch.log(2 * b)).sum(-1)


def _binom_logpmf(k, n, p: float):
    return (torch.lgamma(n + 1) - torch.lgamma(k + 1)
            - torch.lgamma(n - k + 1) + k * math.log(p)
            + (n - k) * math.log1p(-p))


class BinomialKernel(StochasticKernel):
    """Binomial kernel: ``x_0 ~ Binom(n = x, p)``; ``pdf_max`` maximizes
    the pmf over ``n``."""

    def __init__(self, p: float, ret_scale: str = SCALE_LOG, keys=None,
                 pdf_max=None):
        if not 0 < p <= 1:
            raise ValueError("p must be in (0, 1]")
        super().__init__(ret_scale=ret_scale, keys=keys, pdf_max=pdf_max)
        self.p = float(p)

    def log_density(self, stats, obs):
        n = torch.clamp(torch.round(stats), min=0.0)
        k = torch.round(obs).expand_as(n)
        valid = (k >= 0) & (k <= n)
        logpmf = torch.where(
            valid, _binom_logpmf(torch.where(valid, k, torch.zeros_like(k)),
                                 torch.clamp(n, min=1e-10), self.p),
            torch.full_like(n, -math.inf))
        # n == 0, k == 0: pmf 1
        logpmf = torch.where((n == 0) & (k == 0), torch.zeros_like(n),
                             logpmf)
        return logpmf.sum(-1)

    def _compute_pdf_max(self) -> float:
        from scipy.stats import binom
        k = np.maximum(np.round(self._x0_flat), 0.0)
        best = np.zeros_like(k)
        for i, ki in enumerate(k):
            ns = np.arange(max(ki, 1), max(ki / self.p * 2, ki + 2) + 1)
            best[i] = np.max(binom.logpmf(ki, ns, self.p))
        total = float(np.sum(best))
        return total if self.ret_scale == SCALE_LOG else float(np.exp(total))


class PoissonKernel(StochasticKernel):
    """Poisson kernel: ``x_0 ~ Poisson(λ = x)``."""

    def __init__(self, ret_scale: str = SCALE_LOG, keys=None, pdf_max=None):
        super().__init__(ret_scale=ret_scale, keys=keys, pdf_max=pdf_max)

    def log_density(self, stats, obs):
        lam = torch.clamp(stats, min=1e-10)
        k = torch.round(obs)
        logpmf = k * torch.log(lam) - lam - torch.lgamma(k + 1)
        return torch.where(k >= 0, logpmf,
                           torch.full_like(logpmf, -math.inf)).sum(-1)

    def _compute_pdf_max(self) -> float:
        from scipy.stats import poisson
        k = np.maximum(np.round(self._x0_flat), 0.0)
        total = float(np.sum(poisson.logpmf(k, np.maximum(k, 1e-10))))
        return total if self.ret_scale == SCALE_LOG else float(np.exp(total))


class NegativeBinomialKernel(StochasticKernel):
    """Negative binomial kernel: ``x_0 ~ NB(r = x, p)``."""

    def __init__(self, p: float, ret_scale: str = SCALE_LOG, keys=None,
                 pdf_max=None):
        if not 0 < p <= 1:
            raise ValueError("p must be in (0, 1]")
        super().__init__(ret_scale=ret_scale, keys=keys, pdf_max=pdf_max)
        self.p = float(p)

    def log_density(self, stats, obs):
        r = torch.clamp(stats, min=1e-10)
        k = torch.round(obs)
        logpmf = (torch.lgamma(k + r) - torch.lgamma(k + 1)
                  - torch.lgamma(r) + r * math.log(self.p)
                  + k * math.log1p(-self.p))
        return torch.where(k >= 0, logpmf,
                           torch.full_like(logpmf, -math.inf)).sum(-1)

    def _compute_pdf_max(self):
        return None
