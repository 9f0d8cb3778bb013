"""Gaussian-KDE transition — the default proposal kernel.

Port of ``pyabc_tpu/transition/multivariatenormal.py``.  The fit
(weighted covariance × bandwidth² × scaling, Cholesky factor, the
grid-compressed pdf support) is host numpy, the same arithmetic as the
JAX package's host path; ``rvs_from_params`` and ``log_pdf_from_params``
run on the params' device, the latter through the weighted-KDE kernel
(``ops.kde.weighted_kde_logpdf_auto``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops.choice import fast_weighted_choice
from ..ops.kde import weighted_kde_logpdf_auto
from ..weighted_statistics import effective_sample_size
from .base import Transition

#: pdf-support compression thresholds (see _compress_support)
_COMPRESS_MIN_N = 1 << 14
_COMPRESS_MAX_G = 1 << 16
_COMPRESS_CELLS_PER_BW = 64


def smart_cov(theta: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Weighted covariance, identity when singular or non-finite
    (e.g. a single particle)."""
    mean = np.sum(theta * w[:, None], axis=0)
    centered = theta - mean
    cov = (centered * w[:, None]).T @ centered
    bad = ~np.all(np.isfinite(cov)) | (np.trace(cov) <= 0)
    return np.where(bad, np.eye(theta.shape[-1], dtype=theta.dtype), cov)


def regularized_kde_cov(theta: np.ndarray, w: np.ndarray,
                        bandwidth_selector, scaling: float) -> np.ndarray:
    """``smart_cov × bandwidth² × scaling`` plus a trace-scaled diagonal
    jitter; ``w`` must be normalized."""
    dim = theta.shape[-1]
    n_eff = effective_sample_size(w)
    bw = bandwidth_selector(n_eff, dim)
    cov = smart_cov(theta, w) * (bw ** 2) * scaling
    return cov + 1e-8 * np.eye(dim, dtype=cov.dtype) * np.maximum(
        np.trace(cov) / dim, 1e-8)


def silverman_rule_of_thumb(n_eff, dim):
    """Silverman bandwidth factor."""
    return (4.0 / (n_eff * (dim + 2.0))) ** (1.0 / (dim + 4.0))


def scott_rule_of_thumb(n_eff, dim):
    """Scott bandwidth factor."""
    return n_eff ** (-1.0 / (dim + 4.0))


class MultivariateNormalTransition(Transition):
    """Weighted Gaussian KDE proposal."""

    # shared KDE state and the grid-compressed pdf support (grid-sized,
    # not per particle) pass through pad_params unchanged
    NO_PAD_KEYS = ("chol", "log_norm", "c_support", "c_log_w")

    def __init__(self, scaling: float = 1.0,
                 bandwidth_selector: Callable = silverman_rule_of_thumb):
        super().__init__()
        self.scaling = float(scaling)
        self.bandwidth_selector = bandwidth_selector
        self._chol: Optional[np.ndarray] = None
        self._log_norm = None
        self._compressed: Optional[tuple] = None
        self._grid_g: Optional[int] = None

    def _fit(self, theta: np.ndarray, w: np.ndarray):
        dim = theta.shape[-1]
        cov = regularized_kde_cov(theta, w, self.bandwidth_selector,
                                  self.scaling)
        self._chol = np.linalg.cholesky(cov)
        self._log_norm = (-0.5 * dim * np.log(2 * np.pi)
                          - np.sum(np.log(np.diag(self._chol))))
        self._compressed = self._compress_support(theta, w)

    def _compress_support(self, theta: np.ndarray, w: np.ndarray
                          ) -> Optional[tuple]:
        """Zeroth/first-moment grid compression of a large 1-D pdf support.

        The density of a KDE with bandwidth h changes only at scale h, so
        for the pdf (not rvs — resampling stays exact on the full support)
        the N-point support is replaced by G cells of width h/64 carrying
        each cell's (weight mass, weighted centroid); centring each cell's
        Gaussian at its centroid leaves a second-order log-density error
        (≲ 1e-3 worst case).  G rides a power-of-two ladder that never
        shrinks on one instance (floor 8192, cap 2**16); empty cells carry
        log weight -1e30.
        """
        n, dim = theta.shape
        if dim != 1 or n < _COMPRESS_MIN_N:
            return None
        h = float(np.asarray(self._chol)[0, 0])
        x = np.asarray(theta[:, 0], dtype=np.float64)
        lo, hi = float(x.min()), float(x.max())
        rng = hi - lo
        if not (np.isfinite(rng) and rng > 0 and h > 0):
            return None
        g_needed = _COMPRESS_CELLS_PER_BW * rng / h
        if g_needed > _COMPRESS_MAX_G:
            return None  # the grid cannot resolve the bandwidth: exact
        g = 1 << max(int(np.ceil(np.log2(max(g_needed, 8192)))), 0)
        if self._grid_g is not None:
            g = max(g, self._grid_g)
        self._grid_g = g
        dx = rng / g
        idx = np.clip(((x - lo) / dx).astype(np.int64), 0, g - 1)
        w64 = np.asarray(w, dtype=np.float64)
        mass = np.bincount(idx, weights=w64, minlength=g)
        first = np.bincount(idx, weights=w64 * x, minlength=g)
        centers = lo + (np.arange(g) + 0.5) * dx
        centroid = np.where(mass > 0, first / np.maximum(mass, 1e-300),
                            centers)
        log_mass = np.where(mass > 0,
                            np.log(np.maximum(mass, 1e-300)), -1e30)
        return (centroid[:, None].astype(np.float32),
                log_mass.astype(np.float32))

    def get_params(self) -> dict:
        params = {
            "support": self.theta,
            "log_w": np.log(np.maximum(self.w, 1e-38)),
            "chol": self._chol,
            "log_norm": self._log_norm,
        }
        if self._compressed is not None:
            params["c_support"], params["c_log_w"] = self._compressed
        return params

    @staticmethod
    def rvs_from_params(generator: torch.Generator, params: dict,
                        n: int) -> torch.Tensor:
        """Weighted resample of a support row plus correlated noise."""
        support, chol = params["support"], params["chol"]
        idx = fast_weighted_choice(generator, params["log_w"], n)
        noise = torch.randn(n, support.shape[-1], generator=generator,
                            device=support.device, dtype=support.dtype)
        return support[idx] + noise @ chol.T

    @staticmethod
    def log_pdf_from_params(x: torch.Tensor, params: dict) -> torch.Tensor:
        """logsumexp_i(log w_i + log N(x − X_i; Σ)) through the KDE kernel,
        against the grid-compressed support when the fit produced one."""
        if "c_support" in params:
            return weighted_kde_logpdf_auto(
                x, params["c_support"], params["c_log_w"], params["chol"],
                params["log_norm"])
        return weighted_kde_logpdf_auto(
            x, params["support"], params["log_w"], params["chol"],
            params["log_norm"])
