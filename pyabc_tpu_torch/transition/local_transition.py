"""Local (k-NN covariance) KDE transition, à la Filippi et al.

Port of ``pyabc_tpu/transition/local_transition.py``: every particle
gets the weighted covariance of its k nearest neighbours (default k =
N/4), and the proposal mixes the per-particle Gaussians.

The fit runs on the transition's device (``device``; the run's when an
``ABCSMC`` owns it, else the card unless the caller asks for the CPU),
as the JAX package runs it on its device: the neighbour search is a
pairwise squared distance in chunks of :data:`_CHUNK` query rows plus
``torch.topk`` (ties at the k-th neighbour may pick a different,
equally near particle than ``lax.top_k``), then the ``[N, k, D]``
neighbour block (N²·D/4 floats at the default k: 0.4 GB at N = 1e4, D =
4), the covariances with the reference's trace-scaled jitter, and their
Cholesky factors (``cholesky_ex``: a factor that fails is NaN, as in
JAX, with no host read).  The fitted state leaves as host numpy, like
every transition's params.  The log-density solves each particle's
triangular factor against query chunks of :data:`_CHUNK` rows.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..device import device_of, resolve_device
from ..ops.choice import choice_from_cdf
from .base import Transition, support_cdf

#: query rows per chunk of the neighbour search and of the log-density
_CHUNK = 1024


class LocalTransition(Transition):
    """KDE with per-particle local covariances (k ≈ N/4 by default)."""

    # per-particle Cholesky stacks pad with identity so the solves stay
    # well-posed; the paired log_w = -1e30 rows carry no density mass
    PAD_FILL = {"log_w": -1e30, "chols": "eye"}

    def __init__(self, k: Optional[int] = None, k_fraction: float = 0.25,
                 scaling: float = 1.0, device=None):
        super().__init__()
        self.k = k
        self.k_fraction = float(k_fraction)
        self.scaling = float(scaling)
        #: where the fit runs (None: the owning run's device, or the card)
        self.device = device
        self._chols: Optional[np.ndarray] = None      # [N, D, D]
        self._log_norms: Optional[np.ndarray] = None  # [N]

    def _fit(self, theta: np.ndarray, w: np.ndarray):
        dev = resolve_device(self.device)
        n, d = theta.shape
        k = (self.k if self.k is not None
             else max(int(self.k_fraction * n), d + 1))
        k = min(max(k, d + 1), n)
        x = torch.as_tensor(theta, device=dev)
        wt = torch.as_tensor(w, device=dev)
        nbr = torch.cat([
            torch.topk(-((x[i:i + _CHUNK, None, :] - x[None, :, :]) ** 2
                         ).sum(-1), k, dim=1).indices
            for i in range(0, n, _CHUNK)])                 # [N, k]
        nb_theta = x[nbr]                                   # [N, k, D]
        nb_w = wt[nbr]
        nb_w = nb_w / nb_w.sum(1, keepdim=True)
        mean = (nb_theta * nb_w[..., None]).sum(1, keepdim=True)
        cent = nb_theta - mean
        cov = torch.einsum("nkd,nke,nk->nde", cent, cent, nb_w) * self.scaling
        trace = torch.diagonal(cov, dim1=1, dim2=2).sum(-1)
        cov = cov + 1e-6 * torch.eye(d, device=dev) * torch.clamp(
            trace[:, None, None] / d, min=1e-8)
        chols, info = torch.linalg.cholesky_ex(cov)
        chols = torch.where((info > 0)[:, None, None],
                            torch.full_like(chols, math.nan), chols)
        log_norms = (-0.5 * d * math.log(2 * math.pi)
                     - torch.log(torch.diagonal(chols, dim1=1, dim2=2)
                                 ).sum(-1))
        self._chols = chols.cpu().numpy()
        self._log_norms = log_norms.cpu().numpy()

    def get_params(self) -> dict:
        return {"support": self.theta,
                "log_w": np.log(np.maximum(self.w, 1e-38)),
                "chols": self._chols,
                "log_norms": self._log_norms}

    @staticmethod
    def rvs_from_params(generator: torch.Generator, params: dict,
                        n: int) -> torch.Tensor:
        """A weighted resample of the support (from the params' prepared
        CDF, when they carry one) plus its particle's correlated noise."""
        support = params["support"]
        idx = choice_from_cdf(generator, support_cdf(params), n)
        noise = torch.randn(n, support.shape[-1], generator=generator,
                            device=device_of(generator),
                            dtype=support.dtype)
        return support[idx] + torch.einsum("nde,ne->nd",
                                           params["chols"][idx], noise)

    @staticmethod
    def log_pdf_from_params(x: torch.Tensor, params: dict,
                            chunk: int = _CHUNK) -> torch.Tensor:
        """``logsumexp_i(log w_i + log N(x; X_i, L_i L_iᵀ))``."""
        support, log_w = params["support"], params["log_w"]
        chols, log_norms = params["chols"], params["log_norms"]
        out = []
        for i in range(0, x.shape[0], chunk):
            diff = x[i:i + chunk, None, :] - support[None, :, :]  # [C, N, D]
            z = torch.linalg.solve_triangular(
                chols, diff.permute(1, 2, 0), upper=False)       # [N, D, C]
            maha = (z * z).sum(1).T                               # [C, N]
            comp = log_w[None, :] - 0.5 * maha + log_norms[None, :]
            out.append(torch.logsumexp(comp, dim=-1))
        return torch.cat(out)
