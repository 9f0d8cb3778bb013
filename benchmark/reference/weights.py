"""ABC-SMC importance weights, worked out again from the populations.

Generation t's particles were proposed from generation t - 1: a model
``s`` drawn with its probability, a jump to ``m`` (stay with
``p_stay``, else uniformly to another model), then ``theta`` from model
``m``'s Gaussian KDE over its particles of t - 1.  Each accepted
particle's weight is, up to one constant for the generation,

    prior(m) prior_m(theta) / (sum_s p_s jump(s -> m) * q_m(theta)),

with ``q_m`` the KDE: the weighted covariance of model m's particles
times Silverman's factor squared, plus a diagonal of 1e-8 of its mean
variance (pyABC's ``MultivariateNormalTransition``), the factor at the
particles' effective sample size.  The density is exact: every support
row, no grid, in blocks of query rows.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def silverman(n_eff: float, dim: int) -> float:
    return (4.0 / (n_eff * (dim + 2.0))) ** (1.0 / (dim + 4.0))


def kde_cov(theta: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The proposal's covariance from particles ``theta [N, d]`` with
    weights ``w`` (float64 throughout)."""
    theta = np.asarray(theta, np.float64)
    w = np.asarray(w, np.float64)
    w = w / w.sum()
    dim = theta.shape[1]
    n_eff = 1.0 / np.sum(w * w)
    mean = w @ theta
    centered = theta - mean
    cov = (centered * w[:, None]).T @ centered
    cov = cov * silverman(n_eff, dim) ** 2
    return cov + 1e-8 * np.eye(dim) * max(np.trace(cov) / dim, 1e-8)


def log_uniform_prior(theta: np.ndarray, box: Sequence[Sequence[float]]
                      ) -> np.ndarray:
    """log density of independent uniforms, ``box`` = [(loc, width)] per
    column; -inf outside."""
    out = np.zeros(theta.shape[0])
    for j, (loc, width) in enumerate(box):
        x = theta[:, j].astype(np.float64)
        inside = (x >= loc) & (x <= loc + width)
        out += np.where(inside, -math.log(width), -np.inf)
    return out


def kde_log_pdf(x: torch.Tensor, support: torch.Tensor, w: torch.Tensor,
                cov: np.ndarray, block: int = 128) -> torch.Tensor:
    """log sum_j w_j N(x_i; support_j, cov), in the dtype of ``x``, in
    blocks of ``block`` query rows.  ``w`` sums to 1."""
    dt, dev = x.dtype, x.device
    chol = np.linalg.cholesky(cov)
    inv = torch.as_tensor(np.linalg.inv(chol).T, device=dev).to(dt)
    dim = cov.shape[0]
    log_norm = (-0.5 * dim * math.log(2 * math.pi)
                - float(np.sum(np.log(np.diag(chol)))))
    zs = support @ inv
    log_w = torch.log(w)
    out = []
    for i in range(0, x.shape[0], block):
        zq = x[i:i + block] @ inv
        diff = zq[:, None, :] - zs[None, :, :]
        logit = log_w[None, :] - 0.5 * (diff * diff).sum(-1)
        out.append(torch.logsumexp(logit, dim=1))
    return torch.cat(out) + log_norm


def log_weights(prev: dict, cur: dict, idx: np.ndarray, priors: list,
                p_stay: float, device,
                dtype=torch.float64) -> np.ndarray:
    """The reference's log weight (up to a constant) of rows ``idx`` of
    generation ``cur``, proposed from generation ``prev``.  ``priors``
    holds each model's uniform box.  ``dtype`` is the precision of the
    density (float64: the reference; a lower one: the control)."""
    n_models = len(priors)
    m_prev = prev["m"]
    w_prev = prev["weight"].astype(np.float64)
    p_prev = np.array([w_prev[m_prev == j].sum() for j in range(n_models)])
    p_prev = p_prev / p_prev.sum()
    m = cur["m"][idx]
    theta = cur["theta"][idx]
    out = np.full(idx.shape[0], -np.inf)
    for j in range(n_models):
        rows = np.nonzero(m == j)[0]
        if not rows.size:
            continue
        dim = len(priors[j])
        th = theta[rows, :dim]
        if n_models == 1:
            log_mix = 0.0
        else:
            jump = (1.0 - p_stay) / (n_models - 1)
            log_mix = math.log(sum(p_prev[s] * (p_stay if s == j else jump)
                                   for s in range(n_models)))
        sel = m_prev == j
        sup = prev["theta"][sel, :dim]
        ws = w_prev[sel] / w_prev[sel].sum()
        cov = kde_cov(sup, ws)
        q = kde_log_pdf(torch.as_tensor(th, device=device).to(dtype),
                        torch.as_tensor(sup, device=device).to(dtype),
                        torch.as_tensor(ws, device=device).to(dtype), cov)
        q = q.to(torch.float64).cpu().numpy()
        out[rows] = (log_uniform_prior(th, priors[j])
                     - math.log(n_models) - log_mix - q)
    return out
