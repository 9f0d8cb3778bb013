"""Discrete random-walk transition for integer parameters (port of
``pyabc_tpu/transition/randomwalk.py``): a weighted resample of the
support plus an integer step per dimension, 0 with probability
``p_stay``, else uniform over ``{-n_steps, …, n_steps} \\ {0}``.  The pmf
of a query is ``Σ_i w_i · Π_d p(step = x_d − X_id)``, batched."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.choice import choice_from_cdf, fast_weighted_choice
from .base import Transition, support_cdf


class DiscreteRandomWalkTransition(Transition):
    NO_PAD_KEYS = ("step_log_probs", "n_steps")  # shared walk config

    def __init__(self, n_steps: int = 1, p_stay: float = 0.5):
        super().__init__()
        self.n_steps = int(n_steps)
        self.p_stay = float(p_stay)

    def _fit(self, theta, w):
        pass  # nothing beyond support and weights

    def _step_log_probs(self) -> np.ndarray:
        """log p(step) over offsets ``[-n_steps .. n_steps]``."""
        n_off = 2 * self.n_steps + 1
        probs = np.full(n_off, (1.0 - self.p_stay) / (n_off - 1),
                        dtype=np.float32)
        probs[self.n_steps] = self.p_stay
        return np.log(probs)

    def get_params(self) -> dict:
        return {"support": self.theta,
                "log_w": np.log(np.maximum(self.w, 1e-38)),
                "step_log_probs": self._step_log_probs(),
                "n_steps": self.n_steps}

    @staticmethod
    def rvs_from_params(generator: torch.Generator, params: dict,
                        n: int) -> torch.Tensor:
        support, slp = params["support"], params["step_log_probs"]
        n_steps = (slp.shape[0] - 1) // 2  # static: no device read
        # the support's draw from the params' prepared CDF, when they
        # carry one; the step pmf is a few entries
        idx = choice_from_cdf(generator, support_cdf(params), n)
        d = support.shape[-1]
        steps = fast_weighted_choice(generator, slp, n * d).view(n, d) \
            - n_steps
        return support[idx] + steps.to(support.dtype)

    @staticmethod
    def log_pdf_from_params(x: torch.Tensor, params: dict) -> torch.Tensor:
        support, log_w = params["support"], params["log_w"]
        slp = params["step_log_probs"]
        n_steps = (slp.shape[0] - 1) // 2
        diff = torch.round(x[:, None, :] - support[None, :, :]).to(
            torch.int64)
        in_range = diff.abs() <= n_steps
        per_dim = torch.where(
            in_range, slp[(diff + n_steps).clamp(0, slp.shape[0] - 1)],
            torch.full(diff.shape, -torch.inf, device=x.device))
        return torch.logsumexp(log_w[None, :] + per_dim.sum(-1), dim=-1)
