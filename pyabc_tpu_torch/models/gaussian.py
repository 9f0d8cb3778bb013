"""1-D Gaussian model — BASELINE config #1 (port of
``pyabc_tpu/models/gaussian.py``): y ~ N(mu, sigma²), prior
mu ~ N(0, prior_scale²)."""

from __future__ import annotations

import torch

from ..distance import PNormDistance
from ..model import SimpleModel
from ..random_variables import RV, Distribution


def gaussian_model(generator, theta):
    """y ~ N(mu, 1); ``theta[:, 0]`` = mu."""
    mu = theta[:, 0]
    return {"y": mu + torch.randn(mu.shape, generator=generator,
                                  device=mu.device)}


class GaussianModel(SimpleModel):
    def __init__(self, sigma: float = 1.0, name: str = "gaussian"):
        self.sigma = float(sigma)

        def fn(generator, theta):
            mu = theta[:, 0]
            noise = torch.randn(mu.shape, generator=generator,
                                device=mu.device)
            return {"y": mu + self.sigma * noise}

        super().__init__(fn, name=name)


def make_gaussian_problem(observed: float = 1.0, prior_scale: float = 1.0):
    """(models, priors, distance, observed) of config #1."""
    return ([GaussianModel()],
            [Distribution(mu=RV("norm", 0.0, prior_scale))],
            PNormDistance(p=2), {"y": observed})
