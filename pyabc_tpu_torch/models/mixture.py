"""Two competing Gaussian models — the model-selection problem of
BASELINE config #2 (port of ``pyabc_tpu/models/mixture.py``)."""

from __future__ import annotations

import torch

from ..distance import PNormDistance
from ..model import SimpleModel
from ..random_variables import RV, Distribution


def make_two_gaussians_problem(sigma: float = 0.5,
                               y_observed: float = 1.0,
                               mu_a: float = -0.5, mu_b: float = 0.5,
                               prior_width: float = 1.0):
    """Two models differing only in the prior location of their mean:
    model j simulates y ~ N(mu, sigma²), mu ~ U(mu_j, mu_j + width).

    Returns ``(models, priors, distance, observed, posterior_fn)`` where
    ``posterior_fn(y)`` is the analytic model-B posterior probability.
    """

    def sample_fn(generator, theta):
        mu = theta[:, 0]
        noise = torch.randn(mu.shape, generator=generator, device=mu.device)
        return {"y": mu + sigma * noise}

    models = [SimpleModel(sample_fn, name="model_a"),
              SimpleModel(sample_fn, name="model_b")]
    priors = [Distribution(mu=RV("uniform", mu_a, prior_width)),
              Distribution(mu=RV("uniform", mu_b, prior_width))]
    distance = PNormDistance(p=2)
    observed = {"y": y_observed}

    def posterior_fn(y: float) -> float:
        """P(model B | y) under a uniform model prior: the marginal
        likelihood of y is the uniform-normal convolution."""
        from scipy import stats as ss

        def marginal(lo, width):
            return (ss.norm.cdf(y, lo, sigma)
                    - ss.norm.cdf(y, lo + width, sigma)) / width

        pa = marginal(mu_a, prior_width)
        pb = marginal(mu_b, prior_width)
        return pb / (pa + pb)

    return models, priors, distance, observed, posterior_fn
