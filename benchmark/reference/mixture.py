"""Config #2's posterior in closed form.

Frozen copy of ``posterior_fn`` in ``pyabc_tpu_torch/models/mixture.py``
(lines 36-47), with the normal CDF from ``math.erf`` in place of scipy's:
model j draws y ~ N(mu, sigma^2) with mu ~ U(loc_j, loc_j + width), so
the marginal likelihood of y is the uniform-normal convolution.
"""

from __future__ import annotations

import math


def norm_cdf(x: float, loc: float, scale: float) -> float:
    return 0.5 * (1.0 + math.erf((x - loc) / (scale * math.sqrt(2.0))))


def marginal(y: float, loc: float, width: float, sigma: float) -> float:
    return (norm_cdf(y, loc, sigma) - norm_cdf(y, loc + width, sigma)) / width


def p_model_b(y: float, mu_a: float, mu_b: float, width: float,
              sigma: float) -> float:
    """P(model B | y) under a uniform model prior."""
    pa = marginal(y, mu_a, width, sigma)
    pb = marginal(y, mu_b, width, sigma)
    return pb / (pa + pb)
