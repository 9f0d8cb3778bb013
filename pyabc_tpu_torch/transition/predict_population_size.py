"""Predict the population size that meets a target density CV: fit
``cv(n) = a·n^b`` to bootstrap estimates and invert it.

Copied from ``pyabc_tpu/transition/predict_population_size.py`` (host
numpy, deterministic).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def fit_powerlaw(ns, cvs):
    """Least-squares fit of ``log cv = log a + b log n``: ``(a, b)``."""
    ns = np.asarray(ns, dtype=np.float64)
    cvs = np.maximum(np.asarray(cvs, dtype=np.float64), 1e-12)
    A = np.stack([np.ones_like(ns), np.log(ns)], axis=1)
    coef, *_ = np.linalg.lstsq(A, np.log(cvs), rcond=None)
    log_a, b = coef
    return np.exp(log_a), b


def predict_population_size(cv_estimates: Dict[int, float],
                            target_cv: float,
                            min_size: int = 8,
                            max_size: int = 10**7,
                            fallback: Optional[int] = None) -> int:
    """Invert the fitted power law at ``target_cv``, clipped to
    ``[min_size, max_size]``.  ``fallback`` (the caller's current size)
    comes back when the fit degenerates — cv not decreasing in n, or a
    non-finite inversion — so a noisy bootstrap cannot ratchet the size
    upward."""
    ns = list(cv_estimates.keys())
    cvs = [cv_estimates[n] for n in ns]
    if fallback is None:
        fallback = max(ns) if ns else min_size
    if len(ns) < 2:
        return int(ns[0]) if ns else int(fallback)
    a, b = fit_powerlaw(ns, cvs)
    if b >= 0:
        return int(fallback)
    n_req = (target_cv / a) ** (1.0 / b)
    if not np.isfinite(n_req):
        return int(fallback)
    return int(np.clip(n_req, min_size, max_size))
