"""Weighted statistics for the host control plane.

Port of the host (numpy) half of ``pyabc_tpu/weighted_statistics.py``:
the epsilon schedule and the diagnostics run once per generation on
host float64 arrays, exactly as the JAX package runs them.  The
sort-free sketch it switches to above 2**20 points is not ported yet
(ROADMAP): the quantile here is the exact sort-and-interpolate oracle at
every size.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def weighted_quantile(points, weights: Optional[np.ndarray] = None,
                      alpha: float = 0.5) -> float:
    """Weighted ``alpha``-quantile: linear interpolation of the sorted
    points at midpoint cumulative weights, ``interp(alpha, cs - w/2,
    pts)`` (the reference convention)."""
    points = np.asarray(points)
    if weights is None:
        weights = np.full(points.shape, 1.0 / points.shape[0])
    weights = np.asarray(weights)
    weights = weights / np.sum(weights)
    order = np.argsort(points)
    pts = points[order]
    w = weights[order]
    cum = np.cumsum(w)
    return np.interp(alpha, cum - 0.5 * w, pts)


def weighted_median(points, weights=None) -> float:
    return weighted_quantile(points, weights, alpha=0.5)


def effective_sample_size(weights):
    """ESS = (Σw)² / Σw²."""
    weights = np.asarray(weights)
    return np.sum(weights) ** 2 / np.sum(weights ** 2)
