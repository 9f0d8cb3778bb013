"""Weighted statistics: quantiles, moments, ESS, resampling.

Port of ``pyabc_tpu/weighted_statistics.py``.  Every function takes host
numpy arrays or tensors and answers in kind: the control plane calls
them once per generation on host float64 arrays, exactly as the JAX
package does, and a device caller keeps its tensors on the device.

Above :data:`POP_MATERIALIZE_CAP` points a quantile never sorts: tensors
go through the histogram sketch (:mod:`.ops.quantile_sketch`), host
arrays through the iterated-histogram refinement
:func:`_np_sketch_quantile`.  Above :data:`RESIDUAL_RANK_CAP` support
points the deterministic resampler ranks its residuals with the sketch's
top-k instead of a sort.  Both checks are on the shape alone.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops.choice import fast_weighted_choice, ordered_cumsum
from .ops.quantile_sketch import sketch_topk_mask, sketch_weighted_quantile

#: population size above which a quantile routes sort-free
POP_MATERIALIZE_CAP = 1 << 20
#: support size above which the deterministic resampler's residual
#: ranking uses the sort-free top-k sketch
RESIDUAL_RANK_CAP = 1 << 14


def _np_sketch_quantile(points, weights, alpha, bins: int = 4096,
                        passes: int = 3):
    """Host twin of the sketch: iterated fixed-bin histogram refinement
    by ``np.bincount``, O(N) per pass, no sorted copy.  The bracket after
    p passes is ``range / bins**p`` wide."""
    points = np.asarray(points, np.float64).ravel()
    if weights is None:
        weights = np.full(points.shape, 1.0 / points.shape[0])
    weights = np.asarray(weights, np.float64).ravel()
    finite = np.isfinite(points)
    if not finite.all():
        points, weights = points[finite], weights[finite]
    total = float(np.sum(weights))
    if points.size == 0 or total <= 0:
        return np.float64(np.nan)
    lo, hi = float(np.min(points)), float(np.max(points))
    below = 0.0
    target = float(alpha) * total
    for _ in range(passes):
        width = max((hi - lo) / bins, 1e-300)
        sel = (points >= lo) & (points <= hi)
        idx = np.clip(((points[sel] - lo) / width).astype(np.int64),
                      0, bins - 1)
        hist = np.bincount(idx, weights=weights[sel], minlength=bins)
        cdf = below + np.cumsum(hist)
        b = min(int(np.searchsorted(cdf, target, side="left")), bins - 1)
        if b > 0:
            below = float(cdf[b - 1])
        new_lo = lo + b * width
        hi = lo + (b + 1) * width
        lo = new_lo
    return np.float64(0.5 * (lo + hi))


def weighted_quantile(points, weights=None, alpha: float = 0.5,
                      method: str = "exact"):
    """Weighted ``alpha``-quantile: linear interpolation of the sorted
    points at midpoint cumulative weights, ``interp(alpha, cs − w/2,
    pts)`` (the reference convention).  ``method="sketch"`` sends tensors
    through the sort-free sketch; host arrays stay exact below the cap."""
    if method not in ("exact", "sketch"):
        raise ValueError(f"unknown quantile method {method!r}")
    over_cap = int(points.shape[0]) > POP_MATERIALIZE_CAP
    if torch.is_tensor(points):
        if method == "sketch" or over_cap:
            return sketch_weighted_quantile(points, weights, alpha)
        if weights is None:
            weights = torch.full_like(points, 1.0 / points.shape[0])
        weights = weights / weights.sum()
        order = torch.argsort(points, stable=True)
        pts, w = points[order], weights[order]
        mid = ordered_cumsum(w) - 0.5 * w
        a = torch.full((1,), float(alpha), dtype=mid.dtype,
                       device=mid.device)
        i = torch.searchsorted(mid, a, right=True).clamp(1, mid.shape[0] - 1)
        x0, x1, f0, f1 = mid[i - 1], mid[i], pts[i - 1], pts[i]
        frac = torch.where(x1 > x0, (a - x0) / (x1 - x0),
                           torch.zeros_like(a))
        q = f0 + frac * (f1 - f0)
        q = torch.where(a < mid[0], pts[:1], q)
        return torch.where(a > mid[-1], pts[-1:], q)[0]
    points = np.asarray(points)
    if over_cap:
        return _np_sketch_quantile(points, weights, alpha)
    if weights is None:
        weights = np.full(points.shape, 1.0 / points.shape[0])
    weights = np.asarray(weights)
    weights = weights / np.sum(weights)
    order = np.argsort(points)
    pts = points[order]
    w = weights[order]
    cum = np.cumsum(w)
    return np.interp(alpha, cum - 0.5 * w, pts)


def weighted_median(points, weights=None):
    return weighted_quantile(points, weights, alpha=0.5)


def weighted_mean(points, weights):
    weights = weights / weights.sum()
    return (points * weights).sum()


def weighted_var(points, weights):
    weights = weights / weights.sum()
    mean = (points * weights).sum()
    return (weights * (points - mean) ** 2).sum()


def weighted_std(points, weights):
    var = weighted_var(points, weights)
    return torch.sqrt(var) if torch.is_tensor(var) else np.sqrt(var)


def weighted_mse(points, weights, refval):
    """Weighted mean squared error around a reference value."""
    weights = weights / weights.sum()
    return (weights * (points - refval) ** 2).sum()


def effective_sample_size(weights):
    """ESS = (Σw)² / Σw²."""
    if not torch.is_tensor(weights):
        weights = np.asarray(weights)
    return weights.sum() ** 2 / (weights ** 2).sum()


def resample(generator: torch.Generator, points: torch.Tensor,
             weights: torch.Tensor, n: int) -> torch.Tensor:
    """Multinomial resampling of ``n`` points with probability ∝
    ``weights``, drawn from ``generator``."""
    log_w = torch.log(torch.clamp(weights / weights.sum(), min=1e-38))
    return points[fast_weighted_choice(generator, log_w, n)]


def resample_indices_deterministic(weights: torch.Tensor, n: int,
                                   rank_cap: Optional[int]
                                   = RESIDUAL_RANK_CAP) -> torch.Tensor:
    """Deterministic residual resampling indices: each point ⌊n·w⌋ times,
    the remaining slots to the largest remainders (ties by ascending
    index, the stable-sort order).  Fixed output size ``n``.

    Above ``rank_cap`` support points the largest-remainder ranking runs
    through :func:`~.ops.quantile_sketch.sketch_topk_mask`: remainders
    within the sketch's resolution of the cut may swap which point gets
    the extra copy.  ``rank_cap=None`` sorts at every size."""
    weights = weights / weights.sum()
    scaled = weights * n
    base = torch.floor(scaled).to(torch.int64)
    residual = scaled - base
    n_extra = n - base.sum()
    n_points = weights.shape[0]
    if rank_cap is not None and n_points > rank_cap:
        extra = sketch_topk_mask(residual, n_extra).to(torch.int64)
    else:
        rank = torch.argsort(-residual, stable=True)
        take = (torch.arange(n_points, device=weights.device)
                < n_extra).to(torch.int64)
        extra = torch.zeros(n_points, dtype=torch.int64,
                            device=weights.device).scatter(0, rank, take)
    ends = torch.cumsum(base + extra, 0)
    pos = torch.arange(n, device=weights.device)
    return torch.searchsorted(ends, pos, right=True)
