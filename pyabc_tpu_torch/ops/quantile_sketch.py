"""Sort-free weighted quantiles and top-k selection (fixed-bin sketch).

Port of ``pyabc_tpu/ops/quantile_sketch.py``.  Each pass scatter-adds the
(masked, weighted) points into ``bins`` buckets over the current bracket,
finds the bucket that holds the target cumulative mass and narrows the
bracket to it; after ``passes`` passes the bracket is ``(hi - lo) /
bins ** passes`` wide (:func:`sketch_error_bound`) — about 1e-6 of the
range at the defaults, for ``passes`` scatter-adds and no sort.  It backs
``QuantileEpsilon(device_sketch=True)`` in the fused engine.

Semantics kept from the JAX package:

- the target is the inverse weighted CDF at ``alpha * W``, linearly
  interpolated inside the final bucket; masked rows (``valid`` False,
  non-finite points, zero weight) are excluded exactly, and no valid row
  gives NaN;
- :func:`sketch_topk_mask` takes the buckets above the threshold bucket
  whole, refines the threshold bucket, and breaks the last ties by
  ascending index — the order a stable ``argsort(-x)`` gives exact ties.

The histograms are ``index_add_`` (the JAX package's ``.at[].add``); the
bucket search is ``torch.searchsorted`` on the cumulative histogram.
Nothing here reads a value back to the host.
"""

from __future__ import annotations

import math

import torch

#: default resolution: bins per pass x refinement passes
DEFAULT_BINS = 1024
DEFAULT_PASSES = 2

_TINY = 1e-30


def sketch_error_bound(lo, hi, bins: int = DEFAULT_BINS,
                       passes: int = DEFAULT_PASSES):
    """Half-width of the final bracket: the sketch's worst-case distance
    from the inverse-CDF quantile (gaps between order statistics
    aside)."""
    return (hi - lo) / float(bins) ** passes


def _search(cum: torch.Tensor, value: torch.Tensor, right: bool
            ) -> torch.Tensor:
    """``searchsorted`` of one scalar value (a 0-d tensor result)."""
    return torch.searchsorted(cum, value.reshape(1).to(cum.dtype),
                              right=right)[0]


def sketch_weighted_quantile(points: torch.Tensor, weights=None,
                             alpha: float = 0.5, *, valid=None,
                             bins: int = DEFAULT_BINS,
                             passes: int = DEFAULT_PASSES) -> torch.Tensor:
    """Weighted ``alpha``-quantile by iterated histogram refinement.

    ``points``/``weights``/``valid`` are same-shape 1-D tensors (weights
    default to uniform, valid to "finite point and positive weight").
    Returns a 0-d tensor: the inverse weighted CDF at ``alpha * sum(valid
    weights)``, interpolated inside the final bracket; NaN when no row is
    valid."""
    f32 = torch.float32
    x = points.to(f32)
    dev = x.device
    w = torch.ones_like(x) if weights is None else weights.to(f32)
    ok = torch.isfinite(x) & (w > 0)
    if valid is not None:
        ok = ok & valid
    zeros = torch.zeros_like(x)
    w = torch.where(ok, w, zeros)

    total = w.sum()
    lo0 = torch.where(ok, x, torch.full_like(x, math.inf)).min()
    hi0 = torch.where(ok, x, torch.full_like(x, -math.inf)).max()
    if not torch.is_tensor(alpha):
        alpha = torch.full((), float(alpha), dtype=f32, device=dev)
    target = torch.clamp(alpha.to(f32), 0.0, 1.0) * total

    lo, hi = lo0, hi0
    b_lo = lo0
    width = torch.clamp((hi0 - lo0) / bins, min=_TINY)
    c_before = torch.zeros((), dtype=f32, device=dev)
    w_bin = total
    for _ in range(passes):
        width = torch.clamp((hi - lo) / bins, min=_TINY)
        idx = torch.clamp(((x - lo) / width).to(torch.int64), 0, bins - 1)
        in_bracket = ok & (x >= lo) & (x <= hi)
        mass_below = torch.where(ok & (x < lo), w, zeros).sum()
        hist = torch.zeros(bins, dtype=f32, device=dev).index_add_(
            0, idx, torch.where(in_bracket, w, zeros))
        cum = mass_below + torch.cumsum(hist, 0)
        b = torch.clamp(_search(cum, target, right=False), 0, bins - 1)
        b_lo = lo + b.to(f32) * width
        c_before = torch.where(b > 0, cum[torch.clamp(b - 1, min=0)],
                               mass_below)
        w_bin = hist[b]
        lo, hi = b_lo, b_lo + width

    frac = torch.clamp((target - c_before) / torch.clamp(w_bin, min=_TINY),
                       0.0, 1.0)
    q = torch.minimum(torch.maximum(b_lo + frac * width, lo0), hi0)
    return torch.where(total > 0, q, torch.full_like(q, math.nan))


def sketch_topk_mask(values: torch.Tensor, k, *, valid=None,
                     bins: int = DEFAULT_BINS,
                     passes: int = DEFAULT_PASSES) -> torch.Tensor:
    """Boolean mask selecting the ``k`` largest valid ``values`` without
    sorting them: exactly ``min(k, #valid)`` rows come back True — whole
    buckets above the threshold bucket, then the refined threshold
    bucket's rows by ascending index (rows within
    :func:`sketch_error_bound` of the k-th value may swap with it)."""
    x = values.to(torch.float32)
    dev = x.device
    ok = torch.isfinite(x)
    if valid is not None:
        ok = ok & valid
    n_ok = ok.to(torch.int64).sum()
    if not torch.is_tensor(k):
        k = torch.full((), int(k), dtype=torch.int64, device=dev)
    k_rem = torch.minimum(torch.clamp(k.to(torch.int64), min=0), n_ok)

    lo = torch.where(ok, x, torch.full_like(x, math.inf)).min()
    hi = torch.where(ok, x, torch.full_like(x, -math.inf)).max()
    selected = torch.zeros(x.shape, dtype=torch.bool, device=dev)
    cand = ok
    for _ in range(passes):
        width = torch.clamp((hi - lo) / bins, min=_TINY)
        idx = torch.clamp(((x - lo) / width).to(torch.int64), 0, bins - 1)
        hist = torch.zeros(bins, dtype=torch.int64, device=dev).index_add_(
            0, idx, cand.to(torch.int64))
        cum = torch.cumsum(hist, 0)
        n_cand = cum[bins - 1]
        # first bucket whose cumulative count exceeds n_cand - k_rem:
        # buckets strictly above it hold < k_rem rows, take them whole
        b = _search(cum, n_cand - k_rem, right=True)
        above = cand & (idx > b)
        selected = selected | above
        k_rem = k_rem - above.to(torch.int64).sum()
        bc = torch.clamp(b, 0, bins - 1)
        cand = cand & (idx == bc) & (b < bins)
        lo = lo + bc.to(torch.float32) * width
        hi = lo + width

    pos = torch.cumsum(cand.to(torch.int64), 0) - 1
    return selected | (cand & (pos < k_rem))
