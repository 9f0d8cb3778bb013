"""Screen-threshold calibration from paired (low, full) distances.

Port of ``pyabc_tpu/fidelity/calibrate.py``.  Every screening decision
derived from the pair stream goes through :func:`screen_threshold`, one
tensor function with no host read, so the device block
(``sampler/fused.py``) and a host-side audit share the same math; the
numpy mirrors are copied as the tests' independent oracle.

Semantics, per generation ``t`` with threshold ``eps_t``:

- *acceptable pairs* are calibration rows whose full-fidelity distance
  would pass the current accept test (``d_full <= eps_t``);
- the screen threshold is ``margin × Q_{1-q}(d_lo | acceptable)``: at
  most a ``q`` fraction of the acceptable calibration pairs lie above the
  quantile;
- *self-disable*: with fewer than ``min_pairs`` acceptable pairs, or a
  low/full Pearson correlation over all valid pairs below ``min_corr``,
  the threshold is ``+inf`` and the screen passes every candidate.  NaN
  ring rows (empty slots, and a fresh carry's seed) never count as
  pairs, so a fresh run starts self-disabled.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def pearson_corr(x: torch.Tensor, y: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Pearson correlation over the ``mask``-selected finite rows, as a
    0-d tensor: ``-inf`` with fewer than 2 rows, ``0`` for a
    zero-variance selection."""
    mask = mask & torch.isfinite(x) & torch.isfinite(y)
    zero = torch.zeros_like(x)
    n = mask.sum().to(torch.float32)
    denom_n = torch.clamp(n, min=1.0)
    xm = torch.where(mask, x, zero).sum() / denom_n
    ym = torch.where(mask, y, zero).sum() / denom_n
    dx = torch.where(mask, x - xm, zero)
    dy = torch.where(mask, y - ym, zero)
    cov = (dx * dy).sum()
    var = torch.sqrt((dx * dx).sum() * (dy * dy).sum())
    corr = cov / torch.clamp(var, min=1e-30)
    return torch.where(n >= 2, corr, torch.full_like(corr, -math.inf))


def screen_threshold(cal_lo: torch.Tensor, cal_full: torch.Tensor, eps,
                     *, q: float, margin: float, min_corr: float,
                     min_pairs: int) -> torch.Tensor:
    """Conservative low-fidelity screen threshold, a float32 0-d tensor
    on the rings' device (no host read).

    ``cal_lo``/``cal_full`` are the paired calibration rings (NaN = empty
    slot), ``eps`` this generation's accept threshold.  A candidate whose
    low-fidelity distance is strictly above the result is screened out;
    ``+inf`` disables the screen for the generation."""
    return screen_calibration(cal_lo, cal_full, eps, q=q, margin=margin,
                              min_corr=min_corr, min_pairs=min_pairs)[0]


def screen_calibration(cal_lo: torch.Tensor, cal_full: torch.Tensor, eps,
                       *, q: float, margin: float, min_corr: float,
                       min_pairs: int):
    """:func:`screen_threshold` with the two facts behind it, as 0-d
    tensors (no host read): ``(tau, n_acc, corr)``, the acceptable pairs
    and the correlation over all valid pairs that the self-disable rule
    reads."""
    cal_lo = cal_lo.to(torch.float32)
    cal_full = cal_full.to(torch.float32)
    eps = torch.as_tensor(eps, dtype=torch.float32, device=cal_lo.device)
    valid = torch.isfinite(cal_lo) & torch.isfinite(cal_full)
    acceptable = valid & (cal_full <= eps)
    n_acc = acceptable.sum()

    # the ceil((1 - q) * n_acc)-th smallest acceptable low-fidelity
    # distance: non-acceptable rows sort to +inf behind them
    xs = torch.where(acceptable, cal_lo, torch.full_like(cal_lo, math.inf))
    xs_sorted = torch.sort(xs).values
    k = torch.ceil((1.0 - q) * n_acc.to(torch.float32)).to(torch.int64)
    idx = torch.clamp(k - 1, 0, cal_lo.shape[0] - 1)
    # index_select: indexing with a 0-d tensor would read it on the host
    quant = xs_sorted.index_select(0, idx.reshape(1))[0]

    corr = pearson_corr(cal_lo, cal_full, valid)
    enabled = (n_acc >= min_pairs) & (corr >= min_corr) \
        & torch.isfinite(quant)
    tau = torch.where(enabled, quant * margin,
                      torch.full_like(quant, math.inf))
    return tau, n_acc, corr


# ---------------------------------------------------------------------------
# host (numpy) mirrors: the tests' independent oracle
# ---------------------------------------------------------------------------

def pearson_corr_np(x, y, mask=None) -> float:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    m = np.isfinite(x) & np.isfinite(y)
    if mask is not None:
        m &= np.asarray(mask, bool)
    if m.sum() < 2:
        return -np.inf
    xv, yv = x[m], y[m]
    dx, dy = xv - xv.mean(), yv - yv.mean()
    var = np.sqrt((dx * dx).sum() * (dy * dy).sum())
    if var <= 0:
        return 0.0
    return float((dx * dy).sum() / var)


def screen_threshold_np(cal_lo, cal_full, eps, *, q, margin, min_corr,
                        min_pairs) -> float:
    """Independent numpy implementation of :func:`screen_threshold`
    (select -> sort -> index, no masking)."""
    lo = np.asarray(cal_lo, np.float64)
    full = np.asarray(cal_full, np.float64)
    valid = np.isfinite(lo) & np.isfinite(full)
    acc_lo = np.sort(lo[valid & (full <= eps)])
    n_acc = acc_lo.size
    corr = pearson_corr_np(lo, full, valid)
    if n_acc < min_pairs or corr < min_corr:
        return np.inf
    k = int(np.ceil((1.0 - q) * n_acc))
    quant = acc_lo[max(k - 1, 0)]
    if not np.isfinite(quant):
        return np.inf
    return float(quant * margin)
