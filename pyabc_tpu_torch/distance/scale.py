"""Scale functions for adaptive distance weighting.

Port of ``pyabc_tpu/distance/scale.py``.  Each function maps a sum-stat
block ``data[R, S]`` (and the observed ``x_0[S]``) to a per-component
scale ``[S]``; :class:`~.distance.AdaptivePNormDistance` weights each
component by the inverse scale.  All reductions run on the block's device
and are NaN-aware: rows of failed simulations (NaN stats) drop out of a
column's estimate, and a column with no finite-or-infinite value gives
NaN.

PyTorch has no reduction with NumPy's NaN semantics for every case, so
the two used here are written out:

- the NaN median sorts each column once (NaN sorts last), counts the
  non-NaN values ``c`` and interpolates between the sorted rows
  ``floor((c − 1)/2)`` and ``ceil((c − 1)/2)`` with weights ``1 − h`` and
  ``h``, ``h = 0.5`` for even ``c`` — ``jnp.nanmedian``'s linear
  interpolation.  ``torch.nanmedian`` returns the lower middle value for
  an even count, and ``torch.nanquantile`` refuses inputs above 2^24
  elements (a record block of 2^21 × 20 is larger);
- the NaN standard deviation is the root of the masked mean of squared
  deviations from the masked mean, ddof 0 (``jnp.nanstd``; ``torch.std``
  defaults to ddof 1 and is not NaN-aware).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _count(data: Tensor) -> Tensor:
    """Non-NaN values per column, as the data's float type."""
    return (~torch.isnan(data)).sum(0).to(data.dtype)


def nanmean(data: Tensor) -> Tensor:
    return torch.nansum(data, 0) / _count(data)


def nanstd(data: Tensor) -> Tensor:
    dev = data - nanmean(data)
    sq = torch.where(torch.isnan(data), torch.zeros_like(dev), dev * dev)
    return torch.sqrt(sq.sum(0) / _count(data))


def nanmedian(data: Tensor) -> Tensor:
    srt = torch.sort(data, dim=0).values
    cnt = _count(data)
    q = 0.5 * (cnt - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    top = torch.clamp(cnt - 1.0, min=0.0)
    lo_i = torch.clamp(torch.minimum(low, top), min=0.0).long()[None]
    hi_i = torch.clamp(torch.minimum(high, top), min=0.0).long()[None]
    low_v = srt.gather(0, lo_i)[0]
    high_v = srt.gather(0, hi_i)[0]
    return low_v * (1.0 - high_w) + high_v * high_w


def _nanextreme(data: Tensor, largest: bool) -> Tensor:
    fill = float("-inf") if largest else float("inf")
    filled = torch.where(torch.isnan(data), torch.full_like(data, fill), data)
    out = filled.amax(0) if largest else filled.amin(0)
    return torch.where(_count(data) > 0, out,
                       torch.full_like(out, float("nan")))


def standard_deviation(data: Tensor, x_0: Tensor = None) -> Tensor:
    return nanstd(data)


def mean(data: Tensor, x_0: Tensor = None) -> Tensor:
    return nanmean(torch.abs(data))


def median(data: Tensor, x_0: Tensor = None) -> Tensor:
    return nanmedian(torch.abs(data))


def span(data: Tensor, x_0: Tensor = None) -> Tensor:
    return _nanextreme(data, True) - _nanextreme(data, False)


def mean_absolute_deviation(data: Tensor, x_0: Tensor = None) -> Tensor:
    """mean |x − mean(x)|."""
    return nanmean(torch.abs(data - nanmean(data)))


def median_absolute_deviation(data: Tensor, x_0: Tensor = None) -> Tensor:
    """median |x − median(x)|."""
    return nanmedian(torch.abs(data - nanmedian(data)))


def bias(data: Tensor, x_0: Tensor) -> Tensor:
    """|mean(x) − x_0|."""
    return torch.abs(nanmean(data) - x_0)


def root_mean_square_deviation(data: Tensor, x_0: Tensor) -> Tensor:
    """sqrt(bias² + std²)."""
    return torch.sqrt(bias(data, x_0) ** 2 + standard_deviation(data) ** 2)


def standard_deviation_to_observation(data: Tensor, x_0: Tensor) -> Tensor:
    return torch.sqrt(nanmean((data - x_0) ** 2))


def mean_absolute_deviation_to_observation(data: Tensor, x_0: Tensor
                                           ) -> Tensor:
    return nanmean(torch.abs(data - x_0))


def median_absolute_deviation_to_observation(data: Tensor, x_0: Tensor
                                             ) -> Tensor:
    return nanmedian(torch.abs(data - x_0))


def combined_mean_absolute_deviation(data: Tensor, x_0: Tensor) -> Tensor:
    return mean_absolute_deviation(data) + bias(data, x_0)


def combined_median_absolute_deviation(data: Tensor, x_0: Tensor) -> Tensor:
    return median_absolute_deviation(data) + bias(data, x_0)


SCALE_FUNCTIONS = {
    fn.__name__: fn
    for fn in [
        standard_deviation, mean, median, span,
        mean_absolute_deviation, median_absolute_deviation,
        bias, root_mean_square_deviation,
        standard_deviation_to_observation,
        mean_absolute_deviation_to_observation,
        median_absolute_deviation_to_observation,
        combined_mean_absolute_deviation,
        combined_median_absolute_deviation,
    ]
}
