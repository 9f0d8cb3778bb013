"""pdf normalizations for stochastic acceptance.

Port of ``pyabc_tpu/acceptor/pdf_norm.py`` (host numpy, the same
arithmetic).  The normalization constant c bounds the kernel density so
that acceptance probabilities ``(pdf/c)^(1/T)`` stay in [0, 1]; every
value here is on the log scale.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def pdf_norm_from_kernel(kernel_val: float = None, prev_pdf_norm=None,
                         get_weighted_distances=None, prev_temp=None
                         ) -> float:
    """The kernel's analytic maximum density."""
    return float(kernel_val)


def pdf_norm_max_found(kernel_val=None, prev_pdf_norm: Optional[float] = None,
                       get_weighted_distances: Callable = None,
                       prev_temp=None) -> float:
    """Running maximum of the densities found so far."""
    values = []
    if prev_pdf_norm is not None and np.isfinite(prev_pdf_norm):
        values.append(float(prev_pdf_norm))
    if get_weighted_distances is not None:
        dens, _ = get_weighted_distances()
        dens = np.asarray(dens, dtype=np.float64)
        if dens.size:
            values.append(float(np.max(dens)))
    if not values:
        return float(kernel_val) if kernel_val is not None else 0.0
    return max(values)


class ScaledPDFNorm:
    """Temperature-scaled normalization: the max-found norm lowered by
    ``log(factor) · T_next`` (``T_next ≈ alpha · T_prev``), so that the
    reduction survives the ``^(1/T)`` of the acceptance step."""

    def __init__(self, factor: float = 10.0, alpha: float = 0.5):
        self.factor = float(factor)
        self.alpha = float(alpha)

    def __call__(self, kernel_val=None, prev_pdf_norm=None,
                 get_weighted_distances=None, prev_temp=None) -> float:
        base = pdf_norm_max_found(
            kernel_val=kernel_val, prev_pdf_norm=prev_pdf_norm,
            get_weighted_distances=get_weighted_distances)
        if prev_temp is None or prev_temp <= 1.0:
            return base
        next_temp = max(self.alpha * prev_temp, 1.0)
        return base - np.log(self.factor) * next_temp
