"""Device ops: the weighted-KDE log-density (plain and CUDA), the
inverse-CDF, systematic and residual weighted choices, and the quantile
sketch."""

from .choice import (fast_weighted_choice, residual_weighted_choice,
                     systematic_weighted_choice)
from .kde import weighted_kde_logpdf, weighted_kde_logpdf_auto
from .kde_cuda import weighted_kde_logpdf_cuda
from .quantile_sketch import (sketch_error_bound, sketch_topk_mask,
                              sketch_weighted_quantile)

__all__ = ["weighted_kde_logpdf", "weighted_kde_logpdf_auto",
           "weighted_kde_logpdf_cuda", "fast_weighted_choice",
           "systematic_weighted_choice", "residual_weighted_choice",
           "sketch_weighted_quantile", "sketch_topk_mask",
           "sketch_error_bound"]
