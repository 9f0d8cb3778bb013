"""Device ops: the weighted-KDE log-density (plain and CUDA) and the
inverse-CDF and residual weighted choices."""

from .choice import fast_weighted_choice, residual_weighted_choice
from .kde import weighted_kde_logpdf, weighted_kde_logpdf_auto
from .kde_cuda import weighted_kde_logpdf_cuda

__all__ = ["fast_weighted_choice", "residual_weighted_choice", "weighted_kde_logpdf",
           "weighted_kde_logpdf_auto", "weighted_kde_logpdf_cuda"]
