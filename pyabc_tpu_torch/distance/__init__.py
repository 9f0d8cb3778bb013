"""Distances (port of ``pyabc_tpu/distance``: the p-norms, adaptive and
not, the aggregated, z-score, PCA and range distances, the scale
functions, and the stochastic kernels)."""

from .base import (AcceptAllDistance, Distance, IdentityFakeDistance,
                   NoDistance, SimpleFunctionDistance, to_distance)
from .distance import (AdaptiveAggregatedDistance, AdaptivePNormDistance,
                       AggregatedDistance, DistanceWithMeasureList,
                       MinMaxDistance, PCADistance, PercentileDistance,
                       PNormDistance, RangeEstimatorDistance,
                       ZScoreDistance)
from .kernel import (SCALE_LIN, SCALE_LOG, BinomialKernel,
                     IndependentLaplaceKernel, IndependentNormalKernel,
                     NegativeBinomialKernel, NormalKernel, PoissonKernel,
                     SimpleFunctionKernel, StochasticKernel)
from . import scale
from .scale import (SCALE_FUNCTIONS, combined_mean_absolute_deviation,
                    combined_median_absolute_deviation,
                    mean_absolute_deviation, median_absolute_deviation,
                    root_mean_square_deviation, standard_deviation)

__all__ = ["Distance", "NoDistance", "AcceptAllDistance",
           "IdentityFakeDistance", "SimpleFunctionDistance", "to_distance",
           "PNormDistance", "AdaptivePNormDistance", "AggregatedDistance",
           "AdaptiveAggregatedDistance", "ZScoreDistance", "PCADistance",
           "DistanceWithMeasureList", "RangeEstimatorDistance",
           "MinMaxDistance", "PercentileDistance",
           "SCALE_FUNCTIONS", "SCALE_LIN", "SCALE_LOG", "StochasticKernel",
           "SimpleFunctionKernel", "NormalKernel", "IndependentNormalKernel",
           "IndependentLaplaceKernel", "BinomialKernel", "PoissonKernel",
           "NegativeBinomialKernel", "scale", "standard_deviation",
           "median_absolute_deviation", "mean_absolute_deviation",
           "root_mean_square_deviation", "combined_mean_absolute_deviation",
           "combined_median_absolute_deviation"]
