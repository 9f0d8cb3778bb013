"""Distances (port of ``pyabc_tpu/distance``: the p-norm, the adaptive
p-norm and its scale functions, and the stochastic kernels)."""

from .base import Distance
from .distance import AdaptivePNormDistance, PNormDistance
from .kernel import (SCALE_LIN, SCALE_LOG, BinomialKernel,
                     IndependentLaplaceKernel, IndependentNormalKernel,
                     NegativeBinomialKernel, NormalKernel, PoissonKernel,
                     SimpleFunctionKernel, StochasticKernel)
from .scale import SCALE_FUNCTIONS

__all__ = ["Distance", "PNormDistance", "AdaptivePNormDistance",
           "SCALE_FUNCTIONS", "SCALE_LIN", "SCALE_LOG", "StochasticKernel",
           "SimpleFunctionKernel", "NormalKernel", "IndependentNormalKernel",
           "IndependentLaplaceKernel", "BinomialKernel", "PoissonKernel",
           "NegativeBinomialKernel"]
