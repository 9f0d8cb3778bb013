"""pyabc_tpu_torch: the PyTorch / CUDA port of pyabc_tpu.

A second package beside the JAX reference.  This slice runs the
sequential ABC-SMC path of configs #1 and #2 (``ABCSMC`` ->
``VectorizedSampler`` -> candidate rounds -> Gaussian-KDE transition ->
PNorm distance -> quantile epsilon -> uniform acceptor -> sqlite
History) with the weighted-KDE log-density as a hand-written CUDA kernel
(``csrc/kde_logpdf.cu``).  Entry points run on the card unless the
caller passes ``device="cpu"`` (see :mod:`.device`).  Nothing here
imports JAX or the JAX package.
"""

from .acceptor import Acceptor, UniformAcceptor
from .device import resolve_device
from .distance import Distance, PNormDistance
from .epsilon import (ConstantEpsilon, Epsilon, ListEpsilon, MedianEpsilon,
                      QuantileEpsilon)
from .model import Model, SimpleModel
from .parameters import Parameter, ParameterSpace
from .population import Population
from .populationstrategy import ConstantPopulationSize
from .random_variables import RV, Distribution, ModelPerturbationKernel
from .sampler import VectorizedSampler
from .smc import ABCSMC
from .storage import History
from .transition import MultivariateNormalTransition

__all__ = [
    "ABCSMC", "Acceptor", "UniformAcceptor", "Distance", "PNormDistance",
    "Epsilon", "ConstantEpsilon", "ListEpsilon", "QuantileEpsilon",
    "MedianEpsilon", "Model", "SimpleModel", "Parameter", "ParameterSpace",
    "Population", "ConstantPopulationSize", "RV", "Distribution",
    "ModelPerturbationKernel", "VectorizedSampler", "History",
    "MultivariateNormalTransition", "resolve_device",
]
