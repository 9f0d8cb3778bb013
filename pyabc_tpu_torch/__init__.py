"""pyabc_tpu_torch: the PyTorch / CUDA port of pyabc_tpu.

A second package beside the JAX reference.  It runs the sequential
ABC-SMC path of configs #1 to #5 (``ABCSMC`` -> ``VectorizedSampler`` ->
candidate rounds -> Gaussian-KDE transition -> PNorm or adaptive PNorm
distance over the record stream, or a stochastic kernel -> quantile
epsilon or temperature -> uniform or stochastic acceptor -> sqlite
History; models: Gaussians, Lotka-Volterra SDE, SIR tau-leap, ODEs
through the PEtab importers of :mod:`.petab`) with the weighted-KDE
log-density as a hand-written CUDA kernel (``csrc/kde_logpdf.cu``).
Entry points run on the card unless the caller passes ``device="cpu"``
(see :mod:`.device`).  Nothing here imports JAX or the JAX package.
"""

from .acceptor import (Acceptor, ScaledPDFNorm, StochasticAcceptor,
                       UniformAcceptor, pdf_norm_from_kernel,
                       pdf_norm_max_found)
from .device import resolve_device
from .distance import (AdaptivePNormDistance, BinomialKernel, Distance,
                       IndependentLaplaceKernel, IndependentNormalKernel,
                       NegativeBinomialKernel, NormalKernel, PNormDistance,
                       PoissonKernel, SimpleFunctionKernel, StochasticKernel)
from .distance import scale
from .distance.scale import SCALE_FUNCTIONS
from .epsilon import (AcceptanceRateScheme, ConstantEpsilon, DalyScheme,
                      Epsilon, EssScheme, ExpDecayFixedIterScheme,
                      ExpDecayFixedRatioScheme, FrielPettittScheme,
                      ListEpsilon, ListTemperature, MedianEpsilon,
                      PolynomialDecayFixedIterScheme, QuantileEpsilon,
                      Temperature, TemperatureBase, TemperatureScheme)
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
    "AdaptivePNormDistance", "scale", "SCALE_FUNCTIONS",
    "Epsilon", "ConstantEpsilon", "ListEpsilon", "QuantileEpsilon",
    "MedianEpsilon", "Model", "SimpleModel", "Parameter", "ParameterSpace",
    "Population", "ConstantPopulationSize", "RV", "Distribution",
    "ModelPerturbationKernel", "VectorizedSampler", "History",
    "MultivariateNormalTransition", "resolve_device",
    "StochasticAcceptor", "pdf_norm_from_kernel", "pdf_norm_max_found",
    "ScaledPDFNorm", "StochasticKernel", "SimpleFunctionKernel",
    "NormalKernel", "IndependentNormalKernel", "IndependentLaplaceKernel",
    "BinomialKernel", "PoissonKernel", "NegativeBinomialKernel",
    "TemperatureBase", "ListTemperature", "Temperature",
    "TemperatureScheme", "AcceptanceRateScheme", "ExpDecayFixedIterScheme",
    "ExpDecayFixedRatioScheme", "PolynomialDecayFixedIterScheme",
    "DalyScheme", "FrielPettittScheme", "EssScheme",
]
