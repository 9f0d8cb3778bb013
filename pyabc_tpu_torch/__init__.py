"""pyabc_tpu_torch: the PyTorch / CUDA port of pyabc_tpu.

A second package beside the JAX reference.  It runs the sequential
ABC-SMC path of configs #1 to #5 (``ABCSMC`` -> ``VectorizedSampler`` ->
candidate rounds -> Gaussian-KDE transition -> PNorm or adaptive PNorm
distance over the record stream, or a stochastic kernel -> quantile
epsilon or temperature -> uniform or stochastic acceptor -> sqlite
History; models: Gaussians, Lotka-Volterra SDE, SIR tau-leap, ODEs
through the PEtab importers of :mod:`.petab`) with the weighted-KDE
log-density as a hand-written CUDA kernel (``csrc/kde_logpdf.cu``), and
the component library a user configures: the prior families and their
truncation, the population-size strategies, the local and random-walk
transitions and the grid search over them, the aggregated, z-score, PCA
and range distances, ``IntegratedModel`` and the host bridges of
:mod:`.external`.
Entry points run on the card unless the caller passes ``device="cpu"``
(see :mod:`.device`).  Nothing here imports JAX or the JAX package.
"""

from .acceptor import (Acceptor, ScaledPDFNorm, StochasticAcceptor,
                       UniformAcceptor, pdf_norm_from_kernel,
                       pdf_norm_max_found)
from .device import resolve_device
from .distance import (AdaptiveAggregatedDistance, AdaptivePNormDistance,
                       AggregatedDistance, BinomialKernel, Distance,
                       DistanceWithMeasureList, IndependentLaplaceKernel,
                       IndependentNormalKernel, MinMaxDistance,
                       NegativeBinomialKernel, NormalKernel, PCADistance,
                       PercentileDistance, PNormDistance, PoissonKernel,
                       RangeEstimatorDistance, SimpleFunctionDistance,
                       SimpleFunctionKernel, StochasticKernel,
                       ZScoreDistance)
from .distance import scale
from .distance.scale import SCALE_FUNCTIONS
from .epsilon import (AcceptanceRateScheme, ConstantEpsilon, DalyScheme,
                      Epsilon, EssScheme, ExpDecayFixedIterScheme,
                      ExpDecayFixedRatioScheme, FrielPettittScheme,
                      ListEpsilon, ListTemperature, MedianEpsilon,
                      PolynomialDecayFixedIterScheme, QuantileEpsilon,
                      Temperature, TemperatureBase, TemperatureScheme)
from .model import IntegratedModel, Model, ModelResult, SimpleModel
from .parameters import Parameter, ParameterSpace
from .population import Population
from .populationstrategy import (AdaptivePopulationSize,
                                 ConstantPopulationSize, ListPopulationSize)
from .random_variables import (RV, Distribution, LowerBoundDecorator,
                               ModelPerturbationKernel, RVBase, RVDecorator,
                               ScipyRV, TabulatedRV, TruncatedRV)
from .sampler import VectorizedSampler
from .smc import ABCSMC
from .storage import History
from .transition import (DiscreteRandomWalkTransition, GridSearchCV,
                         LocalTransition, MultivariateNormalTransition)

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
    "RVBase", "RVDecorator", "TruncatedRV", "LowerBoundDecorator",
    "ScipyRV", "TabulatedRV", "ListPopulationSize",
    "AdaptivePopulationSize", "LocalTransition",
    "DiscreteRandomWalkTransition", "GridSearchCV", "AggregatedDistance",
    "AdaptiveAggregatedDistance", "ZScoreDistance", "PCADistance",
    "DistanceWithMeasureList", "RangeEstimatorDistance", "MinMaxDistance",
    "PercentileDistance", "SimpleFunctionDistance", "IntegratedModel",
    "ModelResult",
]
