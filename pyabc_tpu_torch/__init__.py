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
:mod:`.external`; and the reference-compatible surface: the progress bar
(``ABCSMC(show_progress=True)``), ``DefaultSampler``, the host samplers
over a map, an executor or a dask client, ``AggregatedTransition``, the
pyABC ORM-schema export and the parity classes of the JAX package's
``__all__``; and scale-out: ``ShardedSampler`` over a mesh of ranks
(:mod:`.parallel`), the pod one-dispatch posture, the serving tier
(:mod:`.serve`) and its fleet scheduler (:mod:`.sched`).
Entry points run on the card unless the caller passes ``device="cpu"``
(see :mod:`.device`).  Nothing here imports JAX or the JAX package.
"""

from . import autotune  # noqa: F401  (tuner, program ladder, build cache)
from . import resilience  # noqa: F401  (faults/retry/checkpoint namespace)
from . import telemetry  # noqa: F401  (spans/metrics/timeline namespace)
from .acceptor import (Acceptor, AcceptorResult, ScaledPDFNorm,
                       SimpleFunctionAcceptor, StochasticAcceptor,
                       UniformAcceptor, pdf_norm_from_kernel,
                       pdf_norm_max_found)
from .device import resolve_device
from .distance import (SCALE_LIN, SCALE_LOG, AcceptAllDistance,
                       AdaptiveAggregatedDistance, AdaptivePNormDistance,
                       AggregatedDistance, BinomialKernel, Distance,
                       DistanceWithMeasureList, IdentityFakeDistance,
                       IndependentLaplaceKernel, IndependentNormalKernel,
                       MinMaxDistance, NegativeBinomialKernel, NoDistance,
                       NormalKernel, PCADistance, PercentileDistance,
                       PNormDistance, PoissonKernel, RangeEstimatorDistance,
                       SimpleFunctionDistance, SimpleFunctionKernel,
                       StochasticKernel, ZScoreDistance)
from .distance import scale
from .distance.scale import SCALE_FUNCTIONS
from .epsilon import (AcceptanceRateScheme, ConstantEpsilon, DalyScheme,
                      Epsilon, EssScheme, ExpDecayFixedIterScheme,
                      ExpDecayFixedRatioScheme, FrielPettittScheme,
                      ListEpsilon, ListTemperature, MedianEpsilon, NoEpsilon,
                      PolynomialDecayFixedIterScheme, QuantileEpsilon,
                      Temperature, TemperatureBase, TemperatureScheme)
from .model import IntegratedModel, Model, ModelResult, SimpleModel
from .parameters import Parameter, ParameterSpace
from .platform_factory import DefaultSampler
from .population import Particle, Population
from .populationstrategy import (AdaptivePopulationSize,
                                 ConstantPopulationSize, ListPopulationSize)
from .random_variables import (RV, Distribution, LowerBoundDecorator,
                               ModelPerturbationKernel, RVBase, RVDecorator,
                               ScipyRV, TabulatedRV, TruncatedRV)
from .sampler import (ConcurrentFutureSampler, DaskDistributedSampler,
                      MappingSampler, MulticoreEvalParallelSampler,
                      MulticoreParticleParallelSampler,
                      RedisEvalParallelSampler, RoundKernel, Sample, Sampler,
                      ShardedSampler, SingleCoreSampler, VectorizedSampler)
from .smc import ABCSMC
from .storage import History, create_sqlite_db_id
from .sumstat import SumStatSpec
from .transition import (AggregatedTransition, DiscreteRandomWalkTransition,
                         GridSearchCV, LocalTransition,
                         MultivariateNormalTransition)
from .version import __version__  # noqa: F401

__all__ = [
    "ABCSMC", "History", "create_sqlite_db_id", "Population", "Particle",
    "Parameter", "ParameterSpace", "RVDecorator", "SimpleFunctionAcceptor",
    "TemperatureScheme", "DistanceWithMeasureList", "SumStatSpec",
    "Model", "SimpleModel", "IntegratedModel", "ModelResult",
    "RV", "RVBase", "Distribution", "ModelPerturbationKernel",
    "LowerBoundDecorator", "TruncatedRV", "ScipyRV", "TabulatedRV",
    "Distance", "NoDistance", "AcceptAllDistance", "IdentityFakeDistance",
    "SimpleFunctionDistance", "PNormDistance", "AdaptivePNormDistance",
    "AggregatedDistance", "AdaptiveAggregatedDistance", "ZScoreDistance",
    "PCADistance", "RangeEstimatorDistance", "MinMaxDistance",
    "PercentileDistance", "StochasticKernel", "SimpleFunctionKernel",
    "NormalKernel", "IndependentNormalKernel", "IndependentLaplaceKernel",
    "BinomialKernel", "PoissonKernel", "NegativeBinomialKernel",
    "SCALE_LIN", "SCALE_LOG", "scale", "SCALE_FUNCTIONS",
    "Epsilon", "NoEpsilon", "ConstantEpsilon", "ListEpsilon",
    "QuantileEpsilon", "MedianEpsilon", "TemperatureBase", "ListTemperature",
    "Temperature", "AcceptanceRateScheme", "ExpDecayFixedIterScheme",
    "ExpDecayFixedRatioScheme", "PolynomialDecayFixedIterScheme",
    "DalyScheme", "FrielPettittScheme", "EssScheme",
    "Acceptor", "AcceptorResult", "UniformAcceptor", "StochasticAcceptor",
    "pdf_norm_from_kernel", "pdf_norm_max_found", "ScaledPDFNorm",
    "MultivariateNormalTransition", "LocalTransition",
    "DiscreteRandomWalkTransition", "GridSearchCV", "AggregatedTransition",
    "ConstantPopulationSize", "AdaptivePopulationSize", "ListPopulationSize",
    "Sampler", "Sample", "VectorizedSampler", "DefaultSampler",
    "SingleCoreSampler", "MulticoreEvalParallelSampler",
    "MulticoreParticleParallelSampler", "MappingSampler",
    "ConcurrentFutureSampler", "DaskDistributedSampler", "RoundKernel",
    "ShardedSampler", "RedisEvalParallelSampler",
    "resolve_device", "__version__",
]


def __getattr__(name):
    """``pyabc_tpu_torch.visualization`` / ``.visserver`` on first use:
    importing the package does not pull matplotlib."""
    if name in ("visualization", "visserver"):
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
