"""Samplers (port of ``pyabc_tpu/sampler``: the vectorized sampler, its
device loop and the candidate rounds, the local sampler aliases, and the
host samplers that farm rounds out over a map, an executor or a dask
client)."""

from .base import RoundResult, Sample, Sampler, SamplingError
from .dask_sampler import DaskDistributedSampler
from .mapping import ConcurrentFutureSampler, MappingSampler
from .rounds import RoundKernel
from .vectorized import (MulticoreEvalParallelSampler,
                         MulticoreParticleParallelSampler,
                         SingleCoreSampler, VectorizedSampler)

__all__ = ["Sampler", "Sample", "SamplingError", "RoundResult",
           "RoundKernel", "VectorizedSampler", "SingleCoreSampler",
           "MulticoreEvalParallelSampler",
           "MulticoreParticleParallelSampler", "MappingSampler",
           "ConcurrentFutureSampler", "DaskDistributedSampler"]
