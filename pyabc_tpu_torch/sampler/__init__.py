"""Samplers (port of ``pyabc_tpu/sampler``: the vectorized sampler, its
device loop and the candidate rounds)."""

from .base import RoundResult, Sample, Sampler, SamplingError
from .rounds import RoundKernel
from .vectorized import VectorizedSampler

__all__ = ["Sampler", "Sample", "SamplingError", "RoundResult",
           "RoundKernel", "VectorizedSampler"]
