"""Distances (port of ``pyabc_tpu/distance``: the p-norm, the adaptive
p-norm and its scale functions)."""

from .base import Distance
from .distance import AdaptivePNormDistance, PNormDistance
from .scale import SCALE_FUNCTIONS

__all__ = ["Distance", "PNormDistance", "AdaptivePNormDistance",
           "SCALE_FUNCTIONS"]
