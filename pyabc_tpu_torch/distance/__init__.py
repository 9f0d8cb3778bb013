"""Distances (port of ``pyabc_tpu/distance``; PNorm only in this slice)."""

from .base import Distance
from .distance import PNormDistance

__all__ = ["Distance", "PNormDistance"]
