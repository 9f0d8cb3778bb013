"""Epsilon schedules (port of ``pyabc_tpu/epsilon``; temperature schemes
come with a later slice)."""

from .base import Epsilon
from .epsilon import (ConstantEpsilon, ListEpsilon, MedianEpsilon,
                      QuantileEpsilon)

__all__ = ["Epsilon", "ConstantEpsilon", "ListEpsilon", "QuantileEpsilon",
           "MedianEpsilon"]
