"""Transitions (port of ``pyabc_tpu/transition``; the Gaussian KDE only
in this slice)."""

from .base import Transition
from .multivariatenormal import (MultivariateNormalTransition,
                                 scott_rule_of_thumb,
                                 silverman_rule_of_thumb)

__all__ = ["Transition", "MultivariateNormalTransition",
           "silverman_rule_of_thumb", "scott_rule_of_thumb"]
