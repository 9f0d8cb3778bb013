"""Epsilon schedules (port of ``pyabc_tpu/epsilon``: threshold schedules
and the temperature schedules of the stochastic acceptor)."""

from .base import Epsilon, NoEpsilon
from .epsilon import (ConstantEpsilon, ListEpsilon, MedianEpsilon,
                      QuantileEpsilon)
from .temperature import (AcceptanceRateScheme, DalyScheme, EssScheme,
                          ExpDecayFixedIterScheme, ExpDecayFixedRatioScheme,
                          FrielPettittScheme, ListTemperature,
                          PolynomialDecayFixedIterScheme, Temperature,
                          TemperatureBase, TemperatureScheme)

__all__ = ["Epsilon", "NoEpsilon", "ConstantEpsilon", "ListEpsilon", "QuantileEpsilon",
           "MedianEpsilon", "TemperatureBase", "ListTemperature",
           "Temperature", "TemperatureScheme", "AcceptanceRateScheme",
           "ExpDecayFixedIterScheme", "ExpDecayFixedRatioScheme",
           "PolynomialDecayFixedIterScheme", "DalyScheme",
           "FrielPettittScheme", "EssScheme"]
