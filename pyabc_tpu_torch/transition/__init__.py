"""Transitions (port of ``pyabc_tpu/transition``): the Gaussian KDE,
the local k-NN KDE, the discrete random walk, the grid search over a
transition's hyperparameters, the aggregation of transitions over blocks
of columns, and the population-size prediction."""

from .base import AggregatedTransition, NotFittedError, Transition
from .local_transition import LocalTransition
from .model_selection import GridSearchCV
from .multivariatenormal import (MultivariateNormalTransition,
                                 scott_rule_of_thumb,
                                 silverman_rule_of_thumb)
from .predict_population_size import fit_powerlaw, predict_population_size
from .randomwalk import DiscreteRandomWalkTransition

__all__ = ["Transition", "AggregatedTransition", "NotFittedError",
           "MultivariateNormalTransition",
           "LocalTransition", "DiscreteRandomWalkTransition",
           "GridSearchCV", "silverman_rule_of_thumb", "scott_rule_of_thumb",
           "fit_powerlaw", "predict_population_size"]
