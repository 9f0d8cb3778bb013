"""Bootstrap CV of the density estimate (port of ``pyabc_tpu/cv``)."""

from ..transition.predict_population_size import (fit_powerlaw,
                                                  predict_population_size)
from .bootstrap import calc_cv

__all__ = ["calc_cv", "fit_powerlaw", "predict_population_size"]
