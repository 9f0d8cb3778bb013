"""Model problems of configs #1 to #4 and the ODE model of config #5."""

from .gaussian import GaussianModel, gaussian_model, make_gaussian_problem
from .lotka_volterra import (LV_TRUTH, LotkaVolterraSDE,
                             make_lotka_volterra_problem)
from .mixture import make_two_gaussians_problem
from .ode import ODEModel
from .sir import SIR_TRUTH, SIRTauLeap, make_sir_problem

__all__ = ["GaussianModel", "gaussian_model", "make_gaussian_problem",
           "make_two_gaussians_problem", "LotkaVolterraSDE",
           "make_lotka_volterra_problem", "LV_TRUTH", "SIRTauLeap",
           "make_sir_problem", "SIR_TRUTH", "ODEModel"]
