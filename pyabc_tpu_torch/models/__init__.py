"""Model problems of configs #1 and #2."""

from .gaussian import GaussianModel, make_gaussian_problem
from .mixture import make_two_gaussians_problem

__all__ = ["GaussianModel", "make_gaussian_problem",
           "make_two_gaussians_problem"]
