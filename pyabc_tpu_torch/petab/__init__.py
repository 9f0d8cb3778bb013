"""PEtab bridge (port of ``pyabc_tpu/petab``): PEtab parameter tables to
priors, the ODE importer, and the zero-code SBML importer."""

from .base import PetabImporter
from .ode import LikelihoodODEModel, ODEPetabImporter
from .problem import PetabProblem, PetabSBMLModel, SBMLPetabImporter
from .sbml import SBMLModel, parse_sbml

__all__ = ["PetabImporter", "ODEPetabImporter", "LikelihoodODEModel",
           "PetabProblem", "PetabSBMLModel", "SBMLPetabImporter",
           "SBMLModel", "parse_sbml"]
