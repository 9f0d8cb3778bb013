"""PEtab import: parameter tables -> priors.

Port of ``pyabc_tpu/petab/base.py``: a PEtab parameter table (a
``petab.Problem``'s, or a pandas DataFrame with PEtab column names indexed
by ``parameterId``) becomes a :class:`~pyabc_tpu_torch.random_variables.
Distribution` on the estimation scale; model and kernel creation are the
subclasses' (:mod:`.ode`, :mod:`.problem`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..random_variables import (Distribution, Laplace, LogNorm, Norm,
                                RVBase, Uniform)

# PEtab prior-type constants (petab spec)
UNIFORM = "uniform"
PARAMETER_SCALE_UNIFORM = "parameterScaleUniform"
NORMAL = "normal"
PARAMETER_SCALE_NORMAL = "parameterScaleNormal"
LAPLACE = "laplace"
LOG_NORMAL = "logNormal"
LOG_LAPLACE = "logLaplace"

LIN = "lin"
LOG = "log"
LOG10 = "log10"


def _rv_from_row(row) -> Optional[RVBase]:
    """One parameter-table row -> RV on the objective (estimation)
    scale; None for a parameter that is not estimated."""
    if int(row.get("estimate", 1)) == 0:
        return None
    prior_type = row.get("objectivePriorType") or row.get(
        "initializationPriorType") or PARAMETER_SCALE_UNIFORM
    pars = row.get("objectivePriorParameters") or row.get(
        "initializationPriorParameters")
    scale = row.get("parameterScale", LIN)

    def to_scale(v):
        v = float(v)
        if scale == LOG:
            return np.log(v)
        if scale == LOG10:
            return np.log10(v)
        return v

    if pars is None or (isinstance(pars, float) and np.isnan(pars)):
        a, b = row["lowerBound"], row["upperBound"]
        lo, hi = to_scale(a), to_scale(b)
        return Uniform(lo, hi - lo)
    a, b = (float(x) for x in str(pars).split(";"))

    if prior_type in (UNIFORM,):
        lo, hi = to_scale(a), to_scale(b)
        return Uniform(lo, hi - lo)
    if prior_type == PARAMETER_SCALE_UNIFORM:
        return Uniform(a, b - a)
    if prior_type == NORMAL:
        rv = Norm(to_scale(a), b)
        return rv
    if prior_type == PARAMETER_SCALE_NORMAL:
        return Norm(a, b)
    if prior_type == LOG_NORMAL:
        return LogNorm(b, np.exp(a))
    if prior_type == LAPLACE:
        return Laplace(to_scale(a), b)
    raise ValueError(f"unsupported PEtab prior type: {prior_type}")


class PetabImporter:
    """Create priors (and models) from a PEtab problem.

    ``problem`` may be a ``petab.Problem`` (if petab is installed) or a
    pandas DataFrame shaped like a PEtab parameter table indexed by
    parameterId.
    """

    def __init__(self, problem):
        self.problem = problem

    def _parameter_df(self):
        if hasattr(self.problem, "parameter_df"):
            return self.problem.parameter_df
        if hasattr(self.problem, "iterrows"):
            return self.problem
        raise TypeError("need a petab.Problem or a parameter DataFrame")

    def create_prior(self) -> Distribution:
        """Parameter table -> joint prior."""
        df = self._parameter_df()
        rvs = {}
        for par_id, row in df.iterrows():
            rv = _rv_from_row(row)
            if rv is not None:
                rvs[str(par_id)] = rv
        return Distribution(rvs)

    def create_model(self):
        raise NotImplementedError(
            "subclass PetabImporter and build an ODEModel for the problem "
            "(see pyabc_tpu_torch.models.ODEModel)")

    def create_kernel(self):
        raise NotImplementedError
