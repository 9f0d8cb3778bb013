"""PEtab problem ingestion: YAML + tables + SBML -> runnable model.

Port of ``pyabc_tpu/petab/problem.py``: a PEtab problem (its parameter,
observable, measurement and condition tables and its SBML model) becomes
prior + model + kernel with no model code.  The SBML subset parser
(:mod:`.sbml`) builds a batched RHS, the whole candidate batch integrates
in one fixed-step RK4 loop per simulation condition, observables are
evaluated over the trajectory from the PEtab observable formulas and read
at the measurement times by linear interpolation, and the measurement
log-likelihood (normal or Laplace noise; lin, log or log10
transformation) is one reduction.  ``ODEPetabImporter`` (:mod:`.ode`) is
the manual route for models outside the SBML subset.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np
import torch

from ..distance.kernel import SCALE_LOG, SimpleFunctionKernel
from ..model import Model
from .base import LIN, LOG, LOG10, PetabImporter
from .ode import LLH, _read_llh
from .sbml import ExprError, SBMLModel, eval_expr, parse_sbml


def _read_table(path: str):
    import pandas as pd
    sep = "\t" if path.endswith((".tsv", ".txt")) else ","
    return pd.read_csv(path, sep=sep)


class PetabProblem:
    """A loaded PEtab problem: tables + parsed SBML model.

    ``from_yaml`` reads the standard PEtab YAML layout; the constructor
    also accepts in-memory DataFrames + an :class:`SBMLModel` (or SBML
    XML string) for programmatic use.
    """

    def __init__(self, sbml_model, parameter_df, observable_df,
                 measurement_df, condition_df=None):
        if isinstance(sbml_model, str):
            sbml_model = parse_sbml(sbml_model)
        self.model: SBMLModel = sbml_model
        self.parameter_df = parameter_df.set_index("parameterId") \
            if "parameterId" in parameter_df.columns else parameter_df
        self.observable_df = observable_df.set_index("observableId") \
            if "observableId" in observable_df.columns else observable_df
        self.measurement_df = measurement_df
        self.condition_df = condition_df
        if condition_df is not None and "conditionId" in condition_df.columns:
            self.condition_df = condition_df.set_index("conditionId")

    @classmethod
    def from_yaml(cls, path: str) -> "PetabProblem":
        import yaml
        with open(path) as f:
            spec = yaml.safe_load(f)
        base = os.path.dirname(os.path.abspath(path))

        def resolve(name):
            return os.path.join(base, name)

        import pandas as pd
        prob = spec["problems"][0]
        parameter_file = spec.get("parameter_file") or prob.get(
            "parameter_file")
        parameter_df = _read_table(resolve(parameter_file))
        sbml_files = prob.get("sbml_files") or [prob["sbml_file"]]
        sbml_model = parse_sbml(resolve(sbml_files[0]))
        observable_df = pd.concat(
            [_read_table(resolve(f)) for f in prob["observable_files"]])
        measurement_df = pd.concat(
            [_read_table(resolve(f)) for f in prob["measurement_files"]])
        condition_df = None
        if prob.get("condition_files"):
            condition_df = pd.concat(
                [_read_table(resolve(f)) for f in prob["condition_files"]])
        return cls(sbml_model, parameter_df, observable_df, measurement_df,
                   condition_df)

    def estimated_ids(self) -> List[str]:
        df = self.parameter_df
        est = df[df.get("estimate", 1).astype(int) == 1] \
            if "estimate" in df.columns else df
        return [str(i) for i in est.index]

    def parameter_scales(self) -> Dict[str, str]:
        df = self.parameter_df
        if "parameterScale" not in df.columns:
            return {str(i): LIN for i in df.index}
        return {str(i): str(s) for i, s in df["parameterScale"].items()}

    def nominal_values(self) -> Dict[str, float]:
        df = self.parameter_df
        if "nominalValue" not in df.columns:
            return {}
        return {str(i): float(v) for i, v in df["nominalValue"].items()
                if np.isfinite(v)}


def _unscale(value, scale: str):
    if scale == LOG:
        return torch.exp(value)
    if scale == LOG10:
        return 10.0**value
    return value


class PetabSBMLModel(Model):
    """Batched RK4 simulation of a PEtab problem returning ``{'llh': [N]}``.

    One integration per simulation condition (conditions are few; the
    candidate axis is the batch).  Measurement times are read off the
    trajectory by linear interpolation, so arbitrary PEtab time points
    need no grid alignment.
    """

    def __init__(self, problem: PetabProblem, n_steps: int = 200,
                 name: str = "petab_sbml"):
        super().__init__(name)
        self.problem = problem
        self.n_steps = int(n_steps)
        self._rhs = problem.model.make_rhs()
        self._state_ids = problem.model.state_ids()
        self._scales = problem.parameter_scales()
        self._estimated = problem.estimated_ids()
        self._nominal = problem.nominal_values()
        self._conditions = self._group_measurements()
        self._t_max = max(
            (float(row["time"]) for _, _, rows in self._conditions
             for row in rows),
            default=1.0) or 1.0

    # ---- measurement bookkeeping ---------------------------------------

    def _group_measurements(self):
        """[(condition_id, overrides, rows)] with rows =
        [{observableId, time, measurement, noise_override}]."""
        mdf = self.problem.measurement_df
        groups = []
        cond_ids = (mdf["simulationConditionId"].unique()
                    if "simulationConditionId" in mdf.columns else [None])
        for cid in cond_ids:
            sel = mdf if cid is None else mdf[
                mdf["simulationConditionId"] == cid]
            overrides = {}
            if cid is not None and self.problem.condition_df is not None \
                    and cid in self.problem.condition_df.index:
                row = self.problem.condition_df.loc[cid]
                for col, val in row.items():
                    if col in ("conditionName",):
                        continue
                    if isinstance(val, float) and np.isnan(val):
                        continue
                    overrides[str(col)] = val
            rows = []
            for _, r in sel.iterrows():
                rows.append({
                    "observableId": str(r["observableId"]),
                    "time": float(r["time"]),
                    "measurement": float(r["measurement"]),
                    "noiseParameters": r.get("noiseParameters"),
                    "observableParameters": r.get("observableParameters"),
                })
            groups.append((cid, overrides, rows))
        return groups

    # ---- simulation -----------------------------------------------------

    def _theta_env(self, theta: torch.Tensor) -> Dict[str, object]:
        """Estimated parameters (unscaled, [N]) + fixed nominals.

        Only theta needs unscaling: estimated parameters travel on the
        objective (parameterScale) scale, while the table's nominalValue
        column is ALWAYS linear-scale per the PEtab spec."""
        env = {}
        for pid, val in self._nominal.items():
            if pid not in self._estimated:
                env[pid] = val
        for j, pid in enumerate(self._estimated):
            env[pid] = _unscale(theta[:, j], self._scales.get(pid, LIN))
        return env

    def _resolve_override(self, val, env, n, device):
        """A condition-table cell: numeric, or a parameter/entity name."""
        try:
            return torch.full((n,), float(val), device=device)
        except (TypeError, ValueError):
            pass
        name = str(val)
        if name in env:
            return torch.as_tensor(env[name], dtype=torch.float32,
                                   device=device).expand(n)
        base = self.problem.model.base_env()
        if name in base:
            return torch.full((n,), float(base[name]), device=device)
        raise ExprError(f"cannot resolve condition override {val!r}")

    def _integrate(self, theta_env: Dict[str, object],
                   overrides: Dict[str, object], n: int, device):
        """RK4 over the grid; returns (times [T+1], states [T+1, N, S],
        the condition's environment)."""
        model = self.problem.model
        dt = self._t_max / self.n_steps
        y0_vals = model.y0()
        y0_cols = []
        for i, sid in enumerate(self._state_ids):
            if sid in overrides:
                y0_cols.append(self._resolve_override(
                    overrides[sid], theta_env, n, device))
            else:
                y0_cols.append(torch.full((n,), y0_vals[i], device=device))
        y = torch.stack(y0_cols, dim=-1)
        env = dict(theta_env)
        for k, v in overrides.items():
            if k not in self._state_ids:
                env[k] = self._resolve_override(v, theta_env, n, device)
        traj = [y]
        for i in range(self.n_steps):
            t = i * dt
            k1 = self._rhs(y, env, t)
            k2 = self._rhs(y + 0.5 * dt * k1, env, t + 0.5 * dt)
            k3 = self._rhs(y + 0.5 * dt * k2, env, t + 0.5 * dt)
            k4 = self._rhs(y + dt * k3, env, t + dt)
            y = y + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
            traj.append(y)
        full = torch.stack(traj)                          # [T+1, N, S]
        times = np.linspace(0.0, self._t_max, self.n_steps + 1)
        return times, full, env

    def _observable_series(self, obs_id: str, full, env, row=None):
        """Evaluate the observable formula over the trajectory -> [N, T+1].
        ``observableParameter{n}_{obsId}`` placeholders resolve from the
        measurement row's observableParameters column."""
        odf = self.problem.observable_df
        formula = str(odf.loc[obs_id, "observableFormula"])
        # [N]-shaped parameter arrays get a trailing axis so formulas can
        # mix them with [N, T+1] state series (e.g. 'scaling_par * A')
        local = {k: (v[:, None] if getattr(v, "ndim", 0) == 1 else v)
                 for k, v in env.items()}
        for i, sid in enumerate(self._state_ids):
            local[sid] = full[..., i].T                      # [N, T+1]
        base = self.problem.model.base_env()
        for k, v in base.items():
            local.setdefault(k, v)
        local = self.problem.model.resolve_assignments(local) \
            if self.problem.model.assignment_rules else local
        if row is not None:
            local.update(self._placeholder_env(
                "observableParameter", obs_id,
                row.get("observableParameters")))
        val = eval_expr(formula, local)
        return torch.as_tensor(val, dtype=full.dtype,
                               device=full.device).expand(
            full.shape[1], full.shape[0])

    @staticmethod
    def _placeholder_env(prefix: str, obs_id: str, cell) -> Dict[str, float]:
        if cell is None or (isinstance(cell, float) and np.isnan(cell)):
            return {}
        parts = str(cell).split(";")
        return {f"{prefix}{i + 1}_{obs_id}": float(p)
                for i, p in enumerate(parts)}

    def _noise_value(self, obs_id: str, env, row):
        odf = self.problem.observable_df
        formula = odf.loc[obs_id].get("noiseFormula", 1.0)
        if formula is None or (isinstance(formula, float)
                               and np.isnan(formula)):
            # a blank noiseFormula cell reads as NaN — default sigma,
            # like a missing column
            formula = 1.0
        local = dict(env)
        base = self.problem.model.base_env()
        for k, v in base.items():
            local.setdefault(k, v)
        local.update(self._placeholder_env(
            "noiseParameter", obs_id, row.get("noiseParameters")))
        return eval_expr(str(formula), local)

    def sample(self, generator, theta: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        n = theta.shape[0]
        device = theta.device
        env = self._theta_env(theta)
        llh = torch.zeros(n, dtype=torch.float32, device=device)
        odf = self.problem.observable_df
        for cid, overrides, rows in self._conditions:
            times, full, cenv = self._integrate(env, overrides, n, device)
            dt = times[1] - times[0] if len(times) > 1 else 1.0
            series_cache: Dict[str, torch.Tensor] = {}
            for row in rows:
                oid = row["observableId"]
                has_op = row.get("observableParameters") is not None and \
                    not (isinstance(row.get("observableParameters"), float)
                         and np.isnan(row.get("observableParameters")))
                if oid in series_cache and not has_op:
                    series = series_cache[oid]
                else:
                    series = self._observable_series(
                        oid, full, cenv, row)
                    if not has_op:
                        series_cache[oid] = series
                # linear interpolation at the measurement time
                pos = row["time"] / dt
                i0 = int(np.clip(np.floor(pos), 0, len(times) - 2))
                frac = float(pos - i0)
                y_sim = series[:, i0] * (1 - frac) + series[:, i0 + 1] * frac
                sigma = self._noise_value(oid, cenv, row)
                sigma = torch.as_tensor(sigma, dtype=torch.float32,
                                        device=device).expand(n)
                m = row["measurement"]
                trans = LIN
                if "observableTransformation" in odf.columns:
                    tcell = odf.loc[oid, "observableTransformation"]
                    if isinstance(tcell, str):
                        trans = tcell
                dist = "normal"
                if "noiseDistribution" in odf.columns:
                    dcell = odf.loc[oid, "noiseDistribution"]
                    if isinstance(dcell, str):
                        dist = dcell
                if trans == LOG:
                    # log m in float32, as the JAX package takes it
                    resid = torch.log(torch.full_like(y_sim, m)) - torch.log(
                        y_sim)
                    jac = -math.log(m)
                elif trans == LOG10:
                    resid = math.log10(m) - torch.log10(y_sim)
                    jac = -math.log(m * math.log(10.0))
                else:
                    resid = m - y_sim
                    jac = 0.0
                if dist == "laplace":
                    llh = llh + (-resid.abs() / sigma
                                 - torch.log(2 * sigma) + jac)
                else:
                    llh = llh + (-0.5 * (resid / sigma) ** 2
                                 - 0.5 * torch.log(2 * math.pi * sigma ** 2)
                                 + jac)
        return {LLH: llh}


class SBMLPetabImporter(PetabImporter):
    """Zero-code PEtab import: a PEtab YAML (or a built
    :class:`PetabProblem`) in, prior + model + kernel out.

    >>> importer = SBMLPetabImporter.from_yaml("problem.yaml")
    >>> abc = ABCSMC(importer.create_model(), importer.create_prior(),
    ...              importer.create_kernel(), eps=Temperature(),
    ...              acceptor=StochasticAcceptor())
    >>> abc.new("sqlite://", importer.get_observed())
    """

    def __init__(self, problem: PetabProblem, n_steps: int = 200):
        super().__init__(problem.parameter_df)
        self.petab_problem = problem
        self.n_steps = int(n_steps)

    @classmethod
    def from_yaml(cls, path: str, n_steps: int = 200) -> "SBMLPetabImporter":
        return cls(PetabProblem.from_yaml(path), n_steps=n_steps)

    def create_model(self) -> PetabSBMLModel:
        return PetabSBMLModel(self.petab_problem, n_steps=self.n_steps)

    def create_kernel(self) -> SimpleFunctionKernel:
        """The log-scale kernel that reads the model's llh back."""
        return SimpleFunctionKernel(_read_llh, ret_scale=SCALE_LOG)

    def get_observed(self) -> Dict[str, float]:
        """Observed-stat placeholder: the data lives in the measurement
        table (same convention as ODEPetabImporter.get_observed)."""
        return {LLH: 0.0}
