"""The port's ODE model and PEtab bridge against the JAX package's.

- ``ODEModel``: noise-free trajectories at the observed steps to rtol
  1e-5; ``low_fidelity`` keeps the grid and the observation indices of
  the JAX model.
- ``LikelihoodODEModel`` (the ``ODEPetabImporter`` route): the llh to
  atol 1e-4 over a θ grid.
- ``_rv_from_row``: ``log_pdf`` of every prior type and scale, rtol 1e-5.
- The SBML subset parser and expression evaluator on the JAX tests' XML
  strings.
- ``PetabSBMLModel``: the llh to atol 1e-4 over a θ grid, on the lin and
  log10 parameter scales, with a condition override, Laplace noise, a
  log transformation and two conditions.
- ``from_yaml`` on a problem directory under ``tmp_path``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import pyabc_tpu_torch as pt
from pyabc_tpu.models.ode import ODEModel as JaxODE
from pyabc_tpu.petab import ODEPetabImporter as JaxODEImporter
from pyabc_tpu.petab import PetabProblem as JaxProblem
from pyabc_tpu.petab import PetabSBMLModel as JaxSBMLModel
from pyabc_tpu.petab import SBMLPetabImporter as JaxSBMLImporter
from pyabc_tpu.petab import sbml as jsbml
from pyabc_tpu.petab.base import _rv_from_row as jax_rv_from_row
from pyabc_tpu_torch.models import ODEModel
from pyabc_tpu_torch.petab import (ODEPetabImporter, PetabProblem,
                                   PetabSBMLModel, SBMLPetabImporter)
from pyabc_tpu_torch.petab import sbml
from pyabc_tpu_torch.petab.base import _rv_from_row
from test_petab_sbml import SBML_DECAY, SBML_RATE_RULE, _write_problem_dir

KEY = jax.random.PRNGKey(0)


def _gen():
    g = torch.Generator()
    g.manual_seed(0)
    return g


def _lv_rhs_jax(y, th):
    return jnp.stack([th[:, 0] * y[:, 0] - th[:, 1] * y[:, 0] * y[:, 1],
                      th[:, 1] * y[:, 0] * y[:, 1] - th[:, 2] * y[:, 1]], -1)


def _lv_rhs_torch(y, th):
    return torch.stack([th[:, 0] * y[:, 0] - th[:, 1] * y[:, 0] * y[:, 1],
                        th[:, 1] * y[:, 0] * y[:, 1] - th[:, 2] * y[:, 1]],
                       -1)


def test_ode_model_trajectories():
    rng = np.random.default_rng(0)
    theta = rng.uniform([0.5, 0.2, 0.3], [1.5, 0.6, 1.0],
                        (64, 3)).astype(np.float32)
    kw = dict(y0=[2.0, 1.0], t_max=6.0, n_steps=120,
              obs_idx=[0, 7, 30, 31, 119, 60])
    j_model = JaxODE(_lv_rhs_jax, **kw)
    model = ODEModel(_lv_rhs_torch, **kw)
    ref = j_model.sample(KEY, jnp.asarray(theta))
    got = model.simulate(_gen(), torch.as_tensor(theta))
    assert set(got) == set(ref) == {"y0", "y1"}
    for k in ref:
        assert got[k].shape == (64, 6)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5)
    traj = model.integrate(torch.as_tensor(theta))
    assert traj.shape == (6, 64, 2)
    np.testing.assert_array_equal(traj[:, :, 0].T.numpy(),
                                  got["y0"].numpy())

    lo, j_lo = model.low_fidelity(), j_model.low_fidelity()
    assert lo.n_steps == j_lo.n_steps == 30
    np.testing.assert_array_equal(lo.obs_idx, np.asarray(j_lo.obs_idx))
    np.testing.assert_allclose(
        lo.simulate(_gen(), torch.as_tensor(theta))["y1"].numpy(),
        np.asarray(j_lo.sample(KEY, jnp.asarray(theta))["y1"]), rtol=1e-5)


def test_ode_model_noise_comes_from_the_generator():
    model = ODEModel(lambda y, th: -th[:, :1] * y, y0=[1.0], t_max=1.0,
                     n_steps=10, noise_scale=0.1)
    theta = torch.full((5, 1), 0.7)
    a = model.simulate(_gen(), theta)["y0"]
    b = model.simulate(_gen(), theta)["y0"]
    clean = model.integrate(theta)[..., 0].T
    assert torch.equal(a, b) and not torch.equal(a, clean)
    assert float((a - clean).abs().max()) < 0.6


# ---------------------------------------------------------------- ODE importer


def _par_df(scale="lin"):
    return pd.DataFrame({
        "parameterId": ["k"], "parameterScale": [scale],
        "lowerBound": [0.01], "upperBound": [3.0], "estimate": [1],
        "objectivePriorType": ["uniform"],
        "objectivePriorParameters": ["0.01;3.0"]}).set_index("parameterId")


def test_likelihood_ode_model_llh():
    t_max, n_steps = 2.0, 20
    obs_idx = np.asarray([4, 9, 14, 19])
    times = (obs_idx + 1) * (t_max / n_steps)
    data = np.exp(-0.7 * times) + 0.05 * np.random.default_rng(0).normal(
        size=times.shape)
    kw = dict(y0=[1.0], t_max=t_max, n_steps=n_steps, obs_idx=obs_idx,
              measurements={"y0": data}, sigma=0.05)
    j_imp = JaxODEImporter(_par_df(), rhs=lambda y, th: -th[:, 0:1] * y,
                           **kw)
    imp = ODEPetabImporter(_par_df(), rhs=lambda y, th: -th[:, 0:1] * y,
                           **kw)
    theta = np.linspace(0.01, 3.0, 301, dtype=np.float32)[:, None]
    ref = np.asarray(j_imp.create_model().simulate(
        KEY, jnp.asarray(theta))["llh"])
    got = imp.create_model().simulate(_gen(), torch.as_tensor(theta))["llh"]
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    # the kernel reads the llh back; the observed stats are a placeholder
    kernel = imp.create_kernel()
    assert kernel.ret_scale == "SCALE_LOG"
    assert imp.get_observed() == j_imp.get_observed() == {"llh": 0.0}
    x = torch.as_tensor(theta[:, 0])
    kernel.bind(pt.sumstat.SumStatSpec.from_example({"llh": 0.0}),
                {"llh": 0.0})
    assert torch.equal(kernel.compute(x[:, None], torch.zeros(1), {}), x)
    prior = imp.create_prior()
    np.testing.assert_allclose(
        prior.log_pdf_array(torch.as_tensor(theta)).numpy(),
        np.asarray(j_imp.create_prior().log_pdf_array(jnp.asarray(theta))),
        rtol=1e-6)


# ---------------------------------------------------------------- priors


ROWS = [
    {"objectivePriorType": "uniform", "objectivePriorParameters": "0.1;4"},
    {"objectivePriorType": "parameterScaleUniform",
     "objectivePriorParameters": "-1;0.5"},
    {"objectivePriorType": "normal", "objectivePriorParameters": "1.5;0.3"},
    {"objectivePriorType": "parameterScaleNormal",
     "objectivePriorParameters": "-0.5;0.7"},
    {"objectivePriorType": "logNormal",
     "objectivePriorParameters": "0.2;0.4"},
    {"objectivePriorType": "laplace", "objectivePriorParameters": "2.0;0.5"},
    {"lowerBound": 0.05, "upperBound": 5.0},
]


@pytest.mark.parametrize("scale", ["lin", "log", "log10"])
@pytest.mark.parametrize("row", ROWS, ids=lambda r: r.get(
    "objectivePriorType", "bounds"))
def test_rv_from_row(row, scale):
    row = pd.Series({"parameterScale": scale, "estimate": 1, **row})
    ref, got = jax_rv_from_row(row), _rv_from_row(row)
    assert type(got).__name__ == type(ref).__name__
    x = np.linspace(-3.0, 6.0, 181).astype(np.float32)
    np.testing.assert_allclose(got.log_pdf(torch.as_tensor(x)).numpy(),
                               np.asarray(ref.log_pdf(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_rv_from_row_skips_and_raises():
    assert _rv_from_row(pd.Series({"estimate": 0})) is None
    with pytest.raises(ValueError, match="unsupported PEtab prior"):
        _rv_from_row(pd.Series({"objectivePriorType": "logLaplace",
                                "objectivePriorParameters": "0;1"}))


def test_lognorm_and_laplace_samples():
    g = _gen()
    for rv, mean, std in ((pt.RV("lognorm", 0.5, 2.0),
                           2.0 * np.exp(0.125),
                           2.0 * np.sqrt((np.exp(0.25) - 1) * np.exp(0.25))),
                          (pt.RV("laplace", 1.0, 0.5), 1.0,
                           0.5 * np.sqrt(2.0))):
        x = rv.sample(g, (200_000,)).double()
        assert abs(float(x.mean()) - mean) < 0.02 * std * 5
        assert abs(float(x.std()) / std - 1.0) < 0.03


# ---------------------------------------------------------------- SBML


def test_sbml_parser_on_the_jax_tests_documents():
    for xml in (SBML_DECAY, SBML_RATE_RULE):
        doc, j_doc = sbml.parse_sbml(xml), jsbml.parse_sbml(xml)
        assert doc.state_ids() == j_doc.state_ids()
        assert doc.y0() == j_doc.y0()
        assert doc.parameters == j_doc.parameters
        assert doc.base_env() == j_doc.base_env()
        assert doc.rate_rules == j_doc.rate_rules
        assert doc.assignment_rules == j_doc.assignment_rules
        assert [r.kinetic_law for r in doc.reactions] == \
            [r.kinetic_law for r in j_doc.reactions]
        y = np.array([[2.0], [4.0]], np.float32)
        env = {"k1": np.array([0.5, 1.0], np.float32)}
        got = doc.make_rhs()(torch.as_tensor(y),
                             {k: torch.as_tensor(v) for k, v in env.items()})
        ref = j_doc.make_rhs()(jnp.asarray(y),
                               {k: jnp.asarray(v) for k, v in env.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    bad = SBML_DECAY.replace("<listOfReactions>",
                             "<listOfEvents/><listOfReactions>")
    with pytest.raises(sbml.ExprError, match="events"):
        sbml.parse_sbml(bad)


@pytest.mark.parametrize("formula", [
    "a * b + exp(0) - a^2", "log10(b) * sqrt(abs(a)) / (1 + tanh(a))",
    "max(a, 1.5) + min(b, a) - pow(b, 0.5)", "log(e) * pi - floor(b)",
])
def test_eval_expr_matches_jax(formula):
    a = np.array([0.5, 1.0, 2.5], np.float32)
    env = {"a": a, "b": 3.0}
    ref = jsbml.eval_expr(formula, {"a": jnp.asarray(a), "b": 3.0})
    got = sbml.eval_expr(formula, {"a": torch.as_tensor(a), "b": 3.0})
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-6)
    assert sbml.expr_names(formula) == jsbml.expr_names(formula)
    assert sbml.eval_expr("b * 2", env) == 6.0


@pytest.mark.parametrize("bad", ["__import__('os').system('true')", "a.b",
                                 "[1,2]", "lambda: 1", "open('x')"])
def test_eval_expr_rejects_non_math(bad):
    with pytest.raises(sbml.ExprError):
        sbml.eval_expr(bad, {})


def test_mathml_to_infix_matches_jax():
    import xml.etree.ElementTree as ET
    for src in (
            '<apply><times/><cn type="e-notation">1.5<sep/>-2</cn>'
            '<apply><ln/><ci>x</ci></apply></apply>',
            '<apply><log/><logbase><cn>2</cn></logbase><ci>x</ci></apply>',
            '<apply><root/><degree><cn>3</cn></degree><ci>x</ci></apply>',
            '<apply><minus/><apply><power/><ci>x</ci><cn>2</cn></apply>'
            '</apply>'):
        m = ET.fromstring('<math xmlns="http://www.w3.org/1998/Math/MathML">'
                          + src + '</math>')
        assert sbml.mathml_to_infix(m) == jsbml.mathml_to_infix(m)


# ---------------------------------------------------------------- PetabSBML


def _decay_problem(pkg_problem, scale="lin", noise="normal", trans="lin",
                   two_conditions=False, override=False):
    """In-memory PEtab tables for the decay model."""
    times = np.array([0.5, 1.0, 1.5, 2.0])
    data = np.exp(-0.7 * times) + 0.05 * np.random.default_rng(0).normal(
        size=4)
    lo, hi = (np.log10(0.01), np.log10(3.0)) if scale == "log10" else \
        (0.01, 3.0)
    par = pd.DataFrame({
        "parameterId": ["k1"], "parameterScale": [scale],
        "lowerBound": [0.01], "upperBound": [3.0], "estimate": [1],
        "objectivePriorType": ["parameterScaleUniform"],
        "objectivePriorParameters": [f"{lo};{hi}"]})
    obs = pd.DataFrame({"observableId": ["obs_a"],
                        "observableFormula": ["A"], "noiseFormula": [0.05],
                        "noiseDistribution": [noise],
                        "observableTransformation": [trans]})
    cond = ["c0"] * 4
    meas = list(data)
    if two_conditions:
        cond += ["c1"] * 4
        meas += list(2.0 * np.exp(-0.7 * times) + 0.05 *
                     np.random.default_rng(1).normal(size=4))
    mdf = pd.DataFrame({"observableId": "obs_a",
                        "simulationConditionId": cond,
                        "time": list(times) * (len(cond) // 4),
                        "measurement": meas})
    cdf = pd.DataFrame({"conditionId": ["c0", "c1"], "A": [1.0, 2.0]}) \
        if (two_conditions or override) else \
        pd.DataFrame({"conditionId": ["c0"]})
    if override and not two_conditions:
        cdf = pd.DataFrame({"conditionId": ["c0"], "A": [2.0]})
    return pkg_problem(SBML_DECAY, par, obs, mdf, cdf)


CASES = {
    "lin": {}, "log10_scale": {"scale": "log10"},
    "override": {"override": True}, "laplace": {"noise": "laplace"},
    "log_transform": {"trans": "log"},
    "log10_transform": {"trans": "log10"},
    "two_conditions": {"two_conditions": True},
}


@pytest.mark.parametrize("case", list(CASES))
def test_petab_sbml_model_llh(case):
    kw = CASES[case]
    j_model = JaxSBMLModel(_decay_problem(JaxProblem, **kw), n_steps=60)
    model = PetabSBMLModel(_decay_problem(PetabProblem, **kw), n_steps=60)
    # on the log scales the llh reaches -5e3 at the ends of [0.2, 2.5],
    # where one float32 unit in the last place is 5e-4: keep |llh| < 1e3
    k = (np.linspace(0.4, 1.2, 24) if "transform" in case
         else np.linspace(0.2, 2.5, 24))
    theta = (np.log10(k) if kw.get("scale") == "log10" else k).astype(
        np.float32)[:, None]
    ref = np.asarray(j_model.simulate(KEY, jnp.asarray(theta))["llh"])
    got = model.simulate(_gen(), torch.as_tensor(theta))["llh"].numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_from_yaml(tmp_path):
    yaml_path, data, times = _write_problem_dir(tmp_path)
    j_imp = JaxSBMLImporter.from_yaml(str(yaml_path), n_steps=100)
    imp = SBMLPetabImporter.from_yaml(str(yaml_path), n_steps=100)
    assert imp.create_prior().space.names == ("k1",)
    theta = np.array([[0.3], [0.7], [2.5]], np.float32)
    np.testing.assert_allclose(
        imp.create_prior().log_pdf_array(torch.as_tensor(theta)).numpy(),
        np.asarray(j_imp.create_prior().log_pdf_array(jnp.asarray(theta))),
        rtol=1e-6)
    ref = np.asarray(j_imp.create_model().simulate(
        KEY, jnp.asarray(theta))["llh"])
    got = imp.create_model().simulate(_gen(), torch.as_tensor(theta))["llh"]
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    # the true rate's llh matches the analytic solution's
    analytic = np.sum(-0.5 * ((data - np.exp(-0.7 * times)) / 0.05) ** 2
                      - 0.5 * np.log(2 * np.pi * 0.05 ** 2))
    assert abs(float(got[1]) - analytic) < 0.05
    assert imp.get_observed() == {"llh": 0.0}
    assert isinstance(imp.create_kernel(), pt.SimpleFunctionKernel)
