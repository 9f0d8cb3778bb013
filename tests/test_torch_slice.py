"""End-to-end slice of the PyTorch port on the CPU (``device="cpu"``).

- Twins of tests/test_e2e_slice.py: the 1-D Gaussian (BASELINE config #1)
  posterior and a resumed run.
- Two-Gaussian model selection (config #2) at pop 2000 over 5
  generations in both packages: each p(B) within ``2·2.5/√pop`` of the
  analytic value, and within that of each other.  Random streams differ
  between the packages, so the two runs agree statistically, not
  bitwise.
"""

import numpy as np
import pytest

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem
from pyabc_tpu_torch.models import (GaussianModel,
                                    make_two_gaussians_problem)


def _gaussian_abc(pop, seed):
    # y ~ N(mu, 1), one observation summarized by its value
    return pt.ABCSMC(
        models=GaussianModel(name="gauss"),
        parameter_priors=pt.Distribution(mu=pt.RV("norm", 0.0, 1.0)),
        distance_function=pt.PNormDistance(p=2),
        population_size=pop,
        sampler=pt.VectorizedSampler(device="cpu"),
        seed=seed)


def test_gaussian_posterior(db_path):
    """Prior N(0,1), likelihood N(mu,1), observe y=1: posterior
    N(0.5, 0.5) — the tolerances of test_e2e_slice.py."""
    abc = _gaussian_abc(1000, seed=1)
    abc.new(db_path, {"y": 1.0})
    history = abc.run(max_nr_populations=6, minimum_epsilon=0.01)
    df, w = history.get_distribution(m=0)
    mu_est = float(np.sum(df["mu"].to_numpy() * w))
    var_est = float(np.sum(w * (df["mu"].to_numpy() - mu_est) ** 2))
    assert abs(mu_est - 0.5) < 0.15
    assert 0.3 < var_est < 0.9
    assert history.max_t >= 2


def test_resume(db_path):
    abc = _gaussian_abc(200, seed=2)
    abc.new(db_path, {"y": 1.0})
    h1 = abc.run(max_nr_populations=2)
    t_first = h1.max_t
    assert t_first >= 0
    eps_first = float(h1.get_all_populations().epsilon.iloc[-1])

    abc2 = _gaussian_abc(200, seed=2)
    abc2.load(db_path, abc_id=h1.id)
    h2 = abc2.run(max_nr_populations=2)
    assert h2.max_t > t_first
    # the schedule continues from the stored population
    assert float(h2.get_all_populations().epsilon.iloc[-1]) < eps_first


def test_run_before_new_raises():
    with pytest.raises(RuntimeError, match="new"):
        _gaussian_abc(10, seed=0).run()


def _p_model_b(history):
    return float(history.get_model_probabilities(history.max_t).get(1, 0.0))


def test_model_selection_matches_jax_and_analytic():
    pop, gens = 2000, 5
    tol = 2 * 2.5 / np.sqrt(pop)

    models, priors, distance, observed, posterior_fn = \
        make_two_gaussians_problem()
    abc = pt.ABCSMC(
        models, priors, distance, population_size=pop,
        eps=pt.MedianEpsilon(),
        sampler=pt.VectorizedSampler(max_batch_size=1 << 16,
                                     max_rounds_per_call=16, device="cpu"),
        stores_sum_stats=False, seed=0)
    abc.new("sqlite://", observed)
    p_port = _p_model_b(abc.run(max_nr_populations=gens))
    assert abc.history.max_t == gens - 1
    assert [r["t"] for r in abc.timeline] == list(range(gens))

    j_models, j_priors, j_distance, j_observed, _ = jax_problem()
    j_abc = jpt.ABCSMC(
        j_models, j_priors, j_distance, population_size=pop,
        eps=jpt.MedianEpsilon(),
        sampler=jpt.VectorizedSampler(max_batch_size=1 << 16,
                                      max_rounds_per_call=16),
        stores_sum_stats=False, seed=0)
    j_abc.new("sqlite://", j_observed)
    p_jax = _p_model_b(j_abc.run(max_nr_populations=gens))

    p_true = float(posterior_fn(1.0))
    assert abs(p_port - p_true) < tol
    assert abs(p_jax - p_true) < tol
    assert abs(p_port - p_jax) < tol
