"""The port's transition library against the JAX package's.

- ``LocalTransition``: on tie-free data the k-NN fit gives the same
  Cholesky factors and log norms (rtol 1e-4: a float32 covariance from
  a different summation order), and the log-density of a query batch
  agrees (atol 1e-4); with the JAX fit installed
  (``convert.install_local_transition``) to atol 2e-5.
- ``DiscreteRandomWalkTransition``: the same log-pmf (atol 1e-6) and
  draws whose steps follow it.
- ``GridSearchCV`` picks the JAX package's grid point on a clear case.
- ``predict_population_size`` / ``fit_powerlaw``: identical numbers.
- ``mean_cv``: within bootstrap noise of the JAX package's (the two
  packages draw different bootstrap resamples).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.transition.predict_population_size import (
    fit_powerlaw as jax_fit_powerlaw,
    predict_population_size as jax_predict)
from pyabc_tpu_torch.convert import install_local_transition, to_torch
from pyabc_tpu_torch.transition import fit_powerlaw, predict_population_size

RNG = np.random.default_rng(4)
THETA = RNG.normal(0.0, [1.0, 2.0], (300, 2)).astype(np.float32)
THETA[:, 1] += 0.5 * THETA[:, 0]  # correlated, all distances distinct
W = RNG.uniform(0.5, 1.5, 300).astype(np.float32)
QUERY = RNG.normal(0.0, 2.0, (77, 2)).astype(np.float32)


def _local_pair(k=None):
    j = jpt.LocalTransition(k=k).fit(THETA, W)
    p = pt.LocalTransition(k=k, device="cpu").fit(THETA, W)
    return j, p


@pytest.mark.parametrize("k", [None, 12])
def test_local_transition_fit_parity(k):
    j, p = _local_pair(k)
    np.testing.assert_allclose(p._chols, np.asarray(j._chols), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(p._log_norms, np.asarray(j._log_norms),
                               rtol=1e-4, atol=1e-5)
    want = np.asarray(j.log_pdf(jnp.asarray(QUERY)))
    got = p.log_pdf(torch.as_tensor(QUERY)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_local_transition_installed_log_pdf_and_padding():
    """The JAX fit installed in the port: log-density to float32
    rounding, also from params padded with identity factors."""
    j, _ = _local_pair()
    p = install_local_transition(pt.LocalTransition(device="cpu"),
                                 j.theta, j.w, j._chols, j._log_norms)
    want = np.asarray(j.log_pdf_from_params(jnp.asarray(QUERY),
                                            j.get_params()))
    got = p.log_pdf(torch.as_tensor(QUERY)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-6)
    padded = to_torch(p.pad_params(p.get_params(), 512), "cpu")
    assert padded["chols"].shape == (512, 2, 2)
    np.testing.assert_array_equal(padded["chols"][300:].numpy(),
                                  np.broadcast_to(np.eye(2), (212, 2, 2)))
    got_pad = pt.LocalTransition.log_pdf_from_params(
        torch.as_tensor(QUERY), padded, chunk=32).numpy()
    np.testing.assert_allclose(got_pad, got, atol=1e-6)


def test_local_transition_draws_follow_its_density():
    _, p = _local_pair()
    x = p.rvs(torch.Generator().manual_seed(2), 20000)
    assert x.shape == (20000, 2)
    # the proposal's mean is the weighted support mean
    mean = (THETA * (W / W.sum())[:, None]).sum(0)
    np.testing.assert_allclose(x.mean(0).numpy(), mean, atol=0.06)


def test_random_walk_parity():
    ints = RNG.integers(-3, 4, (40, 2)).astype(np.float32)
    w = RNG.uniform(0.2, 1.0, 40).astype(np.float32)
    q = RNG.integers(-5, 6, (60, 2)).astype(np.float32)
    j = jpt.DiscreteRandomWalkTransition(n_steps=2, p_stay=0.4).fit(ints, w)
    p = pt.DiscreteRandomWalkTransition(n_steps=2, p_stay=0.4).fit(ints, w)
    want = np.asarray(j.log_pdf(jnp.asarray(q)))
    got = p.log_pdf(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    one = pt.DiscreteRandomWalkTransition(n_steps=1, p_stay=0.5).fit(
        np.zeros((1, 1), np.float32), np.ones(1, np.float32))
    x = one.rvs(torch.Generator().manual_seed(0), 30000)[:, 0]
    freq = [float((x == v).float().mean()) for v in (-1.0, 0.0, 1.0)]
    np.testing.assert_allclose(freq, [0.25, 0.5, 0.25], atol=0.015)


def test_grid_search_picks_the_jax_grid_point():
    """Narrow bandwidths have a large bootstrap CV: both packages keep
    the widest scaling of the grid."""
    x = RNG.normal(size=(400, 1)).astype(np.float32)
    w = np.ones(400, np.float32)
    grid = {"scaling": [0.02, 0.2, 3.0]}
    j = jpt.GridSearchCV(param_grid=grid).fit(x, w)
    p = pt.GridSearchCV(param_grid=grid, device="cpu").fit(x, w)
    assert p.best_params_ == j.best_params_ == {"scaling": 3.0}
    assert isinstance(p.best_estimator_, pt.MultivariateNormalTransition)
    assert p.log_pdf(torch.as_tensor(x[:5])).shape == (5,)


@pytest.mark.parametrize("cvs,target", [
    ({100: 0.4, 200: 0.28, 400: 0.2}, 0.1),
    ({100: 0.4, 200: 0.28, 400: 0.2}, 0.5),
    ({50: 0.1, 100: 0.2}, 0.05),           # cv rising: the fallback
    ({64: 0.3}, 0.1),                      # one size: that size
])
def test_predict_population_size_exact(cvs, target):
    assert predict_population_size(cvs, target, fallback=200) == \
        jax_predict(cvs, target, fallback=200)
    if len(cvs) > 1:
        assert fit_powerlaw(list(cvs), list(cvs.values())) == \
            jax_fit_powerlaw(list(cvs), list(cvs.values()))


def test_mean_cv_within_bootstrap_noise():
    x = RNG.normal(size=(600, 1)).astype(np.float32)
    w = np.ones(600, np.float32)
    j = jpt.MultivariateNormalTransition().fit(x, w)
    p = pt.MultivariateNormalTransition().fit(x, w)
    want = j.mean_cv(jax.random.PRNGKey(0), n_samples=300, n_bootstrap=20)
    got = p.mean_cv(torch.Generator().manual_seed(0), n_samples=300,
                    n_bootstrap=20)
    assert 0.0 < got and got == pytest.approx(want, rel=0.25)
    # more rows, smaller CV, in both
    got_big = p.mean_cv(torch.Generator().manual_seed(1), n_samples=2400,
                        n_bootstrap=20)
    assert got_big < got
