"""Gaussian-KDE transition fit of the PyTorch port against the JAX package.

The fit is host float64/float32 numpy in both packages (the JAX package
runs it with ``xp = np``), so the same numpy θ, w must give the same
Cholesky factor, log normalizer and grid-compressed support to 1e-6.
"""

import numpy as np
import pytest
import torch

from pyabc_tpu.transition import MultivariateNormalTransition as JaxMVN
from pyabc_tpu_torch.transition import MultivariateNormalTransition


def _population(n, d, seed):
    rng = np.random.default_rng(seed)
    theta = (0.5 + 0.4 * rng.standard_normal((n, d))).astype(np.float32)
    w = rng.uniform(0.2, 1.8, n).astype(np.float32)
    return theta, w


@pytest.mark.parametrize("n,d", [(1, 1), (300, 1), (20000, 1), (500, 2),
                                 (800, 5)])
def test_fit_matches_jax(n, d):
    theta, w = _population(n, d, seed=n + d)
    ref = JaxMVN().fit(theta, w)
    got = MultivariateNormalTransition().fit(theta, w)
    np.testing.assert_allclose(got._chol, np.asarray(ref._chol),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(got._log_norm),
                               float(ref._log_norm), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [16384, 50000])
def test_compress_support_matches_jax(n):
    theta, w = _population(n, 1, seed=n)
    ref = JaxMVN().fit(theta, w)
    got = MultivariateNormalTransition().fit(theta, w)
    assert ref._compressed is not None and got._compressed is not None
    for a, b in zip(got._compressed, ref._compressed):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
    assert got._grid_g == ref._grid_g


def test_compress_grid_is_monotone_like_jax():
    """The grid size never shrinks on one instance (a later, narrower
    posterior keeps the earlier grid), in both packages."""
    wide, w1 = _population(30000, 1, seed=1)
    narrow = (0.5 + 0.02 * (wide - 0.5)).astype(np.float32)
    ref, got = JaxMVN(), MultivariateNormalTransition()
    for theta in (wide, narrow):
        ref.fit(theta, w1)
        got.fit(theta, w1)
        assert got._grid_g == ref._grid_g
    np.testing.assert_allclose(got._compressed[1],
                               np.asarray(ref._compressed[1]), atol=1e-6)


def test_pad_params_matches_jax():
    theta, w = _population(700, 2, seed=3)
    ref = JaxMVN().fit(theta, w)
    got = MultivariateNormalTransition().fit(theta, w)
    p_ref = ref.pad_params(ref.get_params(), 1024)
    p_got = got.pad_params(got.get_params(), 1024)
    assert set(p_ref) == set(p_got)
    for k in p_ref:
        np.testing.assert_allclose(np.asarray(p_got[k]),
                                   np.asarray(p_ref[k]), rtol=1e-6)
    assert np.all(p_got["log_w"][700:] == np.float32(-1e30))


def test_rvs_draws_only_real_support_rows():
    """Resampling never lands on a -1e30 pad row: with a zero-noise
    Cholesky every draw equals a real support row."""
    theta, w = _population(100, 1, seed=4)
    tr = MultivariateNormalTransition().fit(theta, w)
    params = tr.pad_params(tr.get_params(), 256)
    params = {k: torch.as_tensor(np.asarray(v, dtype=np.float32))
              for k, v in params.items()}
    params["chol"] = torch.zeros_like(params["chol"])
    gen = torch.Generator().manual_seed(0)
    draws = tr.rvs_from_params(gen, params, 20000).numpy()[:, 0]
    assert np.isin(draws, theta[:, 0]).all()
