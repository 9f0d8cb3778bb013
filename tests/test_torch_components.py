"""Host control-plane components of the PyTorch port against the JAX
package on the same weighted populations: weighted quantile and median,
effective sample size, the quantile/median epsilon schedules, model
probabilities, normalized weights and weighted distances.  Both packages
compute these in host numpy, so they agree to float rounding (rtol
1e-6)."""

import numpy as np
import pytest

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.weighted_statistics import (effective_sample_size as j_ess,
                                           weighted_quantile as j_quantile)
from pyabc_tpu_torch.weighted_statistics import (effective_sample_size,
                                                 weighted_median,
                                                 weighted_quantile)


def _weighted(n, seed, ties=False):
    rng = np.random.default_rng(seed)
    d = rng.gamma(2.0, 0.3, n)
    if ties:
        d = np.round(d, 1)
    w = rng.uniform(0.0, 2.0, n)
    return d.astype(np.float32), (w / w.sum()).astype(np.float32)


@pytest.mark.parametrize("alpha", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("ties", [False, True])
def test_weighted_quantile_matches_jax(alpha, ties):
    d, w = _weighted(5000, seed=int(alpha * 10), ties=ties)
    np.testing.assert_allclose(weighted_quantile(d, w, alpha),
                               j_quantile(d, w, alpha), rtol=1e-6)
    np.testing.assert_allclose(weighted_quantile(d, None, alpha),
                               j_quantile(d, None, alpha), rtol=1e-6)


def test_weighted_median_and_ess_match_jax():
    d, w = _weighted(3000, seed=4)
    np.testing.assert_allclose(weighted_median(d, w),
                               j_quantile(d, w, 0.5), rtol=1e-6)
    np.testing.assert_allclose(effective_sample_size(w), j_ess(w),
                               rtol=1e-6)


@pytest.mark.parametrize("make", [
    lambda m: m.MedianEpsilon(),
    lambda m: m.QuantileEpsilon(alpha=0.3, quantile_multiplier=0.9),
    lambda m: m.QuantileEpsilon(alpha=0.7, weighted=False),
])
def test_quantile_epsilon_schedule_matches_jax(make):
    ref, got = make(jpt), make(pt)
    for t in range(3):
        d, w = _weighted(2000, seed=10 + t)
        get = lambda: (d, w)  # noqa: E731
        if t == 0:
            ref.initialize(0, get)
            got.initialize(0, get)
        else:
            ref.update(t, get)
            got.update(t, get)
        np.testing.assert_allclose(got(t), ref(t), rtol=1e-6)
    # an unknown t falls back to the latest known value in both
    assert got(7) == pytest.approx(ref(7), rel=1e-6)


def test_constant_and_list_epsilon():
    assert pt.ConstantEpsilon(0.3)(5) == jpt.ConstantEpsilon(0.3)(5)
    assert pt.ListEpsilon([1.0, 0.5])(1) == jpt.ListEpsilon([1.0, 0.5])(1)


def test_model_probabilities_match_jax():
    rng = np.random.default_rng(5)
    m = rng.integers(0, 3, 4000).astype(np.int32)
    theta = rng.standard_normal((4000, 2)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, 4000).astype(np.float32)
    d = rng.uniform(0.0, 1.0, 4000).astype(np.float32)
    ref = jpt.Population(m, theta, w, d)
    got = pt.Population(m, theta, w, d)
    np.testing.assert_allclose(got.get_model_probabilities(3),
                               np.asarray(ref.get_model_probabilities(3)),
                               rtol=1e-6)
    np.testing.assert_allclose(got.normalized_weights(),
                               np.asarray(ref.normalized_weights()),
                               rtol=1e-6)
    assert got.nr_of_models_alive() == ref.nr_of_models_alive()
    for a, b in zip(got.get_weighted_distances(),
                    ref.get_weighted_distances()):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)
