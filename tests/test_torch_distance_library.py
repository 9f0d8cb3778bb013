"""The eight library distances of the port against the JAX package's.

One seeded input — observed stats with a vector and a scalar key, a
calibration sample, a record block and a query batch — goes through both
packages: bind, initialize from the calibration sample, (for the
adaptive aggregate) one update from the same records, then the distances
of the query batch under generation 1's params.  Tolerance rtol 1e-5,
atol 1e-6 (float32 in both).  Each class declares ``adaptive`` as its
JAX twin does, so the port's eligibility checks decide alike.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem
from pyabc_tpu.sumstat import SumStatSpec as JaxSpec
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.sumstat import SumStatSpec

RNG = np.random.default_rng(8)
X0 = {"a": np.array([0.5, -1.0], np.float32), "b": np.float32(2.0)}
CALIB = {"a": RNG.normal(0, [1.0, 3.0], (400, 2)).astype(np.float32),
         "b": RNG.gamma(2.0, 1.0, 400).astype(np.float32)}
RECORDS = {"a": RNG.normal(0.2, [0.5, 2.0], (700, 2)).astype(np.float32),
           "b": RNG.gamma(3.0, 0.5, 700).astype(np.float32)}
QUERY = {"a": RNG.normal(0, 1.5, (64, 2)).astype(np.float32),
         "b": np.concatenate([[2.0], RNG.gamma(2.0, 1.0, 63)]).astype(
             np.float32)}


def _make(pkg, name):
    build = {
        "aggregated": lambda: pkg.AggregatedDistance(
            [pkg.PNormDistance(p=1), pkg.ZScoreDistance()],
            weights=[1.0, 0.5], factors=[2.0, 1.0]),
        "adaptive_aggregated": lambda: pkg.AdaptiveAggregatedDistance(
            [pkg.PNormDistance(p=2), pkg.MinMaxDistance(p=1)]),
        "zscore": lambda: pkg.ZScoreDistance(),
        "pca": lambda: pkg.PCADistance(),
        "measure_list": lambda: pkg.DistanceWithMeasureList(
            measures_to_use=["a"], p=1.5),
        "range_estimator": lambda: pkg.RangeEstimatorDistance(p=2),
        "minmax": lambda: pkg.MinMaxDistance(p=2),
        "percentile": lambda: pkg.PercentileDistance(measures_to_use=["b"]),
    }
    return build[name]()


NAMES = ["aggregated", "adaptive_aggregated", "zscore", "pca",
         "measure_list", "range_estimator", "minmax", "percentile"]


def _jax_run(d):
    spec = JaxSpec.from_example({k: jnp.asarray(v) for k, v in X0.items()})
    x0 = {k: jnp.asarray(v) for k, v in X0.items()}
    d.bind(spec, x0)
    d.initialize(0, lambda: {k: jnp.asarray(v) for k, v in CALIB.items()},
                 x0, spec)
    d.update(1, lambda: {k: jnp.asarray(v) for k, v in RECORDS.items()})
    stats = spec.flatten({k: jnp.asarray(v) for k, v in QUERY.items()})
    return np.asarray(d.compute(stats, spec.flatten_single(x0),
                                d.get_params(1)))


def _port_run(d):
    spec = SumStatSpec.from_example(X0)
    d.bind(spec, X0)
    d.initialize(0, lambda: {k: torch.as_tensor(v) for k, v in CALIB.items()},
                 X0, spec)
    d.update(1, lambda: {k: torch.as_tensor(v) for k, v in RECORDS.items()})
    stats = spec.flatten({k: torch.as_tensor(v) for k, v in QUERY.items()})
    params = pt.convert.to_torch(d.get_params(1), "cpu")
    return d.compute(stats, spec.flatten_single(X0), params).numpy()


@pytest.mark.parametrize("name", NAMES)
def test_distance_parity(name):
    j, p = _make(jpt, name), _make(pt, name)
    assert type(p).__name__ == type(j).__name__
    assert getattr(p, "adaptive", False) == getattr(j, "adaptive", False)
    assert p.requires_all_sum_stats == j.requires_all_sum_stats
    want, got = _jax_run(j), _port_run(p)
    assert got.shape == (64,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert p.params_time_invariant() == j.params_time_invariant()


def test_adaptive_aggregated_weights_from_the_records():
    """The refit weights of generation 1 are 1/span of each sub-distance
    over the records, as in the JAX package, and install_weights carries
    them across."""
    j, p = _make(jpt, "adaptive_aggregated"), _make(pt, "adaptive_aggregated")
    _jax_run(j)
    _port_run(p)
    np.testing.assert_allclose(p.weights[1], j.weights[1], rtol=1e-5)
    assert set(p.weights) == set(j.weights) == {0, 1}
    fresh = _make(pt, "adaptive_aggregated")
    pt.convert.install_weights(fresh, j.weights)
    np.testing.assert_array_equal(fresh.weights[1], j.weights[1])


def test_the_port_abc_sees_the_same_adaptivity():
    """``_distance_is_adaptive`` and the device-chain eligibility decide
    as in the JAX package for the new distances."""
    models, priors, _, _, _ = make_two_gaussians_problem()
    jmodels, jpriors, _, _, _ = jax_problem()
    for name in NAMES:
        abc = pt.ABCSMC(models, priors, _make(pt, name), population_size=50,
                        sampler=pt.VectorizedSampler(device="cpu"),
                        fuse_generations=2)
        jabc = jpt.ABCSMC(jmodels, jpriors, _make(jpt, name),
                          population_size=50, fuse_generations=2)
        assert abc._distance_is_adaptive() == jabc._distance_is_adaptive()
        assert abc._fused_eligible() == jabc._fused_eligible()
