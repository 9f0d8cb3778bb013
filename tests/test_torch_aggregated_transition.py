"""The port's ``AggregatedTransition`` against the JAX package's
(``pyabc_tpu/transition/base.py:210-300``): densities on the same fitted
support to K1's tolerance, the twins of ``tests/test_transition.py``'s
aggregated tests, the per-block generator streams, and the engine the
two packages pick for the same configuration."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.transition import MultivariateNormalTransition as JaxMVN
from pyabc_tpu_torch.transition import MultivariateNormalTransition as MVN
from pyabc_tpu_torch.transition.base import sub_generators

#: K1's tolerance (tests/test_ops_kde_pallas.py:30-36)
ATOL, RTOL = 5e-3, 1e-4


def _fitted(n=700, d=4, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.normal(size=(n, d)).astype(np.float32) * [1.0, 0.5, 2.0, 1.0]
    w = (rng.random(n) + 0.1).astype(np.float32)
    blocks = {(0, 2): 1.0, (2, 3): 0.5, (3, 4): 2.0}
    agg_j = jpt.AggregatedTransition(
        {k: JaxMVN(scaling=s) for k, s in blocks.items()})
    agg_p = pt.AggregatedTransition(
        {k: MVN(scaling=s) for k, s in reversed(list(blocks.items()))})
    agg_j.fit(theta, w)
    agg_p.fit(theta, w)
    x = rng.normal(size=(300, d)).astype(np.float32) * 1.5
    return agg_j, agg_p, theta, x


def test_log_pdf_matches_the_jax_package():
    agg_j, agg_p, _, x = _fitted()
    ref = np.asarray(agg_j.log_pdf(jnp.asarray(x)))
    got = agg_p.log_pdf(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    # the composed static kernel on padded params is the same density
    _, lp = agg_p.static_fns()
    params = agg_p.pad_params(agg_p.get_params(), 1024)
    from pyabc_tpu_torch.convert import to_torch
    got_s = lp(torch.from_numpy(x), to_torch(params, "cpu")).numpy()
    np.testing.assert_allclose(got_s, ref, atol=ATOL, rtol=RTOL)
    assert list(agg_p.get_params()) == ["0:2", "2:3", "3:4"]


def test_aggregated_transition_order_and_coverage():
    """Insertion order does not matter; gaps and overlaps raise."""
    agg = pt.AggregatedTransition({(1, 2): MVN(), (0, 1): MVN()})
    theta = np.column_stack([np.full(64, 5.0), np.full(64, -5.0)]) \
        .astype(np.float32)
    agg.fit(theta, np.ones(64) / 64)
    draws = agg.rvs(torch.Generator().manual_seed(0), 256).numpy()
    assert abs(draws[:, 0].mean() - 5.0) < 0.5
    assert abs(draws[:, 1].mean() + 5.0) < 0.5
    rvs_static, _ = agg.static_fns()
    from pyabc_tpu_torch.convert import to_torch
    params = to_torch(agg.pad_params(agg.get_params(), 64), "cpu")
    draws_s = rvs_static(torch.Generator().manual_seed(1), params,
                         256).numpy()
    assert abs(draws_s[:, 0].mean() - 5.0) < 0.5
    assert abs(draws_s[:, 1].mean() + 5.0) < 0.5
    with pytest.raises(ValueError, match="contiguously"):
        pt.AggregatedTransition({(0, 1): MVN(), (2, 3): MVN()})
    with pytest.raises(ValueError, match="empty"):
        pt.AggregatedTransition({(1, 1): MVN()})


def test_blocks_draw_from_streams_of_their_own():
    """Each block draws from its own stream, seeded from the run
    generator's state: the same state gives the same draws, the next
    call new ones, and a block's draws are its sub-transition's from
    that stream."""
    _, agg, _, _ = _fitted()
    from pyabc_tpu_torch.convert import to_torch
    params = to_torch(agg.get_params(), "cpu")
    rvs, _ = agg.static_fns()
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a, b = rvs(g1, params, 100), rvs(g2, params, 100)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not torch.equal(rvs(g1, params, 100), a)
    g3 = torch.Generator().manual_seed(5)
    streams = sub_generators(g3, 3)
    block = MVN.rvs_from_params(streams[1], params["2:3"], 100)
    np.testing.assert_array_equal(a[:, 2:3].numpy(), block.numpy())


def test_aggregated_transition_e2e_abcsmc():
    """The twin of the JAX test: two parameters, one sub-transition per
    column, both inferred (pop 400, 4 generations)."""
    def model(generator, theta):
        n = theta.shape[0]
        return {"a": theta[:, 0] + 0.1 * torch.randn(n, generator=generator),
                "b": theta[:, 1] + 0.1 * torch.randn(n, generator=generator)}

    agg = pt.AggregatedTransition({(0, 1): MVN(), (1, 2): MVN(scaling=0.5)})
    abc = pt.ABCSMC(
        models=pt.SimpleModel(model),
        parameter_priors=pt.Distribution(mu_a=pt.RV("uniform", -1.0, 2.0),
                                         mu_b=pt.RV("uniform", -1.0, 2.0)),
        distance_function=pt.PNormDistance(p=2), population_size=400,
        transitions=agg, sampler=pt.VectorizedSampler(device="cpu"),
        seed=8)
    abc.new("sqlite://", {"a": 0.3, "b": 0.7})
    h = abc.run(max_nr_populations=4)
    df, w = h.get_distribution()
    assert abs(float(np.sum(df["mu_a"].to_numpy() * w)) - 0.3) < 0.15
    assert abs(float(np.sum(df["mu_b"].to_numpy() * w)) - 0.7) < 0.15
    assert all(r["path"] == "sequential" for r in abc.timeline)
    assert abc.timeline[-1]["kde_support"][0]["blocks"][0]["rows"] >= 256


@pytest.mark.parametrize("run_mode", ["auto", "onedispatch"])
def test_engine_is_the_jax_packages_choice(run_mode):
    """An aggregated transition has no device refit: neither package
    runs fused blocks or a one-dispatch run for it, and both do for the
    plain Gaussian KDE."""
    from pyabc_tpu.models import make_two_gaussians_problem as jax_problem
    from pyabc_tpu_torch.models import make_two_gaussians_problem

    def build(mod, problem, trans, **kw):
        models, priors, distance, observed, _ = problem()
        abc = mod.ABCSMC(models, priors, distance, population_size=200,
                         eps=mod.ConstantEpsilon(0.3), transitions=trans,
                         sampler=mod.VectorizedSampler(**kw),
                         fuse_generations=2, run_mode=run_mode)
        abc.new("sqlite://", observed)
        return abc

    for aggregated in (True, False):
        def trans(mod, mvn):
            if aggregated:
                return [mod.AggregatedTransition({(0, 1): mvn()})
                        for _ in range(2)]
            return [mvn() for _ in range(2)]

        a_j = build(jpt, jax_problem, trans(jpt, JaxMVN))
        a_p = build(pt, make_two_gaussians_problem, trans(pt, MVN),
                    device="cpu")
        assert a_p._fused_eligible() == a_j._fused_eligible() \
            == (not aggregated)
        assert a_p._onedispatch_eligible() == a_j._onedispatch_eligible() \
            == (not aggregated and run_mode == "onedispatch")
