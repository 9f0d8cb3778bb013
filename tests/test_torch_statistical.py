"""The JAX package's analytic suite (tests/test_statistical.py) through
the port on the CPU, at the JAX tests' sizes and tolerances: the cookie
jar, the beta-binomial with Beta priors, the continuous non-Gaussian
posterior, the exponential–gamma conjugate pair with a Gamma prior,
the adaptive population size's power-law inversion, the binomial kernel
through the stochastic triple, and the truncated-normal prior.  Each
problem is held to its JAX test's own tolerance.
"""

import numpy as np
import pytest
import torch
from scipy.special import binom as sp_binom, gamma as sp_gamma

import pyabc_tpu_torch as pt

CPU = {"device": "cpu"}


def _sampler(**kw):
    return pt.VectorizedSampler(**CPU, **kw)


def test_cookie_jar(db_path):
    """Two zero-parameter models, P(result = 0 | jar j) = theta_j."""
    theta1, theta2 = 0.2, 0.6

    def make_model(theta):
        def model(generator, th):  # th: [N, 0]
            p = torch.full((th.shape[0],), 1.0 - theta, device=th.device)
            return {"result": torch.bernoulli(p, generator=generator)}
        return model

    abc = pt.ABCSMC(
        models=[pt.SimpleModel(make_model(theta1), name="jar1"),
                pt.SimpleModel(make_model(theta2), name="jar2")],
        parameter_priors=[pt.Distribution(), pt.Distribution()],
        distance_function=pt.MinMaxDistance(),
        population_size=1500,
        eps=pt.MedianEpsilon(0.1),
        sampler=_sampler(),
        seed=8)
    abc.new(db_path, {"result": 0})
    h = abc.run(minimum_epsilon=0.2, max_nr_populations=1)
    mp = h.get_model_probabilities(h.max_t)
    expected1 = theta1 / (theta1 + theta2)
    expected2 = theta2 / (theta1 + theta2)
    assert abs(float(mp.get(0, 0.0)) - expected1) + \
        abs(float(mp.get(1, 0.0)) - expected2) < 0.05


def test_beta_binomial_different_priors(db_path):
    binomial_n = 5
    a1, b1 = 1.0, 1.0
    a2, b2 = 10.0, 1.0
    n1 = 2

    def model(generator, th):
        p = th[:, 0:1].expand(th.shape[0], binomial_n)
        return {"result": torch.bernoulli(p, generator=generator).sum(1)}

    abc = pt.ABCSMC(
        models=[pt.SimpleModel(model, name="m1"),
                pt.SimpleModel(model, name="m2")],
        parameter_priors=[pt.Distribution(theta=pt.RV("beta", a1, b1)),
                          pt.Distribution(theta=pt.RV("beta", a2, b2))],
        distance_function=pt.MinMaxDistance(),
        population_size=800,
        eps=pt.MedianEpsilon(0.1),
        sampler=_sampler(),
        seed=10)
    abc.new(db_path, {"result": n1})
    h = abc.run(minimum_epsilon=0.2, max_nr_populations=3)

    def B(a, b):
        return sp_gamma(a) * sp_gamma(b) / sp_gamma(a + b)

    def evidence(a, b):
        return sp_binom(binomial_n, n1) * B(a + n1, b + binomial_n - n1) \
            / B(a, b)

    e1, e2 = evidence(a1, b1), evidence(a2, b2)
    mp = h.get_model_probabilities(h.max_t)
    assert abs(float(mp.get(0, 0.0)) - e1 / (e1 + e2)) + \
        abs(float(mp.get(1, 0.0)) - e2 / (e1 + e2)) < 0.08


def test_continuous_non_gaussian(db_path):
    d_observed = 0.5

    def model(generator, th):
        u = th[:, 0]
        return {"result": u * torch.rand(u.shape, generator=generator,
                                         device=u.device)}

    abc = pt.ABCSMC(
        models=pt.SimpleModel(model, name="scaled_uniform"),
        parameter_priors=pt.Distribution(u=pt.RV("uniform", 0.0, 1.0)),
        distance_function=pt.MinMaxDistance(),
        population_size=250,
        eps=pt.MedianEpsilon(0.2),
        sampler=_sampler(),
        seed=12)
    abc.new(db_path, {"result": d_observed})
    h = abc.run(minimum_epsilon=-1, max_nr_populations=2)

    df, w = h.get_distribution(m=0)
    x = df["u"].to_numpy()
    order = np.argsort(x)
    xs = np.hstack((-200.0, x[order], 200.0))
    cdf = np.hstack((0.0, np.cumsum(w[order]), 1.0))

    def f_expected(u):
        return np.where(
            u > d_observed,
            (np.log(u) - np.log(d_observed)) / (-np.log(d_observed)), 0.0)

    grid = np.linspace(0.1, 1.0, 50)
    assert np.abs(np.interp(grid, xs, cdf) - f_expected(grid)).max() < 0.12


def test_exponential_gamma_conjugate(db_path):
    a, b = 2.0, 1.0
    n_obs = 8
    lam_true = 1.6
    rng = np.random.default_rng(5)
    y = rng.exponential(1.0 / lam_true, size=n_obs).astype(np.float32)

    def model(generator, theta):
        lam = torch.clamp(theta[:, :1], min=1e-6)
        u = 1e-7 + (1.0 - 1e-7) * torch.rand(
            theta.shape[0], n_obs, generator=generator, device=theta.device)
        return {"ybar": (-torch.log(u) / lam).mean(1)}

    abc = pt.ABCSMC(
        pt.SimpleModel(model),
        pt.Distribution(lam=pt.RV("gamma", a, scale=1.0 / b)),
        pt.PNormDistance(p=1),
        population_size=800,
        sampler=_sampler(max_batch_size=1 << 15),
        seed=17)
    abc.new(db_path, {"ybar": float(np.mean(y))})
    h = abc.run(max_nr_populations=7, minimum_epsilon=1e-3)
    df, w = h.get_distribution()
    lam_mean = float(np.sum(df["lam"].to_numpy() * w))
    posterior_mean = (a + n_obs) / (b + float(np.sum(y)))
    assert lam_mean == pytest.approx(posterior_mean, rel=0.2)


def test_adaptive_population_size_power_law_inversion():
    rng = np.random.default_rng(0)
    theta = rng.normal(size=(512, 2)).astype(np.float32)
    w = np.full(512, 1 / 512, np.float32)
    tr = pt.MultivariateNormalTransition()
    tr.fit(theta, w)

    loose = pt.AdaptivePopulationSize(512, mean_cv=10.0, quantize=False,
                                      **CPU)
    loose.update([tr], [1.0])
    assert loose.nr_particles < 512, loose.nr_particles

    tight = pt.AdaptivePopulationSize(512, mean_cv=1e-4, quantize=False,
                                      max_population_size=10**6, **CPU)
    tight.update([tr], [1.0])
    assert tight.nr_particles > 512, tight.nr_particles


def test_binomial_kernel_stochastic_triple_e2e():
    p_success = 0.4
    true_n = 20
    rng = np.random.default_rng(0)
    observed_k = float(rng.binomial(true_n, p_success))

    def model(generator, theta):
        return {"n": torch.clamp(torch.round(theta[:, 0]), min=0.0)}

    abc = pt.ABCSMC(
        models=pt.SimpleModel(model),
        parameter_priors=pt.Distribution(n=pt.RV("uniform", 0.0, 60.0)),
        distance_function=pt.BinomialKernel(p=p_success),
        population_size=400,
        eps=pt.Temperature(),
        acceptor=pt.StochasticAcceptor(),
        sampler=_sampler(),
        seed=4)
    abc.new("sqlite://", {"n": observed_k})
    h = abc.run(max_nr_populations=4)
    df, w = h.get_distribution()
    mean_n = float(np.sum(df["n"].to_numpy() * w))
    assert abs(mean_n - observed_k / p_success) < 6.0, mean_n


def test_truncated_prior_e2e():
    def model(generator, theta):
        mu = theta[:, 0]
        return {"y": mu + 0.2 * torch.randn(mu.shape, generator=generator,
                                            device=mu.device)}

    prior = pt.Distribution(
        mu=pt.TruncatedRV(pt.RV("norm", 0.0, 1.0), lower=0.0))
    abc = pt.ABCSMC(pt.SimpleModel(model), prior, pt.PNormDistance(p=2),
                    population_size=400, sampler=_sampler(), seed=13)
    abc.new("sqlite://", {"y": 0.15})
    h = abc.run(max_nr_populations=4)
    df, w = h.get_distribution()
    draws = df["mu"].to_numpy()
    assert (draws >= 0.0).all(), draws.min()
    mean = float(np.sum(draws * w))
    assert 0.0 < mean < 0.45, mean
