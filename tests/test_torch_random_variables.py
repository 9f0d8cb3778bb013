"""The port's random variables against the JAX package's and scipy's.

For each of the 15 native families, the truncation decorators, the
tabulated approximation and the scipy fallback: ``log_pdf`` and ``cdf``
on one numpy grid through both packages (float32 in both; atol and rtol
1e-5 unless a family states its own), the port's samples against scipy
by a KS test (continuous) or a χ² test (discrete) at p > 1e-3, and the
port's own ``betainc`` against ``scipy.special.betainc``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sp
import scipy.stats as ss
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu_torch.random_variables import betainc

N_DRAWS = 40_000

#: name, args, kwargs (the same for RV(...) in both packages and for
#: scipy.stats), grid
FAMILIES = [
    ("norm", (0.5, 2.0), {}, np.linspace(-6, 7, 61)),
    ("uniform", (-1.0, 3.0), {}, np.linspace(-2, 3, 61)),
    ("lognorm", (), {"s": 0.7, "scale": 1.5}, np.linspace(-1, 8, 61)),
    ("expon", (0.2, 1.5), {}, np.linspace(-1, 9, 61)),
    ("laplace", (0.3, 0.8), {}, np.linspace(-4, 4, 61)),
    ("cauchy", (0.1, 0.5), {}, np.linspace(-6, 6, 61)),
    ("gamma", (2.5,), {"scale": 1.3}, np.linspace(-1, 12, 61)),
    ("beta", (2.0, 5.0), {}, np.linspace(-0.2, 1.2, 61)),
    ("randint", (2, 9), {}, np.arange(-1, 12, 0.5)),
    ("poisson", (3.5,), {}, np.arange(0, 16, 1.0)),
    ("t", (4.0, 0.2, 1.5), {}, np.linspace(-9, 9, 61)),
    ("chi2", (3.0,), {}, np.linspace(-1, 14, 61)),
    ("weibull_min", (1.7, 0.0, 2.0), {}, np.linspace(-1, 7, 61)),
    ("binom", (12, 0.3), {}, np.arange(-2, 15, 0.5)),
    ("nbinom", (5, 0.4), {}, np.arange(-2, 30, 1.0)),
]

#: per-family tolerances where float32 forbids 1e-5: the t cdf's
#: betainc runs in float32 in JAX and float64 here
TOL = {"t": dict(atol=3e-5, rtol=3e-5)}


def _both(name, args, kwargs):
    return jpt.RV(name, *args, **kwargs), pt.RV(name, *args, **kwargs)


def _check(jax_fn, port_fn, grid, **tol):
    g = np.asarray(grid, np.float32)
    want = np.asarray(jax_fn(jnp.asarray(g)))
    got = port_fn(torch.as_tensor(g)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **{"atol": 1e-5, "rtol": 1e-5,
                                             **tol})


@pytest.mark.parametrize("name,args,kwargs,grid", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_family_parity(name, args, kwargs, grid):
    j, p = _both(name, args, kwargs)
    assert type(p).__name__ == type(j).__name__
    assert p.discrete == j.discrete
    _check(j.log_pdf, p.log_pdf, grid, **TOL.get(name, {}))
    if name in ("randint", "poisson"):
        # the JAX classes have no cdf: the port's against scipy's
        frozen = getattr(ss, name)(*args, **kwargs)
        _check(frozen.cdf, p.cdf, grid)
    else:
        _check(j.cdf, p.cdf, grid, **TOL.get(name, {}))
    if hasattr(j, "ppf"):
        _check(j.ppf, p.ppf, np.linspace(0.01, 0.99, 21))


def _goodness_of_fit(draws, frozen, discrete):
    """p-value of the draws against scipy's distribution."""
    if not discrete:
        return ss.kstest(draws, frozen.cdf).pvalue
    ks, counts = np.unique(draws, return_counts=True)
    expected = frozen.pmf(ks) * draws.size
    keep = expected >= 5  # the χ² approximation's rule
    obs, exp = counts[keep], expected[keep]
    rest = draws.size - exp.sum()
    if rest > 1e-6 * draws.size:  # the tails, lumped into one bin
        obs = np.append(obs, counts[~keep].sum())
        exp = np.append(exp, rest)
    return ss.chisquare(obs, exp * obs.sum() / exp.sum()).pvalue


@pytest.mark.parametrize("name,args,kwargs,grid", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_family_samples_match_scipy(name, args, kwargs, grid):
    rv = pt.RV(name, *args, **kwargs)
    gen = torch.Generator().manual_seed(11)
    draws = rv.sample(gen, (N_DRAWS,)).numpy().astype(np.float64)
    assert draws.shape == (N_DRAWS,)
    frozen = getattr(ss, name)(*args, **kwargs)
    assert _goodness_of_fit(draws, frozen, rv.discrete) > 1e-3


def _decorated():
    """(id, JAX rv, port rv, grid, scipy frozen twin or None)."""
    out = []
    j = jpt.TruncatedRV(jpt.RV("norm", 0.0, 1.0), lower=0.0)
    p = pt.TruncatedRV(pt.RV("norm", 0.0, 1.0), lower=0.0)
    out.append(("truncated_lower", j, p, np.linspace(-1, 4, 41),
                ss.truncnorm(0.0, np.inf)))
    j = jpt.TruncatedRV(jpt.RV("gamma", 2.0), lower=0.5, upper=3.0)
    p = pt.TruncatedRV(pt.RV("gamma", 2.0), lower=0.5, upper=3.0)
    out.append(("truncated_both", j, p, np.linspace(0, 4, 41), None))
    j = jpt.LowerBoundDecorator(jpt.RV("laplace", 0.0, 1.0), -0.5)
    p = pt.LowerBoundDecorator(pt.RV("laplace", 0.0, 1.0), -0.5)
    out.append(("lower_bound", j, p, np.linspace(-2, 5, 41), None))
    j = jpt.TabulatedRV("gumbel_r", 0.5, 1.2)
    p = pt.TabulatedRV("gumbel_r", 0.5, 1.2)
    out.append(("tabulated_continuous", j, p, np.linspace(-3, 9, 61),
                ss.gumbel_r(0.5, 1.2)))
    j = jpt.TabulatedRV("hypergeom", 20, 7, 12)
    p = pt.TabulatedRV("hypergeom", 20, 7, 12)
    out.append(("tabulated_discrete", j, p, np.arange(-1, 10, 0.5),
                ss.hypergeom(20, 7, 12)))
    j = jpt.RV("gumbel_l", 0.0, 2.0)
    p = pt.RV("gumbel_l", 0.0, 2.0)
    out.append(("scipy", j, p, np.linspace(-12, 4, 41),
                ss.gumbel_l(0.0, 2.0)))
    return out


DECORATED = _decorated()


@pytest.mark.parametrize("case", DECORATED, ids=[c[0] for c in DECORATED])
def test_decorated_parity(case):
    _, j, p, grid, _ = case
    _check(j.log_pdf, p.log_pdf, grid)
    _check(j.cdf, p.cdf, grid)


@pytest.mark.parametrize("case", [c for c in DECORATED if c[4] is not None],
                         ids=[c[0] for c in DECORATED if c[4] is not None])
def test_decorated_samples_match_scipy(case):
    _, _, p, _, frozen = case
    gen = torch.Generator().manual_seed(5)
    draws = p.sample(gen, (N_DRAWS,)).numpy().astype(np.float64)
    assert _goodness_of_fit(draws, frozen, p.discrete) > 1e-3


def test_truncated_sample_stays_in_bounds_and_clips():
    """Rejection fills the rows; what no pass fills is clipped."""
    p = pt.TruncatedRV(pt.RV("norm", 0.0, 1.0), lower=1.0, upper=1.5)
    x = p.sample(torch.Generator().manual_seed(0), (5000,))
    assert bool(((x >= 1.0) & (x <= 1.5)).all())
    tight = pt.TruncatedRV(pt.RV("norm", 0.0, 1.0), lower=6.0, max_iter=3)
    x = tight.sample(torch.Generator().manual_seed(0), (100,))
    assert bool((x >= 6.0).all())
    assert float((x == 6.0).float().mean()) > 0.99  # clipped


@pytest.mark.parametrize("lo,hi", [(0.05, 5.0), (0.5, 60.0), (1.0, 1e3)])
def test_betainc_against_scipy(lo, hi):
    """The port's continued fraction in float64: ≤ 1e-11 absolute."""
    rng = np.random.default_rng(int(hi))
    a, b = rng.uniform(lo, hi, 3000), rng.uniform(lo, hi, 3000)
    x = np.concatenate([rng.uniform(0, 1, 2990),
                        [0.0, 1.0, -0.1, 1.1, 1e-12, 1 - 1e-12, 0.5, 0.5,
                         0.25, 0.75]])
    got = betainc(torch.as_tensor(a), torch.as_tensor(b),
                  torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, sp.betainc(a, b, np.clip(x, 0, 1)),
                               atol=1e-11, rtol=0)


def test_distribution_batched_parity():
    grid = np.random.default_rng(3).uniform(-0.5, 1.5, (50, 3)).astype(
        np.float32)
    jd = jpt.Distribution(a=jpt.RV("beta", 2, 3), b=jpt.RV("gamma", 2.0),
                          c=jpt.TruncatedRV(jpt.RV("norm", 0, 1), lower=0))
    pd_ = pt.Distribution(a=pt.RV("beta", 2, 3), b=pt.RV("gamma", 2.0),
                          c=pt.TruncatedRV(pt.RV("norm", 0, 1), lower=0))
    want = np.asarray(jd.log_pdf_array(jnp.asarray(grid)))
    got = pd_.log_pdf_array(torch.as_tensor(grid)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    draws = pd_.rvs_array(torch.Generator().manual_seed(1), 100)
    assert draws.shape == (100, 3) and math.isfinite(
        float(pd_.log_pdf_array(draws).sum()))
