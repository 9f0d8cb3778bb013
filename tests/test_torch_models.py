"""The port's Lotka-Volterra and SIR models against the JAX package's.

- LV: the JAX model's noise block, drawn from its key, goes through the
  port's ``integrate``; prey and predator agree to ``1e-4·max|value|``.
- SIR, the update: both packages run with the same deterministic
  stand-in for the Poisson draw (the JAX module's ``jax.random.poisson``
  replaced for the test); the trajectories agree.
- SIR, the draws: 4096 epidemics at one θ in each package; peak and
  final infected count pass a two-sample KS test (p > 1e-3).
- ``obs_idx`` equals the JAX model's; shapes, conservation and the
  low-fidelity variants as in tests/test_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as ss

from pyabc_tpu.models import LotkaVolterraSDE as JaxLV
from pyabc_tpu.models import SIRTauLeap as JaxSIR
from pyabc_tpu_torch.distance import AdaptivePNormDistance
from pyabc_tpu_torch.models import (LV_TRUTH, SIR_TRUTH, LotkaVolterraSDE,
                                    SIRTauLeap, make_lotka_volterra_problem,
                                    make_sir_problem)
from pyabc_tpu_torch.models.sir import sir_step


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _lv_thetas(n, seed):
    rng = np.random.default_rng(seed)
    return (np.log(np.asarray(LV_TRUTH)) + 0.3 * rng.standard_normal(
        (n, 4))).astype(np.float32)


@pytest.mark.parametrize("n_steps,n_obs", [(300, 10), (60, 6)])
def test_lv_integrate_matches_jax_under_its_noise(n_steps, n_obs):
    key = jax.random.PRNGKey(n_steps)
    theta = _lv_thetas(64, n_steps)
    ref = JaxLV(n_steps=n_steps, n_obs=n_obs).sample(key, jnp.asarray(theta))
    # the JAX model's own draw: normal(key, [n_steps, N, 2])
    noises = np.array(jax.random.normal(key, (n_steps, 64, 2)))
    got = LotkaVolterraSDE(n_steps=n_steps, n_obs=n_obs).integrate(
        torch.as_tensor(theta), torch.as_tensor(noises))
    for k in ("prey", "predator"):
        r = np.asarray(ref[k])
        assert got[k].shape == r.shape == (64, n_obs)
        np.testing.assert_allclose(got[k].numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())


def _rounded(lam):
    # a deterministic stand-in for a Poisson draw with its mean's scale
    return jnp.floor(1.3 * lam + 0.4)


def test_sir_update_matches_jax_given_the_same_counts(monkeypatch):
    rng = np.random.default_rng(1)
    theta = (np.log(np.asarray(SIR_TRUTH))
             + 0.4 * rng.standard_normal((50, 2))).astype(np.float32)
    monkeypatch.setattr(jax.random, "poisson",
                        lambda key, lam, shape=None, dtype=None:
                        _rounded(lam))
    ref = JaxSIR(n_steps=150).sample(jax.random.PRNGKey(0),
                                     jnp.asarray(theta))
    got = SIRTauLeap(n_steps=150).integrate(
        torch.as_tensor(theta), lambda lam: torch.floor(1.3 * lam + 0.4))
    for k in ("infected", "peak", "peak_time"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6)


def test_sir_step_clamps_in_order():
    s, i = torch.tensor([5.0, 100.0]), torch.tensor([3.0, 2.0])
    s2, i2 = sir_step(s, i, torch.tensor([9.0, 4.0]),
                      torch.tensor([20.0, 1.0]))
    # n_inf <= s first, then n_rec <= i + n_inf
    assert s2.tolist() == [0.0, 96.0] and i2.tolist() == [0.0, 5.0]


def test_sir_draws_match_jax_in_distribution():
    n = 4096
    theta = np.log(np.tile(np.asarray(SIR_TRUTH, np.float32), (n, 1)))
    ref = JaxSIR().simulate(jax.random.PRNGKey(5), jnp.asarray(theta))
    got = SIRTauLeap().simulate(_gen(5), torch.as_tensor(theta))
    for k, col in (("peak", None), ("infected", -1)):
        a = got[k].numpy() if col is None else got[k][:, col].numpy()
        b = np.asarray(ref[k]) if col is None else np.asarray(ref[k])[:, col]
        assert ss.ks_2samp(a, b).pvalue > 1e-3, k


@pytest.mark.parametrize("model", ["lv", "sir"])
@pytest.mark.parametrize("n_steps,n_obs", [(300, 10), (150, 10), (60, 10),
                                           (40, 10), (50, 5), (7, 6),
                                           (1000, 17)])
def test_obs_idx_equals_jax(model, n_steps, n_obs):
    ours, theirs = ((LotkaVolterraSDE, JaxLV) if model == "lv"
                    else (SIRTauLeap, JaxSIR))
    np.testing.assert_array_equal(
        ours(n_steps=n_steps, n_obs=n_obs).obs_idx,
        np.asarray(theirs(n_steps=n_steps, n_obs=n_obs).obs_idx))


def test_lv_shapes_and_determinism():
    model = LotkaVolterraSDE(n_steps=50, n_obs=5)
    theta = torch.log(torch.tensor([[1.0, 0.4, 1.0, 0.4]] * 7))
    out = model.simulate(_gen(42), theta)
    assert out["prey"].shape == out["predator"].shape == (7, 5)
    assert bool((out["prey"] >= 0).all())
    out2 = model.simulate(_gen(42), theta)
    assert torch.equal(out["prey"], out2["prey"])


def test_sir_conservation_and_peak():
    model = SIRTauLeap(n_pop=500, i0=5, n_steps=60, n_obs=6)
    out = model.simulate(_gen(42), torch.log(torch.tensor([[0.8, 0.2]] * 4)))
    inf = out["infected"].numpy()
    assert inf.shape == (4, 6)
    assert (inf >= 0).all() and (inf <= 500).all()
    assert (out["peak"].numpy() >= inf.max(axis=1) - 1e-6).all()


def test_sir_peak_time_takes_the_first_step_of_a_plateau():
    """With every count zero the trajectory stays at i0: the peak is at
    step 0, as jnp.argmax picks the first maximum."""
    model = SIRTauLeap(n_steps=20)
    out = model.integrate(torch.zeros(3, 2), torch.zeros_like)
    assert out["peak"].tolist() == [10.0] * 3
    assert out["peak_time"].tolist() == [0.0] * 3


def test_sir_beta_drives_peak():
    model = SIRTauLeap()
    lo = model.simulate(_gen(1), torch.log(torch.tensor([[0.25, 0.2]] * 32)))
    hi = model.simulate(_gen(1), torch.log(torch.tensor([[2.0, 0.2]] * 32)))
    assert hi["peak"].mean() > 2 * lo["peak"].mean()


@pytest.mark.parametrize("cls", [LotkaVolterraSDE, SIRTauLeap])
def test_low_fidelity_keeps_the_stat_layout(cls):
    model = cls()
    lofi = model.low_fidelity()
    assert lofi.n_steps == model.n_steps // 4 and lofi.n_obs == model.n_obs
    d = 4 if cls is LotkaVolterraSDE else 2
    theta = torch.log(torch.tensor(
        [LV_TRUTH if d == 4 else SIR_TRUTH] * 3))
    full, low = model.simulate(_gen(0), theta), lofi.simulate(_gen(0), theta)
    assert {k: v.shape for k, v in full.items()} == \
        {k: v.shape for k, v in low.items()}


def test_problem_factories():
    for make, d, s in ((make_lotka_volterra_problem, 4, 20),
                       (make_sir_problem, 2, 12)):
        models, priors, distance, observed = make()
        assert len(models) == len(priors) == 1 and priors[0].dim == d
        assert isinstance(distance, AdaptivePNormDistance)
        assert sum(np.size(v) for v in observed.values()) == s
        for v in observed.values():
            assert np.all(np.isfinite(v))
        # seeded: the same observed data every time
        again = make()[3]
        for k in observed:
            np.testing.assert_array_equal(observed[k], again[k])
