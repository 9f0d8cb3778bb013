"""The port's weighted statistics and residual choice against the JAX
package's, on one seeded numpy input.

Moments, ESS and the exact quantile agree to float32 rounding (rtol
1e-5) on tensors and exactly on host arrays (both packages run the same
numpy there); the deterministic residual resampler gives the same
indices; above a (patched, small) ``POP_MATERIALIZE_CAP`` both packages'
sort-free quantiles agree to the sketch's bracket and lie where the
weighted CDF crosses alpha.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyabc_tpu.weighted_statistics as jws
import pyabc_tpu_torch.weighted_statistics as pws
from pyabc_tpu.ops.choice import residual_weighted_choice as jax_residual
from pyabc_tpu_torch.ops.choice import residual_weighted_choice
from pyabc_tpu_torch.ops.quantile_sketch import sketch_error_bound

RNG = np.random.default_rng(21)
X = RNG.normal(1.0, 2.0, 3000).astype(np.float32)
W = RNG.exponential(1.0, 3000).astype(np.float32)


@pytest.mark.parametrize("fn", ["weighted_mean", "weighted_std",
                                "weighted_var"])
def test_moments(fn):
    want = float(getattr(jws, fn)(jnp.asarray(X), jnp.asarray(W)))
    got = float(getattr(pws, fn)(torch.as_tensor(X), torch.as_tensor(W)))
    assert got == pytest.approx(want, rel=1e-5)
    host = getattr(pws, fn)(X.astype(np.float64), W.astype(np.float64))
    assert float(host) == float(getattr(jws, fn)(X.astype(np.float64),
                                                 W.astype(np.float64)))


def test_mse_and_ess():
    want = float(jws.weighted_mse(jnp.asarray(X), jnp.asarray(W), 0.7))
    got = float(pws.weighted_mse(torch.as_tensor(X), torch.as_tensor(W),
                                 0.7))
    assert got == pytest.approx(want, rel=1e-5)
    assert float(pws.effective_sample_size(torch.as_tensor(W))) == \
        pytest.approx(float(jws.effective_sample_size(jnp.asarray(W))),
                      rel=1e-5)


@pytest.mark.parametrize("alpha", [0.1, 0.5, 0.9])
def test_exact_quantile(alpha):
    want = float(jws.weighted_quantile(jnp.asarray(X), jnp.asarray(W),
                                       alpha))
    got = float(pws.weighted_quantile(torch.as_tensor(X),
                                      torch.as_tensor(W), alpha))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-6)
    host = pws.weighted_quantile(X.astype(np.float64),
                                 W.astype(np.float64), alpha)
    assert host == jws.weighted_quantile(X.astype(np.float64),
                                         W.astype(np.float64), alpha)


@pytest.mark.parametrize("alpha", [0.25, 0.5])
def test_sketch_quantile_above_the_cap(monkeypatch, alpha):
    """With the cap patched to 1000 points, 3000 points route sort-free
    in both packages, on tensors and host arrays alike."""
    exact = float(jws.weighted_quantile(X.astype(np.float64),
                                        W.astype(np.float64), alpha))
    monkeypatch.setattr(pws, "POP_MATERIALIZE_CAP", 1000)
    monkeypatch.setattr(jws, "POP_MATERIALIZE_CAP", 1000)
    lo, hi = float(X.min()), float(X.max())
    bound = sketch_error_bound(lo, hi)
    dev = float(pws.weighted_quantile(torch.as_tensor(X),
                                      torch.as_tensor(W), alpha))
    jax_dev = float(jws.weighted_quantile(jnp.asarray(X), jnp.asarray(W),
                                          alpha))
    host = float(pws.weighted_quantile(X, W, alpha))
    jax_host = float(jws.weighted_quantile(X, W, alpha))
    assert host == jax_host
    # the sketch inverts the weighted CDF at alpha; the exact path
    # interpolates at midpoint weights: both lie between the points
    # where the CDF crosses alpha ∓ the largest weight
    order = np.argsort(X)
    cum = np.cumsum(W[order].astype(np.float64)) / W.sum()
    step = float(W.max() / W.sum())
    q_lo = X[order][np.searchsorted(cum, alpha - step)]
    q_hi = X[order][np.searchsorted(cum, alpha + step)]
    for q in (exact, dev, jax_dev, host):
        assert q_lo - bound <= q <= q_hi + bound
    assert dev == pytest.approx(jax_dev, abs=bound)


@pytest.mark.parametrize("n", [17, 500, 3000])
def test_residual_indices(n):
    w = W / W.sum()
    want = np.asarray(jws.resample_indices_deterministic(jnp.asarray(w), n))
    got = pws.resample_indices_deterministic(torch.as_tensor(w), n).numpy()
    np.testing.assert_array_equal(got, want)


def test_residual_choice_from_log_weights():
    log_w = np.log(W).astype(np.float32)
    want = np.asarray(jax_residual(jnp.asarray(log_w), 1000))
    got = residual_weighted_choice(torch.as_tensor(log_w), 1000).numpy()
    np.testing.assert_array_equal(got, want)


def test_residual_sketch_ranking_above_the_cap():
    """Above the rank cap the top-k sketch ranks the residuals: the same
    total, each count within one of the sorted ranking's."""
    w = torch.as_tensor(W / W.sum())
    sorted_idx = pws.resample_indices_deterministic(w, 2000, rank_cap=None)
    sketch_idx = pws.resample_indices_deterministic(w, 2000, rank_cap=100)
    a = torch.bincount(sorted_idx, minlength=W.size)
    b = torch.bincount(sketch_idx, minlength=W.size)
    assert int(a.sum()) == int(b.sum()) == 2000
    assert int((a - b).abs().max()) <= 1


def test_resample_draws_from_the_weights():
    pts = torch.arange(4, dtype=torch.float32)
    w = torch.tensor([0.0, 0.5, 0.25, 0.25])
    out = pws.resample(torch.Generator().manual_seed(0), pts, w, 20000)
    freq = torch.bincount(out.long(), minlength=4).float() / 20000
    assert float(freq[0]) == 0.0
    np.testing.assert_allclose(freq[1:].numpy(), [0.5, 0.25, 0.25],
                               atol=0.02)
