"""Candidate rounds and the device loop of the PyTorch port.

Deterministic pieces are held to the JAX package on identical numpy
inputs: the proposal density of the two-model problem (atol 1e-4, the
KDE's float32 summation-order tolerance), the prior log-density, the
p-norm distance and the uniform acceptor.  The device loop's compaction
order and the deferred weight correction are checked on hand-made
rounds.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem
from pyabc_tpu.sampler.rounds import RoundKernel as JaxRoundKernel
from pyabc_tpu.sumstat import SumStatSpec as JaxSpec
from pyabc_tpu.transition import MultivariateNormalTransition as JaxMVN
from pyabc_tpu_torch.convert import to_numpy, to_torch
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.sampler.base import RoundResult
from pyabc_tpu_torch.sampler.device_loop import build_stateful_loop
from pyabc_tpu_torch.sampler.rounds import RoundKernel
from pyabc_tpu_torch.sumstat import SumStatSpec


def _kernels():
    """The two-model problem as a RoundKernel in each package."""
    obs = {"y": np.float32(1.0)}
    j_models, j_priors, j_dist, _, _ = jax_problem()
    j_spec = JaxSpec.from_example({"y": jnp.float32(1.0)})
    j_dist.bind(j_spec, obs)
    j_kernel = JaxRoundKernel(
        j_models, j_priors, np.zeros(2, np.float32),
        jpt.ModelPerturbationKernel(2, 0.7), [JaxMVN(), JaxMVN()], j_dist,
        jpt.UniformAcceptor(), j_spec, j_spec.flatten_single(obs), dim=1)
    models, priors, dist, _, _ = make_two_gaussians_problem()
    spec = SumStatSpec.from_example(obs)
    dist.bind(spec, obs)
    kernel = RoundKernel(
        models, priors, np.zeros(2, np.float32),
        pt.ModelPerturbationKernel(2, 0.7),
        [pt.MultivariateNormalTransition(),
         pt.MultivariateNormalTransition()], dist, pt.UniformAcceptor(),
        spec, spec.flatten_single(obs), dim=1)
    return j_kernel, kernel


def _round_params(n, seed):
    """Padded per-model KDE params fitted (by the JAX transition) from a
    numpy population, as the orchestrator builds them."""
    rng = np.random.default_rng(seed)
    m = (rng.uniform(size=n) < 0.8).astype(np.int32)
    theta = np.where(m[:, None] == 1,
                     1.0 + 0.2 * rng.standard_normal((n, 1)),
                     0.4 + 0.1 * rng.standard_normal((n, 1))
                     ).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    trans = []
    for j in range(2):
        idx = np.nonzero(m == j)[0]
        tr = JaxMVN().fit(theta[idx], w[idx])
        bucket = 1 << int(np.ceil(np.log2(idx.size)))
        trans.append(tr.pad_params(tr.get_params(), bucket))
    probs = np.bincount(m, weights=w, minlength=2)
    probs = probs / probs.sum()
    params = {"model_log_probs": np.log(probs).astype(np.float32),
              "transition": tuple(trans)}
    q_m = (rng.uniform(size=700) < 0.7).astype(np.int32)
    q_theta = (0.8 + 0.35 * rng.standard_normal((700, 1))).astype(np.float32)
    return params, q_m, q_theta


@pytest.mark.parametrize("n", [3000, 90000])
def test_proposal_log_density_matches_jax(n):
    """Both packages' proposal density on converted params; n = 90000
    takes the grid-compressed support for both models."""
    j_kernel, kernel = _kernels()
    params, q_m, q_theta = _round_params(n, seed=n)
    for p in params["transition"]:
        assert ("c_support" in p) == (n > 30000)
    ref = np.asarray(j_kernel.proposal_log_density(
        jnp.asarray(q_m), jnp.asarray(q_theta), params))
    got = kernel.proposal_log_density(
        torch.as_tensor(q_m.astype(np.int64)), torch.as_tensor(q_theta),
        to_torch(params, "cpu"))
    np.testing.assert_allclose(to_numpy(got), ref, atol=1e-4, rtol=1e-5)


def test_log_prior_matches_jax():
    j_kernel, kernel = _kernels()
    rng = np.random.default_rng(0)
    m = rng.integers(0, 2, 500).astype(np.int32)
    theta = rng.uniform(-1.0, 2.0, (500, 1)).astype(np.float32)
    theta[:4, 0] = [-0.5, 0.5, 1.5, 0.49999]   # the prior boundaries
    ref = np.asarray(j_kernel._log_prior(jnp.asarray(m), jnp.asarray(theta)))
    got = kernel._log_prior(torch.as_tensor(m.astype(np.int64)),
                            torch.as_tensor(theta)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_normal_prior_matches_jax():
    rng = np.random.default_rng(1)
    theta = rng.normal(0.0, 2.0, (400, 2)).astype(np.float32)
    ref = jpt.Distribution(a=jpt.RV("norm", 0.3, 1.5),
                           b=jpt.RV("uniform", -1.0, 2.0))
    got = pt.Distribution(a=pt.RV("norm", 0.3, 1.5),
                          b=pt.RV("uniform", -1.0, 2.0))
    np.testing.assert_allclose(
        got.log_pdf_array(torch.as_tensor(theta)).numpy(),
        np.asarray(ref.log_pdf_array(jnp.asarray(theta))), atol=1e-5)


@pytest.mark.parametrize("p", [1.0, 2.0, math.inf])
def test_pnorm_distance_matches_jax(p):
    rng = np.random.default_rng(2)
    stats = rng.standard_normal((300, 4)).astype(np.float32)
    obs = rng.standard_normal(4).astype(np.float32)
    x0 = {"a": obs[:3], "b": obs[3]}
    weights = {"a": 2.0, "b": 0.5}
    j_dist = jpt.PNormDistance(p=p, weights=weights)
    j_dist.bind(JaxSpec.from_example({k: jnp.asarray(v)
                                      for k, v in x0.items()}), x0)
    dist = pt.PNormDistance(p=p, weights=weights)
    dist.bind(SumStatSpec.from_example(x0), x0)
    ref = np.asarray(j_dist.compute(jnp.asarray(stats), jnp.asarray(obs),
                                    j_dist.get_params(0)))
    got = dist.compute(torch.as_tensor(stats), torch.as_tensor(obs),
                       to_torch(dist.get_params(0), "cpu")).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_uniform_acceptor_matches_jax():
    rng = np.random.default_rng(3)
    d = rng.uniform(0.0, 1.0, 1000).astype(np.float32)
    eps = lambda t: 0.37  # noqa: E731
    j_acc, acc = jpt.UniformAcceptor(), pt.UniformAcceptor()
    j_ok, j_w = j_acc.accept(None, jnp.asarray(d), j_acc.get_params(0, eps))
    ok, w = acc.accept(None, torch.as_tensor(d),
                       to_torch(acc.get_params(0, eps), "cpu"))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    np.testing.assert_array_equal(w.numpy(), np.asarray(j_w))


def _fixed_rounds(masks, log_weights=None):
    """A raw round that replays hand-made rounds: lane i of round r has
    m = r, theta = 100 r + i."""
    calls = {"r": 0}

    def raw_round(generator, params):
        r = calls["r"]
        calls["r"] += 1
        acc = torch.as_tensor(masks[r])
        b = acc.shape[0]
        lane = torch.arange(b, dtype=torch.float32)
        lw = (torch.zeros(b) if log_weights is None
              else torch.as_tensor(log_weights[r]))
        return RoundResult(
            m=torch.full((b,), r, dtype=torch.int64),
            theta=(100.0 * r + lane)[:, None], distance=lane,
            accepted=acc, log_weight=torch.where(acc, lw, -math.inf),
            stats=lane[:, None])

    return raw_round


def test_compaction_keeps_round_lane_order_and_truncates():
    masks = [[0, 1, 1, 0, 1, 0], [1, 0, 0, 0, 0, 1], [1, 1, 1, 1, 1, 1]]
    masks = [np.asarray(m, bool) for m in masks]
    start, step, finalize, reset = build_stateful_loop(
        _fixed_rounds(masks), B=6, n_target=7, max_rounds=10)
    state = step(None, {}, start())
    assert state["rounds"] == 3            # stops once count >= n_target
    assert int(state["count"]) == 11       # all acceptances, capped at 13
    view = finalize(state, {})
    np.testing.assert_array_equal(
        view["theta"][:, 0].numpy(), [1, 2, 4, 100, 105, 200, 201])
    np.testing.assert_array_equal(view["m"].numpy(), [0, 0, 0, 1, 1, 2, 2])


def test_compaction_stops_at_n_target_and_rewinds():
    masks = [np.ones(8, bool)] * 3
    start, step, finalize, reset = build_stateful_loop(
        _fixed_rounds(masks), B=8, n_target=5, max_rounds=3)
    state = step(None, {}, start())
    assert state["rounds"] == 1 and int(state["count"]) == 8
    np.testing.assert_array_equal(finalize(state, {})["theta"][:, 0].numpy(),
                                  [0, 1, 2, 3, 4])
    state = reset(state)
    assert int(state["count"]) == 0 and state["rounds"] == 0


def test_finalize_subtracts_the_deferred_density():
    """``lw - log_denom`` where the partial weight is finite; -inf rows
    (and a -inf density) never turn into NaN."""
    masks = [np.array([1, 1, 1, 1], bool)]
    lws = [np.array([0.5, -1.0, -math.inf, 2.0], np.float32)]
    denom = torch.tensor([0.25, 3.0, -math.inf, -math.inf])
    start, step, finalize, _ = build_stateful_loop(
        _fixed_rounds(masks, lws), B=4, n_target=4, max_rounds=1,
        weight_correction=lambda m, theta, params: denom)
    view = finalize(step(None, {}, start()), {})
    np.testing.assert_array_equal(view["log_weight"].numpy(),
                                  [0.25, -4.0, -math.inf, math.inf])
