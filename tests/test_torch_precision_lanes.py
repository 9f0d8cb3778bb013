"""The compute precision lanes (``$PYABC_TPU_PRECISION_LANES``) against
the JAX package's.

Both packages freeze the policy at first use; the fixture drops both
frozen policies before and after every test (and the environment is
restored), so no lane leaks into a later test of the same worker.

Tolerances:

- ``split_bf16``: bit-equal; ``bf16x3_matmul``: 1e-6 relative (only the
  float32 accumulation may round differently; measured: equal).
- The plain KDE's bf16 lane: 5e-5 absolute at [500 × 512, d = 2], where
  the lane itself moves the log-density by 6.8e-4 (measured max |Δ| of
  the two packages 1.5e-5 over 8 seeds).  Those inputs lie on a dyadic
  grid with uniform weights over a power-of-two support and a diagonal
  power-of-two bandwidth, so both packages whiten to the same bits: the
  bf16 split turns a last-bit difference in a whitened coordinate into a
  difference as large as the lane's own error, which is what two
  packages whose triangular solves round differently show on generic
  inputs (there each lane is held to the float64 value instead).
- The distance lane: the bf16-rounded residual bit-equal; the distance
  bit-equal for p = 1, 2 and inf on one statistic (config #2's), and on
  six for p = inf; for p = 1 and 2 on six statistics the float32 sum and
  root follow each library's reduction order and ``pow`` (as on the
  float32 lane): 4 float32 ulps (measured: 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.ops import kde as jax_kde
from pyabc_tpu.ops import precision as jax_precision
from pyabc_tpu_torch.ops import kde
from pyabc_tpu_torch.ops import precision


@pytest.fixture(autouse=True)
def frozen_policies(monkeypatch):
    monkeypatch.delenv(precision.PRECISION_ENV, raising=False)
    precision._reset_for_testing()
    jax_precision._reset_for_testing()
    yield monkeypatch
    monkeypatch.delenv(precision.PRECISION_ENV, raising=False)
    precision._reset_for_testing()
    jax_precision._reset_for_testing()


def _set_lanes(monkeypatch, value):
    monkeypatch.setenv(precision.PRECISION_ENV, value)
    precision._reset_for_testing()
    jax_precision._reset_for_testing()


def _policy(mod):
    try:
        return {c: mod.lanes(c) for c in mod.COMPONENTS}
    except ValueError as err:
        return str(err)


@pytest.mark.parametrize("value", [
    "f32", "bf16", " BF16 ", "kde=bf16", "distance=bf16",
    "kde=bf16,distance=f32", "KDE=BF16, distance = bf16", "kde=bf16,",
    ",,", "", "kde", "kde=fp16", "foo=bf16", "kde=bf16,distance",
    "f16", "kde:bf16",
])
def test_parser_matches_the_jax_package(frozen_policies, value):
    _set_lanes(frozen_policies, value)
    assert precision.PRECISION_ENV == jax_precision.PRECISION_ENV
    assert precision.COMPONENTS == jax_precision.COMPONENTS
    assert _policy(precision) == _policy(jax_precision)


def test_policy_is_frozen_and_unknown_components_raise(frozen_policies):
    _set_lanes(frozen_policies, "distance=bf16")
    assert precision.lanes("distance") == "bf16"
    frozen_policies.setenv(precision.PRECISION_ENV, "f32")
    assert precision.lanes("distance") == "bf16"  # frozen at first use
    precision._reset_for_testing()
    assert precision.lanes("distance") == "f32"
    with pytest.raises(ValueError) as port_err:
        precision.lanes("stats")
    with pytest.raises(ValueError) as jax_err:
        jax_precision.lanes("stats")
    assert str(port_err.value) == str(jax_err.value)


def test_split_bf16_is_bit_equal_and_bf16x3_matmul_close():
    rng = np.random.default_rng(0)
    a = (rng.normal(size=(300, 5)) * 10.0 ** rng.integers(-3, 4, (300, 5))
         ).astype(np.float32)
    b = rng.normal(size=(5, 200)).astype(np.float32) * 7.0
    hi, lo = precision.split_bf16(torch.from_numpy(a))
    jhi, jlo = jax_precision.split_bf16(jnp.asarray(a))
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(hi.view(torch.int16).numpy(),
                                  np.asarray(jhi).view(np.int16))
    np.testing.assert_array_equal(lo.view(torch.int16).numpy(),
                                  np.asarray(jlo).view(np.int16))
    got = precision.bf16x3_matmul(torch.from_numpy(a), torch.from_numpy(b))
    ref = np.asarray(jax_precision.bf16x3_matmul(jnp.asarray(a),
                                                 jnp.asarray(b)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    assert (np.abs(got.numpy() - exact) <= 2.0 ** -15 * scale).all()


def _dyadic_kde_inputs(seed):
    """Inputs both packages whiten to the same bits (module docstring)."""
    rng = np.random.default_rng(seed)
    m, n, d = 500, 512, 2

    def grid(k):
        return (np.round(rng.normal(size=(k, d)) * 64) / 64
                * np.array([1.0, 0.5])).astype(np.float32)

    sup, x = grid(n), grid(m)
    log_w = np.full(n, -np.log(n), np.float32)
    chol = np.diag([0.25, 0.125]).astype(np.float32)
    log_norm = np.float32(-d / 2 * np.log(2 * np.pi)
                          - np.log(np.diag(chol)).sum())
    return x, sup, log_w, chol, log_norm


KDE_TOL = 5e-5


def test_plain_kde_bf16_lane_matches_the_jax_lane():
    x, sup, log_w, chol, log_norm = _dyadic_kde_inputs(0)
    jargs = [jnp.asarray(a) for a in (x, sup, log_w, chol, log_norm)]
    targs = [torch.from_numpy(a) for a in (x, sup, log_w, chol)]
    ref_bf16 = np.asarray(jax_kde.weighted_kde_logpdf(*jargs, lanes="bf16"))
    ref_f32 = np.asarray(jax_kde.weighted_kde_logpdf(*jargs, lanes="f32"))
    got = kde.weighted_kde_logpdf(*targs, float(log_norm), lanes="bf16")
    effect = np.abs(ref_bf16 - ref_f32).max()
    assert KDE_TOL < effect / 2
    np.testing.assert_allclose(got.numpy(), ref_bf16, rtol=0, atol=KDE_TOL)
    # small blocks stream the same logsumexp
    blocked = kde.weighted_kde_logpdf(*targs, float(log_norm), lanes="bf16",
                                      query_block=64, support_block=100)
    np.testing.assert_allclose(blocked.numpy(), ref_bf16, rtol=0,
                               atol=KDE_TOL)
    with pytest.raises(ValueError):
        kde.weighted_kde_logpdf(*targs, float(log_norm), lanes="fp16")


def test_kde_bf16_lane_error_on_generic_inputs():
    """Each package's lane against the float64 density: the port's error
    is the JAX package's in size."""
    rng = np.random.default_rng(1)
    m, n, d = 500, 700, 2
    cov = np.array([[1.0, 0.3], [0.3, 0.5]])
    sup = rng.multivariate_normal([1.0, -0.5], cov, n).astype(np.float32)
    x = rng.multivariate_normal([1.0, -0.5], cov, m).astype(np.float32)
    log_w = np.log(rng.uniform(0.1, 1.0, n)).astype(np.float32)
    chol = (np.linalg.cholesky(cov) * n ** (-1 / (d + 4))).astype(np.float32)
    log_norm = np.float32(-d / 2 * np.log(2 * np.pi)
                          - np.log(np.diag(chol)).sum())
    got = kde.weighted_kde_logpdf(
        *[torch.from_numpy(a) for a in (x, sup, log_w, chol)],
        float(log_norm), lanes="bf16").numpy()
    ref = np.asarray(jax_kde.weighted_kde_logpdf(
        *[jnp.asarray(a) for a in (x, sup, log_w, chol, log_norm)],
        lanes="bf16"))
    exact = kde.weighted_kde_logpdf(
        *[torch.from_numpy(a).double() for a in (x, sup, log_w, chol)],
        float(log_norm)).numpy()
    err_port, err_jax = np.abs(got - exact).max(), np.abs(ref - exact).max()
    assert 0 < err_port <= 2 * err_jax
    assert err_jax <= 2 * err_port


def test_auto_kde_follows_the_frozen_lane_on_the_cpu(frozen_policies):
    x, sup, log_w, chol, log_norm = _dyadic_kde_inputs(2)
    targs = [torch.from_numpy(a) for a in (x, sup, log_w, chol)]
    f32 = kde.weighted_kde_logpdf_auto(*targs, float(log_norm))
    np.testing.assert_array_equal(
        f32.numpy(), kde.weighted_kde_logpdf(*targs, float(log_norm)).numpy())
    _set_lanes(frozen_policies, "kde=bf16")
    bf16 = kde.weighted_kde_logpdf_auto(*targs, float(log_norm))
    np.testing.assert_array_equal(
        bf16.numpy(), kde.weighted_kde_logpdf(*targs, float(log_norm),
                                              lanes="bf16").numpy())
    assert np.abs(bf16.numpy() - f32.numpy()).max() > 0


def _distance_inputs(columns):
    rng = np.random.default_rng(3)
    stats = (rng.normal(size=(400, columns))
             * 10.0 ** rng.integers(-2, 3, columns)).astype(np.float32)
    obs = rng.normal(size=columns).astype(np.float32)
    w = rng.uniform(0.1, 3.0, columns).astype(np.float32)
    return stats, obs, w


def _both_distances(cls, p, stats, obs, w):
    got = getattr(pt, cls)(p=p).compute(
        torch.from_numpy(stats), torch.from_numpy(obs),
        {"w": torch.from_numpy(w)})
    ref = np.asarray(getattr(jpt, cls)(p=p).compute(
        jnp.asarray(stats), jnp.asarray(obs), {"w": jnp.asarray(w)}))
    assert got.dtype == torch.float32
    return got.numpy(), ref


@pytest.mark.parametrize("cls", ["PNormDistance", "AdaptivePNormDistance"])
@pytest.mark.parametrize("p", [1.0, 2.0, np.inf])
@pytest.mark.parametrize("lane", ["bf16", "distance=bf16"])
def test_distance_lane_is_bit_equal(frozen_policies, cls, p, lane):
    """One statistic (config #2's distance): bit-equal.  Six: the rounded
    residuals are bit-equal, so the max-norm is; the float32 sum and the
    root follow each library's reduction order and ``pow``, as on the
    float32 lane, and agree to 4 float32 ulps."""
    _set_lanes(frozen_policies, lane)
    got, ref = _both_distances(cls, p, *_distance_inputs(1))
    np.testing.assert_array_equal(got, ref)
    stats, obs, w = _distance_inputs(6)
    got, ref = _both_distances(cls, p, stats, obs, w)
    if np.isinf(p):
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=4 * 2.0 ** -24, atol=0)
    exact = (np.abs(w * (stats - obs)).max(-1) if np.isinf(p) else
             np.sum(np.abs(w * (stats - obs)) ** p, -1) ** (1 / p))
    rel = np.abs(got - exact) / exact
    # the lane is on: the residual's bf16 rounding shows
    assert 1e-5 < rel.max() <= 2.0 ** -8


@pytest.mark.parametrize("p", [1.0, 2.0, np.inf])
def test_f32_distance_lane_is_unchanged(p):
    stats, obs, w = _distance_inputs(6)
    got, ref = _both_distances("PNormDistance", p, stats, obs, w)
    np.testing.assert_allclose(got, ref, rtol=4 * 2.0 ** -24, atol=0)
    diff = torch.abs(torch.from_numpy(w) * (torch.from_numpy(stats)
                                           - torch.from_numpy(obs)))
    plain = (diff.max(-1).values if np.isinf(p)
             else diff.pow(p).sum(-1).pow(1.0 / p))
    np.testing.assert_array_equal(got, plain.numpy())


def test_config2_run_on_the_bf16_lanes_passes_the_gate(frozen_policies):
    """A sequential config-#2 run under ``bf16`` held to ``run_gate``'s
    tolerances at its population; its accepted distances are bf16 values
    (a one-component 2-norm is the rounded residual itself)."""
    _set_lanes(frozen_policies, "bf16")
    pop, gens = 4000, 6
    from pyabc_tpu_torch.models import make_two_gaussians_problem
    models, priors, distance, observed, posterior_fn = \
        make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=pop,
                    eps=pt.MedianEpsilon(),
                    sampler=pt.VectorizedSampler(device="cpu"),
                    stores_sum_stats=False, seed=0, device="cpu")
    abc.new("sqlite://", observed)
    abc.run(max_nr_populations=gens)
    h = abc.history
    t = h.max_t
    assert t + 1 == gens
    p_b = float(h.get_model_probabilities(t).get(1, 0.0))
    df, w = h.get_distribution(m=1, t=t)
    mu = float(np.sum(df["mu"].to_numpy() * w))
    assert abs(p_b - posterior_fn(1.0)) < max(2.5e-3, 2.5 / pop ** 0.5)
    assert abs(mu - 1.0) < max(3e-3, 3.0 / pop ** 0.5)
    d = np.asarray(h.get_population(t).distance, np.float32)
    as_bf16 = torch.from_numpy(d).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(d, as_bf16)
