"""The fused engine's deterministic parts in both packages on the CPU.

Each test gives the JAX function (``pyabc_tpu/sampler/fused.py``,
``ops/choice.py``, ``ops/quantile_sketch.py``, ``smc.py``) and its port
the same numpy inputs from a seed:

- ``systematic_weighted_choice`` with the JAX key's uniform injected as
  ``u0``: identical indices;
- the quantile sketch within ``sketch_error_bound`` of each other, and
  the top-k masks identical (distinct values and exact ties);
- ``_compress_support_device`` (a live, a dead and an unresolved grid):
  centroids rtol 1e-5, log masses atol 1e-5, the same ``resolved``;
- ``_refit_model``, exact (with and without the grid) and capped with
  the uniform injected: equal supports, chol and log norm rtol 1e-5;
- ``_weighted_quantile_device``: rtol 1e-5 (both packages round the
  cumulative weights to float32, XLA's scan in another association; on
  these inputs either is within 4e-6 of the float64 quantile), and the
  sketch form within ``sketch_error_bound``;
- ``_block_max_rounds``, ``_final_mask``, the EWMA rate/safety update and
  the round cap: exact;
- one whole generation of each package's per-generation body, in each ε
  mode and with the adaptive and the stochastic chains, both driven by a
  fixed-batch round that ignores its key, returns one numpy candidate
  batch every round and accepts about 37 % of it (so the compaction runs
  over several partial rounds and is cut to n_target): carry, ε/T,
  distance weights, ring, count and rounds agree; log weights at the KDE
  tolerance of ``tests/test_ops_kde_pallas.py`` (atol 5e-3, rtol 1e-4).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem
from pyabc_tpu.ops import choice as jchoice
from pyabc_tpu.ops import quantile_sketch as jsketch
from pyabc_tpu.sampler import fused as jfused
from pyabc_tpu.sampler.base import RoundResult as JaxRound
from pyabc_tpu.transition.multivariatenormal import \
    silverman_rule_of_thumb as j_silverman
from pyabc_tpu_torch.convert import (carry_to_numpy, carry_to_torch,
                                     install_block_state)
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.ops import choice as pchoice
from pyabc_tpu_torch.ops import quantile_sketch as psketch
from pyabc_tpu_torch.sampler import fused as pfused
from pyabc_tpu_torch.sampler.base import RoundResult as PortRound
from pyabc_tpu_torch.transition.multivariatenormal import \
    silverman_rule_of_thumb as p_silverman

KDE_ATOL, KDE_RTOL = 5e-3, 1e-4


@pytest.fixture(scope="module", autouse=True)
def warm_cpu_log():
    """One ``torch.log`` over a large tensor before any comparison: in a
    process that has run JAX, the first MKL-backed ``torch.log`` on the
    CPU has returned values off by ~4e-5 in some threads' chunks (seen
    in about one process in three); every later call is accurate."""
    torch.log(torch.rand(1 << 16) + 0.5)


def _t(a):
    return torch.tensor(np.array(a))


def _close(a, b, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


# ---- choice and the quantile sketch ---------------------------------------


@pytest.mark.parametrize("n_rows,live,n,seed", [
    (100, 64, 1000, 0), (4096, 1024, 1024, 1), (5000, 2048, 16384, 2),
    (100, 0, 1000, 3), (4096, 0, 1024, 4), (5000, 0, 16384, 5)])
def test_systematic_choice_identical_indices(n_rows, live, n, seed):
    """With ``live`` rows of equal weight (a power of two, the rest at
    zero weight) every CDF value is exact, and the indices are identical
    draw for draw.  With gamma weights (``live`` 0) the two libraries'
    float32 ``softmax``/``cumsum`` round differently (XLA associates the
    scan another way), so a draw within float32 rounding of a CDF step
    may land on either side: the indices are identical at every draw
    farther than 1e-6 of the total mass from a step."""
    rng = np.random.default_rng(seed)
    if live:
        log_w = np.full(n_rows, -np.inf, np.float32)
        log_w[rng.choice(n_rows, live, replace=False)] = 0.0
    else:
        log_w = np.log(rng.gamma(1.0, size=n_rows)).astype(np.float32)
        log_w[rng.uniform(size=n_rows) < 0.2] = -np.inf
    key = jax.random.PRNGKey(seed)
    j_idx = np.asarray(jchoice.systematic_weighted_choice(
        key, jnp.asarray(log_w), n))
    u0 = np.asarray(jax.random.uniform(key, (), dtype=jnp.float32))
    p_idx = pchoice.systematic_weighted_choice(None, _t(log_w), n,
                                               u0=_t(u0)).numpy()
    assert np.all(np.isfinite(log_w[p_idx]))   # never a zero-weight row
    if live:
        np.testing.assert_array_equal(p_idx, j_idx)
        return
    cdf = np.cumsum(np.exp(log_w.astype(np.float64) - log_w.max()))
    cdf /= cdf[-1]
    u = (float(u0) + np.arange(n)) / n
    near = np.abs(u[:, None] - cdf[None, :]).min(1) <= 1e-6
    np.testing.assert_array_equal(p_idx[~near], j_idx[~near])
    assert near.sum() <= n // 100


@pytest.mark.parametrize("alpha", [0.05, 0.5, 0.9])
def test_sketch_quantile_within_its_bound(alpha):
    rng = np.random.default_rng(3)
    x = rng.lognormal(size=20000).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=20000).astype(np.float32)
    valid = rng.uniform(size=20000) < 0.8
    x[~valid & (rng.uniform(size=20000) < 0.5)] = np.inf   # masked sentinels
    j = float(jsketch.sketch_weighted_quantile(
        jnp.asarray(x), jnp.asarray(w), alpha, valid=jnp.asarray(valid)))
    p = float(psketch.sketch_weighted_quantile(_t(x), _t(w), alpha,
                                               valid=_t(valid)))
    ok = valid & np.isfinite(x)
    bound = psketch.sketch_error_bound(x[ok].min(), x[ok].max())
    assert abs(p - j) <= bound
    none = psketch.sketch_weighted_quantile(_t(x), _t(w), alpha,
                                            valid=torch.zeros(20000,
                                                              dtype=bool))
    assert math.isnan(float(none))


@pytest.mark.parametrize("ties", [False, True])
def test_sketch_topk_masks_identical(ties):
    rng = np.random.default_rng(4)
    x = rng.normal(size=5000).astype(np.float32)
    if ties:
        x = np.round(x, 1)                  # many exact ties
    valid = rng.uniform(size=5000) < 0.9
    for k in (0, 1, 137, 2500, 6000):
        j = np.asarray(jsketch.sketch_topk_mask(jnp.asarray(x), k,
                                                valid=jnp.asarray(valid)))
        p = psketch.sketch_topk_mask(_t(x), k, valid=_t(valid)).numpy()
        np.testing.assert_array_equal(p, j)
        assert p.sum() == min(k, valid.sum())


# ---- the grid, the refit, the quantile -----------------------------------


def _grid_inputs(case):
    rng = np.random.default_rng(5)
    n = 1 << 14
    x = (0.6 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    w = rng.uniform(size=n).astype(np.float32)
    w /= w.sum()
    ok = rng.uniform(size=n) < 0.9
    chol = np.array([[0.01]], np.float32)
    if case == "dead":
        ok[:] = False
    if case == "unresolved":
        x[0] = 1000.0                     # one outlier stretches the range
    return x[:, None], w, ok, chol


@pytest.mark.parametrize("case", ["live", "dead", "unresolved"])
def test_compress_support_device(case):
    sup, w, ok, chol = _grid_inputs(case)
    j_c, j_lw, j_res = jfused._compress_support_device(
        jnp.asarray(sup), jnp.asarray(w), jnp.asarray(ok), jnp.asarray(chol))
    p_c, p_lw, p_res = pfused._compress_support_device(
        _t(sup), _t(w), _t(ok), _t(chol))
    _close(p_c, j_c, rtol=1e-5)
    _close(p_lw, j_lw, atol=1e-5)
    assert bool(p_res) == bool(j_res) == (case != "unresolved")
    assert np.all(np.isfinite(p_c.numpy()))


def _population(n, seed, dim=2):
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((n, dim)).astype(np.float32)
    log_w = (0.5 * rng.standard_normal(n)).astype(np.float32)
    m = (rng.uniform(size=n) < 0.6).astype(np.int32)
    count = int(0.9 * n)
    return theta, log_w, m, count


@pytest.mark.parametrize("n,dim,cap", [(300, 2, None), (1 << 14, 1, None),
                                       (2000, 2, 256)])
def test_refit_model(n, dim, cap):
    theta, log_w, m, count = _population(n, seed=n + dim, dim=dim)
    valid = np.arange(n) < count
    key = jax.random.PRNGKey(7)
    for j in (0, 1):
        j_par, j_res = jfused._refit_model(
            jnp.asarray(theta), jnp.asarray(log_w), jnp.asarray(valid),
            jnp.asarray(m), j, dim, n, j_silverman, 1.0, support_cap=cap,
            key=key)
        u0 = _t(np.asarray(jax.random.uniform(key, (), jnp.float32)))
        p_par, p_res = pfused._refit_model(
            _t(theta), _t(log_w), _t(valid), _t(m).long(), j, dim, n,
            p_silverman, 1.0, support_cap=cap, u0=u0)
        np.testing.assert_array_equal(p_par["support"].numpy(),
                                      np.asarray(j_par["support"]))
        _close(p_par["chol"], j_par["chol"], rtol=1e-5)
        _close(p_par["log_norm"], j_par["log_norm"], rtol=1e-5)
        _close(p_par["log_w"], j_par["log_w"], rtol=1e-5, atol=1e-5)
        assert set(p_par) == set(j_par)
        assert bool(p_res) == bool(j_res)
        if "c_support" in p_par:
            _close(p_par["c_support"], j_par["c_support"], rtol=1e-5)
            _close(p_par["c_log_w"], j_par["c_log_w"], atol=1e-5)


@pytest.mark.parametrize("alpha,weighted", [(0.5, True), (0.3, False),
                                            (0.9, True)])
def test_weighted_quantile_device(alpha, weighted):
    rng = np.random.default_rng(8)
    x = rng.exponential(size=3000).astype(np.float32)
    x[:50] = x[50:100]                     # exact ties
    w = rng.uniform(size=3000).astype(np.float32)
    valid = np.arange(3000) < 2700
    qw = w if weighted else valid.astype(np.float32)
    j = jfused._weighted_quantile_device(jnp.asarray(x), jnp.asarray(qw),
                                         jnp.asarray(valid), alpha)
    p = pfused._weighted_quantile_device(_t(x), _t(qw), _t(valid), alpha)
    _close(p, j, rtol=1e-5)
    js = jfused._weighted_quantile_device(jnp.asarray(x), jnp.asarray(qw),
                                          jnp.asarray(valid), alpha,
                                          sketch=True)
    ps = pfused._weighted_quantile_device(_t(x), _t(qw), _t(valid), alpha,
                                          sketch=True)
    assert abs(float(ps) - float(js)) <= psketch.sketch_error_bound(
        x[valid].min(), x[valid].max())


# ---- round budget, final mask, EWMA: exact --------------------------------


@pytest.fixture(scope="module")
def twin_abcs():
    """A two-Gaussian ABCSMC of each package after new() (no run)."""
    models, priors, distance, observed, _ = jax_problem()
    j_abc = jpt.ABCSMC(models, priors, distance, population_size=300,
                       sampler=jpt.VectorizedSampler(), fuse_generations=3,
                       seed=0)
    j_abc.new("sqlite://", observed)
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    p_abc = pt.ABCSMC(models, priors, distance, population_size=300,
                      sampler=pt.VectorizedSampler(device="cpu"),
                      fuse_generations=3, seed=0)
    p_abc.new("sqlite://", observed)
    return j_abc, p_abc


def test_block_max_rounds_and_final_mask(twin_abcs):
    j_abc, p_abc = twin_abcs
    for min_rate in (0.0, 0.625, 0.9, 1e-6):
        j_abc.min_acceptance_rate = p_abc.min_acceptance_rate = min_rate
        for n, B in ((400, 4096), (100, 100), (1000, 100), (10 ** 6, 1 << 19)):
            for rate in (None, 0.5, 0.15, 1e-3, 1e-9):
                assert p_abc._block_max_rounds(n, B, rate_est=rate) == \
                    j_abc._block_max_rounds(n, B, rate_est=rate)
    for nr_pop in (np.inf, 6, 11):
        j_abc.max_nr_populations = p_abc.max_nr_populations = nr_pop
        for t in (1, 4, 5, 8):
            assert p_abc._final_mask(t, 4) == \
                [bool(v) for v in np.asarray(j_abc._final_mask(t, 4))]


@pytest.mark.parametrize("B", [256, 4096, 1 << 19])
def test_ewma_update_and_round_cap(B):
    """The EWMA update and the round cap against the JAX body's
    expressions (``fused.py:469-486``, ``:562-568``), bit for bit."""
    from pyabc_tpu.autotune.tuner import EWMA_ALPHA
    rng = np.random.default_rng(B)
    n_target = 3000
    for _ in range(200):
        rate0 = np.float32(rng.uniform(1e-5, 1.0))
        safety0 = np.float32(rng.uniform(1.0, 4.0))
        count1 = int(rng.integers(0, 2 * n_target))
        rounds1 = int(rng.integers(0, 64))
        factor = float(rng.choice([1.0, 0.5, 0.3]))
        max_rounds = int(rng.choice([1, 16, 64]))
        r0, s0, c1 = jnp.float32(rate0), jnp.float32(safety0), \
            jnp.int32(count1)
        obs = (c1.astype(jnp.float32)
               / jnp.maximum(rounds1 * B, 1).astype(jnp.float32))
        j_rate = jnp.maximum(r0 + EWMA_ALPHA * (obs - r0), 1e-6)
        j_safety = jnp.where(c1 < n_target, jnp.minimum(s0 * 1.25, 4.0), s0)
        pred = jnp.maximum(r0, 1e-6) * jnp.float32(factor)
        need = jnp.ceil(jnp.float32(n_target) / (pred * B) * s0) + 1.0
        j_cap = jnp.clip(need, min(2.0, float(max_rounds)),
                         float(max_rounds)).astype(jnp.int32)
        p_rate, p_safety = pfused.ewma_update(
            torch.tensor(rate0), torch.tensor(safety0),
            torch.tensor(count1), rounds1, B, n_target)
        p_cap = pfused.round_cap(torch.tensor(rate0), torch.tensor(safety0),
                                 n_target, B, max_rounds, factor)
        assert float(p_rate) == float(j_rate)
        assert float(p_safety) == float(j_safety)
        assert int(p_cap) == int(j_cap)


# ---- one whole generation -------------------------------------------------

N_TARGET, B, R = 300, 256, 64


def _batch(seed, stoch=False):
    """One fixed candidate batch: two models, ~37 % accepted."""
    rng = np.random.default_rng(seed)
    m = (rng.uniform(size=B) < 0.5).astype(np.int32)
    theta = np.where(m[:, None] == 0, -0.5, 0.5) + rng.uniform(size=(B, 1))
    stats = (theta + 0.5 * rng.standard_normal((B, 1))).astype(np.float32)
    if stoch:
        m[:] = 0
        dist = (-0.5 * ((stats[:, 0] - 0.5) / 0.1) ** 2).astype(np.float32)
    else:
        dist = np.abs(stats[:, 0] - 1.0).astype(np.float32)
    accepted = rng.uniform(size=B) < 0.37
    log_w = np.where(accepted, -0.1 * rng.standard_normal(B),
                     -np.inf).astype(np.float32)
    return {"m": m, "theta": theta.astype(np.float32), "distance": dist,
            "accepted": accepted, "log_weight": log_w, "stats": stats}


def _carry(seed, stoch=False):
    rng = np.random.default_rng(seed)
    m = np.zeros(N_TARGET, np.int32) if stoch else \
        (rng.uniform(size=N_TARGET) < 0.6).astype(np.int32)
    theta = (np.where(m[:, None] == 0, -0.5, 0.5)
             + rng.uniform(size=(N_TARGET, 1))).astype(np.float32)
    stats = (theta + 0.5 * rng.standard_normal((N_TARGET, 1))).astype(
        np.float32)
    return {"m": m, "theta": theta,
            "log_weight": (0.3 * rng.standard_normal(N_TARGET)).astype(
                np.float32),
            "distance": np.abs(stats[:, 0] - 1.0).astype(np.float32),
            "stats": stats, "count": np.int32(N_TARGET)}


def _ring(seed):
    """A record ring of R rows with generating densities under some
    proposal (any finite values serve the comparison)."""
    rng = np.random.default_rng(seed)
    theta = (0.3 + 0.3 * rng.standard_normal((R, 1))).astype(np.float32)
    stats = theta + 0.1 * rng.standard_normal((R, 1))
    return {"rec_m": np.zeros(R, np.int64), "rec_theta": theta,
            "rec_dist": (-0.5 * ((stats[:, 0] - 0.5) / 0.1) ** 2).astype(
                np.float32),
            "rec_loggen": (0.5 * rng.standard_normal(R)).astype(np.float32)}


def _jax_raw_round(batch):
    arrs = {k: jnp.asarray(v) for k, v in batch.items()}

    def raw(key, params):
        return JaxRound(arrs["m"], arrs["theta"], arrs["distance"],
                        arrs["accepted"], arrs["log_weight"], arrs["stats"])
    return raw


def _port_raw_round(batch):
    arrs = {k: _t(v) for k, v in batch.items()}
    arrs["m"] = arrs["m"].long()

    def raw(generator, params):
        return PortRound(arrs["m"], arrs["theta"], arrs["distance"],
                         arrs["accepted"], arrs["log_weight"], arrs["stats"])
    return raw


def _stoch_abcs():
    def j_model(key, theta):
        return {"y": theta[:, 0] + 0.2 * jax.random.normal(key,
                                                           theta.shape[:1])}

    def p_model(gen, theta):
        return {"y": theta[:, 0] + 0.2 * torch.randn(
            theta.shape[:1], generator=gen, device=theta.device)}

    out = []
    for pkg, model, kw in ((jpt, j_model, {}),
                           (pt, p_model, {"device": "cpu"})):
        abc = pkg.ABCSMC(
            pkg.SimpleModel(model),
            pkg.Distribution(mu=pkg.RV("uniform", -1.0, 2.0)),
            pkg.IndependentNormalKernel(var=0.1 ** 2), population_size=300,
            eps=pkg.Temperature(schemes=[pkg.AcceptanceRateScheme()]),
            acceptor=pkg.StochasticAcceptor(
                pdf_norm_method=pkg.pdf_norm_from_kernel),
            sampler=pkg.VectorizedSampler(**kw), fuse_generations=3, seed=9)
        abc.new("sqlite://", {"y": 0.5})
        out.append(abc)
    return out


def _model_abcs(adaptive):
    out = []
    for pkg, problem, kw in ((jpt, jax_problem, {}),
                             (pt, make_two_gaussians_problem,
                              {"device": "cpu"})):
        models, priors, distance, observed, _ = problem()
        if adaptive:
            distance = pkg.AdaptivePNormDistance(max_weight_ratio=50.0)
        abc = pkg.ABCSMC(models, priors, distance, population_size=300,
                         sampler=pkg.VectorizedSampler(**kw),
                         fuse_generations=3, seed=0)
        abc.new("sqlite://", observed)
        out.append(abc)
    return out


CASES = {  # name -> (eps mode, alpha, multiplier, weighted, adaptive, stoch)
    "constant": ("constant", 0.5, 1.0, True, False, False),
    "quantile": ("quantile", 0.5, 1.0, True, False, False),
    "quantile_unweighted_x0.8": ("quantile", 0.3, 0.8, False, False, False),
    "adaptive": ("quantile", 0.5, 1.0, True, True, False),
    "temperature": ("temperature", 0.5, 1.0, True, False, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_generation_matches_jax(case):
    eps_mode, alpha, mult, weighted, adaptive, stoch = CASES[case]
    j_abc, p_abc = _stoch_abcs() if stoch else _model_abcs(adaptive)
    batch = _batch(11, stoch)
    carry_np = _carry(12, stoch)
    dims = [p.dim for p in p_abc.parameter_priors]
    state = {"eps": 0.4 if not stoch else 50.0, "rate": 0.3,
             "safety": 1.2}
    if adaptive:
        state["dist_w"] = np.array([1.3], np.float32)
    if stoch:
        state["ring"] = _ring(13)
    carry_np = install_block_state(carry_np, **state)
    kw = dict(bandwidth_selectors=[p_silverman] * len(dims),
              scalings=[1.0] * len(dims), dims=dims, n_target=N_TARGET, B=B,
              max_rounds=16, d=1, s=1, eps_mode=eps_mode, eps_alpha=alpha,
              eps_multiplier=mult, eps_weighted=weighted,
              rate_pred_factor=alpha if eps_mode == "quantile" else 1.0)
    j_cfg, p_cfg = {}, {}
    if adaptive:
        jd, pd_ = j_abc.distance_function, p_abc.distance_function
        j_cfg["adaptive_cfg"] = {
            "scale_fn": jd.scale_function, "distance_fn": jd.compute,
            "obs_flat": j_abc._obs_flat, "max_weight_ratio": 50.0,
            "normalize_weights": True, "factors": None}
        p_cfg["adaptive_cfg"] = {
            "scale_fn": pd_.scale_function, "distance_fn": pd_.compute,
            "obs_flat": p_abc._obs_flat, "max_weight_ratio": 50.0,
            "normalize_weights": True, "factors": None}
    if stoch:
        pdf_norm = float(p_abc.distance_function.pdf_max)
        cfg = {"pdf_norm": pdf_norm, "target_rate": 0.3,
               "lin_scale": False, "record_rows": R}
        j_cfg["stoch_cfg"] = p_cfg["stoch_cfg"] = cfg
    j_dist = None if (adaptive or stoch) else \
        j_abc.distance_function.get_params(0)
    p_dist = None if (adaptive or stoch) else \
        carry_to_torch(p_abc.distance_function.get_params(0), "cpu")
    j_one = jfused._build_one_gen(
        j_abc._kernel, distance_params=j_dist, wire_stats=True,
        wire_m_bits=False, raw_round=_jax_raw_round(batch),
        **{**kw, "bandwidth_selectors": [j_silverman] * len(dims)}, **j_cfg)
    p_one = pfused.build_one_gen(
        p_abc._kernel, distance_params=p_dist,
        raw_round=_port_raw_round(batch), **kw, **p_cfg)

    j_carry = {k: jnp.asarray(v.astype(np.int32) if k in ("m", "rec_m")
                              else v) for k, v in carry_np.items()}
    j_carry["count"] = jnp.int32(carry_np["count"])
    j_fn = jax.jit(lambda c, k: j_one(c, k, final_flag=(
        jnp.bool_(False) if stoch else None)))
    j_out, j_wire = j_fn(j_carry, jax.random.PRNGKey(0))
    p_out, p_wire, info = p_one(carry_to_torch(carry_np, "cpu"), None)
    j_out = {k: np.asarray(v) for k, v in j_out.items()}
    p_out = carry_to_numpy(p_out)

    assert set(p_out) == set(j_out)
    assert info["rounds"] == int(j_wire["rounds"])
    assert info["rounds"] >= 3          # several partial rounds
    assert int(p_out["count"]) == int(j_out["count"]) >= N_TARGET
    assert info["host_reads"] == info["rounds"]    # no grid at this pop
    for key in ("m", "theta", "stats"):
        np.testing.assert_array_equal(p_out[key], j_out[key])
    _close(p_out["distance"], j_out["distance"], rtol=1e-6)
    _close(p_out["log_weight"], j_out["log_weight"], rtol=KDE_RTOL,
           atol=KDE_ATOL)
    _close(p_out["rate"], j_out["rate"], rtol=1e-6)
    _close(p_out["safety"], j_out["safety"], rtol=1e-6)
    if stoch:
        # the temperature from the bisection solve: b agrees to ~1e-4
        _close(p_out["eps"], j_out["eps"], rtol=1e-3)
        assert 1.0 <= float(p_out["eps"]) < 50.0
        for key in ("rec_m", "rec_theta", "rec_dist"):
            np.testing.assert_array_equal(p_out[key], j_out[key])
        _close(p_out["rec_loggen"], j_out["rec_loggen"], rtol=KDE_RTOL,
               atol=KDE_ATOL)
    else:
        _close(p_out["eps"], j_out["eps"], rtol=1e-6)
    if adaptive:
        _close(p_out["dist_w"], j_out["dist_w"], rtol=1e-6)
