"""The port's multi-fidelity cascade (``pyabc_tpu_torch/fidelity/``, the
staged round, the screened block) against the JAX package's, twins of
``tests/test_fidelity.py``.

- ``screen_threshold`` equal to the JAX package's and to the numpy mirror
  (rtol 1e-6), and every self-disable case;
- ``screen_mask``, ``compact_survivors`` and ``scatter_back`` equal to
  the JAX package's on the same masks;
- ``FidelityConfig`` resolution, validation and digest identical;
- ``_fidelity_eligible`` gives the JAX package's decision on the same
  configurations;
- one theta batch through both packages' staged rounds, the SIR
  simulators' Poisson draws replaced by one deterministic count in both
  (the seam of ``tests/test_torch_models.py``) and one tau: the same
  survivors, the same slots, distances at rtol 1e-5;
- one screened generation of both packages' block bodies from one carry
  and one fixed staged batch: the same rings, count, rounds and ε;
- runs: ``fidelity`` off is bit-identical to a run without it, the staged
  and plain rounds propose the same candidates, the first screened
  generation on a fresh carry runs self-disabled, a screened SIR run at
  pop 200 keeps its posterior, and the four-seed gate (slow).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu import fidelity as jfid
from pyabc_tpu.models.sir import SIRTauLeap as JaxSIR
from pyabc_tpu.sampler import fused as jfused
from pyabc_tpu.sampler.base import RoundResult as JaxRound
from pyabc_tpu.transition.multivariatenormal import \
    silverman_rule_of_thumb as j_silverman
from pyabc_tpu_torch import fidelity as pfid
from pyabc_tpu_torch.convert import (carry_to_numpy, carry_to_torch,
                                     install_block_state)
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.models.lotka_volterra import LotkaVolterraSDE
from pyabc_tpu_torch.models.sir import SIRTauLeap
from pyabc_tpu_torch.random_variables import RV, Distribution
from pyabc_tpu_torch.sampler import fused as pfused
from pyabc_tpu_torch.sampler.base import RoundResult as PortRound
from pyabc_tpu_torch.transition.multivariatenormal import \
    silverman_rule_of_thumb as p_silverman

KW = dict(q=0.02, margin=1.25, min_corr=0.2, min_pairs=32)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("PYABC_TPU_FIDELITY", "PYABC_TPU_FIDELITY_Q",
                "PYABC_TPU_FIDELITY_FULL_FRACTION", "PYABC_TPU_HBM_BUDGET",
                "PYABC_TPU_CARRY_PRECISION"):
        monkeypatch.delenv(var, raising=False)


def _paired(n=512, noise=0.1, seed=0):
    rng = np.random.default_rng(seed)
    d_full = rng.gamma(2.0, 1.0, n).astype(np.float32)
    d_lo = (d_full * (1.0 + noise * rng.standard_normal(n))
            + 0.05).astype(np.float32)
    return d_lo, d_full


def _both_thresholds(d_lo, d_full, eps, **kw):
    j = float(jfid.screen_threshold(jnp.asarray(d_lo), jnp.asarray(d_full),
                                    jnp.float32(eps), **kw))
    p = pfid.screen_threshold(torch.as_tensor(d_lo), torch.as_tensor(d_full),
                              eps, **kw)
    assert p.dtype == torch.float32 and p.shape == ()
    return j, float(p), pfid.screen_threshold_np(d_lo, d_full, eps, **kw)


# ---------------------------------------------------------------------------
# calibrator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("noise,eps_q", [(0.1, 0.5), (0.3, 0.3),
                                         (0.05, 0.8)])
def test_threshold_matches_jax_and_the_numpy_mirror(seed, noise, eps_q):
    d_lo, d_full = _paired(noise=noise, seed=seed)
    eps = float(np.quantile(d_full, eps_q))
    j, p, n = _both_thresholds(d_lo, d_full, eps, **KW)
    assert np.isfinite(p)
    assert p == pytest.approx(j, rel=1e-6)
    assert p == pytest.approx(n, rel=1e-6)
    assert pfid.screen_threshold_np(d_lo, d_full, eps, **KW) == \
        jfid.screen_threshold_np(d_lo, d_full, eps, **KW)
    assert pfid.pearson_corr_np(d_lo, d_full) == \
        jfid.pearson_corr_np(d_lo, d_full)
    valid = np.isfinite(d_lo) & np.isfinite(d_full)
    pc = float(pfid.pearson_corr(torch.as_tensor(d_lo),
                                 torch.as_tensor(d_full),
                                 torch.as_tensor(valid)))
    assert pc == pytest.approx(pfid.pearson_corr_np(d_lo, d_full),
                               rel=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("q", [0.02, 0.1, 0.25])
def test_false_reject_bound_is_conservative(seed, q):
    d_lo, d_full = _paired(n=1024, noise=0.3, seed=seed)
    eps = float(np.quantile(d_full, 0.3))
    acceptable = d_full <= eps
    for margin in (1.0, 1.25):
        tau = float(pfid.screen_threshold(
            torch.as_tensor(d_lo), torch.as_tensor(d_full), eps, q=q,
            margin=margin, min_corr=0.0, min_pairs=8))
        assert np.isfinite(tau)
        assert float(np.mean(d_lo[acceptable] > tau)) <= q + 1e-9


def test_self_disable_cases_match_jax():
    rng = np.random.default_rng(3)
    # weak correlation
    d_lo = rng.gamma(2.0, 1.0, 512).astype(np.float32)
    d_full = rng.gamma(2.0, 1.0, 512).astype(np.float32)
    kw = dict(KW, min_corr=0.9)
    assert _both_thresholds(d_lo, d_full, np.median(d_full), **kw) == \
        (np.inf, np.inf, np.inf)
    # NaN rings (a fresh carry)
    nan = np.full(128, np.nan, np.float32)
    assert _both_thresholds(nan, nan, 1.0, **KW) == (np.inf, np.inf,
                                                     np.inf)
    # too few acceptable pairs
    d_lo, d_full = _paired(n=16)
    assert _both_thresholds(d_lo, d_full, np.median(d_full),
                            **dict(KW, min_corr=0.0)) == \
        (np.inf, np.inf, np.inf)
    # a non-finite quantile: the acceptable low distances are +inf
    d_lo, d_full = _paired(n=256)
    d_lo[d_full <= np.median(d_full)] = np.inf
    j, p, n = _both_thresholds(d_lo, d_full, np.median(d_full),
                               **dict(KW, min_corr=-1.0))
    assert j == p == n == np.inf
    # half-empty ring: the NaN rows do not count
    d_lo, d_full = _paired(n=512)
    d_lo[::2] = np.nan
    j, p, n = _both_thresholds(d_lo, d_full, np.median(d_full), **KW)
    assert np.isfinite(p) and p == pytest.approx(j, rel=1e-6)


# ---------------------------------------------------------------------------
# screening ops
# ---------------------------------------------------------------------------

def test_screen_mask_nan_and_inf_semantics():
    d_lo = np.asarray([0.5, 2.0, np.nan, 1.0], np.float32)
    valid = np.asarray([True, True, True, False])
    for tau in (1.0, np.inf):
        p = pfid.screen_mask(torch.as_tensor(d_lo), tau,
                             torch.as_tensor(valid)).numpy()
        j = np.asarray(jfid.screen_mask(jnp.asarray(d_lo), jnp.float32(tau),
                                        jnp.asarray(valid)))
        np.testing.assert_array_equal(p, j)
    assert p.tolist() == [True, True, True, False]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("n_full", [1, 7, 64, 300])
def test_compaction_and_scatter_match_jax(seed, n_full):
    rng = np.random.default_rng(seed)
    B = 256
    survive = rng.uniform(size=B) < rng.uniform(0.05, 0.95)
    j = [np.asarray(a) for a in jfid.compact_survivors(jnp.asarray(survive),
                                                        n_full)]
    p = [a.numpy() for a in pfid.compact_survivors(torch.as_tensor(survive),
                                                   n_full)]
    for a, b in zip(p, j):
        np.testing.assert_array_equal(a, b)
    vals = rng.normal(size=(n_full, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        pfid.scatter_back(torch.as_tensor(p[0]), torch.as_tensor(vals), B,
                          np.inf).numpy(),
        np.asarray(jfid.scatter_back(jnp.asarray(j[0]), jnp.asarray(vals),
                                     B, jnp.float32(jnp.inf))))


def test_compact_scatter_roundtrip():
    survive = torch.tensor([False, True, False, True, True, False])
    idx, slot_ok, idx_c = pfid.compact_survivors(survive, n_full=2)
    assert idx.tolist() == [1, 3] and slot_ok.tolist() == [True, True]
    out = pfid.scatter_back(idx, torch.tensor([10.0, 30.0]), 6, np.inf)
    assert out.tolist() == [np.inf, 10.0, np.inf, 30.0, np.inf, np.inf]
    idx, slot_ok, idx_c = pfid.compact_survivors(survive, n_full=5)
    assert int(slot_ok.sum()) == 3 and int(idx_c.max()) < 6


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def test_config_resolution_and_digest_match_jax(monkeypatch):
    P, J = pfid.FidelityConfig, jfid.FidelityConfig
    for value in (None, False, "off", "none", "", True, "screen",
                  " Screen "):
        p, j = P.resolve(value), J.resolve(value)
        assert (p is None) == (j is None)
        if p is not None:
            assert p.digest_key() == j.digest_key()
    cfg = P(full_fraction=0.15, cal_rows=4096)
    assert P.resolve(cfg) is cfg
    assert cfg.digest_key() == J(full_fraction=0.15,
                                 cal_rows=4096).digest_key()
    for bad, err in (("turbo", ValueError), (3.14, TypeError)):
        with pytest.raises(err):
            P.resolve(bad)
    monkeypatch.setenv("PYABC_TPU_FIDELITY", "off")
    assert P.resolve("screen") is None and P.resolve(cfg) is None
    monkeypatch.delenv("PYABC_TPU_FIDELITY")
    monkeypatch.setenv("PYABC_TPU_FIDELITY_Q", "0.1")
    monkeypatch.setenv("PYABC_TPU_FIDELITY_FULL_FRACTION", "0.25")
    assert P.resolve("screen").digest_key() == \
        J.resolve("screen").digest_key()
    assert P.resolve("screen").false_reject_q == 0.1
    for B, frac in ((256, 0.5), (7, 0.5), (8, 1e-9), (1 << 18, 0.15)):
        assert P.static_n_full(B, frac) == J.static_n_full(B, frac)


def test_config_validation():
    for kw in ({"full_fraction": 0.0}, {"full_fraction": 1.5},
               {"false_reject_q": 1.0}, {"margin": 0.5},
               {"cal_rows": 8, "min_pairs": 32}):
        with pytest.raises(ValueError):
            pfid.FidelityConfig(**kw)
        with pytest.raises(ValueError):
            jfid.FidelityConfig(**kw)


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------

def _observed(model, theta, seed):
    g = torch.Generator()
    g.manual_seed(seed)
    obs = model.simulate(g, torch.log(torch.tensor([theta])))
    return {k: v[0].numpy() for k, v in obs.items()}


def _sir_problem(n_steps=40, n_obs=8):
    model = SIRTauLeap(n_steps=n_steps, n_obs=n_obs)
    prior = Distribution(log_beta=RV("uniform", -2.0, 3.0),
                         log_gamma=RV("uniform", -3.0, 3.0))
    return ([model], [prior], pt.PNormDistance(p=2),
            _observed(model, [0.8, 0.2], 11))


def _lv_problem(n_steps=80, n_obs=8):
    model = LotkaVolterraSDE(n_steps=n_steps, n_obs=n_obs)
    prior = Distribution(log_a=RV("uniform", -1.0, 2.0),
                         log_b=RV("uniform", -3.0, 2.0),
                         log_c=RV("uniform", -2.0, 2.0),
                         log_d=RV("uniform", -1.0, 2.0))
    return ([model], [prior], pt.PNormDistance(p=2),
            _observed(model, [1.1, 0.4, 1.0, 0.4], 7))


def _jax_sir_problem(observed, n_steps=40, n_obs=8):
    model = JaxSIR(n_steps=n_steps, n_obs=n_obs)
    prior = jpt.Distribution(log_beta=jpt.RV("uniform", -2.0, 3.0),
                             log_gamma=jpt.RV("uniform", -3.0, 3.0))
    return [model], [prior], jpt.PNormDistance(p=2), observed


def _run(fidelity=None, problem=_sir_problem, seed=0, pop=200, gens=4,
         fuse=3, **kw):
    models, priors, distance, observed = problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=pop,
                    sampler=pt.VectorizedSampler(device="cpu"),
                    fuse_generations=fuse, seed=seed, fidelity=fidelity,
                    device="cpu", **kw)
    abc.new("sqlite://", observed)
    return abc, abc.run(max_nr_populations=gens)


def _posterior_mean(h, m=0):
    df, w = h.get_distribution(m=m)
    return (df.to_numpy() * np.asarray(w)[:, None]).sum(axis=0)


def _digest(h):
    d = hashlib.sha256()
    d.update(np.asarray(h.get_all_populations().epsilon, np.float64)
             .tobytes())
    for t in range(h.max_t + 1):
        df, w = h.get_distribution(m=0, t=t)
        d.update(np.ascontiguousarray(df.to_numpy(np.float64)).tobytes())
        d.update(np.asarray(w, np.float64).tobytes())
    return d.hexdigest()


# ---------------------------------------------------------------------------
# eligibility
# ---------------------------------------------------------------------------

def _eligibility_pairs():
    """(name, port ABCSMC, JAX ABCSMC) on the same configurations."""
    from pyabc_tpu.models import make_two_gaussians_problem as j_gauss
    models, priors, distance, observed = _sir_problem()
    jm, jp, jd, jo = _jax_sir_problem(observed)
    out = []
    for name, p_kw, j_kw in (
            ("screen", {"fidelity": "screen"}, {"fidelity": "screen"}),
            ("off", {}, {}),
            ("adaptive", {"fidelity": "screen",
                          "distance_function": pt.AdaptivePNormDistance(
                              p=2)},
             {"fidelity": "screen",
              "distance_function": jpt.AdaptivePNormDistance(p=2)}),
            ("history_acceptor", {
                "fidelity": "screen",
                "acceptor": pt.UniformAcceptor(use_complete_history=True)},
             {"fidelity": "screen",
              "acceptor": jpt.UniformAcceptor(use_complete_history=True)}),
            ("fuse1", {"fidelity": "screen", "fuse_generations": 1},
             {"fidelity": "screen", "fuse_generations": 1})):
        p_kw = {"distance_function": distance, "fuse_generations": 3,
                **p_kw}
        j_kw = {"distance_function": jd, "fuse_generations": 3, **j_kw}
        p = pt.ABCSMC(models, priors, population_size=128,
                      sampler=pt.VectorizedSampler(device="cpu"),
                      device="cpu", **p_kw)
        p.new("sqlite://", observed)
        j = jpt.ABCSMC(jm, jp, population_size=128,
                       sampler=jpt.VectorizedSampler(), **j_kw)
        j.new("sqlite://", jo)
        out.append((name, p, j))
    # models without a surrogate
    m2, p2, d2, o2, _ = make_two_gaussians_problem()
    jm2, jp2, jd2, jo2, _ = j_gauss()
    p = pt.ABCSMC(m2, p2, d2, population_size=128,
                  sampler=pt.VectorizedSampler(device="cpu"),
                  fuse_generations=3, fidelity="screen", device="cpu")
    p.new("sqlite://", o2)
    j = jpt.ABCSMC(jm2, jp2, jd2, population_size=128,
                   sampler=jpt.VectorizedSampler(), fuse_generations=3,
                   fidelity="screen")
    j.new("sqlite://", jo2)
    out.append(("no_surrogate", p, j))
    return out


def test_eligibility_matches_jax():
    decisions = {}
    for name, p, j in _eligibility_pairs():
        assert p._fidelity_eligible() == j._fidelity_eligible(), name
        decisions[name] = p._fidelity_eligible()
    assert decisions == {"screen": True, "off": False, "adaptive": False,
                         "history_acceptor": False, "fuse1": True,
                         "no_surrogate": False}


def test_low_fidelity_contract():
    for model in (SIRTauLeap(), LotkaVolterraSDE()):
        lo = model.low_fidelity()
        assert lo is not None and type(lo).screen_stats_compatible
        theta = torch.zeros(3, 2 if isinstance(model, SIRTauLeap) else 4)
        g = torch.Generator()
        full, cheap = model.simulate(g, theta), lo.simulate(g, theta)
        assert set(full) == set(cheap)
        for k in full:
            assert full[k].shape == cheap[k].shape, k
    assert pt.Model().low_fidelity() is None
    assert not pt.Model.screen_stats_compatible


# ---------------------------------------------------------------------------
# the staged round: one theta batch through both packages
# ---------------------------------------------------------------------------

def _rounded_jax(key, lam, shape=None, dtype=None):
    return jnp.floor(1.3 * lam + 0.4)


def _rounded_torch(lam, generator=None):
    return torch.floor(1.3 * lam + 0.4)


@pytest.mark.parametrize("tau_q,full_fraction", [
    (0.5, 0.5), (0.3, 0.15), (0.9, 0.25), (None, 0.5)])
def test_staged_round_matches_jax(monkeypatch, tau_q, full_fraction):
    B = 256
    models, priors, distance, observed = _sir_problem()
    p_abc = pt.ABCSMC(models, priors, distance, population_size=128,
                      sampler=pt.VectorizedSampler(device="cpu"),
                      fuse_generations=3, fidelity="screen", device="cpu")
    p_abc.new("sqlite://", observed)
    jm, jp, jd, jo = _jax_sir_problem(observed)
    j_abc = jpt.ABCSMC(jm, jp, jd, population_size=128,
                       sampler=jpt.VectorizedSampler(), fuse_generations=3,
                       fidelity="screen")
    j_abc.new("sqlite://", jo)

    rng = np.random.default_rng(5)
    theta = np.stack([rng.uniform(-2.0, 1.0, B), rng.uniform(-3.0, 0.0, B)],
                     1).astype(np.float32)
    theta[:5] = [[-0.22, -1.61]] * 5            # near the truth
    m = np.zeros(B, np.int32)
    valid = rng.uniform(size=B) > 0.05
    log_prior = np.where(valid, -2.2, -np.inf).astype(np.float32)
    monkeypatch.setattr(torch, "poisson", _rounded_torch)
    monkeypatch.setattr(jax.random, "poisson", _rounded_jax)
    p_abc._kernel._propose = lambda *a: (
        torch.as_tensor(m).long(), torch.as_tensor(theta),
        torch.as_tensor(log_prior), torch.as_tensor(valid))
    j_abc._kernel._propose = lambda *a: (
        jnp.asarray(m), jnp.asarray(theta), jnp.asarray(log_prior),
        jnp.asarray(valid))

    # one tau for both: a quantile of the low-fidelity distances
    lo = p_abc._kernel._simulate_all_low(None, torch.as_tensor(theta),
                                         torch.as_tensor(m).long())
    d_lo = distance.compute(lo, p_abc._obs_flat, {"w": torch.ones(
        lo.shape[1])}).numpy()
    tau = np.inf if tau_q is None else float(np.quantile(d_lo, tau_q))
    eps = float(np.quantile(d_lo, 0.4))
    p_params = {"distance": carry_to_torch(
        p_abc.distance_function.get_params(0), "cpu"),
        "acceptor": {"eps": torch.tensor(eps)},
        "fidelity": {"tau": torch.tensor(tau, dtype=torch.float32)}}
    j_params = {"distance": j_abc.distance_function.get_params(0),
                "acceptor": {"eps": jnp.float32(eps)},
                "fidelity": {"tau": jnp.float32(tau)}}
    p_rr, (p_lo, p_full, p_pass) = p_abc._kernel.staged_generation_round(
        None, p_params, B, full_fraction=full_fraction, with_proposal=False)
    j_rr, (j_lo, j_full, j_pass) = j_abc._kernel.staged_generation_round(
        jax.random.PRNGKey(0), j_params, B, full_fraction=full_fraction,
        with_proposal=False)

    survive = valid & ~(d_lo > tau)
    assert int(p_pass[0]) == int(j_pass[0]) == int(survive.sum())
    # the same slots: the pairs' layout and which rows got a full run
    np.testing.assert_array_equal(np.isfinite(p_lo.numpy()),
                                  np.isfinite(np.asarray(j_lo)))
    filled = np.isfinite(p_lo.numpy())
    n_full = pfid.FidelityConfig.static_n_full(B, full_fraction)
    assert filled.sum() == min(n_full, survive.sum())
    slots = pfid.compact_survivors(torch.as_tensor(survive), n_full)[0]
    np.testing.assert_array_equal(
        np.isfinite(p_rr.distance.numpy()),
        np.isin(np.arange(B), slots.numpy()[filled]))
    np.testing.assert_allclose(p_lo.numpy()[filled],
                               np.asarray(j_lo)[filled], rtol=1e-5)
    np.testing.assert_allclose(p_full.numpy()[filled],
                               np.asarray(j_full)[filled], rtol=1e-5)
    np.testing.assert_allclose(p_rr.distance.numpy(),
                               np.asarray(j_rr.distance), rtol=1e-5)
    np.testing.assert_array_equal(p_rr.accepted.numpy(),
                                  np.asarray(j_rr.accepted))
    np.testing.assert_array_equal(p_rr.theta.numpy(),
                                  np.asarray(j_rr.theta))
    np.testing.assert_allclose(p_rr.log_weight.numpy(),
                               np.asarray(j_rr.log_weight), rtol=1e-6)
    assert p_rr.accepted.sum() > 0


def test_staged_and_plain_rounds_propose_the_same_candidates():
    abc, h = _run(fidelity="screen", seed=2, gens=3)
    t = h.max_t
    abc._fit_transitions(t, population=h.get_population(t - 1))
    probs = abc._model_probabilities(t - 1)
    params = carry_to_torch({
        "model_log_probs": np.log(np.maximum(probs, 1e-300)).astype(
            np.float32),
        "transition": abc._trans_params,
        "distance": abc.distance_function.get_params(t),
        "acceptor": abc.acceptor.get_params(t, abc.eps)}, "cpu")
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(123)
    g2.manual_seed(123)
    plain = abc._kernel.generation_round(g1, params, 256)
    staged, (plo, pfull, npass) = abc._kernel.staged_generation_round(
        g2, {**params, "fidelity": {"tau": torch.tensor(np.inf)}}, 256,
        full_fraction=0.5)
    for key in ("theta", "m", "valid"):
        assert torch.equal(getattr(plain, key), getattr(staged, key))
    # tau = +inf: every valid candidate survives; the slots cap the rest
    assert int(npass[0]) == int(plain.valid.sum())
    assert int(staged.accepted.sum()) <= 128
    filled = torch.isfinite(pfull)
    assert int(filled.sum()) == min(128, int(npass[0]))
    assert bool(torch.isfinite(plo[filled]).all())


# ---------------------------------------------------------------------------
# one screened generation of both block bodies
# ---------------------------------------------------------------------------

N_TARGET, B_GEN, N_FULL, CAL = 300, 256, 64, 128


def _gen_inputs(seed):
    rng = np.random.default_rng(seed)
    m = (rng.uniform(size=B_GEN) < 0.5).astype(np.int32)
    theta = (np.where(m[:, None] == 0, -0.5, 0.5)
             + rng.uniform(size=(B_GEN, 1))).astype(np.float32)
    stats = (theta + 0.5 * rng.standard_normal((B_GEN, 1))).astype(
        np.float32)
    dist = np.abs(stats[:, 0] - 1.0).astype(np.float32)
    acc = rng.uniform(size=B_GEN) < 0.2
    lw = np.where(acc, -0.1 * rng.standard_normal(B_GEN),
                  -np.inf).astype(np.float32)
    plo = np.where(np.arange(N_FULL) < 50,
                   rng.gamma(2.0, 0.5, N_FULL), np.nan).astype(np.float32)
    pfull = np.where(np.isfinite(plo), plo * 1.1, np.nan).astype(np.float32)
    batch = {"m": m, "theta": theta, "distance": dist, "accepted": acc,
             "log_weight": lw, "stats": stats}
    n = N_TARGET
    cm = (rng.uniform(size=n) < 0.6).astype(np.int32)
    ctheta = (np.where(cm[:, None] == 0, -0.5, 0.5)
              + rng.uniform(size=(n, 1))).astype(np.float32)
    cstats = (ctheta + 0.5 * rng.standard_normal((n, 1))).astype(np.float32)
    carry = {"m": cm, "theta": ctheta,
             "log_weight": (0.3 * rng.standard_normal(n)).astype(np.float32),
             "distance": np.abs(cstats[:, 0] - 1.0).astype(np.float32),
             "stats": cstats, "count": np.int32(n)}
    d_full = rng.gamma(2.0, 0.2, CAL).astype(np.float32)
    cal = {"cal_lo": (d_full * (1 + 0.1 * rng.standard_normal(CAL))).astype(
        np.float32), "cal_full": d_full}
    cal["cal_lo"][CAL // 2:] = np.nan          # half the ring empty
    cal["cal_full"][CAL // 2:] = np.nan
    return batch, (plo, pfull, np.asarray([37], np.int32)), carry, cal


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_one_screened_generation_matches_jax(precision):
    from pyabc_tpu.models import make_two_gaussians_problem as j_gauss
    batch, pairs, carry_np, cal = _gen_inputs(4)
    carry_np = install_block_state(carry_np, eps=0.4, rate=0.3, safety=1.2,
                                   cal=cal)
    abcs = []
    for pkg, problem, kw in ((jpt, j_gauss, {}),
                             (pt, make_two_gaussians_problem,
                              {"device": "cpu"})):
        models, priors, distance, observed, _ = problem()
        abc = pkg.ABCSMC(models, priors, distance, population_size=300,
                         sampler=pkg.VectorizedSampler(**kw),
                         fuse_generations=3, seed=0)
        abc.new("sqlite://", observed)
        abcs.append(abc)
    j_abc, p_abc = abcs
    fcfg = {"q": 0.02, "margin": 1.25, "min_corr": 0.2, "min_pairs": 32,
            "cal_rows": CAL}
    kw = dict(scalings=[1.0, 1.0], dims=[1, 1], n_target=N_TARGET, B=B_GEN,
              max_rounds=64, d=1, s=1, eps_mode="quantile", eps_alpha=0.5,
              eps_multiplier=1.0, eps_weighted=True, rate_pred_factor=0.5,
              carry_precision=precision)
    j_arrs = {k: jnp.asarray(v) for k, v in batch.items()}
    j_pairs = tuple(jnp.asarray(a) for a in pairs)
    p_arrs = {k: torch.as_tensor(v) for k, v in batch.items()}
    p_arrs["m"] = p_arrs["m"].long()
    p_pairs = tuple(torch.as_tensor(a) for a in pairs)

    def j_raw(key, params):
        return (JaxRound(j_arrs["m"], j_arrs["theta"], j_arrs["distance"],
                         j_arrs["accepted"], j_arrs["log_weight"],
                         j_arrs["stats"]), j_pairs)

    def p_raw(gen, params):
        return (PortRound(p_arrs["m"], p_arrs["theta"], p_arrs["distance"],
                          p_arrs["accepted"], p_arrs["log_weight"],
                          p_arrs["stats"]), p_pairs)

    j_one = jfused._build_one_gen(
        j_abc._kernel, bandwidth_selectors=[j_silverman] * 2,
        distance_params=j_abc.distance_function.get_params(0),
        wire_stats=True, wire_m_bits=False, raw_round=j_raw,
        fidelity_cfg=fcfg, **kw)
    p_one = pfused.build_one_gen(
        p_abc._kernel, bandwidth_selectors=[p_silverman] * 2,
        distance_params=carry_to_torch(
            p_abc.distance_function.get_params(0), "cpu"),
        raw_round=p_raw, fidelity_cfg={**fcfg, "n_full": N_FULL}, **kw)

    from pyabc_tpu.ops.precision import encode_carry as j_encode
    from pyabc_tpu_torch.ops.precision import encode_carry as p_encode
    j_carry = {k: jnp.asarray(v.astype(np.int32) if k == "m" else v)
               for k, v in carry_np.items()}
    j_carry["count"] = jnp.int32(carry_np["count"])
    j_out, j_wire = jax.jit(lambda c, k: j_one(c, k))(
        j_encode(j_carry, precision), jax.random.PRNGKey(0))
    p_out, p_wire, info = p_one(
        p_encode(carry_to_torch(carry_np, "cpu"), precision), None)
    j_out = {k: np.asarray(v) for k, v in j_out.items()}
    p_out = carry_to_numpy(p_out)

    assert set(p_out) == set(j_out)
    assert info["rounds"] == int(j_wire["rounds"]) >= 5
    assert int(p_out["count"]) == int(j_out["count"]) >= N_TARGET
    # the rings: the last round's pairs in front, cut to cal_rows
    for key in ("cal_lo", "cal_full"):
        np.testing.assert_array_equal(p_out[key], j_out[key])
        np.testing.assert_array_equal(p_out[key][:N_FULL],
                                      pairs[key == "cal_full"])
    assert int(info["screen_pass"]) == 37 * info["rounds"]
    np.testing.assert_allclose(p_out["eps"], j_out["eps"], rtol=1e-6)
    for key in ("m", "theta", "stats"):
        np.testing.assert_array_equal(p_out[key].astype(np.float32),
                                      j_out[key].astype(np.float32))
    # this generation's tau from the carried rings, in both packages
    tau_p = pfid.screen_threshold(torch.as_tensor(cal["cal_lo"]),
                                  torch.as_tensor(cal["cal_full"]),
                                  torch.as_tensor(p_out["eps"]), **KW)
    tau_j = jfid.screen_threshold(jnp.asarray(cal["cal_lo"]),
                                  jnp.asarray(cal["cal_full"]),
                                  jnp.asarray(j_out["eps"]), **KW)
    assert float(tau_p) == pytest.approx(float(tau_j), rel=1e-6)


# ---------------------------------------------------------------------------
# runs
# ---------------------------------------------------------------------------

def test_fidelity_off_is_bit_identical(monkeypatch):
    _, h_none = _run(None, seed=5)
    _, h_off = _run("off", seed=5)
    monkeypatch.setenv("PYABC_TPU_FIDELITY", "off")
    abc, h_kill = _run("screen", seed=5)
    assert abc.fidelity is None
    assert _digest(h_none) == _digest(h_off) == _digest(h_kill)


def test_first_screened_generation_on_a_fresh_carry_is_unscreened():
    abc, h = _run("screen", seed=0, gens=5, fuse=2)
    fused_rows = [r for r in abc.timeline if r["path"] == "fused"]
    assert len(fused_rows) >= 4
    taus = [r["screen_tau"] for r in fused_rows]
    # a block seeded from a sequential generation has NaN rings: no pair,
    # no correlation, no screen
    assert taus[0] == np.inf
    assert fused_rows[0]["cal_pairs"] == 0
    assert fused_rows[0]["cal_corr"] == -np.inf
    assert any(np.isfinite(taus[1:]))
    # each row's threshold is the one its calibration facts give
    for r in fused_rows:
        enabled = (r["cal_pairs"] >= abc.fidelity.min_pairs
                   and r["cal_corr"] >= abc.fidelity.min_corr)
        assert np.isfinite(r["screen_tau"]) == enabled
        assert r["rounds"] <= r["round_cap"] <= r["max_rounds"]
    lo, full = abc._fidelity_nan_seed(abc.fidelity.cal_rows)
    assert float(pfid.screen_threshold(
        lo, full, 1.0, q=abc.fidelity.false_reject_q,
        margin=abc.fidelity.margin, min_corr=abc.fidelity.min_corr,
        min_pairs=abc.fidelity.min_pairs)) == np.inf


def test_screened_run_posterior_and_counts():
    _, h_off = _run(None, seed=0)
    abc, h = _run("screen", seed=0)
    rows = [r for r in abc.timeline if r["path"] == "fused"]
    assert rows and all(r["sims_full"] <= r["sims_low"] for r in rows)
    slots = pfid.FidelityConfig().n_full(rows[0]["batch"])
    for r in rows:
        assert r["sims_low"] == r["rounds"] * r["batch"]
        assert r["sims_full"] == r["rounds"] * slots
        assert 0 < r["screen_pass"] <= r["sims_low"]
    assert [len(h.get_population(t)) for t in range(4)] == [200] * 4
    assert np.all(np.abs(_posterior_mean(h) - _posterior_mean(h_off)) < 0.6)


@pytest.mark.parametrize("rate,screened,unscreened", [
    (None, 112, 16), (1.0, 112, 16), (0.1, 112, 16), (0.01, 448, 64),
    (1e-4, 448, 64)])
def test_screened_block_ceiling_budgets_the_slots(rate, screened,
                                                  unscreened):
    """The screened ceiling is the unscreened one times r = B / n_full
    (16·r to 64·r, r = 7 at full_fraction 0.15); an unscreened block
    keeps the JAX package's (``test_torch_fused_ops.py``)."""
    models, priors, distance, observed = _sir_problem()
    kw = dict(population_size=5000, device="cpu",
              sampler=pt.VectorizedSampler(device="cpu"))
    abc = pt.ABCSMC(models, priors, distance,
                    fidelity=pfid.FidelityConfig(full_fraction=0.15), **kw)
    B = 1 << 15
    assert int(round(B / abc.fidelity.n_full(B))) == 7
    assert abc._block_max_rounds(5000, B, rate_est=rate) == screened
    off = pt.ABCSMC(models, priors, distance, **kw)
    assert off._block_max_rounds(5000, B, rate_est=rate) == unscreened


@pytest.mark.parametrize("run_mode,kw", [
    ("onedispatch", {}), ("auto", {"ingest_mode": "overlap"})])
def test_screened_onedispatch_and_pipelined_runs(run_mode, kw):
    abc, h = _run("screen", seed=1, gens=5, fuse=2, run_mode=run_mode,
                  **kw)
    path = "onedispatch" if run_mode == "onedispatch" else "pipelined"
    rows = [r for r in abc.timeline if r["path"] == path]
    assert rows and all("sims_full" in r for r in rows)
    assert [len(h.get_population(t)) for t in range(5)] == [200] * 5


@pytest.mark.slow
@pytest.mark.parametrize("problem", ["sir", "lv"])
def test_four_seed_posterior_gate(problem):
    make = _sir_problem if problem == "sir" else _lv_problem
    diffs = []
    for seed in range(4):
        mus = {}
        for fid in (None, "screen"):
            _, h = _run(fid, problem=make, seed=seed, pop=256, gens=5)
            mus[fid] = _posterior_mean(h)
        diffs.append(np.abs(mus[None] - mus["screen"]))
    assert np.all(np.mean(diffs, axis=0) < 0.35), np.mean(diffs, axis=0)
    assert np.all(np.max(diffs, axis=0) < 0.8), np.max(diffs, axis=0)
