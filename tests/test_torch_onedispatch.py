"""The port's one-dispatch engine (``run_mode="onedispatch"``) on the CPU.

Twins of the JAX package's one-dispatch tests: ``tests/test_fused.py``
(bit identity with fused blocks at a pinned batch, the eligibility
gating, a redispatch past ``max_T``) and the five stop-parity tests of
``tests/test_stop_sampling.py`` (one parametrised test: the one-dispatch,
fused and sequential engines of the port stop for the same reason, and
the one-dispatch populations are bit-identical to the fused ones; one
more case stops on the temperature its last generation pins to 1).  The
device stop chain (``fused.stop_code``) is held against a numpy
transcription of the JAX chain (``pyabc_tpu/sampler/fused.py:934-970``)
on hand-built cases, and one test runs the JAX package's one-dispatch
engine and the port's on the same configuration and compares their
posteriors at the effective sample size.

Every configuration pins the sampler batch (``min == max``), as the JAX
tests do, so that each engine builds its rounds with the same cap.
"""

import logging

import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem
from pyabc_tpu.sampler import fused as jax_fused
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.sampler import fused


# ---- the stop chain against a transcription of the JAX one ---------------


def _chain_np(count, rounds, rounds_tot, eps, lw, m, n_target, B, min_eps,
              min_rate, budget_rounds, n_models, temperature, single_stop):
    """``pyabc_tpu/sampler/fused.py:928-970`` for a live generation, in
    numpy float32."""
    f32 = np.float32
    if temperature:
        thresh, thresh_code = f32(eps) <= f32(1.0), fused.STOP_TEMPERATURE
    else:
        thresh, thresh_code = f32(eps) <= f32(min_eps), fused.STOP_EPS
    single = False
    if single_stop:
        lw = np.asarray(lw, f32)
        nv = np.arange(lw.shape[0]) < count
        lw_m = np.max(np.where(nv & np.isfinite(lw), lw, -np.inf))
        with np.errstate(invalid="ignore", over="ignore"):
            wv = np.where(nv, np.exp(lw - lw_m), f32(0)).astype(f32)
        wv = wv / np.maximum(wv.sum(dtype=f32), f32(1e-38))
        pm = np.array([wv[np.asarray(m) == j].sum(dtype=f32)
                       for j in range(n_models)])
        single = int((pm > 0).sum()) <= 1
    acc_rate = f32(count) / f32(max(rounds * B, 1))
    if thresh:
        code = thresh_code
    elif single:
        code = fused.STOP_SINGLE_MODEL
    elif acc_rate < f32(min_rate):
        code = fused.STOP_ACC_RATE
    elif rounds_tot >= budget_rounds:
        code = fused.STOP_BUDGET
    else:
        code = fused.STOP_NONE
    if count < n_target:
        return fused.STOP_UNDERSHOOT
    return code


def _case(**over):
    """A generation of 8 rows over two live models that stops on
    nothing; ``over`` replaces any input."""
    case = {"count": 8, "rounds": 2, "rounds_tot": 5, "eps": 0.3,
            "lw": np.log(np.full(8, 0.125, np.float32)),
            "m": np.array([0, 1] * 4), "n_target": 8, "B": 16,
            "min_eps": 0.1, "min_rate": 0.01, "budget_rounds": 100,
            "n_models": 2, "temperature": False, "single_stop": True}
    case.update(over)
    return case


_THIRD = float(np.float32(1) / np.float32(3))
_DEAD_ONE = np.where(np.arange(8) % 2 == 1, -np.inf, 0.0).astype(np.float32)

STOP_CASES = {
    "nothing": (_case(), fused.STOP_NONE),
    "eps_tie": (_case(eps=0.25, min_eps=0.25), fused.STOP_EPS),
    "eps_above": (_case(eps=float(np.nextafter(np.float32(0.25),
                                               np.float32(1))),
                        min_eps=0.25), fused.STOP_NONE),
    "temperature_one": (_case(eps=1.0, temperature=True, min_eps=5.0),
                        fused.STOP_TEMPERATURE),
    "temperature_above_one": (
        _case(eps=float(np.nextafter(np.float32(1), np.float32(2))),
              temperature=True), fused.STOP_NONE),
    # 8/24 in float32 rounds up to float32(1/3 + 1 ulp of float64): a
    # float64 comparison would stop here, the JAX chain does not
    "acc_rate_f32_tie": (_case(count=8, rounds=3, B=8, min_rate=float(
        np.nextafter(1.0 / 3.0, 1.0))), fused.STOP_NONE),
    "acc_rate_f32_above": (
        _case(count=8, rounds=3, B=8, min_rate=float(np.nextafter(
            np.float32(_THIRD), np.float32(1)))), fused.STOP_ACC_RATE),
    "budget_tie": (_case(rounds_tot=100, budget_rounds=100),
                   fused.STOP_BUDGET),
    "budget_below": (_case(rounds_tot=99, budget_rounds=100),
                     fused.STOP_NONE),
    "dead_model_weight": (_case(lw=_DEAD_ONE), fused.STOP_SINGLE_MODEL),
    "dead_model_rows": (_case(m=np.zeros(8, np.int64)),
                        fused.STOP_SINGLE_MODEL),
    "dead_model_no_stop": (_case(m=np.zeros(8, np.int64),
                                 single_stop=False), fused.STOP_NONE),
    "eps_before_single": (_case(eps=0.1, m=np.zeros(8, np.int64)),
                          fused.STOP_EPS),
    "single_before_rate": (_case(m=np.zeros(8, np.int64), min_rate=1.0),
                           fused.STOP_SINGLE_MODEL),
    "rate_before_budget": (_case(min_rate=1.0, rounds_tot=100,
                                 budget_rounds=1), fused.STOP_ACC_RATE),
    "undershoot_first": (_case(count=7, eps=0.0, min_rate=1.0,
                               rounds_tot=100, budget_rounds=1,
                               m=np.zeros(8, np.int64)),
                         fused.STOP_UNDERSHOOT),
    "undershoot_temperature": (_case(count=0, eps=1.0, temperature=True),
                               fused.STOP_UNDERSHOOT),
}


def test_stop_codes_are_the_jax_packages():
    for name in ("STOP_NONE", "STOP_EPS", "STOP_TEMPERATURE",
                 "STOP_SINGLE_MODEL", "STOP_ACC_RATE", "STOP_BUDGET",
                 "STOP_UNDERSHOOT"):
        assert getattr(fused, name) == getattr(jax_fused, name), name


@pytest.mark.parametrize("name", sorted(STOP_CASES))
def test_stop_code_matches_the_jax_chain(name):
    case, expected = STOP_CASES[name]
    assert _chain_np(**case) == expected
    got = fused.stop_code(
        torch.tensor(case["count"]), case["rounds"], case["rounds_tot"],
        torch.tensor(case["eps"], dtype=torch.float32),
        torch.from_numpy(np.asarray(case["lw"], np.float32)),
        torch.from_numpy(np.asarray(case["m"], np.int64)),
        case["n_target"], case["B"], case["min_eps"], case["min_rate"],
        case["budget_rounds"], case["n_models"], case["temperature"],
        case["single_stop"])
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == expected


# ---- twins of tests/test_fused.py ------------------------------------------


def _onedispatch_abc(run_mode="onedispatch", fuse=2, pop=200, batch=2048,
                     eps_value=0.2, seed=0, **kwargs):
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=pop,
                    eps=pt.ConstantEpsilon(eps_value),
                    sampler=pt.VectorizedSampler(min_batch_size=batch,
                                                 max_batch_size=batch,
                                                 device="cpu"),
                    fuse_generations=fuse, run_mode=run_mode, seed=seed,
                    **kwargs)
    abc.new("sqlite://", observed)
    return abc


def _paths(abc):
    return [r["path"] for r in abc.timeline]


def _assert_same_populations(h_a, h_b, n_models=2):
    assert h_a.max_t == h_b.max_t
    for t in range(h_a.max_t + 1):
        for m in range(n_models):
            df_a, w_a = h_a.get_distribution(m=m, t=t)
            df_b, w_b = h_b.get_distribution(m=m, t=t)
            assert len(df_a) == len(df_b), (t, m)
            if len(df_a) == 0:
                continue
            np.testing.assert_array_equal(df_a["mu"].to_numpy(),
                                          df_b["mu"].to_numpy())
            np.testing.assert_array_equal(w_a, w_b)


def test_onedispatch_bit_identical_to_fused():
    a_o = _onedispatch_abc()
    h_o = a_o.run(max_nr_populations=7)
    a_f = _onedispatch_abc(run_mode="auto")
    h_f = a_f.run(max_nr_populations=7)
    assert h_o.max_t == 6 and h_f.max_t == 6
    assert a_o.run_dispatches == 1
    assert a_f.run_dispatches == 0
    assert _paths(a_o) == ["sequential"] + ["onedispatch"] * 6
    assert _paths(a_f) == ["sequential"] + ["fused"] * 6
    rows = [r for r in a_o.timeline if r["path"] == "onedispatch"]
    assert all(r["engine"] == "onedispatch" for r in rows)
    # the round-loop reads and the one control read of each generation
    # (no grid at pop 200)
    assert all(r["host_reads"] == r["rounds"] + 1 for r in rows)
    assert a_o.control_roundtrip_s > 0
    _assert_same_populations(h_o, h_f)
    assert [len(h_o.get_population(t)) for t in range(7)] == [200] * 7


def test_onedispatch_eligibility_gating():
    for mode in ("auto", "classic"):
        abc0 = _onedispatch_abc(run_mode=mode)
        assert abc0._onedispatch_eligible() is False
        assert abc0._fused_eligible() is True
    assert _onedispatch_abc()._onedispatch_eligible() is True
    # no device form of ListEpsilon's stop test
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc2 = pt.ABCSMC(models, priors, distance, population_size=200,
                     eps=pt.ListEpsilon([0.5, 0.3, 0.2, 0.1, 0.05]),
                     sampler=pt.VectorizedSampler(device="cpu"),
                     fuse_generations=2, run_mode="onedispatch", seed=0)
    abc2.new("sqlite://", observed)
    assert abc2._onedispatch_eligible() is False
    assert _onedispatch_abc(fuse=1)._onedispatch_eligible() is False
    # the engine probe's verdict at scale retires it, as fused blocks
    abc5 = _onedispatch_abc(pop=1_000_000)
    assert abc5._onedispatch_eligible() is True
    abc5._engine_choice = "sequential"
    assert abc5._onedispatch_eligible() is False
    with pytest.raises(ValueError, match="run_mode"):
        _onedispatch_abc(run_mode="pipelined")


def test_onedispatch_runs_on_the_card_by_default():
    models, priors, distance, _, _ = make_two_gaussians_problem()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.ABCSMC(models, priors, distance, fuse_generations=2,
                  run_mode="onedispatch")


def test_onedispatch_redispatch_past_max_t():
    abc = _onedispatch_abc(onedispatch_max_t=2)
    h = abc.run(max_nr_populations=7)
    assert h.max_t == 6
    assert abc.run_dispatches == 3
    assert _paths(abc) == ["sequential"] + ["onedispatch"] * 6
    assert [len(h.get_population(t)) for t in range(7)] == [200] * 7
    # one generator: the dispatch boundaries draw nothing of their own
    _assert_same_populations(h, _onedispatch_abc().run(max_nr_populations=7))


def test_onedispatch_undershoot_falls_back_to_sequential(caplog):
    """The twin of the fused undershoot test: a 16-round cap at batch
    256 cannot fill 2000 particles at ε 0.05, the dispatch writes
    nothing and the sequential engine takes every generation."""
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=2000,
                    eps=pt.ConstantEpsilon(0.05),
                    sampler=pt.VectorizedSampler(min_batch_size=256,
                                                 max_batch_size=256,
                                                 device="cpu"),
                    fuse_generations=2, run_mode="onedispatch", seed=0)
    abc.new("sqlite://", observed)
    with caplog.at_level(logging.INFO, logger="ABC"):
        h = abc.run(max_nr_populations=3)
    assert h.max_t == 2
    assert [len(h.get_population(t)) for t in range(3)] == [2000] * 3
    assert abc.run_dispatches >= 1
    assert any("one-dispatch run undershot" in r.message
               for r in caplog.records)
    assert "onedispatch" not in _paths(abc)


# ---- twins of the stop-parity tests of tests/test_stop_sampling.py --------


def _pinned(batch):
    return pt.VectorizedSampler(min_batch_size=batch, max_batch_size=batch,
                                device="cpu")


def _min_eps_build(run_mode, fuse):
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=400,
                    eps=pt.QuantileEpsilon(alpha=0.8),
                    sampler=_pinned(4096), fuse_generations=fuse,
                    run_mode=run_mode, onedispatch_max_t=16, seed=0)
    abc.new("sqlite://", observed)
    return abc


def _min_rate_build(run_mode, fuse):
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=150,
                    sampler=_pinned(4096), fuse_generations=fuse,
                    run_mode=run_mode, onedispatch_max_t=16, seed=1)
    abc.new("sqlite://", observed)
    return abc


def _budget_build(run_mode, fuse):
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=200,
                    eps=pt.ConstantEpsilon(0.2), sampler=_pinned(2048),
                    fuse_generations=fuse, run_mode=run_mode,
                    onedispatch_max_t=16, seed=0)
    abc.new("sqlite://", observed)
    return abc


def _temperature_build(run_mode, fuse):
    def model(generator, theta):
        return {"y": theta[:, 0] + 0.2 * torch.randn(
            theta.shape[:1], generator=generator, device=theta.device)}

    abc = pt.ABCSMC(
        pt.SimpleModel(model),
        pt.Distribution(mu=pt.RV("uniform", -1.0, 2.0)),
        pt.IndependentNormalKernel(var=0.1 ** 2), population_size=400,
        eps=pt.Temperature(schemes=[pt.AcceptanceRateScheme()]),
        acceptor=pt.StochasticAcceptor(
            pdf_norm_method=pt.pdf_norm_from_kernel),
        sampler=_pinned(4096), fuse_generations=fuse, run_mode=run_mode,
        onedispatch_max_t=16, seed=9)
    abc.new("sqlite://", {"y": 0.5})
    return abc


def _single_model_build(run_mode, fuse):
    """The far model cannot reach the data (noiseless, distance >= 0.1):
    median-ε annealing kills it."""
    def mk(shift):
        def fn(generator, theta):
            return {"y": theta[:, 0] + shift}
        return fn

    models = [pt.SimpleModel(mk(0.0), name="near"),
              pt.SimpleModel(mk(1.6), name="far")]
    priors = [pt.Distribution(mu=pt.RV("uniform", -1.0, 2.0))
              for _ in range(2)]
    abc = pt.ABCSMC(models, priors, pt.PNormDistance(p=2),
                    population_size=300, sampler=_pinned(4096),
                    fuse_generations=fuse, run_mode=run_mode,
                    onedispatch_max_t=16, seed=0,
                    stop_if_only_single_model_alive=True)
    abc.new("sqlite://", {"y": 0.5})
    return abc


def _budget_run_kwargs(less: int = 0):
    """The simulation budget set to the exact total at the end of
    generation 3 of the sequential engine, less ``less`` (a >=-vs-> slip
    on any engine moves the stop at the exact total, a floor for the
    ceil of the whole rounds left moves it one below)."""
    probe = _budget_build("auto", 1)
    h = probe.run(max_nr_populations=6)
    pops = h.get_all_populations()
    sims = pops[pops.t >= 0].samples.to_numpy()
    return {"max_nr_populations": 6,
            "max_total_nr_simulations": int(sims[:4].sum()) - less}


#: criterion -> (build function, K, run() kwargs, stop string, models, last t
#: the stop must come at or before)
STOP_PARITY = {
    "minimum_epsilon": (_min_eps_build, 4,
                        lambda: {"max_nr_populations": 14,
                                 "minimum_epsilon": 0.25},
                        "Stopping: minimum epsilon reached", 2, 12),
    "min_acceptance_rate": (_min_rate_build, 3,
                            lambda: {"max_nr_populations": 14,
                                     "min_acceptance_rate": 0.1},
                            "Stopping: acceptance rate too low", 2, 12),
    "simulation_budget": (_budget_build, 2, _budget_run_kwargs,
                          "Stopping: simulation budget exhausted", 2, 3),
    "simulation_budget_less_one": (
        _budget_build, 2, lambda: _budget_run_kwargs(less=1),
        "Stopping: simulation budget exhausted", 2, 3),
    "temperature": (_temperature_build, 3,
                    lambda: {"max_nr_populations": 7},
                    "Stopping: temperature reached 1", 1, 5),
    # the run's last generation pins T = 1 (final_rel in the dispatch,
    # the final mask in a block)
    "temperature_last_generation": (_temperature_build, 2,
                                    lambda: {"max_nr_populations": 3},
                                    "Stopping: temperature reached 1", 1,
                                    2),
    "single_model_alive": (_single_model_build, 3,
                           lambda: {"max_nr_populations": 14},
                           "Stopping: single model alive", 2, 12),
}


@pytest.mark.parametrize("criterion", sorted(STOP_PARITY))
def test_onedispatch_stop_parity(criterion):
    build, K, run_kwargs, reason, n_models, last_t = STOP_PARITY[criterion]
    kwargs = run_kwargs()
    a_o = build("onedispatch", K)
    h_o = a_o.run(**kwargs)
    a_f = build("auto", K)
    h_f = a_f.run(**kwargs)
    a_s = build("auto", 1)
    h_s = a_s.run(**kwargs)
    assert (a_o.stop_reason, a_f.stop_reason, a_s.stop_reason) == \
        (reason,) * 3
    assert a_o.run_dispatches == 1
    assert "onedispatch" in _paths(a_o), _paths(a_o)
    _assert_same_populations(h_o, h_f, n_models)
    assert h_o.max_t <= last_t
    if criterion.startswith("simulation_budget"):
        # the exact boundary: generation 3 itself on every engine
        assert h_o.max_t == h_s.max_t == 3
    if criterion == "temperature_last_generation":
        assert h_o.max_t == h_s.max_t == 2


# ---- across packages --------------------------------------------------------


@pytest.fixture(scope="module")
def jax_onedispatch_run():
    """The JAX package's one-dispatch run of ``_onedispatch_abc``'s
    configuration (pop 200, ``ConstantEpsilon(0.2)``, 7 generations)."""
    models, priors, distance, observed, posterior_fn = jax_problem()
    abc = jpt.ABCSMC(models, priors, distance, population_size=200,
                     eps=jpt.ConstantEpsilon(0.2),
                     sampler=jpt.VectorizedSampler(min_batch_size=2048,
                                                   max_batch_size=2048),
                     fuse_generations=2, run_mode="onedispatch",
                     history_mode="eager", seed=0)
    abc.new("sqlite://", observed)
    h = abc.run(max_nr_populations=7)
    return abc, h


def _last_generation(history):
    """(p(B), E[μ_B], σ of μ_B under model B, ESS of the population)."""
    t = history.max_t
    pop = history.get_population(t)
    w = np.asarray(pop.weight, np.float64)
    w = w / w.sum()
    ess = 1.0 / np.sum(w ** 2)
    p_b = float(w[np.asarray(pop.m) == 1].sum())
    df, wb = history.get_distribution(m=1, t=t)
    wb = np.asarray(wb, np.float64) / np.sum(wb)
    mu = df["mu"].to_numpy(np.float64)
    mean = float(mu @ wb)
    return p_b, mean, float(np.sqrt(wb @ (mu - mean) ** 2)), ess


def test_onedispatch_posterior_agrees_across_packages(jax_onedispatch_run):
    a_j, h_j = jax_onedispatch_run
    a_p = _onedispatch_abc()
    h_p = a_p.run(max_nr_populations=7)
    assert h_p.max_t == h_j.max_t == 6
    assert a_p.run_dispatches == a_j.run_dispatches == 1
    pb_j, mu_j, sd_j, ess_j = _last_generation(h_j)
    pb_p, mu_p, sd_p, ess_p = _last_generation(h_p)
    ess = min(ess_j, ess_p)
    # p(B): binomial spread at the ESS, both runs' noise
    sig_p = np.sqrt(2 * pb_j * (1 - pb_j) / ess)
    assert abs(pb_p - pb_j) <= 4 * sig_p, (pb_p, pb_j, sig_p)
    # E[μ_B]: the posterior spread over model B's share of the ESS
    sig_mu = np.sqrt(sd_j ** 2 / (pb_j * ess_j) + sd_p ** 2 / (pb_p * ess_p))
    assert abs(mu_p - mu_j) <= 4 * sig_mu, (mu_p, mu_j, sig_mu)
