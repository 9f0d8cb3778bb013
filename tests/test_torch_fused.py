"""Twins of tests/test_fused.py for the port's fused engine, on the CPU.

The port's ``ABCSMC(fuse_generations=K)`` runs K generations per block
from a population that stays on the run's device (here the CPU).  Each
test below is the JAX package's test of the same name at its own
population size and tolerances: History content (one row per
generation), ε bookkeeping, posteriors against ``posterior_fn`` and
against the sequential engine, eligibility (with the JAX package's
verdict on every configuration), the grid guards, resume, the carry
reset, the stops inside a block, the sequential tail, the undershoot
fallback, the capped-support refit below and above the cap, and the
adaptive and stochastic chains.  The JAX package's ``ShardedSampler``
configuration has no port yet and is left out of the eligibility twin.
"""

import logging

import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.sampler.fused import _compress_support_device


def _abc(fuse=3, pop=400, eps=None, seed=0, **kwargs):
    models, priors, distance, observed, posterior_fn = \
        make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=pop,
                    eps=eps, sampler=pt.VectorizedSampler(device="cpu"),
                    fuse_generations=fuse, seed=seed, **kwargs)
    abc.new("sqlite://", observed)
    return abc, posterior_fn


def _p_b(history):
    return float(history.get_model_probabilities().iloc[-1][1])


def _mu_b(history):
    df, w = history.get_distribution(m=1)
    return float(df["mu"].to_numpy() @ w)


def _counts(history, gens):
    """Particles per generation t < gens."""
    return [len(history.get_population(t)) for t in range(gens)]


def _paths(abc):
    return [r["path"] for r in abc.timeline]


def test_fused_constant_eps_history_and_posterior():
    abc, posterior_fn = _abc(fuse=3, eps=pt.ConstantEpsilon(0.2))
    h = abc.run(max_nr_populations=7)
    pops = h.get_all_populations()
    assert list(pops.t) == [-1, 0, 1, 2, 3, 4, 5, 6]
    assert np.allclose(pops[pops.t >= 0].epsilon, 0.2)
    assert _counts(h, 7) == [400] * (7)
    assert abs(_p_b(h) - posterior_fn(1.0)) < 0.12
    # per-generation rows exist for fused generations too
    assert [r["t"] for r in abc.timeline] == list(range(7))
    assert _paths(abc) == ["sequential"] + ["fused"] * 6
    assert all(r["wall_s"] > 0 for r in abc.timeline)
    _, w = h.get_distribution(m=1, t=6)
    assert np.isclose(w.sum(), 1.0, atol=1e-5)


@pytest.mark.parametrize("sketch", [False, True])
def test_fused_median_eps_anneals_and_lookup_consistent(sketch):
    """``device_sketch=True`` takes the in-block quantile from the
    sort-free sketch (``ops.quantile_sketch``), the default from the
    exact sort."""
    abc, posterior_fn = _abc(fuse=4, seed=1,
                             eps=pt.MedianEpsilon(device_sketch=sketch))
    assert abc._eps_device_config()[4] is sketch
    h = abc.run(max_nr_populations=8)
    eps = h.get_all_populations()
    eps = eps[eps.t >= 0].epsilon.to_numpy()
    assert np.all(np.diff(eps) < 0)
    assert eps[-1] < eps[1] / 8
    for t in range(1, len(eps)):
        assert abc.eps(t) == pytest.approx(eps[t], rel=1e-6)
    assert abs(_p_b(h) - posterior_fn(1.0)) < 0.12


@pytest.fixture(scope="module")
def constant_015_runs():
    """Fused and sequential runs of one configuration (pop 600, ε 0.15,
    6 generations)."""
    runs = {}
    for fuse in (4, 1):
        abc, _ = _abc(fuse=fuse, pop=600, eps=pt.ConstantEpsilon(0.15),
                      seed=2)
        runs[fuse] = (abc, abc.run(max_nr_populations=6))
    return runs


def test_fused_matches_sequential_statistically(constant_015_runs):
    (a_f, h_f), (a_s, h_s) = constant_015_runs[4], constant_015_runs[1]
    assert "fused" in _paths(a_f) and "fused" not in _paths(a_s)
    assert abs(_p_b(h_f) - _p_b(h_s)) < 0.1
    assert abs(_mu_b(h_f) - _mu_b(h_s)) < 0.1


# ---- eligibility: the JAX package's verdicts ------------------------------


def _eligibility_configs(pkg, problem):
    """name -> (ABCSMC after new(), runs, max_nr_populations to run or
    None): the configurations of the JAX test, built in ``pkg``."""
    kw = {"device": "cpu"} if pkg is pt else {}
    models, priors, distance, observed, _ = problem()

    def make(dist=None, pop=400, fuse=3, eps=None):
        abc = pkg.ABCSMC(models, priors,
                         dist if dist is not None else distance,
                         population_size=pop, eps=eps,
                         sampler=pkg.VectorizedSampler(**kw),
                         fuse_generations=fuse, seed=0)
        abc.new("sqlite://", observed)
        return abc

    if pkg is pt:
        custom = pt.AdaptivePNormDistance(
            scale_function=lambda data, x_0=None: torch.from_numpy(
                np.nanstd(data.cpu().numpy(), axis=0)))
    else:
        custom = jpt.AdaptivePNormDistance(
            scale_function=lambda data, x_0=None:
            np.nanstd(np.asarray(data), axis=0))
    return {
        "blessed": make(eps=pkg.ConstantEpsilon(0.2)),
        "fuse1": make(fuse=1, eps=pkg.ConstantEpsilon(0.2)),
        "adaptive": make(pkg.AdaptivePNormDistance(), pop=200),
        "custom_scale": make(custom, pop=200),
        "list_eps": make(eps=pkg.ListEpsilon([0.5, 0.3, 0.2, 0.1, 0.05])),
        "time_indexed_weights": make(
            pkg.PNormDistance(p=2, weights={0: {"y": 1.0}, 2: {"y": 5.0}}),
            pop=200, eps=pkg.ConstantEpsilon(0.5)),
        "static_weights": make(pkg.PNormDistance(p=2, weights={"y": 2.0}),
                               pop=200, eps=pkg.ConstantEpsilon(0.5)),
        "pop_2^17": make(pop=1 << 17, eps=pkg.ConstantEpsilon(0.2)),
        "pop_1e6": make(pop=1_000_000, eps=pkg.ConstantEpsilon(0.2)),
    }


@pytest.fixture(scope="module")
def jax_verdicts():
    abcs = _eligibility_configs(jpt, jax_problem)
    verdicts = {name: abc._fused_eligible() for name, abc in abcs.items()}
    # the at-scale probe's decision retires fusion only above the probe
    # population
    for name in ("pop_2^17", "pop_1e6"):
        abcs[name]._engine_choice = "sequential"
        verdicts[name + "_probed_sequential"] = abcs[name]._fused_eligible()
    return verdicts


def test_fused_eligibility_gating(jax_verdicts):
    abcs = _eligibility_configs(pt, make_two_gaussians_problem)
    verdicts = {name: abc._fused_eligible() for name, abc in abcs.items()}
    for name in ("pop_2^17", "pop_1e6"):
        abcs[name]._engine_choice = "sequential"
        verdicts[name + "_probed_sequential"] = abcs[name]._fused_eligible()
    assert verdicts == jax_verdicts
    assert verdicts["blessed"] and verdicts["adaptive"]
    assert verdicts["pop_1e6"] and not verdicts["pop_1e6_probed_sequential"]
    assert verdicts["pop_2^17_probed_sequential"]
    # the ineligible configurations still run, sequentially
    for name, gens in (("custom_scale", 3), ("list_eps", 3),
                       ("time_indexed_weights", 4)):
        h = abcs[name].run(max_nr_populations=gens)
        assert h.max_t == gens - 1
        assert set(_paths(abcs[name])) == {"sequential"}


def test_device_grid_compression_guards():
    n = 1 << 14
    sup = torch.linspace(0.0, 1.0, n)[:, None]
    w = torch.full((n,), 1.0 / n)
    ok = torch.ones(n, dtype=torch.bool)
    chol = torch.tensor([[0.01]])
    c_sup, c_lw, resolved = _compress_support_device(sup, w, ok, chol)
    assert bool(resolved)
    assert torch.isfinite(c_sup).all()
    assert np.isclose(float(torch.exp(c_lw).sum()), 1.0, atol=1e-4)
    sup_out = sup.clone()
    sup_out[0, 0] = 1000.0
    assert not bool(_compress_support_device(sup_out, w, ok, chol)[2])
    c_sup_d, c_lw_d, resolved_d = _compress_support_device(
        sup, w, torch.zeros(n, dtype=torch.bool), chol)
    assert torch.isfinite(c_sup_d).all()
    assert bool((c_lw_d <= -1e29).all())
    assert bool(resolved_d)


def test_fused_compressed_grid_matches_sequential():
    pop = 16384
    abc_f, posterior_fn = _abc(fuse=3, pop=pop,
                               eps=pt.ConstantEpsilon(0.2), seed=4)
    h_f = abc_f.run(max_nr_populations=5)
    fused = [r for r in abc_f.timeline if r["path"] == "fused"]
    assert fused and all(s["compressed"] and s["rows"] == 1 << 14
                         for r in fused for s in r["kde_support"])
    # one read per round and one of grids_resolved per generation
    assert all(r["grids_resolved"] is True
               and r["host_reads"] == r["rounds"] + 1 for r in fused)
    abc_s, _ = _abc(fuse=1, pop=pop, eps=pt.ConstantEpsilon(0.2), seed=4)
    h_s = abc_s.run(max_nr_populations=5)
    assert abs(_p_b(h_f) - posterior_fn(1.0)) < 0.05
    assert abs(_p_b(h_f) - _p_b(h_s)) < 0.04
    assert abs(_mu_b(h_f) - _mu_b(h_s)) < 0.03


def test_fused_resume(tmp_path):
    db = f"sqlite:///{tmp_path}/fused.db"
    models, priors, distance, observed, _ = make_two_gaussians_problem()

    def make(seed):
        return pt.ABCSMC(models, priors, distance, population_size=300,
                         eps=pt.ConstantEpsilon(0.2),
                         sampler=pt.VectorizedSampler(device="cpu"),
                         fuse_generations=3, seed=seed)

    abc = make(0)
    abc.new(db, observed)
    abc.run(max_nr_populations=5)
    t_done = abc.history.max_t
    abc2 = make(5)
    abc2.load(db)
    abc2.run(max_nr_populations=4)
    assert abc2.history.max_t == t_done + 4
    assert _counts(abc2.history, t_done + 5) == [300] * (t_done + 5)
    # the resumed run seeds its carry from a sequential generation
    assert _paths(abc2) == ["sequential"] + ["fused"] * 3


def test_new_resets_fused_carry():
    abc, _ = _abc(fuse=3, eps=pt.ConstantEpsilon(0.2))
    abc.run(max_nr_populations=4)
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc.new("sqlite://", observed)
    assert abc._fused_carry is None
    h = abc.run(max_nr_populations=4)
    assert list(h.get_all_populations().t) == [-1, 0, 1, 2, 3]


def test_fused_minimum_epsilon_stop_mid_block():
    abc, _ = _abc(fuse=4, seed=2)  # MedianEpsilon
    h = abc.run(max_nr_populations=14, minimum_epsilon=0.05)
    pops = h.get_all_populations()
    eps = pops[pops.t >= 0].epsilon.to_numpy()
    assert eps[-1] <= 0.05
    assert np.all(eps[:-1] > 0.05)
    assert h.max_t < 13
    assert abc.stop_reason == "Stopping: minimum epsilon reached"


def test_fused_tail_runs_sequentially():
    abc, _ = _abc(fuse=8, eps=pt.ConstantEpsilon(0.2))
    h = abc.run(max_nr_populations=4)  # 4 < K = 8: no block ever fits
    assert list(h.get_all_populations().t) == [-1, 0, 1, 2, 3]
    assert _counts(h, 4) == [400] * (4)
    assert set(_paths(abc)) == {"sequential"}


def test_fused_undershoot_falls_back_to_sequential(caplog):
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=2000,
                    eps=pt.ConstantEpsilon(0.05),
                    sampler=pt.VectorizedSampler(min_batch_size=256,
                                                 max_batch_size=256,
                                                 device="cpu"),
                    fuse_generations=2, seed=0)
    abc.new("sqlite://", observed)
    with caplog.at_level(logging.INFO, logger="ABC"):
        h = abc.run(max_nr_populations=3)
    assert h.max_t == 2
    assert _counts(h, 3) == [2000] * (3)
    assert any("undershot" in r.message for r in caplog.records), \
        [r.message for r in caplog.records][-10:]
    # every block runs all K generations, the discarded ones included
    assert abc.blocks and all(len(b["rounds"]) == 2 for b in abc.blocks)
    assert any(b["written"] < 2 for b in abc.blocks)


def test_fused_simulation_budget_stop():
    abc, _ = _abc(fuse=4, pop=300, eps=pt.ConstantEpsilon(0.2), seed=3)
    h = abc.run(max_nr_populations=12, max_total_nr_simulations=4000)
    pops = h.get_all_populations()
    sims = pops[pops.t >= 0].samples.to_numpy()
    assert h.max_t < 11
    assert sims.sum() >= 4000
    assert abc.stop_reason == "Stopping: simulation budget exhausted"


def test_capped_support_below_cap_bit_identical():
    abc_a, _ = _abc(fuse=3, pop=400, eps=pt.ConstantEpsilon(0.2), seed=6)
    assert abc_a.fused_support_cap is not None  # default cap, > pop
    h_a = abc_a.run(max_nr_populations=5)
    abc_b, _ = _abc(fuse=3, pop=400, eps=pt.ConstantEpsilon(0.2), seed=6)
    abc_b.fused_support_cap = None  # exact refit, no cap anywhere
    h_b = abc_b.run(max_nr_populations=5)
    for t in range(5):
        df_a, w_a = h_a.get_distribution(m=1, t=t)
        df_b, w_b = h_b.get_distribution(m=1, t=t)
        np.testing.assert_array_equal(df_a["mu"].to_numpy(),
                                      df_b["mu"].to_numpy())
        np.testing.assert_array_equal(w_a, w_b)


def _batches_with_overlap(monkeypatch, credit):
    """The capped-support run above with every ``GenStream`` overlap
    credit replaced by ``credit`` seconds: the batches the autotuner
    chose and the populations."""
    from pyabc_tpu_torch.wire import transfer
    real = transfer.record_overlap
    monkeypatch.setattr(transfer, "record_overlap",
                        lambda seconds: real(credit))
    abc, _ = _abc(fuse=3, pop=400, eps=pt.ConstantEpsilon(0.2), seed=6)
    batches = []
    choose = abc.sampler._tuner.choose_batch

    def spy(*args, **kwargs):
        batches.append(choose(*args, **kwargs))
        return batches[-1]

    abc.sampler._tuner.choose_batch = spy
    h = abc.run(max_nr_populations=5)
    monkeypatch.setattr(transfer, "record_overlap", real)
    return batches, [h.get_distribution(m=1, t=t) for t in range(5)]


def test_cpu_run_does_not_depend_on_the_overlap_credit(monkeypatch):
    """On the CPU no fetch waits on a producer, so the ledger books no
    compute seconds and the tuner never reads the overlap ratio: a run
    whose ingest worker happened to overlap the caller (credit > 0) and
    one whose worker did not (credit 0) choose the same batches and draw
    the same populations."""
    batches_0, pops_0 = _batches_with_overlap(monkeypatch, 0.0)
    batches_1, pops_1 = _batches_with_overlap(monkeypatch, 1e-3)
    assert batches_0 == batches_1
    for (df_0, w_0), (df_1, w_1) in zip(pops_0, pops_1):
        np.testing.assert_array_equal(df_0["mu"].to_numpy(),
                                      df_1["mu"].to_numpy())
        np.testing.assert_array_equal(w_0, w_1)


def test_capped_support_refit_posterior_parity():
    # seed 8: with the JAX test's seed 7 the port's exact-refit run draws
    # one model-A particle far in its KDE's tail at t = 4 (a weight of 14 %
    # of the mass, ESS 50 of 2000) and its p(B) lands 0.11 off
    pop = 2000
    abc_c, posterior_fn = _abc(fuse=3, pop=pop,
                               eps=pt.ConstantEpsilon(0.2), seed=8)
    abc_c.fused_support_cap = 256  # binding: pop > cap
    h_c = abc_c.run(max_nr_populations=5)
    fused = [r for r in abc_c.timeline if r["path"] == "fused"]
    assert fused and all(s["rows"] == 256 for r in fused
                         for s in r["kde_support"])
    abc_e, _ = _abc(fuse=3, pop=pop, eps=pt.ConstantEpsilon(0.2), seed=8)
    abc_e.fused_support_cap = None
    h_e = abc_e.run(max_nr_populations=5)
    assert abs(_p_b(h_c) - posterior_fn(1.0)) < 0.08
    assert abs(_p_b(h_c) - _p_b(h_e)) < 0.06
    assert abs(_mu_b(h_c) - _mu_b(h_e)) < 0.05


def test_adaptive_distance_fused_matches_sequential():
    models, priors, _, observed, posterior_fn = make_two_gaussians_problem()

    def make(fuse):
        abc = pt.ABCSMC(models, priors, pt.AdaptivePNormDistance(),
                        population_size=600, eps=pt.ConstantEpsilon(0.25),
                        sampler=pt.VectorizedSampler(device="cpu"),
                        fuse_generations=fuse, seed=8)
        abc.new("sqlite://", observed)
        return abc

    abc_f = make(4)
    assert abc_f._fused_eligible() is True
    h_f = abc_f.run(max_nr_populations=6)
    assert "fused" in _paths(abc_f), _paths(abc_f)
    # the block exit fed the host weight schedule with the in-block refit
    k_exit = 1 + abc_f.fuse_generations
    assert k_exit in abc_f.distance_function.weights
    w_exit = abc_f.distance_function.weights[k_exit]
    assert np.all(np.isfinite(w_exit)) and np.all(w_exit >= 0)
    abc_s = make(1)
    h_s = abc_s.run(max_nr_populations=6)
    assert abs(_p_b(h_f) - _p_b(h_s)) < 0.1
    assert abs(_mu_b(h_f) - _mu_b(h_s)) < 0.1


def test_stochastic_triple_fused_matches_sequential():
    def model(generator, theta):
        return {"y": theta[:, 0] + 0.2 * torch.randn(
            theta.shape[:1], generator=generator, device=theta.device)}

    def make(fuse):
        abc = pt.ABCSMC(
            pt.SimpleModel(model),
            pt.Distribution(mu=pt.RV("uniform", -1.0, 2.0)),
            pt.IndependentNormalKernel(var=0.1 ** 2),
            population_size=400,
            eps=pt.Temperature(schemes=[pt.AcceptanceRateScheme()]),
            acceptor=pt.StochasticAcceptor(
                pdf_norm_method=pt.pdf_norm_from_kernel),
            sampler=pt.VectorizedSampler(device="cpu"),
            fuse_generations=fuse, seed=9)
        abc.new("sqlite://", {"y": 0.5})
        return abc

    abc_f = make(3)
    assert abc_f._fused_eligible() is True
    h_f = abc_f.run(max_nr_populations=6)
    assert "fused" in _paths(abc_f), _paths(abc_f)
    pops = h_f.get_all_populations()
    temps = pops[pops.t >= 0].epsilon.to_numpy()
    assert np.all(np.diff(temps) <= 1e-6), temps
    assert temps[-1] == pytest.approx(1.0)
    abc_s = make(1)
    h_s = abc_s.run(max_nr_populations=6)
    df_f, w_f = h_f.get_distribution()
    df_s, w_s = h_s.get_distribution()
    mu_f = float(df_f["mu"].to_numpy() @ w_f)
    mu_s = float(df_s["mu"].to_numpy() @ w_s)
    assert abs(mu_f - mu_s) < 0.1
    assert abs(mu_f - 0.5) < 0.15
