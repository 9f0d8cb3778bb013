"""The port's pipelined engine (``ABCSMC._run_pipelined``) on the CPU.

Twins of ``tests/test_wire_streaming.py:107-238``: the ingest depth
changes when work happens, never what is computed (depth 2 and depth 0
write the same History bits, with K = 1 and with K = 2 blocks);
``ingest_mode="sequential"`` and a small population under ``"auto"`` take
the classic loop, while a device-eligible run at pop >= 2^17 takes the
pipeline and lazy rows by default; the pipeline's posterior agrees with
the sequential loop's and with the JAX package's pipeline within the
bounds of the JAX package's ``test_overlap_posterior_matches_sequential_
mode`` (means within 0.15, the last ε within half); a stop behind
speculative blocks rewinds them and counts them in the ledger; a fetch
that fails on the worker raises within one generation and leaves a
loadable database; an adaptive distance's in-block refit pre-seeds the
next block's weights.
"""

import numpy as np
import pytest

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
import pyabc_tpu_torch.sampler.base as sampler_base
import pyabc_tpu_torch.smc as smc
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.wire import WireError, transfer


def _history_rows(abc):
    rows = {}
    for t in range(abc.history.max_t + 1):
        pop = abc.history.get_population(t=t)
        rows[t] = (pop.theta, pop.weight, pop.m, pop.distance)
    return rows


def _assert_same_rows(a, b):
    ra, rb = _history_rows(a), _history_rows(b)
    assert ra.keys() == rb.keys()
    for t in ra:
        for xa, xb in zip(ra[t], rb[t]):
            np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(
        a.history.get_all_populations().epsilon.to_numpy(),
        b.history.get_all_populations().epsilon.to_numpy())


def _run(pop=300, gens=3, db="sqlite://", **kw):
    kw.setdefault("ingest_mode", "overlap")
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=pop,
                    sampler=pt.VectorizedSampler(device="cpu"), seed=3,
                    device="cpu", **kw)
    abc.new(db, observed)
    abc.run(max_nr_populations=gens)
    return abc


@pytest.mark.parametrize("K", [1, 2])
def test_depth_invariance(K):
    """Depth 2 (overlapped) and depth 0 (inline) write the same bits,
    with K = 1 blocks (the default at scale) and with K = 2."""
    kw = dict(gens=4, fuse_generations=K)
    if K > 1:
        kw["eps"] = pt.QuantileEpsilon(alpha=0.5)
    a = _run(ingest_depth=2, **kw)
    b = _run(ingest_depth=0, **kw)
    assert "pipelined" in {r["path"] for r in a.timeline}
    assert [r["path"] for r in a.timeline] == [r["path"] for r in b.timeline]
    assert [r["rounds"] for r in a.timeline if r["path"] == "pipelined"] \
        == [r["rounds"] for r in b.timeline if r["path"] == "pipelined"]
    _assert_same_rows(a, b)


def test_sequential_mode_and_small_auto_take_the_classic_loop():
    def run(mode):
        models, priors, distance, observed, _ = make_two_gaussians_problem()
        abc = pt.ABCSMC(models, priors, distance, population_size=200,
                        sampler=pt.VectorizedSampler(device="cpu"), seed=3,
                        device="cpu", ingest_mode=mode)
        assert not abc._overlap_enabled()
        abc.new("sqlite://", observed)
        abc.run(max_nr_populations=3)
        assert {r["path"] for r in abc.timeline} == {"sequential"}
        return abc

    _assert_same_rows(run("sequential"), run("auto"))


def test_auto_pipelines_a_device_eligible_run_from_overlap_min_pop():
    """Through the normal entry point, a device-eligible run at pop >=
    2^17 takes the pipelined engine and lazy rows, as in the JAX
    package; "sequential", a one-dispatch run or an ineligible chain
    does not."""
    models, priors, distance, _, _ = make_two_gaussians_problem()

    def abc(pop, **kw):
        return pt.ABCSMC(models, priors, distance, population_size=pop,
                         sampler=pt.VectorizedSampler(device="cpu"),
                         device="cpu", **kw)

    big = pt.ABCSMC.OVERLAP_MIN_POP
    assert big == jpt.ABCSMC.OVERLAP_MIN_POP == 1 << 17
    assert abc(big)._overlap_enabled()
    assert abc(big).history_mode == "lazy"
    assert not abc(big - 1)._overlap_enabled()
    assert abc(big - 1, ingest_mode="overlap")._overlap_enabled()
    assert not abc(big, ingest_mode="sequential")._overlap_enabled()
    assert not abc(big, run_mode="onedispatch",
                   fuse_generations=2)._overlap_enabled()
    stoch = pt.ABCSMC(
        models, priors, pt.IndependentNormalKernel(var=[1.0]),
        population_size=big, eps=pt.Temperature(),
        acceptor=pt.StochasticAcceptor(),
        sampler=pt.VectorizedSampler(device="cpu"), device="cpu",
        ingest_mode="overlap")
    assert not stoch._overlap_enabled()
    with pytest.raises(ValueError, match="ingest_mode"):
        abc(100, ingest_mode="async")


def _post_mean(abc):
    pop = abc.history.get_population()
    th = np.asarray(pop.theta)[:, 0]
    w = np.asarray(pop.weight)
    return float((th * w).sum() / w.sum())


def _last_eps(abc):
    return abc.history.get_all_populations().epsilon.to_numpy()[-1]


def test_posterior_matches_the_sequential_loop_and_the_jax_package():
    """Pop 800, 4 generations: the pipeline against the port's classic
    loop and against the JAX package's pipeline."""
    ov = _run(pop=800, gens=4, ingest_depth=2)
    seq = _run(pop=800, gens=4, ingest_mode="sequential")
    models, priors, distance, observed, _ = jax_problem()
    ref = jpt.ABCSMC(models, priors, distance, population_size=800,
                     sampler=jpt.VectorizedSampler(), seed=3,
                     ingest_mode="overlap", ingest_depth=2)
    ref.new("sqlite://", observed)
    ref.run(max_nr_populations=4)
    for other in (seq, ref):
        assert abs(_post_mean(ov) - _post_mean(other)) < 0.15
        assert abs(_last_eps(ov) - _last_eps(other)) \
            / max(_last_eps(other), 1e-9) < 0.5


def test_ledger_moves_and_generation_transfer():
    before = transfer.snapshot()
    abc = _run(gens=3, ingest_depth=2)
    d = transfer.delta(before)
    assert d["d2h_bytes"] > 0 and d["d2h_mb_per_s"] > 0.0
    assert d["compute_s"] >= 0.0 and d["overlap_s"] >= 0.0
    assert d["fetch_s"] >= d["d2h_s"] - 1e-9
    assert sorted(abc.generation_transfer) == [0, 1, 2]
    for row in abc.timeline:
        assert row["overlap_s"] >= 0.0 and row["d2h_s"] >= 0.0
    before = transfer.snapshot()
    _run(gens=3, ingest_depth=0)
    assert transfer.delta(before)["overlap_s"] == 0.0


def test_stop_behind_speculative_blocks_rewinds_them():
    """ε reaches the minimum at t = 2 while t = 3 is already dispatched at
    depth 2: the block is abandoned, counted as a rewind, and neither its
    rows nor its simulations reach the run — depth 0 writes the same."""
    probe = _run(gens=4, ingest_depth=0, history_mode="eager")
    eps2 = float(probe.history.get_all_populations().epsilon.iloc[3])
    models, priors, distance, observed, _ = make_two_gaussians_problem()

    def run(depth):
        abc = pt.ABCSMC(models, priors, distance, population_size=300,
                        sampler=pt.VectorizedSampler(device="cpu"), seed=3,
                        device="cpu", ingest_mode="overlap",
                        ingest_depth=depth)
        abc.new("sqlite://", observed)
        abc.run(minimum_epsilon=eps2, max_nr_populations=6)
        return abc

    before = transfer.snapshot()
    a = run(2)
    rewinds = transfer.delta(before)["rewinds"]
    b = run(0)
    assert a.stop_reason == b.stop_reason == smc.STOP_EPS
    assert a.history.max_t == b.history.max_t == 2
    assert rewinds >= 1
    _assert_same_rows(a, b)
    np.testing.assert_array_equal(
        a.history.get_all_populations().samples.to_numpy(),
        b.history.get_all_populations().samples.to_numpy())
    assert a._store.resident_ts() == []


def test_injected_fetch_failure_surfaces(monkeypatch, tmp_path):
    """A fetch that fails on the ingest worker aborts the run with a
    WireError within one generation; the database stays loadable and
    resumable."""
    db = "sqlite:///" + str(tmp_path / "flaky.db")
    real = sampler_base.fetch_to_host
    calls = {"n": 0}

    def flaky(tree, ready=None):
        calls["n"] += 1
        if calls["n"] > 2:
            raise OSError("d2h brownout")
        return real(tree, ready)

    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=300,
                    sampler=pt.VectorizedSampler(device="cpu"), seed=3,
                    device="cpu", ingest_mode="overlap", ingest_depth=2,
                    history_mode="eager")
    abc.new(db, observed)
    monkeypatch.setattr(sampler_base, "fetch_to_host", flaky)
    monkeypatch.setattr(smc, "fetch_to_host", flaky)
    with pytest.raises(WireError, match="brownout"):
        abc.run(max_nr_populations=5)
    monkeypatch.undo()
    abc2 = pt.ABCSMC(models, priors, distance, population_size=300,
                     sampler=pt.VectorizedSampler(device="cpu"), seed=4,
                     device="cpu", ingest_mode="sequential")
    abc2.load(db)
    t_before = abc2.history.max_t
    assert t_before <= 1
    abc2.run(max_nr_populations=2)
    assert abc2.history.max_t >= t_before + 1


def test_adaptive_distance_preseeds_each_next_block():
    """The in-block refit's weights reach the host schedule at each block
    exit, so every block after the first runs from a pre-seeded weight
    vector; the posterior stays with the sequential loop's."""
    models, priors, _, observed, _ = make_two_gaussians_problem()

    def make(mode):
        abc = pt.ABCSMC(models, priors, pt.AdaptivePNormDistance(),
                        population_size=600, eps=pt.ConstantEpsilon(0.25),
                        sampler=pt.VectorizedSampler(device="cpu"), seed=8,
                        ingest_mode=mode)
        abc.new("sqlite://", observed)
        abc.run(max_nr_populations=5)
        return abc

    ov = make("overlap")
    blocks = [r["t"] for r in ov.timeline if r["path"] == "pipelined"]
    assert blocks[:2] == [1, 2], blocks
    weights = ov.distance_function.weights
    for t in blocks[1:]:
        assert t in weights and np.all(np.isfinite(weights[t]))
    seq = make("sequential")
    assert abs(_post_mean(ov) - _post_mean(seq)) < 0.15
