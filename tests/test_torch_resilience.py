"""The port's resilience layer held to the JAX package's
(``pyabc_tpu/resilience``, ``tests/test_resilience.py``): the fault-plan
grammar and its seeded firing, the retry policy's backoff, one table of
exceptions classified alike (a CUDA out-of-memory beside XLA's
``RESOURCE_EXHAUSTED``), and the end-to-end chaos contracts on the CPU —
an injected dispatch fault absorbed bit for bit, fetch and History
faults absorbed, a SIGTERM mid-generation flushed and spliced on resume,
a stale splice discarded, and a ``run.drain`` fault latching the
one-dispatch engine off with the JAX package's engine paths.  A retried
dispatch that failed after its rounds had drawn gives the same
population as a clean run, in every engine; a fatal error raises."""

import sqlite3

import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem
from pyabc_tpu.resilience import faults as jax_faults
from pyabc_tpu.resilience import journal as jax_journal
from pyabc_tpu.resilience import retry as jax_retry
from pyabc_tpu.wire.streaming import WireError as JaxWireError
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.resilience import checkpoint as ckpt
from pyabc_tpu_torch.resilience import faults, journal, retry
from pyabc_tpu_torch.telemetry import REGISTRY
from pyabc_tpu_torch.wire.streaming import WireError

from torch_process_state import clean_process_state  # noqa: F401


def _sampler(**kw):
    kw.setdefault("min_batch_size", 8)
    kw.setdefault("max_batch_size", 64)
    kw.setdefault("max_rounds_per_call", 1)
    return pt.VectorizedSampler(device="cpu", **kw)


def _abc(db_path, seed=11, pop=300, ckpt_rounds=0, models=None, **abc_kw):
    ms, priors, distance, observed, _ = make_two_gaussians_problem()
    sampler_kw = abc_kw.pop("sampler_kw", {})
    abc = pt.ABCSMC(models or ms, priors, distance, population_size=pop,
                    sampler=_sampler(**sampler_kw), seed=seed,
                    checkpoint_every_rounds=ckpt_rounds, **abc_kw)
    if db_path is not None:
        abc.new(db_path, observed)
    return abc


# ---- the fault-plan grammar, seeded firing, backoff -----------------------

PLANS = [
    "wire.fetch@3:raise=ConnectionResetError;preempt@5:sigterm",
    "device.dispatch@2+:delay=0.01",
    "history.append~0.25:raise=OperationalError",
    "journal.write@1:corrupt=3;store.spill@4:sigkill",
    "run.drain@2:raise=TimeoutError;fidelity.calibrate@1:sigkill",
    "store.hydrate@1:corrupt;history.materialize@7:raise=WireError",
]


@pytest.mark.parametrize("text", PLANS)
def test_fault_strings_parse_to_the_jax_specs(text):
    ours = faults.FaultPlan.parse(text, seed=3)
    theirs = jax_faults.FaultPlan.parse(text, seed=3)
    assert len(ours.specs) == len(theirs.specs)
    for a, b in zip(ours.specs, theirs.specs):
        assert (a.site, a.mode, a.arg, a.action) == \
            (b.site, b.mode, b.arg, b.action)
        if isinstance(a.action_arg, type):
            assert a.action_arg.__name__ == b.action_arg.__name__
        else:
            assert a.action_arg == b.action_arg


@pytest.mark.parametrize("bad", [
    "nosuch.site@1:raise=ValueError", "wire.fetch@0:sigterm",
    "wire.fetch:sigterm", "wire.fetch@1", "wire.fetch~2:sigterm",
    "wire.fetch@1:raise=NoSuchError", "wire.fetch@1:corrupt=0",
    "wire.fetch@1:sigkill=3", "wire.fetch@1:explode"])
def test_bad_directives_raise_in_both(bad):
    with pytest.raises(ValueError):
        faults.FaultPlan.parse(bad)
    with pytest.raises(ValueError):
        jax_faults.FaultPlan.parse(bad)


def _fired_visits(mod, text, seed, n=300):
    plan = mod.FaultPlan.parse(text, seed=seed)
    out, before = [], 0
    for v in range(1, n + 1):
        plan.visit("device.dispatch")
        now = sum(plan.fired.values())
        if now > before:
            out.append(v)
        before = now
    return out


@pytest.mark.parametrize("seed", [0, 7])
def test_the_same_seed_fires_at_the_same_visits(seed):
    text = "device.dispatch~0.2:delay=0;device.dispatch@17:delay=0"
    ours = _fired_visits(faults, text, seed)
    assert ours == _fired_visits(jax_faults, text, seed)
    assert 17 in ours and 20 < len(ours) < 120


def test_corrupt_flips_the_same_bits():
    data = bytes(range(256)) * 4
    arr = np.arange(64, dtype=np.float32)
    for d in (data, arr, {"a": arr, "b": arr.astype(np.int64)}):
        a = faults.FaultPlan.parse("journal.write@1:corrupt=5",
                                   seed=2).visit("journal.write", data=d)
        b = jax_faults.FaultPlan.parse("journal.write@1:corrupt=5",
                                       seed=2).visit("journal.write", data=d)
        if isinstance(d, dict):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b))
            assert not np.array_equal(np.asarray(a), np.asarray(d))


def test_disabled_fault_point_passes_data_through():
    blob = b"abc"
    assert faults.fault_point(faults.SITE_FETCH, data=blob) is blob
    assert faults.active_plan() is None


def test_install_from_env(monkeypatch):
    monkeypatch.setenv(faults.FAULTS_ENV, "wire.fetch@2:delay=0")
    monkeypatch.setenv(faults.FAULT_SEED_ENV, "4")
    plan = faults.install_from_env()
    assert plan is faults.active_plan() and plan.seed == 4


@pytest.mark.parametrize("seed", [0, 5])
def test_retry_delays_equal_under_one_seed(seed):
    ours = retry.RetryPolicy(base_delay_s=0.05, seed=seed)
    theirs = jax_retry.RetryPolicy(base_delay_s=0.05, seed=seed)
    assert [ours.delay_s(k) for k in range(1, 9)] == \
        [theirs.delay_s(k) for k in range(1, 9)]


def test_retry_policy_from_env(monkeypatch):
    monkeypatch.setenv(retry.RETRIES_ENV, "5")
    monkeypatch.setenv(retry.RETRY_BASE_ENV, "0.5")
    p = retry.RetryPolicy.from_env()
    assert (p.max_attempts, p.base_delay_s) == (5, 0.5)


def _xla(msg):
    cls = type("XlaRuntimeError", (RuntimeError,), {})
    return cls(msg)


def _chained(wire_cls, cause):
    try:
        raise wire_cls("ingest failed") from cause
    except wire_cls as err:
        return err


# (JAX-side exception, port-side exception, transient?)
TABLE = [
    (ConnectionResetError("x"), ConnectionResetError("x"), True),
    (TimeoutError("x"), TimeoutError("x"), True),
    (sqlite3.OperationalError("database is locked"),
     sqlite3.OperationalError("database is locked"), True),
    (sqlite3.OperationalError("no such table"),
     sqlite3.OperationalError("no such table"), False),
    (OSError(5, "I/O error"), OSError(5, "I/O error"), True),
    (FileNotFoundError("x"), FileNotFoundError("x"), False),
    (ValueError("shape"), ValueError("shape"), False),
    (RuntimeError("boom"), RuntimeError("boom"), False),
    (_xla("RESOURCE_EXHAUSTED: out of memory allocating 4 GiB"),
     torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
     True),
    (_xla("RESOURCE_EXHAUSTED: oom"),
     RuntimeError("CUDA error: out of memory"), True),
    (_xla("INVALID_ARGUMENT: bad shape"), _xla("INVALID_ARGUMENT: x"),
     False),
    (_xla("UNAVAILABLE: socket closed"), _xla("UNAVAILABLE: socket"), True),
    (RuntimeError("buffer has been donated"),
     RuntimeError("buffer has been donated"), False),
    (jax_journal.IntegrityError("crc"), journal.IntegrityError("crc"),
     False),
    (_chained(JaxWireError, ConnectionResetError("x")),
     _chained(WireError, ConnectionResetError("x")), True),
    (_chained(JaxWireError, ValueError("x")),
     _chained(WireError, ValueError("x")), False),
]


@pytest.mark.parametrize("jax_err,our_err,transient", TABLE,
                         ids=[f"row{i}" for i in range(len(TABLE))])
def test_one_exception_table_classified_alike(jax_err, our_err, transient):
    assert jax_retry.is_transient(jax_err) is transient
    assert retry.is_transient(our_err) is transient


@pytest.mark.parametrize("msg", [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: device-side assert triggered",
    "CUDA error: unspecified launch failure",
    "CUDA error: misaligned address",
    "CUDA error: an illegal instruction was encountered"])
def test_sticky_cuda_errors_are_fatal_with_one_attempt(msg):
    err = RuntimeError(msg)
    assert retry.is_sticky_cuda_error(err)
    assert not retry.is_transient(err)
    policy = retry.RetryPolicy(base_delay_s=0.0)
    calls = []

    def fn():
        calls.append(1)
        raise RuntimeError(msg)

    with pytest.raises(RuntimeError, match="CUDA error"):
        policy.call(fn, faults.SITE_DISPATCH)
    assert len(calls) == 1 and policy.last_attempts == 1


def test_retry_exhausts_transient_and_restores_the_generator():
    policy = retry.RetryPolicy(max_attempts=3, base_delay_s=0.0)
    gen = torch.Generator().manual_seed(5)
    draws = []

    def fn():
        draws.append(torch.rand(3, generator=gen))
        raise ConnectionResetError("link")

    with pytest.raises(retry.RetryExhausted) as info:
        policy.call(fn, faults.SITE_DISPATCH, rng=gen)
    assert info.value.attempts == 3
    assert isinstance(info.value.__cause__, ConnectionResetError)
    for d in draws[1:]:
        assert torch.equal(d, draws[0])  # every attempt, the same draws


def test_degrade_rung_halves_to_the_floor():
    s = _sampler(min_batch_size=64, max_batch_size=256)
    before = REGISTRY.to_dict().get("resilience_degrade_total", 0)
    assert s.degrade_rung() == 128
    assert s.degrade_rung() == 64
    assert s.degrade_rung() is None
    assert REGISTRY.to_dict()["resilience_degrade_total"] - before == 2


# ---- end-to-end chaos on the CPU -------------------------------------------


def _assert_same_history(h_a, h_b):
    assert h_a.max_t == h_b.max_t
    for t in range(h_a.max_t + 1):
        a, b = h_a.get_population(t=t), h_b.get_population(t=t)
        np.testing.assert_array_equal(a.theta, b.theta)
        np.testing.assert_array_equal(a.weight, b.weight)


def test_injected_dispatch_fault_absorbed_exactly(tmp_path):
    clean = _abc(str(tmp_path / "clean.db"), seed=21)
    h_clean = clean.run(max_nr_populations=2)
    plan = faults.install(faults.FaultPlan.parse(
        "device.dispatch@3:raise=ConnectionResetError"))
    chaos = _abc(str(tmp_path / "chaos.db"), seed=21)
    h_chaos = chaos.run(max_nr_populations=2)
    assert plan.fired == {(faults.SITE_DISPATCH, "raise"): 1}
    _assert_same_history(h_clean, h_chaos)


def test_injected_fetch_and_append_faults_absorbed(tmp_path):
    faults.install(faults.FaultPlan.parse(
        "wire.fetch@2:raise=ConnectionResetError;"
        "history.append@1:raise=ConnectionResetError"))
    before = REGISTRY.to_dict().get("resilience_retries_total", 0)
    abc = _abc(str(tmp_path / "chaos2.db"), seed=22)
    h = abc.run(max_nr_populations=2)
    assert h.max_t == 1
    assert REGISTRY.to_dict()["resilience_retries_total"] - before >= 2
    for t in range(h.max_t + 1):
        pop = h.get_population(t=t)
        assert pop.theta.shape[0] == 300
        assert np.isclose(pop.weight.sum(), 1.0, atol=1e-5)


class _Flaky:
    """A model function that raises ``exc`` at its ``at``-th call, once:
    by then the round has drawn its proposals."""

    def __init__(self, fn, at, exc):
        self.fn, self.at, self.exc, self.calls = fn, at, exc, 0

    def __call__(self, generator, theta):
        self.calls += 1
        if self.calls == self.at:
            raise self.exc("injected mid-round failure")
        return self.fn(generator, theta)


ENGINES = {
    "sequential": dict(sampler_kw={"max_rounds_per_call": 4}),
    "fused": dict(fuse_generations=2, eps=pt.ConstantEpsilon(0.2),
                  sampler_kw={"min_batch_size": 512,
                              "max_batch_size": 512}),
    "onedispatch": dict(fuse_generations=2, run_mode="onedispatch",
                        eps=pt.ConstantEpsilon(0.2),
                        sampler_kw={"min_batch_size": 512,
                                    "max_batch_size": 512}),
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("exc,fatal", [(ConnectionResetError, False),
                                       (ValueError, True)])
def test_failure_after_rounds_drew_retries_the_same_draws(engine, exc,
                                                          fatal):
    kw = ENGINES[engine]
    clean = _abc("sqlite://", seed=5, pop=200, **{
        k: v for k, v in kw.items()})
    h_clean = clean.run(max_nr_populations=4)
    models, _, _, _, _ = make_two_gaussians_problem()
    flaky = _Flaky(models[1]._fn, at=9, exc=exc)
    models[1]._fn = flaky
    chaos = _abc("sqlite://", seed=5, pop=200, models=models, **{
        k: v for k, v in kw.items()})
    if fatal:
        with pytest.raises(ValueError, match="mid-round"):
            chaos.run(max_nr_populations=4)
        return
    before = REGISTRY.to_dict().get("resilience_retries_total", 0)
    h_chaos = chaos.run(max_nr_populations=4)
    assert flaky.calls > 9
    assert REGISTRY.to_dict()["resilience_retries_total"] - before == 1
    assert [r["path"] for r in chaos.timeline] == \
        [r["path"] for r in clean.timeline]
    _assert_same_history(h_clean, h_chaos)


def test_preemption_mid_generation_flushes_and_resume_splices(tmp_path):
    db = str(tmp_path / "preempt.db")
    probe_plan = faults.install(
        faults.FaultPlan.parse("preempt@1000000:sigterm"))
    probe = _abc(str(tmp_path / "probe.db"), seed=31, ckpt_rounds=1)
    probe.run(max_nr_populations=1)
    v0 = probe_plan.visits(faults.SITE_PREEMPT)
    assert v0 >= 1

    plan = faults.install(
        faults.FaultPlan.parse(f"preempt@{v0 + 2}:sigterm"))
    abc = _abc(db, seed=31, ckpt_rounds=1)
    with pytest.raises(ckpt.Preempted):
        abc.run(max_nr_populations=3)
    faults.uninstall()
    ckpt.clear_preempt()
    assert plan.fired == {(faults.SITE_PREEMPT, "sigterm"): 1}

    assert abc.history.max_t == 0
    row = abc.history.load_sub_checkpoint(1)
    assert row is not None
    assert 1 <= row["n_accepted"] < 300
    assert row["nr_evaluations"] >= row["n_accepted"]
    assert row["batch"]["theta"].shape[0] == row["n_accepted"]

    abc2 = _abc(None, seed=32, ckpt_rounds=1)
    abc2.load(db)
    h = abc2.run(max_nr_populations=2)
    assert h.max_t >= 1
    assert h.load_sub_checkpoint(1) is None
    pops = h.get_all_populations()
    t1 = pops[pops.t == 1].iloc[0]
    assert int(t1.samples) >= row["nr_evaluations"]
    for t in range(h.max_t + 1):
        pop = h.get_population(t=t)
        assert pop.theta.shape[0] == 300
        assert np.isclose(pop.weight.sum(), 1.0, atol=1e-5)


def test_stale_splice_discarded_on_eps_mismatch(tmp_path):
    db = str(tmp_path / "stale.db")
    abc = _abc(db, seed=41, ckpt_rounds=1)
    fake = {"m": np.zeros(5, np.int64),
            "theta": np.zeros((5, 1), np.float32),
            "distance": np.full(5, 0.1, np.float32),
            "log_weight": np.zeros(5, np.float32)}
    abc.history.save_sub_checkpoint(0, fake, rounds=3,
                                    nr_evaluations=192, eps=1e9)
    h = abc.run(max_nr_populations=1)
    assert h.max_t == 0
    assert h.load_sub_checkpoint(0) is None
    assert h.get_population(t=0).theta.shape[0] == 300


def test_checkpointer_cadence_and_second_preemption(tmp_path):
    hist = pt.History("sqlite:///" + str(tmp_path / "cadence.db"))
    hist.id = 1
    ck = ckpt.GenCheckpointer(hist, t=2, every_rounds=4)
    assert not ck.should_flush(3)
    assert ck.should_flush(4)
    base = {"m": np.zeros(4, np.int64),
            "theta": np.full((4, 1), 7.0, np.float32),
            "distance": np.zeros(4, np.float32),
            "log_weight": np.zeros(4, np.float32)}
    ck.set_base(base, nr_evaluations=100)
    fresh = {k: v[:2] + (2.0 if k == "theta" else 0) for k, v in
             base.items()}
    ck.flush(fresh, rounds=4, nr_evaluations=50)
    assert not ck.should_flush(4)
    ckpt.request_preempt()
    try:
        assert ck.should_flush(5)
        with pytest.raises(ckpt.Preempted):
            ck.maybe_raise_preempted()
    finally:
        ckpt.clear_preempt()
    row = hist.load_sub_checkpoint(2)
    assert row["rounds"] == 4 and row["n_accepted"] == 6
    assert row["nr_evaluations"] == 150
    np.testing.assert_allclose(row["batch"]["theta"][:4], 7.0)
    np.testing.assert_allclose(row["batch"]["theta"][4:], 9.0)


def _drain_run(pkg, problem, sampler_kw):
    models, priors, distance, observed, _ = problem()
    abc = pkg.ABCSMC(models, priors, distance, population_size=200,
                     eps=pkg.ConstantEpsilon(0.2),
                     sampler=pkg.VectorizedSampler(min_batch_size=2048,
                                                   max_batch_size=2048,
                                                   **sampler_kw),
                     fuse_generations=2, run_mode="onedispatch", seed=0)
    abc.new("sqlite://", observed)
    h = abc.run(max_nr_populations=6)
    return abc, h


def test_run_drain_fault_latches_onedispatch_off():
    faults.install(faults.FaultPlan.parse(
        "run.drain@2:raise=ConnectionResetError"))
    abc, h = _drain_run(pt, make_two_gaussians_problem, {"device": "cpu"})
    assert h.max_t == 5
    counts = h.get_nr_particles_per_population()
    assert all(counts[t] == 200 for t in range(6))
    assert abc._fault_onedispatch_off is True
    assert abc._onedispatch_eligible() is False
    paths = [r["path"] for r in abc.timeline.to_rows()]
    assert paths[0] == "sequential"
    assert paths[1] == "onedispatch"
    assert "onedispatch" not in paths[2:]
    # the same paths as the JAX package under the same plan
    jax_faults.install(jax_faults.FaultPlan.parse(
        "run.drain@2:raise=ConnectionResetError"))
    jabc, _ = _drain_run(jpt, jax_problem, {})
    assert paths == [r["path"] for r in jabc.timeline.to_rows()]
