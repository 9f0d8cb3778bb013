"""Twins of ``tests/test_serve_cb.py``: continuous batching on the port's
study axis, on the CPU.

The JAX package's contracts, held by the port:

- lane-turnover bit identity: a study admitted into a freed lane
  mid-batch returns exactly the bytes of the same study seated at window
  0 of a fresh batch of the same shape;
- zero program builds (``xla_compiles_total``) across consecutive lane
  turnovers at a fixed batch shape;
- batch-shape hysteresis and a lossless shrink transplant (the port's
  lanes share no op, so the shrunk lane is bit-identical on every key,
  ``dist`` included: no cross-rung carve-out);
- drain at a window boundary keeps retired lanes' publishes and requeues
  the unfinished lanes whole;
- keyed claims filter by ``batch_key`` and keep aged-priority order.

And the ``serve.window`` fault site, between windows after the
publishes: a ``KeyboardInterrupt`` raised there (an interrupt, not a
failure: the session's ``except Exception`` does not take it) leaves the
retired lane published and the unfinished lanes requeued whole by
``run_forever``'s drain; an ``OSError`` there is a session failure, and
as in the JAX package the unfinished lanes are failed while the retired
lane keeps its tombstone.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import pyabc_tpu_torch as pt
from pyabc_tpu_torch.autotune import (compile_counters,
                                      install_compile_listener)
from pyabc_tpu_torch.resilience import faults
from pyabc_tpu_torch.serve import (ServeWorker, ShapeHysteresis,
                                   StudyBatch, StudyQueue, StudySpec)
from pyabc_tpu_torch.serve.multiplex import batch_key

_worker = functools.partial(ServeWorker, device="cpu")
_batch = functools.partial(StudyBatch, device="cpu")


def _model(generator, theta):
    """Quickstart-shaped simulator; module-level because queue
    submissions pickle the spec, like a tenant's importable model."""
    noise = 0.1 * torch.randn(theta.shape[0], 1, generator=generator,
                              device=theta.device)
    return {"y": theta[:, :1] + noise}


def _spec(pop=100, seed=0, tenant="default", y=0.4, **kw):
    return StudySpec(
        model=_model,
        prior=pt.Distribution(mu=pt.RV("uniform", -1.0, 2.0)),
        observed={"y": float(y)}, population_size=pop,
        seed=seed, tenant=tenant,
        max_generations=kw.pop("max_generations", 3), **kw)


def _drain(batch):
    """Step windows until every occupied lane stopped; returns
    {slot: result} snapshots taken at each lane's own boundary."""
    out = {}
    for _ in range(64):
        for slot in batch.step_window():
            out[slot] = batch.result(slot)
            batch.retire(slot)
        if not batch.unfinished():
            break
    assert not batch.unfinished(), "batch never drained"
    return out


def _assert_same_bits(got, want, context=""):
    assert set(got) == set(want)
    for k in sorted(got):
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert np.array_equal(a, b), f"{context}{k}"


# ---------------------------------------------------------------------------
# lane turnover: bit identity + zero recompiles
# ---------------------------------------------------------------------------

def test_lane_turnover_bit_identity():
    """THE continuous-batching gate: a study admitted into a lane
    freed mid-batch (after its predecessor retired at a window
    boundary) is BITWISE equal — every key, including the distance
    diagnostic — to the same study seated at window 0 of a fresh
    batch of the same shape, because both run the SAME compiled
    program with the admission masked in per-lane."""
    programs = {}
    long0 = _spec(pop=100, seed=0, y=0.2, max_generations=3)
    short = _spec(pop=100, seed=1, y=-0.1, max_generations=2)
    late = _spec(pop=100, seed=2, y=0.5, max_generations=3)

    batch = _batch([long0, short], program_cache=programs, window=1)
    results = {}
    admitted_late = False
    for _ in range(64):
        for slot in batch.step_window():
            spec = batch.slots[slot]
            results[spec.seed] = batch.result(slot)
            batch.retire(slot)
            if not admitted_late:  # the turnover under test
                assert batch.admit(late) == slot
                admitted_late = True
        if admitted_late and not batch.unfinished():
            break
    assert admitted_late and batch.turnovers >= 2
    assert set(results) == {0, 1, 2}

    # reference: each study at window 0 of a fresh same-shape batch,
    # SAME program cache — the compiled fn is shared, so equality is
    # byte-for-byte on every key (no cross-rung dist carve-out needed)
    for spec in (long0, short, late):
        dummy = _spec(pop=100, seed=90 + spec.seed, y=0.0)
        ref = _batch([spec, dummy], program_cache=programs,
                         window=1)
        assert ref.program_cache_hit
        _assert_same_bits(results[spec.seed], _drain(ref)[0],
                          context=f"seed {spec.seed}: ")


def test_zero_recompiles_across_lane_turnovers():
    """Three consecutive admit/retire turnovers at a fixed batch shape
    re-enter the pooled program: XLA compile delta is ZERO after the
    first window (the ISSUE's headline counter-assertion)."""
    install_compile_listener()
    programs = {}
    batch = _batch(
        [_spec(pop=100, seed=0, max_generations=2),
         _spec(pop=100, seed=1, max_generations=2)],
        program_cache=programs, window=1)
    batch.step_window()  # first dispatch pays the one compile
    n0 = compile_counters()["n_compiles"]
    waiting = [_spec(pop=100, seed=s, max_generations=2)
               for s in (10, 11, 12)]
    for _ in range(64):
        for slot in batch.step_window():
            batch.retire(slot)
            if waiting:
                batch.admit(waiting.pop(0), slot=slot)
        if not waiting and not batch.unfinished():
            break
    assert not batch.unfinished()
    assert batch.turnovers >= 3 and batch.admitted == 5
    assert compile_counters()["n_compiles"] == n0, (
        "lane turnover re-traced the batch program")


# ---------------------------------------------------------------------------
# hysteresis + shrink
# ---------------------------------------------------------------------------

def test_shape_hysteresis_prefers_refill_over_shrink():
    h = ShapeHysteresis(shrink_after=3)
    # two underfilled windows: not enough evidence yet
    assert not h.observe(1, 4)
    assert not h.observe(1, 4)
    # a refill lands: streak resets (refill beat shrink)
    assert not h.observe(3, 4)
    # sustained underfill: the THIRD consecutive window triggers
    assert not h.observe(1, 4)
    assert not h.observe(1, 4)
    assert h.observe(1, 4)
    # ...and the trigger consumed the streak
    assert not h.observe(1, 4)
    # rung 1 can never shrink; an empty batch never shrinks mid-drain
    for _ in range(5):
        assert not h.observe(1, 1)
        assert not h.observe(0, 4)


def test_shrink_transplants_inflight_lanes():
    """A shrink mid-run moves every occupied lane's carry onto the
    narrower rung losslessly: the survivor finishes with the same
    populations as an all-solo run (dist gets the documented 1-ULP
    cross-rung carve-out), and the turnover counters carry over."""
    programs = {}
    survivor = _spec(pop=100, seed=0, y=0.2, max_generations=4)
    batch = _batch(
        [survivor, _spec(pop=100, seed=1, max_generations=2),
         _spec(pop=100, seed=2, max_generations=2)],
        program_cache=programs, window=1)
    assert batch.rung == 4
    finished = batch.step_window()
    for slot in finished:
        batch.retire(slot)
    assert batch.occupied() == 1 and batch.occupancy() == 0.25
    small, slot_map = batch.shrink(program_cache=programs)
    assert small.rung == 1 and slot_map == {0: 0}
    assert small.turnovers == batch.turnovers
    assert small.admitted == batch.admitted
    got = _drain(small)[0]
    want = _drain(_batch([survivor], program_cache=programs,
                             window=1))[0]
    _assert_same_bits(got, want)


# ---------------------------------------------------------------------------
# the windowed queue loop: early publish, drain, refill
# ---------------------------------------------------------------------------

def test_drain_mid_session_keeps_publishes_requeues_rest(
        tmp_path, monkeypatch):
    """SIGTERM between windows: the lane that retired before the drain
    keeps its tombstone (early publish is durable), every unfinished
    lane is requeued whole with its bounce counted."""
    monkeypatch.setenv("PYABC_TPU_SERVE_MULTIPLEX", "4")
    monkeypatch.setenv("PYABC_TPU_SERVE_CB_WINDOW", "1")
    queue = StudyQueue(root=str(tmp_path))
    t_short = queue.submit(_spec(seed=0, max_generations=2))
    t_long = queue.submit(_spec(seed=1, max_generations=6))
    worker = _worker(root=str(tmp_path))
    publish = worker._cb_publish_lane

    def publish_then_drain(*args, **kw):
        publish(*args, **kw)  # the SIGTERM lands after this publish
        worker.drain()
    monkeypatch.setattr(worker, "_cb_publish_lane", publish_then_drain)
    served = worker.run_forever(queue, once=True)
    assert served == 1
    stats = queue.stats()
    assert (stats["pending"], stats["claimed"], stats["done"],
            stats["failed"]) == (1, 0, 1, 0)
    tomb = json.load(open(os.path.join(
        queue.root, "done", f"{t_short.id}.json"), encoding="utf-8"))
    assert tomb["engine"] == "multiplex"
    (back,) = queue.pending()
    assert back.id == t_long.id and back.requeues == 1


def test_refill_claims_same_key_work_mid_session(tmp_path, monkeypatch):
    """Four same-``batch_key`` studies against a width-2 worker drain
    in ONE windowed session: the two claimed up front seed the batch,
    the other two join through the keyed refill claim as lanes retire.
    Every lane's trace carries its join/retire markers."""
    monkeypatch.setenv("PYABC_TPU_SERVE_MULTIPLEX", "2")
    monkeypatch.setenv("PYABC_TPU_SERVE_CB_WINDOW", "1")
    monkeypatch.setenv("PYABC_TPU_SERVE_TRACE", "1")
    queue = StudyQueue(root=str(tmp_path))
    tickets = [queue.submit(_spec(seed=s, y=0.1 * s, max_generations=2))
               for s in range(4)]
    worker = _worker(root=str(tmp_path))
    served = worker.run_forever(queue, once=True)
    assert served == 4
    stats = queue.stats()
    assert (stats["pending"], stats["claimed"], stats["done"],
            stats["failed"]) == (0, 0, 4, 0)
    from pyabc_tpu_torch.telemetry.studytrace import StudyTrace
    for t in tickets:
        trace = StudyTrace.assemble(str(tmp_path), t.id)
        names = trace.event_names()
        assert names.count("lane_joined") == 1, names
        assert names.count("lane_retired") == 1, names
        assert names.index("lane_joined") < names.index("published")


# ---------------------------------------------------------------------------
# keyed claims
# ---------------------------------------------------------------------------

def test_keyed_claim_filters_and_keeps_aged_priority(tmp_path):
    q = StudyQueue(root=str(tmp_path), aging_s=1e9, partitions=1)
    spec_a_low = _spec(pop=100, seed=0, priority=0)
    spec_a_high = _spec(pop=100, seed=1, priority=5)
    spec_b = _spec(pop=200, seed=2)  # pop is program shape: new key
    key_a, key_b = batch_key(spec_a_low), batch_key(spec_b)
    assert key_a != key_b
    t_low = q.submit(spec_a_low)
    t_high = q.submit(spec_a_high)
    t_b = q.submit(spec_b)
    # unknown key starves rather than mis-claims
    assert q.claim("w1", batch_key="f" * 64) is None
    # within a key, aged-priority order is preserved
    assert q.claim("w1", batch_key=key_a).id == t_high.id
    assert q.claim("w1", batch_key=key_a).id == t_low.id
    assert q.claim("w1", batch_key=key_a) is None
    # the other key's work was never touched
    assert q.claim("w1", batch_key=key_b).id == t_b.id


def test_keyed_claim_skips_prestamp_tickets(tmp_path):
    """A pending file submitted before the batch_key stamp existed
    (no ``batch_key`` field) is invisible to keyed claims — never
    mis-grouped — but still served by the plain claim path."""
    q = StudyQueue(root=str(tmp_path), partitions=1)
    spec = _spec(pop=100, seed=0)
    t = q.submit(spec)
    with open(t.path, encoding="utf-8") as f:
        payload = json.load(f)
    del payload["batch_key"]
    with open(t.path, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    assert q.claim("w1", batch_key=batch_key(spec)) is None
    plain = q.claim("w1")
    assert plain is not None and plain.id == t.id


# ---------------------------------------------------------------------------
# the serve.window fault site
# ---------------------------------------------------------------------------

@pytest.fixture
def _plan():
    def install(text):
        return faults.install(faults.FaultPlan.parse(text, seed=0))
    yield install
    faults.uninstall()


def _fault_session(tmp_path, monkeypatch, plan_text, _plan):
    monkeypatch.setenv("PYABC_TPU_SERVE_MULTIPLEX", "4")
    monkeypatch.setenv("PYABC_TPU_SERVE_CB_WINDOW", "1")
    queue = StudyQueue(root=str(tmp_path))
    t_short = queue.submit(_spec(seed=0, max_generations=2))
    t_peers = [queue.submit(_spec(seed=s, max_generations=6))
               for s in (1, 2)]
    worker = _worker(root=str(tmp_path), worker_id="w_fault")
    plan = _plan(plan_text)
    return queue, worker, plan, t_short, t_peers


def test_serve_window_interrupt_requeues_the_rest_whole(
        tmp_path, monkeypatch, _plan):
    queue, worker, plan, t_short, t_peers = _fault_session(
        tmp_path, monkeypatch, "serve.window@1:raise=KeyboardInterrupt",
        _plan)
    with pytest.raises(KeyboardInterrupt):
        worker.run_forever(queue, once=True)
    assert plan.visits(faults.SITE_SERVE_WINDOW) == 1
    stats = queue.stats()
    assert (stats["pending"], stats["claimed"], stats["done"],
            stats["failed"]) == (2, 0, 1, 0)
    tomb = json.load(open(os.path.join(
        queue.root, "done", f"{t_short.id}.json"), encoding="utf-8"))
    assert tomb["engine"] == "multiplex"
    back = sorted(queue.pending(), key=lambda t: t.id)
    assert [t.id for t in back] == sorted(t.id for t in t_peers)
    assert all(t.requeues == 1 and t.load_spec().seed in (1, 2)
               for t in back)
    # the bounced lanes are served whole by the next session
    faults.uninstall()
    assert worker.run_forever(queue, once=True) == 2
    assert queue.stats()["done"] == 3


def test_serve_window_error_fails_the_unfinished_lanes(
        tmp_path, monkeypatch, _plan):
    queue, worker, plan, t_short, t_peers = _fault_session(
        tmp_path, monkeypatch, "serve.window@1:raise=OSError", _plan)
    assert worker.run_forever(queue, once=True) == 1
    stats = queue.stats()
    assert (stats["pending"], stats["claimed"], stats["done"],
            stats["failed"]) == (0, 0, 1, 2)
    for t in t_peers:
        tomb = json.load(open(os.path.join(
            queue.root, "failed", f"{t.id}.json"), encoding="utf-8"))
        assert "OSError" in tomb["error"]
