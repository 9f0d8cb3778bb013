"""The port's wire layer (``pyabc_tpu_torch/wire``) on the CPU.

Twins of the engine tests of ``tests/test_wire_streaming.py`` (ordering,
backpressure released at harvest, depth 0 inline, the error latch,
abandon), the transfer ledger's counters and egress attribution, the
fetch chokepoint, the wire decode held bit for bit against the JAX
package's ``wire.ingest`` on one input, :class:`GenStream`, and the
autotuner repair: with both packages' ledgers pinned to one
``(compute_s, overlap_s)``, config #2 with fused blocks of 4 takes the
same block paths and the same batches (the sequential redo's included)
in the port as in the JAX package.  The port before the repair fed the
tuner no ledger seconds and took ``sfffsfffsss`` with smaller batches.
"""

import threading
import time

import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu.wire.ingest as jax_ingest
import pyabc_tpu.wire.transfer as jax_transfer
import pyabc_tpu_torch as pt
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.sampler.base import fetch_to_host, mark_ready
from pyabc_tpu_torch.wire import StreamingIngest, WireError, transfer
from pyabc_tpu_torch.wire import ingest


# ---- the engine ------------------------------------------------------------


def test_submit_result_ordering():
    """Tickets resolve to their own submission's value whatever order the
    workers finish in."""
    with StreamingIngest(depth=2) as eng:
        t1 = eng.submit(lambda: (time.sleep(0.1), "first")[1], label="g0")
        t2 = eng.submit(lambda: "second", label="g1")
        assert t1.result(timeout=5.0) == "first"
        assert t2.result(timeout=5.0) == "second"
        assert t1.work_s >= 0.1


def test_backpressure_blocks_submit_until_harvest():
    """depth 1: the slot frees at harvest, not when the worker ends."""
    with StreamingIngest(depth=1) as eng:
        t1 = eng.submit(lambda: "a", label="g0")
        time.sleep(0.05)
        harvested = {}

        def harvest():
            harvested["v"] = t1.result(timeout=5.0)

        timer = threading.Timer(0.3, harvest)
        timer.start()
        start = time.perf_counter()
        t2 = eng.submit(lambda: "b", label="g1")
        blocked = time.perf_counter() - start
        timer.join(5.0)
        assert not timer.is_alive()
        assert blocked >= 0.2, blocked
        assert t2.wait_s >= 0.2
        assert harvested["v"] == "a"
        assert t2.result(timeout=5.0) == "b"


def test_depth_two_admits_two_without_blocking():
    with StreamingIngest(depth=2) as eng:
        start = time.perf_counter()
        t1 = eng.submit(lambda: 1, label="g0")
        t2 = eng.submit(lambda: 2, label="g1")
        assert time.perf_counter() - start < 0.1
        assert [t1.result(5.0), t2.result(5.0)] == [1, 2]


def test_depth_zero_runs_inline():
    """depth 0: the job runs on the caller thread inside submit, and its
    work is booked as waited — no overlap credit."""
    eng = StreamingIngest(depth=0)
    seen = []
    before = transfer.snapshot()
    t = eng.submit(lambda: (time.sleep(0.02),
                            seen.append(threading.get_ident()))[1] or 7,
                   label="g0")
    assert t.done() and t.result() == 7
    assert seen == [threading.get_ident()]
    assert t.wait_s >= t.work_s >= 0.02
    assert transfer.delta(before)["overlap_s"] == 0.0
    eng.close()


def test_worker_error_latches_engine():
    with StreamingIngest(depth=2) as eng:
        t1 = eng.submit(lambda: 1 / 0, label="g0")
        with pytest.raises(WireError, match="g0"):
            t1.result(timeout=5.0)
        with pytest.raises(WireError):
            eng.submit(lambda: "never runs", label="g1")


def test_abandon_swallows_error_and_frees_slot():
    with StreamingIngest(depth=1) as eng:
        t1 = eng.submit(lambda: 1 / 0, label="g0")
        t1.abandon()
        eng._failed = None
        t2 = eng.submit(lambda: "ok", label="g1")
        assert t2.result(timeout=5.0) == "ok"


def test_overlap_credit_is_work_less_wait():
    """A harvest that waits less than the worker worked credits the
    difference to ``overlap_s``; drain abandons what is outstanding."""
    before = transfer.snapshot()
    with StreamingIngest(depth=2) as eng:
        t1 = eng.submit(lambda: time.sleep(0.1), label="g0")
        time.sleep(0.2)
        t1.result(5.0)
        eng.submit(lambda: time.sleep(0.05), label="g1")
        assert eng.drain() == 1
    got = transfer.delta(before)["overlap_s"]
    assert got >= 0.09


# ---- the ledger --------------------------------------------------------------


def test_ledger_counters_and_egress_attribution():
    before = transfer.snapshot()
    eg0 = transfer.egress_breakdown()
    with transfer.egress("summary"):
        transfer.record_d2h(100, 0.5)
    with transfer.egress("not-a-subsystem"):
        transfer.record_d2h(7, 0.25)
    transfer.record_d2h(11, 0.25)
    transfer.record_h2d(3)
    transfer.record_compute(0.125)
    transfer.record_decode(0.0625)
    transfer.record_rewind(2)
    d = transfer.delta(before)
    assert d["d2h_bytes"] == 118 and d["d2h_calls"] == 3
    assert d["h2d_bytes"] == 3 and d["rewinds"] == 2
    assert d["d2h_s"] == d["fetch_s"] == pytest.approx(1.0)
    assert d["compute_s"] == pytest.approx(0.125)
    assert d["decode_s"] == pytest.approx(0.0625)
    assert d["d2h_mb_per_s"] == pytest.approx(118 / 1e6)
    eg = transfer.egress_breakdown()
    grew = {k: eg[k] - eg0[k] for k in eg}
    assert grew["summary"] == 100 and grew["other"] == 7
    assert grew["population"] == 11
    assert sum(grew.values()) == d["d2h_bytes"]
    assert set(transfer.snapshot()) == set(jax_transfer.snapshot()) - {
        "collective_s"}
    assert transfer.EGRESS_SUBSYSTEMS == jax_transfer.EGRESS_SUBSYSTEMS


def test_timed_d2h_books_the_tree():
    before = transfer.snapshot()
    tree = {"a": np.zeros(10, np.float32), "b": [np.zeros(3, np.int64)]}
    with transfer.timed_d2h() as timer:
        time.sleep(0.01)
    assert timer.commit(tree) is tree
    d = transfer.delta(before)
    assert d["d2h_bytes"] == 64 and d["d2h_s"] >= 0.01


def test_fetch_to_host_copies_and_books_on_the_cpu():
    """The chokepoint returns host copies (the caller may reuse its
    tensors), passes other leaves through, books bytes and calls, and has
    no producer to wait for on the CPU."""
    x = torch.arange(6, dtype=torch.float32)
    tree = {"x": x, "pair": (torch.ones(2, dtype=torch.int64), 5)}
    assert mark_ready(tree) is None
    before = transfer.snapshot()
    out = fetch_to_host(tree)
    x += 1
    np.testing.assert_array_equal(out["x"], np.arange(6, dtype=np.float32))
    assert out["pair"][0].dtype == np.int64 and out["pair"][1] == 5
    d = transfer.delta(before)
    assert d["d2h_bytes"] == 6 * 4 + 2 * 8 and d["d2h_calls"] == 1
    assert d["compute_s"] < 1e-3


# ---- the decode ----------------------------------------------------------------


def _batch(rng, n=64, d=2, stats=True):
    b = {"m": rng.integers(0, 2, n).astype(np.int64),
         "theta": rng.normal(size=(n, d)).astype(np.float32),
         "distance": rng.random(n).astype(np.float32),
         "log_weight": (50.0 + rng.normal(size=n) * 3).astype(np.float32)}
    if stats:
        b["stats"] = rng.normal(size=(n, 3)).astype(np.float32)
    return b


def test_batch_to_population_bit_identical_to_the_jax_package():
    """The float64 max-shift normalization of the JAX package, bit for
    bit, on one input; degenerate weights give None in both."""
    rng = np.random.default_rng(0)
    batch = _batch(rng)
    ours = ingest.batch_to_population(batch)
    ref = jax_ingest.batch_to_population(batch)
    np.testing.assert_array_equal(ours.weight, np.asarray(ref.weight))
    np.testing.assert_array_equal(ours.theta, np.asarray(ref.theta))
    np.testing.assert_array_equal(ours.distance, np.asarray(ref.distance))
    np.testing.assert_array_equal(ours.m, np.asarray(ref.m))
    assert ours.m.dtype == np.int32
    np.testing.assert_array_equal(ours.sum_stats["__flat__"],
                                  batch["stats"])
    dead = dict(batch, log_weight=np.full(64, -np.inf, np.float32))
    assert ingest.batch_to_population(dead) is None
    assert jax_ingest.batch_to_population(dead) is None


def test_split_wires():
    rng = np.random.default_rng(1)
    gens = [_batch(rng, stats=False) for _ in range(3)]
    wires = {k: np.stack([g[k] for g in gens]) for k in gens[0]}
    wires["count"] = np.array([64, 70, 60])
    wires["rounds"] = np.array([1, 2, 3])
    wires["eps"] = np.array([0.5, 0.25, 0.125], np.float32)
    wires["sm_ess"] = np.ones(3, np.float32)
    batches, counts, rounds, eps = ingest.split_block_wire(wires, 3, 64)
    assert counts.tolist() == [64, 70, 60]
    assert rounds.tolist() == [1, 2, 3]
    assert eps.tolist() == [0.5, 0.25, 0.125]
    for got, want in zip(batches, gens):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    out, count, rnd, e = ingest.split_gen_wire(
        ingest.slice_block_wire(wires, 1), 64)
    assert (count, rnd, e) == (70, 2, 0.25)
    single = ingest.split_single_wire(gens[0], 64)
    assert single[0][0] is gens[0] and single[1].tolist() == [64]


def test_genstream_one_ahead_and_abandon():
    """Generation k + 1 is submitted when k is harvested; a custom fetch
    gets the slice, n and the block's ready event; abandon stops the
    rest."""
    calls = []
    wires = {"m": torch.arange(12).reshape(3, 4),
             "count": torch.tensor([4, 4, 3]),
             "rounds": torch.tensor([1, 1, 2])}

    def fetch(k, gw, n, ready):
        calls.append(k)
        assert ready is None and n == 4
        out = fetch_to_host(gw, ready)
        return out["m"].tolist(), int(out["count"]), int(out["rounds"]), None

    with StreamingIngest(depth=1) as eng:
        stream = ingest.GenStream(eng, wires, 3, 4, "blk", fetch=fetch)
        assert stream.result() == ([0, 1, 2, 3], 4, 1, None)
        # generation 1 is in flight; abandon waits it out and generation
        # 2 is never fetched
        stream.abandon()
        assert calls == [0, 1]
        time.sleep(0.05)
        assert calls == [0, 1]
        plain = ingest.GenStream(eng, wires, 3, 4, "blk2")
        batch, count, rounds, eps = plain.result()
        np.testing.assert_array_equal(batch["m"], [0, 1, 2, 3])
        assert (count, rounds, eps) == (4, 1, None)
        plain.abandon()


# ---- the autotuner repair -------------------------------------------------------

#: the ledger seconds both packages see: overlap above compute, so the
#: tuner's margin carries its x1.25 for a transfer-bound run
PINNED = {"compute_s": 0.01, "overlap_s": 0.02}
REPAIR_POP = 1500


def _pin(monkeypatch, module):
    real = module.delta

    def delta(before, after=None):
        return {**real(before, after), **PINNED}

    monkeypatch.setattr(module, "delta", delta)


def _fused_paths_and_batches(pkg):
    """Config #2 as the smoke's fused16384 phase runs it, at pop 1500:
    the engine path of each generation and every batch the autotuner
    chose, in order."""
    problem = jax_problem if pkg is jpt else make_two_gaussians_problem
    kw = {"device": "cpu"} if pkg is pt else {}
    models, priors, distance, observed, _ = problem()
    samp = pkg.VectorizedSampler(max_batch_size=1 << 19,
                                 max_rounds_per_call=16, **kw)
    batches = []
    choose = samp._tuner.choose_batch

    def spy(*args, **kwargs):
        batches.append(choose(*args, **kwargs))
        return batches[-1]

    samp._tuner.choose_batch = spy
    abc = pkg.ABCSMC(models, priors, distance, population_size=REPAIR_POP,
                     eps=pkg.MedianEpsilon(), sampler=samp,
                     stores_sum_stats=False, fuse_generations=4, seed=0,
                     **kw)
    abc.new("sqlite://", observed)
    abc.run(max_nr_populations=11)
    rows = abc.timeline.to_rows() if pkg is jpt else abc.timeline
    return "".join(r["path"][0] for r in rows), batches


def test_ledger_seconds_reach_the_tuner_as_in_the_jax_package(monkeypatch):
    """Both ledgers pinned to one (compute_s, overlap_s): the fused
    blocks, the classic loop and the redo after the undershoot size
    their batches alike, so both packages take the same block paths."""
    _pin(monkeypatch, jax_transfer)
    _pin(monkeypatch, transfer)
    jax_paths, jax_batches = _fused_paths_and_batches(jpt)
    port_paths, port_batches = _fused_paths_and_batches(pt)
    assert "f" in jax_paths and "s" in jax_paths[1:]
    assert port_paths == jax_paths
    assert port_batches == jax_batches
