"""Study traces in the port against the JAX package's.

Twins of ``tests/test_studytrace.py`` for ``pyabc_tpu_torch.serve.tracing``
and ``pyabc_tpu_torch.telemetry.studytrace``.  The folding and accounting
functions run the JAX test's event sequences, with their fixed
timestamps, through both packages: ``fold_segments``, ``fold_phases``,
``latency_histogram``, ``slo_ledger``, ``waterfall_text`` and the Chrome
export must be equal.  The queue and worker twins run the port's serving
path on the CPU (pop 100, two generations) and assemble the trace it
wrote with both packages' ``StudyTrace``.  ``test_scheduler_tick_reports_
trace_gc`` has no twin yet: it needs the scheduler (``sched/``), which the
port does not have (ROADMAP.md Queue 1).
"""

import json
import os
import time

import pytest
import torch

import pyabc_tpu_torch as pt
from pyabc_tpu.telemetry import aggregate as jax_aggregate
from pyabc_tpu.telemetry import studytrace as jst
from pyabc_tpu_torch.serve import ServeWorker, StudyQueue, StudySpec
from pyabc_tpu_torch.serve.tracing import EVENTS, TRACE_ENV, TraceLog
from pyabc_tpu_torch.telemetry import REGISTRY
from pyabc_tpu_torch.telemetry import aggregate, studytrace
from pyabc_tpu_torch.telemetry.studytrace import (StudyTrace, fold_phases,
                                                  fold_segments,
                                                  latency_histogram,
                                                  slo_ledger, waterfall_text)


def _model(generator, theta):
    noise = 0.1 * torch.randn(theta.shape[0], 1, generator=generator,
                              device=theta.device)
    return {"y": theta[:, :1] + noise}


def _spec(pop=100, seed=0, tenant="default", y=0.4, **kw):
    return StudySpec(
        model=_model,
        prior=pt.Distribution(mu=pt.RV("uniform", -1.0, 2.0)),
        observed={"y": float(y)}, population_size=pop,
        seed=seed, tenant=tenant,
        max_generations=kw.pop("max_generations", 2), **kw)


def _synthetic_lifecycle(t0=1000.0, tid="t" * 32):
    """A full single-worker lifecycle with easy round numbers."""
    steps = (("submitted", 0.0), ("queued", 0.0), ("claimed", 1.0),
             ("batched", 1.5), ("dispatched", 2.0), ("drained", 6.0),
             ("published", 6.5), ("tombstoned", 7.0))
    return [{"trace_id": tid, "event": ev, "unix": t0 + dt,
             "mono": dt, "ticket": "tk1", "digest": "d1",
             "worker": "w1"} for ev, dt in steps]


def _bounced(tid="b" * 32):
    steps = (("submitted", 0.0), ("claimed", 1.0), ("requeued", 3.0),
             ("claimed", 5.0), ("published", 6.0), ("tombstoned", 6.5))
    return [{"trace_id": tid, "event": ev, "unix": 100.0 + dt,
             "mono": dt, "worker": f"w{i % 2}"}
            for i, (ev, dt) in enumerate(steps)]


# ---------------------------------------------------------------------------
# lifecycle events on the queue path
# ---------------------------------------------------------------------------

def test_queue_transitions_emit_lifecycle_events(tmp_path):
    q = StudyQueue(root=str(tmp_path))
    t = q.submit(_spec(seed=1))
    assert t.trace_id, "trace id not stamped at submit"
    c = q.claim("w_a")
    assert c.trace_id == t.trace_id
    q.complete(c, wall_s=0.01, engine="solo")
    events = q.trace.events_for(t.id)
    names = [e["event"] for e in events]
    assert names == ["submitted", "queued", "claimed", "tombstoned"]
    assert all(e["trace_id"] == t.trace_id for e in events)
    assert isinstance(events[1]["partition"], int)
    assert events[2]["worker"] == "w_a"
    assert events[3]["state"] == "done"
    assert q.trace.events_for(t.trace_id) == events
    assert [e["event"] for e in q.trace.events_for(t.digest)] == names


def test_bounce_keeps_one_continuous_trace(tmp_path):
    q = StudyQueue(root=str(tmp_path))
    t = q.submit(_spec(seed=2))
    c1 = q.claim("w_dead")
    assert q.requeue(c1, worker="w_dead", error="kill -9")
    c2 = q.claim("w_rescue")
    assert c2.trace_id == t.trace_id
    q.complete(c2, wall_s=0.01, engine="solo")
    names = [e["event"] for e in q.trace.events_for(t.trace_id)]
    assert names == ["submitted", "queued", "claimed", "requeued",
                     "claimed", "tombstoned"]
    # both packages assemble the same trace from the port's log
    got = StudyTrace.assemble(str(tmp_path), t.id)
    ref = jst.StudyTrace.assemble(str(tmp_path), t.id)
    assert got.to_dict() == ref.to_dict()
    assert got.workers == ref.workers == ["w_dead", "w_rescue"]


def test_unknown_event_name_raises(tmp_path):
    log = TraceLog(str(tmp_path))
    with pytest.raises(ValueError):
        log.emit(log.new_id(), "vanished")
    assert "vanished" not in EVENTS


def test_torn_tail_is_skipped_not_fatal(tmp_path):
    log = TraceLog(str(tmp_path))
    tid = log.new_id()
    log.emit(tid, "submitted", digest="d", ticket="tk")
    log.emit(tid, "claimed", digest="d", ticket="tk", worker="w")
    (seg,) = [os.path.join(dp, n)
              for dp, _, ns in os.walk(log.root)
              for n in ns if n.endswith(".jsonl")]
    with open(seg, "a", encoding="utf-8") as f:
        f.write('{"trace_id": "' + tid + '", "event": "drai')
    names = [e["event"] for e in log.events_for(tid)]
    assert names == ["submitted", "claimed"]


# ---------------------------------------------------------------------------
# critical-path folding: both packages, the same fixed timestamps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("events", [_synthetic_lifecycle(), _bounced()],
                         ids=["lifecycle", "bounced"])
@pytest.mark.parametrize("end_unix", [None, 1010.0])
def test_folds_equal_the_jax_package(events, end_unix):
    assert fold_segments(events, end_unix=end_unix) == jst.fold_segments(
        events, end_unix=end_unix)
    assert fold_phases(events, end_unix=end_unix) == jst.fold_phases(
        events, end_unix=end_unix)
    got = StudyTrace.from_events(events, end_unix=end_unix)
    ref = jst.StudyTrace.from_events(events, end_unix=end_unix)
    assert got.to_dict() == ref.to_dict()
    assert waterfall_text(got) == jst.waterfall_text(ref)
    assert got.to_chrome_events() == ref.to_chrome_events()


def test_fold_segments_monotone_and_exhaustive():
    events = _synthetic_lifecycle()
    segs = fold_segments(events)
    assert [s["phase"] for s in segs] == list(studytrace.PHASES)
    for a, b in zip(segs, segs[1:]):
        assert abs((a["t0_unix"] + a["dur_s"]) - b["t0_unix"]) < 1e-9
    phases = fold_phases(events)
    assert (phases["queue_wait_s"], phases["claim_to_dispatch_s"],
            phases["compile_s"], phases["device_s"], phases["drain_s"],
            phases["publish_s"], phases["total_s"]) == (
        1.0, 0.5, 0.5, 4.0, 0.5, 0.5, 7.0)
    assert sum(phases[p] for p in studytrace.PHASES) == pytest.approx(
        phases["total_s"])
    assert phases["bounces"] == 0 and phases["events_n"] == len(events)


def test_fold_bounce_sums_queue_waits():
    phases = fold_phases(_bounced())
    assert phases["queue_wait_s"] == 3.0 and phases["bounces"] == 1
    segs = [s for s in fold_segments(_bounced())
            if s["phase"] == "queue_wait_s"]
    assert len(segs) == 2


def test_instant_markers_do_not_move_the_phase_machine():
    events = _synthetic_lifecycle()
    with_markers = events + [
        {"trace_id": events[0]["trace_id"], "event": "rescued",
         "unix": 1001.2, "mono": 1.2, "resumed_from_gen": 1}]
    assert fold_segments(with_markers) == fold_segments(events)
    assert jst.fold_segments(with_markers) == fold_segments(with_markers)


# ---------------------------------------------------------------------------
# served studies: tombstone block, assembly, export
# ---------------------------------------------------------------------------

def test_served_tombstone_carries_summing_phases(tmp_path, monkeypatch):
    monkeypatch.setenv("PYABC_TPU_SERVE_MULTIPLEX", "1")
    monkeypatch.setenv("PYABC_TPU_SERVE_SLO_P99_MS", "600000")
    q = StudyQueue(root=str(tmp_path))
    t = q.submit(_spec(seed=3))
    worker = ServeWorker(root=str(tmp_path), worker_id="w_e2e",
                         run_mode="classic", device="cpu")
    assert worker.run_forever(q, once=True) == 1
    with open(os.path.join(q.root, "done", f"{t.id}.json"),
              encoding="utf-8") as f:
        tomb = json.load(f)
    block = tomb["trace"]
    assert block["trace_id"] == t.trace_id
    assert block["worker"] == "w_e2e" and block["bounces"] == 0
    phases = block["phases"]
    assert all(phases[p] >= 0.0 for p in studytrace.PHASES)
    assert phases["device_s"] > 0.0
    assert sum(phases[p] for p in studytrace.PHASES) == pytest.approx(
        phases["total_s"], abs=0.1)
    trace = StudyTrace.assemble(str(tmp_path), t.id)
    assert trace.trace_id == t.trace_id
    for ev in ("submitted", "queued", "claimed", "batched",
               "dispatched", "drained", "published", "tombstoned"):
        assert ev in trace.event_names()
    assert trace.to_dict() == jst.StudyTrace.assemble(
        str(tmp_path), t.id).to_dict()
    out = os.path.join(str(tmp_path), "study.trace.json")
    trace.write_chrome_trace(out)
    with open(out, encoding="utf-8") as f:
        chrome = json.load(f)
    spans_x = [e["name"] for e in chrome if e.get("ph") == "X"]
    assert sorted(spans_x) == sorted(
        f"study.{p[:-2]}" for p in studytrace.PHASES)
    snap = REGISTRY.to_dict()
    assert snap.get("serve_slo_under_total", 0) >= 1
    assert snap.get("serve_latency_ms_le_inf", 0) >= 1
    lines = waterfall_text(trace)
    assert len(lines) == 1 + len(studytrace.PHASES)
    assert "bounces 0" in lines[0]


def test_duplicate_submission_traces_as_cache_hit(tmp_path, monkeypatch):
    monkeypatch.setenv("PYABC_TPU_SERVE_MULTIPLEX", "1")
    q = StudyQueue(root=str(tmp_path))
    q.submit(_spec(seed=3))
    worker = ServeWorker(root=str(tmp_path), worker_id="w_hit",
                         run_mode="classic", device="cpu")
    assert worker.run_forever(q, once=True) == 1
    dup = q.submit(_spec(seed=3))
    assert worker.run_forever(q, once=True) == 1
    names = StudyTrace.assemble(str(tmp_path), dup.id).event_names()
    assert "cache_hit" in names and "dispatched" not in names


# ---------------------------------------------------------------------------
# trace-off mode and GC
# ---------------------------------------------------------------------------

def test_trace_off_leaves_no_fingerprint(tmp_path, monkeypatch):
    monkeypatch.setenv(TRACE_ENV, "0")
    q = StudyQueue(root=str(tmp_path))
    t = q.submit(_spec(seed=4))
    assert t.trace_id is None
    assert q.trace.new_id() is None
    c = q.claim("w_off")
    q.complete(c, wall_s=0.01, engine="solo")
    assert not os.path.exists(q.trace.root)
    with open(os.path.join(q.root, "done", f"{t.id}.json"),
              encoding="utf-8") as f:
        tomb = json.load(f)
    assert "trace_id" not in tomb and "trace" not in tomb


def test_trace_sweep_unlinks_old_segments(tmp_path):
    log = TraceLog(str(tmp_path))
    tid = log.new_id()
    log.emit(tid, "submitted", digest="d", ticket="tk")
    (seg,) = [os.path.join(dp, n)
              for dp, _, ns in os.walk(log.root)
              for n in ns if n.endswith(".jsonl")]
    assert log.sweep(retain_s=3600.0) == 0
    old = time.time() - 7200.0
    os.utime(seg, (old, old))
    assert log.sweep(retain_s=3600.0) == 1
    assert not os.path.exists(seg)
    assert log.sweep(retain_s=0.0) == 0


def test_sweep_snapshots_reaps_dead_workers(tmp_path):
    from pyabc_tpu_torch.serve.admission import (publish_latency_snapshot,
                                                 sweep_snapshots)
    root = str(tmp_path)
    for wid in ("host_1", "host_2", "host_3"):
        publish_latency_snapshot(root, wid, [10.0, 20.0])
    slo_dir = os.path.join(root, "slo")
    assert len(os.listdir(slo_dir)) == 3
    publish_latency_snapshot(root, "host_3", [10.0],
                             now=time.time() - 7200.0)
    swept = sweep_snapshots(
        root, liveness={"host_1": True, "host_2": False}, fresh_s=3600.0)
    assert swept == 2
    assert sorted(os.listdir(slo_dir)) == ["host_1.json"]


# ---------------------------------------------------------------------------
# fleet accounting: histograms and the SLO ledger
# ---------------------------------------------------------------------------

def _rollup():
    rollup = {"serve_latency_ms_le_inf": 100.0,
              "serve_latency_ms_sum_total": 20000.0,
              "serve_slo_over_total": 3.0, "serve_slo_under_total": 97.0,
              "serve_shed_total": 5.0, "serve_slo_p99_ms": 800.0}
    for b, n in ((5, 0), (10, 0), (25, 10), (50, 30), (100, 60),
                 (250, 80), (500, 95), (1000, 99), (2500, 99),
                 (5000, 99), (10000, 100)):
        rollup[f"serve_latency_ms_le_{b}"] = float(n)
    return rollup


def test_latency_histogram_rollup_and_percentiles():
    hist = latency_histogram(_rollup(), "serve_latency_ms")
    assert hist == jst.latency_histogram(_rollup(), "serve_latency_ms")
    assert hist["count"] == 100.0 and hist["sum_ms"] == 20000.0
    assert hist["p50_ms"] == 100.0 and hist["p99_ms"] == 1000.0
    assert slo_ledger(_rollup()) == jst.slo_ledger(_rollup())
    assert latency_histogram({}) == jst.latency_histogram({})
    assert slo_ledger({}) == jst.slo_ledger({})


def test_record_study_slo_burns_and_ledger():
    before = REGISTRY.to_dict()

    def delta(key):
        return REGISTRY.to_dict().get(key, 0.0) - before.get(key, 0.0)

    studytrace.record_study_slo(50.0, 10.0, slo_p99_ms=200.0)
    studytrace.record_study_slo(900.0, 700.0, slo_p99_ms=200.0)
    assert delta("serve_slo_under_total") == 1
    assert delta("serve_slo_over_total") == 1
    assert delta("serve_latency_ms_le_inf") == 2
    assert delta("serve_latency_ms_le_100") == 1
    snap = REGISTRY.to_dict()
    ledger = slo_ledger(snap)
    assert ledger == jst.slo_ledger(snap)
    assert ledger["slo_p99_ms"] == 200.0
    assert ledger["over"] >= 1 and ledger["under"] >= 1
    assert 0.0 < ledger["burn_rate"] <= 1.0


def test_prometheus_rendering_reassembles_histogram(tmp_path):
    studytrace.record_study_slo(42.0, 7.0, slo_p99_ms=500.0)
    snap = {"schema_version": aggregate.SCHEMA_VERSION,
            "host": "h", "pid": 1, "metrics": REGISTRY.to_dict()}
    tdir = aggregate.telemetry_dir(str(tmp_path))
    os.makedirs(tdir, exist_ok=True)
    with open(os.path.join(tdir, "snap_h_1.json"), "w",
              encoding="utf-8") as f:
        json.dump(snap, f)
    roll = aggregate.fleet_rollup(str(tmp_path))
    serve = roll["serve"]
    assert serve["latency"]["count"] >= 1
    assert serve["slo"]["slo_p99_ms"] == 500.0
    ref = jax_aggregate.fleet_rollup(str(tmp_path))["serve"]
    for block in ("latency", "queue_wait", "slo"):
        assert serve[block] == ref[block]
    text = aggregate.render_prometheus(str(tmp_path))
    assert 'pyabc_tpu_serve_latency_ms_bucket{le="+Inf"}' in text
    assert "pyabc_tpu_serve_latency_ms_count" in text
    assert "pyabc_tpu_serve_latency_ms_le_" not in text
