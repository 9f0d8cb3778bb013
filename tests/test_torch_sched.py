"""Twins of ``tests/test_sched.py`` for the port's fleet scheduler
(``pyabc_tpu_torch/sched/``) over the port's serving tier on the CPU:

- lease mechanics: the stamp travels with the claim rename, the
  heartbeat's ``on_beat`` renews it, an unrenewed lease lapses;
- reconciliation: a beating worker's claims are never stolen, a
  heartbeat-dead worker's are reaped at once with bounce breadcrumbs, a
  poison ticket is quarantined within its bounce budget with the flight
  dump, a settled duplicate is reaped at claim time;
- resume-not-restart: a requeued durable study continues from its
  journaled generation on the rescue worker (``device="cpu"``); and
  where a worker killed -9 mid-study resumes, per solo run mode (the
  default one-dispatch engine from generation 1, classic engines from
  the end of their last fused block);
- autoscale hysteresis, and the port's targets equal the JAX package's
  over one sequence of (pending, claimed, oldest age) — exact;
- ``sched_*`` metrics in ``fleet_rollup`` and the Prometheus text;
- the four fast chaos trials of ``tools/chaos_soak.py --sched``
  (``freeze``, ``poison``, ``shards``, ``trace``), run by a test-local
  copy of its runner (the tool imports the JAX package);
- the twin of ``tests/test_studytrace.py::
  test_scheduler_tick_reports_trace_gc``.
"""

import json
import os
import time

import pytest
import torch

import pyabc_tpu_torch as pt
from pyabc_tpu.sched import Autoscaler as JaxAutoscaler
from pyabc_tpu_torch.parallel.health import Heartbeat
from pyabc_tpu_torch.sched import Autoscaler, Scheduler
from pyabc_tpu_torch.serve import (ServeWorker, StudyQueue, StudySpec,
                                   study_digest)


def _model(generator, theta):
    """Module-level (pickled through the queue, like a tenant's
    importable model)."""
    noise = 0.1 * torch.randn(theta.shape[0], 1, generator=generator,
                              device=theta.device)
    return {"y": theta[:, :1] + noise}


def _spec(pop=100, seed=0, tenant="default", y=0.4, **kw):
    return StudySpec(
        model=_model,
        prior=pt.Distribution(mu=pt.RV("uniform", -1.0, 2.0)),
        observed={"y": float(y)}, population_size=pop,
        seed=seed, tenant=tenant, **kw)


def _rewind(path, by_s=3600.0):
    old = time.time() - by_s
    os.utime(path, (old, old))


def _clean_env(monkeypatch):
    for var in ("PYABC_TPU_RUN_DIR", "PYABC_TPU_SERVE_DIR",
                "PYABC_TPU_SERVE_LEASE_S",
                "PYABC_TPU_SERVE_MAX_BOUNCES"):
        monkeypatch.delenv(var, raising=False)


# ---- lease mechanics --------------------------------------------------------

def test_lease_stamp_travels_with_claim(tmp_path, monkeypatch):
    _clean_env(monkeypatch)
    q = StudyQueue(root=str(tmp_path), lease_s=60.0)
    t = q.submit(_spec(seed=1))
    _rewind(t.path)  # the ticket waited in pending for an hour
    got = q.claim("w1")
    assert got is not None and got.id == t.id
    assert q.lease_age_s(got) < 5.0
    assert q.lapsed() == []


def test_renew_and_lapse(tmp_path, monkeypatch):
    _clean_env(monkeypatch)
    q = StudyQueue(root=str(tmp_path), lease_s=60.0)
    q.submit(_spec(seed=2))
    got = q.claim("w1")
    _rewind(got.path)
    assert [t.id for t in q.lapsed()] == [got.id]
    assert q.renew_leases("w1") == 1
    assert q.lapsed() == []
    assert q.lease_age_s(got) < 5.0


def test_heartbeat_on_beat_renews(tmp_path, monkeypatch):
    _clean_env(monkeypatch)
    q = StudyQueue(root=str(tmp_path), lease_s=60.0)
    q.submit(_spec(seed=3))
    got = q.claim("w1")
    _rewind(got.path)
    hb = Heartbeat(str(tmp_path / "run"),
                   on_beat=lambda: q.renew_leases("w1"))
    hb.beat()
    assert q.lapsed() == []
    hb.stop()


# ---- reconciliation ---------------------------------------------------------

def test_live_worker_never_stolen(tmp_path, monkeypatch):
    _clean_env(monkeypatch)
    rd = str(tmp_path / "run")
    os.makedirs(rd)
    q = StudyQueue(root=str(tmp_path / "serve"), lease_s=60.0)
    q.submit(_spec(seed=4))
    got = q.claim("h1_42")
    _rewind(got.path)  # the lease LOOKS lapsed...
    with open(os.path.join(rd, "hb_h1_42.json"), "w") as f:
        json.dump({"host": "h1", "pid": 42, "ts": time.time()}, f)
    rep = Scheduler(run_dir=rd, queue=q).tick()  # ...but hb is fresh
    assert rep["alive"] == 1 and rep["requeued"] == []
    assert q.stats()["claimed"] == 1


def test_dead_worker_fast_reap_with_breadcrumbs(tmp_path, monkeypatch):
    _clean_env(monkeypatch)
    rd = str(tmp_path / "run")
    os.makedirs(rd)
    q = StudyQueue(root=str(tmp_path / "serve"), lease_s=3600.0)
    q.submit(_spec(seed=5))
    got = q.claim("h2_77")  # a fresh lease, a dead worker
    hb = os.path.join(rd, "hb_h2_77.json")
    with open(hb, "w") as f:
        json.dump({"host": "h2", "pid": 77, "ts": time.time() - 900}, f)
    _rewind(hb, by_s=900.0)
    rep = Scheduler(run_dir=rd, queue=q).tick()
    assert rep["dead"] == 1 and rep["requeued"] == [got.id]
    pend = q.pending()
    assert len(pend) == 1 and pend[0].requeues == 1
    assert pend[0]._payload["last_worker"] == "h2_77"
    assert "dead" in pend[0]._payload["last_error"]
    hist = pend[0]._payload["bounce_history"]
    assert len(hist) == 1 and hist[0]["worker"] == "h2_77"


def test_poison_quarantine_within_budget(tmp_path, monkeypatch):
    _clean_env(monkeypatch)
    q = StudyQueue(root=str(tmp_path), lease_s=60.0)
    t = q.submit(_spec(seed=6))
    sched = Scheduler(run_dir=None, queue=q, max_bounces=3)
    bounces = 0
    for i in range(10):
        got = q.claim(f"w{i}")
        if got is None:
            break
        _rewind(got.path)
        rep = sched.tick()
        bounces += 1
        if rep["quarantined"]:
            break
    assert rep["quarantined"] == [t.id]
    assert bounces <= 3
    with open(os.path.join(q.root, "failed", f"{t.id}.json")) as f:
        tomb = json.load(f)
    assert tomb["quarantined"] is True
    assert len(tomb["bounce_history"]) == bounces - 1
    assert tomb.get("flight_path") and os.path.exists(tomb["flight_path"])
    assert "spec_b64" not in tomb
    assert q.claim("w_next") is None


def test_claim_reaps_settled_duplicate(tmp_path, monkeypatch):
    _clean_env(monkeypatch)
    q = StudyQueue(root=str(tmp_path), lease_s=60.0)
    q.submit(_spec(seed=7))
    stale = q.claim("w_partitioned")
    assert Scheduler(run_dir=None, queue=q).queue is q
    _rewind(stale.path)
    Scheduler(run_dir=None, queue=q, max_bounces=99).tick()  # bounce
    assert q.stats()["pending"] == 1
    q.complete(stale, wall_s=0.1, engine="solo")
    assert q.claim("w_second") is None, "double-serve of a settled id"
    stats = q.stats()
    assert stats == {**stats, "pending": 0, "done": 1}


def test_scheduler_run_forever_max_ticks(tmp_path, monkeypatch):
    _clean_env(monkeypatch)
    q = StudyQueue(root=str(tmp_path), lease_s=60.0)
    sched = Scheduler(run_dir=None, queue=q)
    seen = []
    n = sched.run_forever(interval_s=0.01, max_ticks=2, on_tick=seen.append)
    assert n == 2 and len(seen) == 2
    assert all("desired_replicas" in rep for rep in seen)


# ---- resume-not-restart -----------------------------------------------------

def test_dead_worker_requeue_resumes_not_restarts(tmp_path, monkeypatch):
    _clean_env(monkeypatch)
    monkeypatch.setenv("PYABC_TPU_SERVE_MULTIPLEX", "1")  # solo only
    root = str(tmp_path / "serve")
    q = StudyQueue(root=root, lease_s=60.0)
    gens_total = 4
    spec = _spec(pop=128, seed=8, max_generations=gens_total)
    t = q.submit(spec)
    # a first worker claims it and dies mid-study: its first 2
    # generations run onto the durable DB through the worker's engine
    dead = q.claim("w_dead")
    assert dead is not None
    worker = ServeWorker(root=root, worker_id="w_rescue",
                         run_mode="classic", durable=True, device="cpu")
    os.makedirs(worker.studies_dir, exist_ok=True)
    digest = study_digest(spec)
    db_path = os.path.join(worker.studies_dir, f"{digest}.solo.db")
    abc = worker._build_engine(spec)
    abc.new("sqlite:///" + db_path, dict(spec.observed))
    partial = abc.run(max_nr_populations=2)
    done_gens = int(partial.max_t) + 1
    assert done_gens == 2
    partial.close()
    _rewind(dead.path)
    rep = Scheduler(run_dir=None, queue=q, max_bounces=5).tick()
    assert rep["requeued"] == [t.id]
    served = worker.run_forever(q, once=True)
    assert served == 1
    summary = worker.cache.get(f"{digest}.solo")
    assert summary is not None
    assert summary["resumed_from_gen"] == done_gens, summary
    assert summary["gens"] >= gens_total
    assert abs(summary["posterior_mean"]["mu"] - 0.4) < 0.3
    stats = q.stats()
    assert stats["done"] == 1 and stats["pending"] == 0, stats
    assert not os.path.exists(db_path)


#: a module-level model for the kill test (a queued spec is pickled):
#: where ``KILL_AT`` is set ("<db rows>:<n>"), the process kills itself
#: -9 at the n-th call that finds that many generations in the study's
#: durable database (``KILL_DB``)
_KILL_MODEL = """
import os
import signal
import sqlite3

import torch

_seen = [0]


def model(generator, theta):
    at = os.environ.get("KILL_AT")
    if at:
        rows, n = (int(x) for x in at.split(":"))
        with sqlite3.connect(os.environ["KILL_DB"]) as conn:
            have = conn.execute("SELECT COUNT(*) FROM populations "
                                "WHERE t >= 0").fetchone()[0]
        _seen[0] += have == rows
        if _seen[0] >= n:
            os.kill(os.getpid(), signal.SIGKILL)
    noise = 0.1 * torch.randn(theta.shape[0], 1, generator=generator,
                              device=theta.device)
    return {"y": theta[:, :1] + noise}
"""

_KILL_WORKER = """
import sys
from pyabc_tpu_torch.serve import ServeWorker, StudyQueue
worker = ServeWorker(root=sys.argv[1], worker_id="w_killed",
                     run_mode=sys.argv[2], durable=True, device="cpu")
worker.run_forever(StudyQueue(root=sys.argv[1]), once=True)
"""


@pytest.mark.parametrize("run_mode,kill_at,resumed", [
    # the one-dispatch engine drains its generations when the dispatch
    # returns: killed inside it, only t = 0 is in the database
    ("onedispatch", "1:5", 1),
    # a classic engine appends each fused block of 4 as it ends (the
    # block's summary-only generations 1-3 are purged at the load: only
    # the block's last generation keeps its particles)
    ("classic", "5:2", 5),
])
def test_worker_killed_mid_study_resumes_from(run_mode, kill_at, resumed,
                                              tmp_path, monkeypatch):
    """A durable study's worker is killed -9 inside a run (a model call
    finds ``kill_at``'s generation count in the study's database); the
    rescue worker resumes from what the database then holds."""
    import subprocess
    import sys
    _clean_env(monkeypatch)
    monkeypatch.setenv("PYABC_TPU_SERVE_MULTIPLEX", "1")  # solo only
    (tmp_path / "kill_model.py").write_text(_KILL_MODEL)
    (tmp_path / "kill_worker.py").write_text(_KILL_WORKER)
    monkeypatch.syspath_prepend(str(tmp_path))
    import kill_model
    root = str(tmp_path / "serve")
    q = StudyQueue(root=root, lease_s=60.0)
    spec = StudySpec(model=kill_model.model,
                     prior=pt.Distribution(mu=pt.RV("uniform", -1.0, 2.0)),
                     observed={"y": 0.4}, population_size=128, seed=8,
                     max_generations=10)
    t = q.submit(spec)
    digest = study_digest(spec)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, KILL_AT=kill_at,
               KILL_DB=os.path.join(root, "studies", f"{digest}.solo.db"),
               PYTHONPATH=os.pathsep.join([repo, str(tmp_path)]))
    proc = subprocess.Popen(
        [sys.executable, str(tmp_path / "kill_worker.py"), root, run_mode],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        _, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == -9, err.decode()[-2000:]
    claimed = os.path.join(q.root, "claimed", "w_killed", f"{t.id}.json")
    _rewind(claimed)
    assert Scheduler(run_dir=None, queue=q, max_bounces=5).tick()[
        "requeued"] == [t.id]
    worker = ServeWorker(root=root, worker_id="w_rescue",
                         run_mode=run_mode, durable=True, device="cpu")
    assert worker.run_forever(q, once=True) == 1
    summary = worker.cache.get(f"{digest}.solo")
    assert summary["resumed_from_gen"] == resumed, summary
    assert abs(summary["posterior_mean"]["mu"] - 0.4) < 0.3


# ---- autoscale hysteresis ---------------------------------------------------

def test_autoscale_raw_target_and_clamps():
    a = Autoscaler(min_replicas=2, max_replicas=6,
                   studies_per_worker=4, aging_pressure_s=120.0)
    assert a.target(0, 0, 0.0) == 2
    assert a.target(8, 0, 0.0) == 2
    assert a.target(9, 0, 0.0) == 3
    assert a.target(8, 4, 0.0) == 3
    assert a.target(8, 0, 300.0) == 3
    assert a.target(999, 0, 0.0) == 6


def test_autoscale_hysteresis_both_directions():
    a = Autoscaler(min_replicas=1, max_replicas=16,
                   studies_per_worker=1, up_ticks=2, down_ticks=3)
    assert a.observe(4, 0, 0.0) == 4
    assert a.observe(8, 0, 0.0) == 4
    assert a.observe(8, 0, 0.0) == 8
    assert a.observe(1, 0, 0.0) == 8
    assert a.observe(1, 0, 0.0) == 8
    assert a.observe(1, 0, 0.0) == 1
    assert a.observe(8, 0, 0.0) == 1
    assert a.observe(1, 0, 0.0) == 1
    assert a.observe(8, 0, 0.0) == 1
    assert a.observe(8, 0, 0.0) == 8


def test_autoscale_targets_equal_the_jax_package(monkeypatch):
    """One seeded sequence of (pending, claimed, oldest age) through both
    packages' autoscalers, from the environment's knobs and from
    explicit ones: the same raw and filtered targets at every tick."""
    import numpy as np
    rng = np.random.default_rng(14)
    seq = [(int(rng.integers(0, 60)), int(rng.integers(0, 20)),
            float(rng.choice([0.0, 30.0, 200.0]))) for _ in range(200)]
    monkeypatch.setenv("PYABC_TPU_SCHED_MIN_REPLICAS", "1")
    monkeypatch.setenv("PYABC_TPU_SCHED_MAX_REPLICAS", "9")
    monkeypatch.setenv("PYABC_TPU_SCHED_UP_TICKS", "3")
    for kw in ({}, dict(min_replicas=2, max_replicas=12,
                        studies_per_worker=5, aging_pressure_s=100.0,
                        up_ticks=2, down_ticks=4)):
        ours, theirs = Autoscaler(**kw), JaxAutoscaler(**kw)
        for p, c, age in seq:
            assert ours.target(p, c, age) == theirs.target(p, c, age)
            assert ours.observe(p, c, age) == theirs.observe(p, c, age)


# ---- observability ----------------------------------------------------------

def test_sched_rollup_and_prometheus(tmp_path):
    from pyabc_tpu_torch.telemetry import aggregate
    rd = str(tmp_path)
    td = aggregate.telemetry_dir(rd)
    os.makedirs(td, exist_ok=True)
    for host, (alive, requeues) in (("hostA", (2, 3)), ("hostB", (1, 4))):
        snap = {"schema_version": aggregate.SCHEMA_VERSION,
                "host": host, "pid": 1,
                "metrics": {"sched_workers_alive": alive,
                            "sched_requeues_total": requeues,
                            "sched_desired_replicas": alive + 1}}
        with open(os.path.join(td, f"snap_{host}.json"), "w") as f:
            json.dump(snap, f)
    sched = aggregate.fleet_rollup(rd)["sched"]
    assert sched["sched_workers_alive"] == 2
    assert sched["sched_desired_replicas"] == 3
    assert sched["sched_requeues_total"] == 7
    text = aggregate.render_prometheus(rd)
    assert "pyabc_tpu_sched_workers_alive 2" in text
    assert "pyabc_tpu_sched_requeues_total 7" in text


def test_scheduler_tick_publishes_sched_metrics(tmp_path, monkeypatch):
    _clean_env(monkeypatch)
    rd = str(tmp_path / "run")
    os.makedirs(rd)
    q = StudyQueue(root=str(tmp_path / "serve"), lease_s=60.0)
    q.submit(_spec(seed=9))
    rep = Scheduler(run_dir=rd, queue=q).tick()
    assert rep["desired_replicas"] >= 1
    from pyabc_tpu_torch.telemetry import aggregate
    roll = aggregate.fleet_rollup(rd)
    assert roll["sched"].get("sched_queue_pending", 0) >= 1
    assert "sched_last_tick_ms" in roll["sched"]


def test_scheduler_tick_reports_trace_gc(tmp_path, monkeypatch):
    monkeypatch.delenv("PYABC_TPU_RUN_DIR", raising=False)
    q = StudyQueue(root=str(tmp_path))
    q.submit(_spec(seed=5))
    rep = Scheduler(run_dir=None, queue=q).tick()
    assert rep["trace_swept"] == 0 and rep["slo_swept"] == 0


# ---- the fast chaos subset --------------------------------------------------

class _SchedEnv:
    """Solo-only routing, durable studies, ring capacity 1, tracing on;
    ambient run-dir/serve-dir/fault config scrubbed."""

    _VARS = {"PYABC_TPU_SERVE_MULTIPLEX": "1",
             "PYABC_TPU_SERVE_DURABLE": "1",
             "PYABC_TPU_STORE_GENS": "1",
             "PYABC_TPU_SERVE_TRACE": "1"}
    _UNSET = ("PYABC_TPU_RUN_DIR", "PYABC_TPU_SERVE_DIR",
              "PYABC_TPU_FAULTS", "PYABC_TPU_SERVE_CB",
              "PYABC_TPU_SERVE_CB_WINDOW")

    def __init__(self, monkeypatch):
        for k, v in self._VARS.items():
            monkeypatch.setenv(k, v)
        for k in self._UNSET:
            monkeypatch.delenv(k, raising=False)


def _chaos_spec(seed: int, pop: int = 256, gens: int = 4):
    from pyabc_tpu_torch.models import gaussian_model
    return StudySpec(
        model=gaussian_model,
        prior=pt.Distribution(mu=pt.RV("norm", 0.0, 1.0)),
        observed={"y": 0.5}, population_size=pop, seed=seed,
        max_generations=gens, tenant="chaos")


def _rewind_lease(queue, worker_id: str, by_s: float = 3600.0):
    wdir = os.path.join(queue.root, "claimed", worker_id)
    old = time.time() - by_s
    for name in os.listdir(wdir):
        if name.endswith(".json"):
            os.utime(os.path.join(wdir, name), (old, old))


def _conservation(queue, n_submitted: int) -> int:
    stats = queue.stats()
    present = (stats["pending"] + stats["claimed"] + stats["done"]
               + stats["failed"])
    assert present == n_submitted, stats
    return n_submitted - present


def _trace_continuity(serve_root: str, key: str) -> int:
    from pyabc_tpu_torch.telemetry.studytrace import (StudyTrace,
                                                      fold_segments)
    trace = StudyTrace.assemble(serve_root, key)
    assert trace is not None and trace.trace_id
    names = trace.event_names()
    assert names.count("claimed") == 2, names
    pos = 0
    for want in ("claimed", "requeued", "claimed", "rescued", "published"):
        while pos < len(names) and names[pos] != want:
            pos += 1
        assert pos < len(names), (want, names)
        pos += 1
    assert len(trace.workers) >= 2
    segs = fold_segments(trace.events)
    for a, b in zip(segs, segs[1:]):
        assert a["t0_unix"] + a["dur_s"] <= b["t0_unix"] + 1e-6
    assert len([s for s in segs if s["phase"] == "queue_wait_s"]) == 2
    return len(trace.events)


def _reschedule(sched, report) -> dict:
    t0 = time.perf_counter()
    rep = sched.tick()
    report["reschedule_ms"] = (time.perf_counter() - t0) * 1e3
    return rep


def run_sched_trial(name: str, workdir: str) -> dict:
    """The port of ``tools/chaos_soak.py``'s ``run_sched_trial`` for the
    four queue-level trials (seed 0)."""
    from pyabc_tpu_torch.serve import shards as _shards
    root = os.path.join(workdir, f"serve_{name}_0")
    report = {"lost": 0, "reschedule_ms": 0.0}
    queue = StudyQueue(root=root, lease_s=30.0)
    if name == "freeze":
        # a partitioned host: its heartbeat file is frozen, so it is
        # dead; its claim is reaped at once, and its late completion
        # converges by id (no double-serve)
        run_dir = os.path.join(workdir, "run_freeze_0")
        os.makedirs(run_dir, exist_ok=True)
        ticket = queue.submit(_chaos_spec(seed=200))
        stale = queue.claim("hfrozen_77")
        hb = os.path.join(run_dir, "hb_hfrozen_77.json")
        with open(hb, "w") as f:
            json.dump({"host": "hfrozen", "pid": 77,
                       "ts": time.time() - 3600}, f)
        _rewind(hb)
        sched = Scheduler(run_dir=run_dir, queue=queue, max_bounces=3)
        rep = _reschedule(sched, report)
        assert rep["dead"] == 1 and rep["requeued"] == [ticket.id], rep
        queue.complete(stale, wall_s=0.1, engine="solo")
        assert queue.claim("w_second") is None
        stats = queue.stats()
        assert stats["done"] == 1 and stats["pending"] == 0, stats
        report["lost"] = _conservation(queue, 1)
    elif name == "poison":
        ticket = queue.submit(_chaos_spec(seed=300))
        sched = Scheduler(run_dir=None, queue=queue, max_bounces=3)
        bounces, rep = 0, {"quarantined": []}
        for r in range(5):
            if queue.claim(f"w_poison_{r}") is None:
                break
            _rewind_lease(queue, f"w_poison_{r}")
            rep = _reschedule(sched, report)
            bounces += 1
            if rep["quarantined"]:
                break
        assert rep["quarantined"] == [ticket.id] and bounces <= 3
        with open(os.path.join(queue.root, "failed",
                               f"{ticket.id}.json")) as f:
            tomb = json.load(f)
        assert tomb.get("quarantined") and tomb.get("bounce_history")
        assert os.path.exists(tomb["flight_path"])
        report["lost"] = _conservation(queue, 1)
    elif name == "shards":
        def pending_path(q, digest, ticket_id):
            part = _shards.partition_of(digest, q.partitions)
            return os.path.join(q.root, "pending",
                                _shards.partition_name(part),
                                f"{ticket_id}.json")

        queue = StudyQueue(root=root, lease_s=30.0, partitions=4)
        specs = [_chaos_spec(seed=400 + i) for i in range(6)]
        tickets = [queue.submit(s) for s in specs]
        for s, t in zip(specs, tickets):
            assert os.path.exists(pending_path(queue, study_digest(s), t.id))
        claims = {"w_a": [], "w_b": []}
        for wid in claims:
            for _ in range(3):
                t = queue.claim(wid)
                assert t is not None, f"{wid} starved"
                claims[wid].append(t)
        ids_a = {t.id for t in claims["w_a"]}
        ids_b = {t.id for t in claims["w_b"]}
        assert not ids_a & ids_b
        assert queue.claim("w_c") is None
        _rewind_lease(queue, "w_b")
        sched = Scheduler(run_dir=None, queue=queue, max_bounces=3)
        rep = _reschedule(sched, report)
        assert sorted(rep["requeued"]) == sorted(ids_b), rep
        for t in claims["w_b"]:
            assert os.path.exists(pending_path(queue, t.digest, t.id))
        t_flat = queue.submit(_chaos_spec(seed=470))
        src = pending_path(queue, t_flat.digest, t_flat.id)
        os.rename(src, os.path.join(queue.root, "pending",
                                    f"{t_flat.id}.json"))
        assert queue.migrate_layout() == 1 and os.path.exists(src)
        drained = 0
        while True:
            t = queue.claim("w_rescue")
            if t is None:
                break
            queue.complete(t, wall_s=0.01, engine="solo")
            drained += 1
        assert drained == len(ids_b) + 1
        for t in claims["w_a"]:
            queue.complete(t, wall_s=0.01, engine="solo")
        stats = queue.stats()
        assert stats["done"] == 7 and stats["pending"] == 0, stats
        report["lost"] = _conservation(queue, 7)
    elif name == "trace":
        ticket = queue.submit(_chaos_spec(seed=600, pop=8))
        t1 = queue.claim("w_first")
        assert t1 is not None and t1.trace_id == ticket.trace_id
        _rewind_lease(queue, "w_first")
        sched = Scheduler(run_dir=None, queue=queue, max_bounces=3)
        rep = _reschedule(sched, report)
        assert rep["requeued"] == [ticket.id], rep
        t2 = queue.claim("w_second")
        assert t2 is not None and t2.trace_id == ticket.trace_id
        for event, fields in (
                ("batched", {"engine": "solo", "width": 1}),
                ("rescued", {"resumed_from_gen": 1}),
                ("dispatched", {"width": 1}),
                ("drained", {}),
                ("published", {"tier": "t1"})):
            assert queue.trace.emit(t2.trace_id, event, digest=t2.digest,
                                    ticket=t2.id, worker="w_second",
                                    **fields) is not None, event
        queue.complete(t2, wall_s=0.01, engine="solo")
        report["trace_events"] = _trace_continuity(root, ticket.id)
        report["lost"] = _conservation(queue, 1)
    return report


@pytest.mark.parametrize("trial", ("freeze", "poison", "shards", "trace"))
def test_sched_chaos_fast_subset(trial, tmp_path, monkeypatch):
    _clean_env(monkeypatch)
    _SchedEnv(monkeypatch)
    rep = run_sched_trial(trial, str(tmp_path))
    assert rep["lost"] == 0
    assert rep["reschedule_ms"] < 10_000
    if trial == "trace":
        assert rep["trace_events"] >= 9
