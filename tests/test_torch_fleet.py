"""The port's fleet layer on the CPU, held to the JAX package.

Twins of ``tests/test_fleet_telemetry.py`` (publisher, throttle,
``publisher_from_env``, garbage snapshots, clock merge, rollup and
Prometheus, heartbeat identity) and of ``tests/test_lanes.py``
(``ProgressPoller``, ``merge_progress``) for ``pyabc_tpu_torch``'s
``telemetry/aggregate.py``, ``telemetry/lanes.py`` and
``parallel/health.py``.  Beyond the twins: a snapshot written by either
package reads in the other, a one-dispatch run with
``$PYABC_TPU_RUN_DIR`` publishes one trajectory row per generation and
the same populations, bit for bit, as the run without it, the operator
stop ends a run between generations, and ``maybe_summary_grid`` matches
the JAX package's on the same population.
"""

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyabc_tpu_torch as pt
from pyabc_tpu.parallel import health as jax_health
from pyabc_tpu.telemetry import aggregate as jax_aggregate
from pyabc_tpu.telemetry import lanes as jax_lanes
from pyabc_tpu.wire import store as jax_store
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.parallel import health
from pyabc_tpu_torch.resilience import checkpoint as ckpt
from pyabc_tpu_torch.resilience import faults
from pyabc_tpu_torch.storage.history import _unpack
from pyabc_tpu_torch.telemetry import aggregate, flight, lanes, spans
from pyabc_tpu_torch.wire import store, transfer


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """The tracer sink, flight ring, progress word and fault plan are
    process-global: every test starts and ends clean, with no run dir,
    host override or grid switch from the environment."""
    for env in (health.RUN_DIR_ENV, aggregate.HOST_ENV, spans.TRACE_ENV,
                lanes.POLL_ENV, store.SUMMARY_GRID_ENV):
        monkeypatch.delenv(env, raising=False)
    faults.uninstall()
    ckpt.clear_preempt()
    spans.TRACER.reset()
    flight.RECORDER.reset()
    lanes.PROGRESS.reset()
    yield
    faults.uninstall()
    ckpt.clear_preempt()
    spans.TRACER.reset()
    flight.RECORDER.reset()
    lanes.PROGRESS.reset()


# ---- publisher and snapshot (test_fleet_telemetry.py:61-105) --------------


def test_publisher_snapshot_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv(aggregate.HOST_ENV, "hostX")
    pub = aggregate.TelemetryPublisher(str(tmp_path), min_interval_s=0.0)
    assert pub.publish(force=True)
    snaps = aggregate.read_snapshots(str(tmp_path))
    assert len(snaps) == 1
    s = snaps[0]
    assert s["schema_version"] == aggregate.SCHEMA_VERSION
    assert s["host"] == "hostX" and s["pid"] == os.getpid()
    assert abs(s["clock"]["trace_t0_unix"] - time.time()) < 3600
    assert set(s["egress"]) == set(transfer.EGRESS_SUBSYSTEMS)
    assert s["pod"] is None  # one process, no torch.distributed group


def test_publisher_throttles_and_force_overrides(tmp_path):
    pub = aggregate.TelemetryPublisher(str(tmp_path), min_interval_s=60.0)
    assert pub.publish()
    assert not pub.publish()         # inside the throttle window
    assert pub.publish(force=True)   # run end always writes


def test_publisher_arms_tracer_unless_explicit(tmp_path):
    aggregate.TelemetryPublisher(str(tmp_path))
    assert spans.TRACER._path and spans.TRACER._path.endswith(".jsonl")
    spans.TRACER.reset()
    mine = str(tmp_path / "mine.jsonl")
    spans.TRACER.configure(trace_path=mine)
    aggregate.TelemetryPublisher(str(tmp_path))
    assert spans.TRACER._path == mine


def test_publisher_from_env_requires_run_dir(tmp_path, monkeypatch):
    assert aggregate.publisher_from_env() is None
    monkeypatch.setenv(health.RUN_DIR_ENV, str(tmp_path))
    pub = aggregate.publisher_from_env()
    assert pub is not None and pub.run_dir == str(tmp_path)


def test_read_snapshots_skips_garbage(tmp_path):
    os.makedirs(aggregate.telemetry_dir(str(tmp_path)))
    (tmp_path / "telemetry" / "snap_bad_1.json").write_text("{torn")
    (tmp_path / "telemetry" / "snap_old_2.json").write_text(
        json.dumps({"schema_version": -1, "host": "old", "pid": 2}))
    assert aggregate.read_snapshots(str(tmp_path)) == []


# ---- merge and rollup (test_fleet_telemetry.py:110-208) -------------------


def _fake_host(run_dir, host, t0_unix_shift, ts_us, metrics=None,
               pod=None, heartbeat=None):
    """One host's span file and snapshot with a known clock anchor."""
    d = aggregate.telemetry_dir(run_dir)
    os.makedirs(d, exist_ok=True)
    stem = f"{host}_1"
    with open(os.path.join(d, f"spans_{stem}.jsonl"), "w") as f:
        f.write(json.dumps({"name": "run", "cat": "pyabc_tpu", "ph": "X",
                            "ts": ts_us, "dur": 1000.0, "pid": 999,
                            "tid": 1, "args": {}}) + "\n")
    snap = {"schema_version": aggregate.SCHEMA_VERSION, "host": host,
            "pid": 1, "written_unix": time.time(),
            "clock": {"trace_t0_unix": 1000.0 + t0_unix_shift,
                      "monotonic_offset_s": 0.0},
            "metrics": metrics or {}}
    if pod is not None:
        snap["pod"] = pod
    if heartbeat is not None:
        snap["heartbeat"] = heartbeat
    with open(os.path.join(d, f"snap_{stem}.json"), "w") as f:
        json.dump(snap, f)


def test_merge_aligns_clocks_across_hosts(tmp_path):
    rd = str(tmp_path)
    _fake_host(rd, "hostA", 0.0, ts_us=100.0)
    _fake_host(rd, "hostB", 5.0, ts_us=100.0)
    merged = aggregate.merge_traces(rd)
    assert merged == jax_aggregate.merge_traces(rd)
    meta = [e for e in merged if e.get("ph") == "M"]
    assert [m["args"]["name"] for m in meta] == ["hostA_1", "hostB_1"]
    events = {e["pid"]: e for e in merged if e.get("ph") == "X"}
    assert set(events) == {0, 1}
    assert events[1]["ts"] - events[0]["ts"] == pytest.approx(5e6)
    path = aggregate.write_merged_trace(rd)
    assert os.path.basename(path) == "fleet_trace.json"
    with open(path) as f:
        assert json.load(f) == merged


@pytest.mark.parametrize("case", ["two_hosts", "pod", "single", "serve"])
def test_fleet_rollup_and_prometheus_match_the_jax_package(tmp_path, case):
    """``fleet_rollup`` and ``render_prometheus`` over the same run
    directory give the JAX package's answers, field for field."""
    rd = str(tmp_path)
    if case == "two_hosts":
        _fake_host(rd, "hostA", 0.0, 1.0, metrics={"evaluations_total": 100})
        _fake_host(rd, "hostB", 0.0, 1.0, metrics={"evaluations_total": 300})
    elif case == "pod":
        for i, (acc, coll) in enumerate([(512, 0.25), (480, 0.25)]):
            _fake_host(rd, f"pod{i}", 0.0, 1.0,
                       metrics={"wire_collective_seconds_total": coll},
                       pod={"process_index": i, "process_count": 2,
                            "local_devices": 4},
                       heartbeat={"generations": 4, "accepted": acc})
    elif case == "single":
        _fake_host(rd, "solo", 0.0, 1.0, metrics={"evaluations_total": 7})
    else:
        # a serving worker's flat latency buckets and scheduler gauges
        _fake_host(rd, "w0", 0.0, 1.0, metrics={
            "serve_latency_ms_le_50": 3.0, "serve_latency_ms_le_100": 4.0,
            "serve_latency_ms_le_inf": 4.0,
            "serve_latency_ms_sum_total": 170.0,
            "serve_slo_over_total": 1.0, "serve_slo_under_total": 3.0,
            "serve_queue_depth": 2.0, "sched_workers_alive": 1.0,
            "serve_tenant_a_studies_total": 4.0})
    roll = aggregate.fleet_rollup(rd)
    assert roll == jax_aggregate.fleet_rollup(rd)
    text = aggregate.render_prometheus(rd)
    assert text == jax_aggregate.render_prometheus(rd)
    if case == "two_hosts":
        assert roll["metrics"]["evaluations_total"] == {
            "sum": 400.0, "max": 300.0, "p50": 100.0, "p99": 300.0,
            "n_hosts": 2}
        assert "pyabc_tpu_fleet_hosts 2" in text
        assert 'pyabc_tpu_fleet_evaluations_total{agg="sum"} 400.0' in text
    elif case == "pod":
        assert roll["pod_hosts"] == 2
        assert roll["collective_s_per_gen"] == pytest.approx(0.5 / 4)
        assert "pyabc_tpu_fleet_collective_s_per_gen 0.125" in text
    elif case == "single":
        assert roll["pod_hosts"] == 1
        assert roll["hosts"][0]["process_index"] is None
    else:
        assert roll["serve"]["latency"]["count"] == 4.0
        assert roll["serve"]["slo"]["burn_rate"] == 0.25
        assert roll["serve"]["tenants"] == {"a": 4.0}
        assert 'pyabc_tpu_serve_latency_ms_bucket{le="+Inf"} 4.0' in text


# ---- heartbeats and the stop sentinel -------------------------------------


def test_heartbeat_carries_fleet_identity(tmp_path, monkeypatch):
    monkeypatch.setenv(aggregate.HOST_ENV, "hostHB")
    hb = health.Heartbeat(str(tmp_path))
    hb.beat()
    assert os.path.basename(hb.path).startswith("hb_hostHB_")
    with open(hb.path) as f:
        payload = json.load(f)
    assert payload["schema_version"] == aggregate.SCHEMA_VERSION
    assert payload["host"] == "hostHB"
    assert payload["monotonic_offset_s"] == pytest.approx(
        time.time() - time.monotonic(), abs=5.0)
    assert set(payload["metrics"]) == set(
        jax_health.Heartbeat(str(tmp_path)).metrics_fn())
    # the JAX package's reader sees the port's worker, and the reverse
    for status in (health.worker_status(str(tmp_path)),
                   jax_health.worker_status(str(tmp_path))):
        assert [(e["host"], e["alive"]) for e in status] == [
            ("hostHB", True)]
    assert health.healthy(str(tmp_path))


def test_heartbeat_fault_site_and_stale_reset(tmp_path, monkeypatch):
    """``heartbeat.write`` is a fault site of the port's plan; a stopped
    worker's file goes STALE and ``reset_workers`` removes it."""
    faults.install(faults.FaultPlan.parse(
        f"{faults.SITE_HEARTBEAT}@1:raise=OSError"))
    hb = health.Heartbeat(str(tmp_path), interval_s=0.05)
    with pytest.raises(OSError):
        hb.beat()
    faults.uninstall()
    hb.beat()
    hb.stop(remove=False)
    assert health.worker_status(str(tmp_path), stale_after_s=60)[0]["alive"]
    past = time.time() - 120
    os.utime(hb.path, (past, past))
    # a reader's first sight of an old file classifies it by wall age
    # (later sights also need the monotonic clock to pass the window)
    health._MONO_SEEN.clear()
    assert not health.healthy(str(tmp_path), stale_after_s=60)
    health._MONO_SEEN.clear()
    assert health.reset_workers(str(tmp_path), stale_after_s=60) == 1
    assert os.listdir(str(tmp_path)) == []


def test_stop_sentinel_round_trip_and_operator_stop(tmp_path, monkeypatch):
    """The sentinel reads in both packages, and a run under a run
    directory holding it stops before its first generation with the
    operator's reason; clearing it lets the run go on."""
    rd = str(tmp_path)
    assert not health.stop_requested(rd)
    jax_health.request_stop(rd)
    assert health.stop_requested(rd) and jax_health.stop_requested(rd)
    monkeypatch.setenv(health.RUN_DIR_ENV, rd)
    assert health.stop_requested() and ckpt._local_stop_requested()
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=100,
                    sampler=pt.VectorizedSampler(device="cpu"), seed=1)
    abc.new("sqlite://", observed)
    h = abc.run(max_nr_populations=2)
    assert abc.stop_reason == "Stopping: operator stop requested"
    assert h.max_t == -1
    health.clear_stop(rd)
    assert not jax_health.stop_requested(rd)
    assert abc.run(max_nr_populations=2).max_t == 1


# ---- progress poller and merge (test_lanes.py:192, :284) ------------------


def test_progress_poller_publishes_only_fresh_active_words():
    pubs = []
    lanes.PROGRESS.begin(t0=1, t_limit=6)
    poller = lanes.ProgressPoller(lambda: pubs.append(1),
                                  interval_s=0.05).start()
    try:
        lanes.PROGRESS.update(1, 0.5, 100, 1)
        deadline = time.time() + 2.0
        while not pubs and time.time() < deadline:
            time.sleep(0.01)
        assert len(pubs) >= 1
        n = len(pubs)
        time.sleep(0.3)  # several ticks over a static word
        assert len(pubs) == n
        lanes.PROGRESS.update(2, 0.4, 120, 2)
        deadline = time.time() + 2.0
        while len(pubs) == n and time.time() < deadline:
            time.sleep(0.01)
        assert len(pubs) == n + 1
    finally:
        poller.stop()
    lanes.PROGRESS.finish()
    assert lanes.PROGRESS.read()["active"] is False
    assert lanes.poll_interval_s() == jax_lanes.poll_interval_s()


def test_merge_progress_matches_the_jax_package():
    a = {"active": True, "gens_done": 2, "updated_unix": 10.0}
    b = {"active": False, "gens_done": 5, "updated_unix": 20.0}
    c = {"active": False, "gens_done": 3, "updated_unix": 5.0}
    for words in ([], [None, None], [a, b, None], [c, b], [a]):
        assert lanes.merge_progress(words) == jax_lanes.merge_progress(
            words)
    merged = lanes.merge_progress([a, b, None])
    assert merged["gens_done"] == 2 and merged["hosts_active"] == 1
    assert merged["hosts_reporting"] == 2
    assert lanes.merge_progress([c, b])["gens_done"] == 5


# ---- across packages -------------------------------------------------------


def test_snapshots_read_across_packages(tmp_path, monkeypatch):
    """A snapshot written by the JAX package and one written by the port
    share a run directory; each package's reader returns both, with the
    same keys, and the rollups agree."""
    rd = str(tmp_path)
    monkeypatch.setenv(aggregate.HOST_ENV, "port-host")
    lanes.PROGRESS.begin(t0=1, t_limit=8, run_id="r1")
    lanes.PROGRESS.update(2, 0.5, 900, 2)
    assert aggregate.TelemetryPublisher(rd, min_interval_s=0.0).publish(
        force=True)
    monkeypatch.setenv(aggregate.HOST_ENV, "jax-host")
    assert jax_aggregate.TelemetryPublisher(rd, min_interval_s=0.0).publish(
        force=True)
    mine = aggregate.read_snapshots(rd)
    theirs = jax_aggregate.read_snapshots(rd)
    assert mine == theirs
    assert [s["host"] for s in mine] == ["jax-host", "port-host"]
    jax_snap, port_snap = mine
    assert set(port_snap) == set(jax_snap)
    for key in ("clock", "heartbeat", "egress"):
        assert set(port_snap[key]) == set(jax_snap[key]), key
    # both ledgers book their cross-process collectives
    # (``collective_s``)
    assert set(jax_snap["wire"]) == set(port_snap["wire"])
    assert port_snap["run_progress"]["gens_done"] == 2
    assert aggregate.fleet_rollup(rd) == jax_aggregate.fleet_rollup(rd)
    assert (aggregate.render_prometheus(rd)
            == jax_aggregate.render_prometheus(rd))


# ---- a run under a run directory -------------------------------------------


def _od_run(run_dir=None, monkeypatch=None, gens=5):
    if run_dir is not None:
        monkeypatch.setenv(health.RUN_DIR_ENV, run_dir)
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=200,
                    eps=pt.ConstantEpsilon(0.2),
                    sampler=pt.VectorizedSampler(min_batch_size=2048,
                                                 max_batch_size=2048,
                                                 device="cpu"),
                    fuse_generations=2, run_mode="onedispatch", seed=0)
    abc.new("sqlite://", observed)
    h = abc.run(max_nr_populations=gens)
    if run_dir is not None:
        monkeypatch.delenv(health.RUN_DIR_ENV)
    return abc, h


def test_onedispatch_run_publishes_and_changes_no_population(
        tmp_path, monkeypatch):
    rd = str(tmp_path)
    abc, h = _od_run(rd, monkeypatch)
    assert abc._fleet is not None and abc.run_dispatches == 1
    snaps = aggregate.read_snapshots(rd)
    assert len(snaps) == 1
    gens = [r["gen"] for r in snaps[0]["trajectory"]]
    assert gens == [r["t"] for r in abc.timeline] == list(range(5))
    assert snaps[0]["run_progress"]["active"] is False
    assert snaps[0]["run_progress"]["gens_done"] == 4
    assert snaps[0]["metrics"]["xla_compiles_total"] >= 1
    assert snaps[0]["heartbeat"]["generations"] >= 5
    assert jax_aggregate.fleet_rollup(rd)["n_hosts"] == 1
    abc0, h0 = _od_run()
    assert abc0._fleet is None
    for t in range(5):
        for m in range(2):
            df, w = h.get_distribution(m=m, t=t)
            df0, w0 = h0.get_distribution(m=m, t=t)
            np.testing.assert_array_equal(df.to_numpy(), df0.to_numpy())
            np.testing.assert_array_equal(w, w0)


# ---- the summary grid -------------------------------------------------------


@pytest.mark.parametrize("seed", [11, 12])
def test_maybe_summary_grid_matches_the_jax_package(monkeypatch, seed):
    rng = np.random.default_rng(seed)
    theta = rng.normal(0.3, 0.7, (300, 1)).astype(np.float32)
    log_w = rng.normal(0.0, 0.5, 300).astype(np.float32)
    dp = {"theta": torch.as_tensor(theta),
          "log_weight": torch.as_tensor(log_w)}
    jdp = {"theta": jnp.asarray(theta), "log_weight": jnp.asarray(log_w),
           "count": jnp.int32(300)}
    assert store.maybe_summary_grid(dp) is None
    monkeypatch.setenv(store.SUMMARY_GRID_ENV, "1")
    got = store.maybe_summary_grid(dp)
    ref = jax_store.maybe_summary_grid(jdp)
    assert got["grid_centroid"].shape == (1 << 14,)
    live = ref["grid_log_mass"] > -1e29
    np.testing.assert_array_equal(got["grid_log_mass"] > -1e29, live)
    np.testing.assert_allclose(got["grid_centroid"], ref["grid_centroid"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["grid_log_mass"][live],
                               ref["grid_log_mass"][live], rtol=0,
                               atol=1e-5)
    # a 2-D parameter space has no grid
    assert store.maybe_summary_grid(
        {"theta": torch.zeros(4, 2), "log_weight": torch.zeros(4)}) is None


def test_lazy_sequential_rows_keep_the_grid(monkeypatch):
    """Under ``$PYABC_TPU_SUMMARY_GRID`` each sequential lazy row keeps
    its grid (and keeps it after materializing); its masses sum to one
    and its centroid mean is the population's weighted mean."""
    monkeypatch.setenv(store.SUMMARY_GRID_ENV, "1")
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=300,
                    sampler=pt.VectorizedSampler(device="cpu"), seed=2,
                    history_mode="lazy", ingest_mode="sequential")
    abc.new("sqlite://", observed)
    h = abc.run(max_nr_populations=3)
    rows = h._conn.execute(
        "SELECT t, summary_grid FROM populations WHERE t >= 0 "
        "ORDER BY t").fetchall()
    assert [t for t, _ in rows] == [0, 1, 2]
    for t, blob in rows:
        grid = _unpack(blob)
        assert grid.shape == (2, 1 << 14)
        mass = np.exp(grid[1].astype(np.float64))
        assert abs(mass.sum() - 1.0) < 1e-5
        pop = h.get_population(t)
        w = pop.weight / pop.weight.sum()
        mean = float(np.sum(w * pop.theta[:, 0]))
        assert abs(float(np.sum(mass * grid[0])) - mean) < 1e-4
