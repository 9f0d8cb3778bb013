"""Cross-host telemetry aggregation over the shared run directory.

Fleet observability rides the SAME mount contract as the heartbeats in
``parallel/health.py``: every host that sees ``PYABC_TPU_RUN_DIR`` (or
is handed an explicit run directory) publishes its telemetry into
``<run_dir>/telemetry/`` —

- ``spans_<host>_<pid>.jsonl`` — the host's Chrome-trace span stream
  (the span tracer is armed with this sink when fleet publishing is on
  and no explicit trace path was configured);
- ``snap_<host>_<pid>.json`` — an atomically-replaced snapshot of the
  metrics registry, wire ledger, egress breakdown, heartbeat summary
  and generation-timeline tail, stamped with a schema version and the
  host's clock anchor.

The aggregation half reads those files back from any process (the
viewer in ``visserver/``, tests):

- :func:`merge_traces` / :func:`write_merged_trace` — one fleet
  Chrome-trace with one track (pid) per host, every host's ``ts``
  shifted onto a common unix timebase via the published
  ``trace_t0_unix`` anchors, so cross-host causality reads directly in
  Perfetto.
- :func:`fleet_rollup` — sum/max/p50/p99 of every numeric metric
  across hosts.
- :func:`render_prometheus` — the rollup as Prometheus text
  (``pyabc_tpu_fleet_*`` samples), the fleet analog of the per-worker
  exporter in ``telemetry/metrics.py``.

Port of ``pyabc_tpu/telemetry/aggregate.py``: the snapshot schema
(``SCHEMA_VERSION``, keys, file names) is the JAX package's, so a
snapshot written by one package reads in the other.  ``pod`` is filled
from ``torch.distributed`` (world size > 1).  ``xla_compiles_total``
counts the port's engine builds (``ABCSMC._get_engine_fn``): the port
compiles no XLA program, and the key keeps its name so the fleet
readers of both packages agree.

Clock model: a span's ``ts`` is microseconds since its tracer's
``perf_counter`` origin.  Each snapshot carries
``clock.trace_t0_unix = time.time() - (perf_counter() - t0)`` — the
wall-clock instant of ``ts == 0``.  The merger picks the earliest
anchor as fleet zero and shifts every host by
``(host_anchor - fleet_zero) * 1e6``, so tracks align to within the
hosts' wall-clock agreement (NTP), which is exactly the guarantee a
shared-filesystem fleet already depends on for heartbeat staleness.

Import direction: telemetry stays a LEAF package: the wire ledger and
the health helpers are imported function-locally.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Dict, List, Optional

from . import spans
from .lanes import PROGRESS, merge_progress
from .metrics import REGISTRY, heartbeat_summary

#: bump when the snapshot payload shape changes; consumers check this
#: instead of sniffing formats (heartbeats embed the same version)
SCHEMA_VERSION = 1

#: override the host identity (defaults to ``socket.gethostname()``) —
#: lets one machine fake a fleet (tests) and disambiguates containers
#: that all report the same kernel hostname
HOST_ENV = "PYABC_TPU_HOST_ID"

#: subdirectory of the run directory holding telemetry files
TELEMETRY_SUBDIR = "telemetry"

_SNAP_PREFIX = "snap_"
_SPANS_PREFIX = "spans_"

#: full timeline rows kept in each snapshot (the compact eps/acceptance
#: trajectory is unbounded — a row is ~40 bytes there)
_TIMELINE_TAIL = 64


def host_id() -> str:
    """This process's fleet identity: ``$PYABC_TPU_HOST_ID`` else the
    hostname."""
    return os.environ.get(HOST_ENV) or socket.gethostname()


def telemetry_dir(run_dir: str) -> str:
    return os.path.join(run_dir, TELEMETRY_SUBDIR)


class TelemetryPublisher:
    """Per-process half: throttled snapshot writes + span-sink arming.

    Created by the orchestrator when a run directory is advertised
    (:func:`publisher_from_env`).  ``publish()`` is called at generation
    boundaries on every run path; it is throttled to at most one write
    per ``min_interval_s`` unless forced (run end), so pod-scale fleets
    do not grind the shared filesystem at sub-second generation rates.

    ``publish()`` is thread-safe: during a one-dispatch run the
    :class:`~.lanes.ProgressPoller` thread force-publishes concurrently
    with the main thread's generation-boundary calls, and both target
    the same snapshot path — the write lock keeps the tmp-then-replace
    dance atomic per caller.
    """

    #: lock-discipline contract: ``_last_write`` under ``_write_lock``
    _GUARDED_BY = {"_last_write": "_write_lock"}

    def __init__(self, run_dir: str, min_interval_s: float = 1.0,
                 process_index: Optional[int] = None):
        self._write_lock = threading.Lock()
        self.run_dir = run_dir
        self.min_interval_s = float(min_interval_s)
        self.process_index = process_index
        self.host = host_id()
        self.pid = os.getpid()
        d = telemetry_dir(run_dir)
        os.makedirs(d, exist_ok=True)
        stem = f"{self.host}_{self.pid}"
        self.snap_path = os.path.join(d, f"{_SNAP_PREFIX}{stem}.json")
        self.spans_path = os.path.join(d, f"{_SPANS_PREFIX}{stem}.jsonl")
        self._last_write = 0.0
        # Arm the tracer into the run directory UNLESS the user already
        # pointed it somewhere explicit (ABCSMC(trace_path=...) /
        # $PYABC_TPU_TRACE wins — fleet publishing must not steal a
        # requested local trace).
        if spans.TRACER._path is None:
            spans.TRACER.configure(trace_path=self.spans_path)

    def publish(self, timeline=None, force: bool = False) -> bool:
        """Write one snapshot (+ flush buffered spans).  Returns whether
        a write happened (throttled calls return False).  Never raises:
        a shared-filesystem hiccup must not kill the run it observes."""
        now = time.time()
        with self._write_lock:
            if not force and now - self._last_write < self.min_interval_s:
                return False
            try:
                payload = self._payload(timeline, now)
                tmp = self.snap_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(payload, f)
                os.replace(tmp, self.snap_path)  # atomic on POSIX
                spans.TRACER.flush()
            except Exception:
                return False
            self._last_write = now
            return True

    def _payload(self, timeline, now: float) -> dict:
        from ..wire import transfer  # function-local: wire imports telemetry

        pod = None
        try:
            import torch
            import torch.distributed as dist
            if (dist.is_available() and dist.is_initialized()
                    and dist.get_world_size() > 1):
                pod = {"process_index": dist.get_rank(),
                       "process_count": dist.get_world_size(),
                       "local_devices": torch.cuda.device_count()}
        except Exception:
            pod = None
        payload = {
            "schema_version": SCHEMA_VERSION,
            "host": self.host,
            "pid": self.pid,
            "process_index": self.process_index,
            "pod": pod,
            "written_unix": now,
            "clock": {
                "trace_t0_unix": spans.TRACER.t0_unix(),
                # wall minus monotonic: lets any consumer translate this
                # host's monotonic stamps without loading the trace
                "monotonic_offset_s": time.time() - time.monotonic(),
            },
            "metrics": REGISTRY.to_dict(),
            "wire": transfer.snapshot(),
            "egress": transfer.egress_breakdown(),
            "heartbeat": heartbeat_summary(),
            # the in-dispatch progress word (telemetry/lanes.py): lets
            # readers show generations advancing while this host is
            # still inside a one-dispatch call; None outside such runs
            "run_progress": PROGRESS.read(),
        }
        if timeline is not None:
            rows = timeline.to_rows()
            payload["trajectory"] = [
                {"gen": r["gen"], "eps": r["eps"],
                 "accepted": r["accepted"], "total": r["total"],
                 "wall_s": r["wall_s"], "engine": r["engine"]}
                for r in rows]
            payload["timeline_tail"] = rows[-_TIMELINE_TAIL:]
        return payload


def publisher_from_env(process_index: Optional[int] = None
                       ) -> Optional[TelemetryPublisher]:
    """A publisher for the advertised run directory, or None when no
    run directory is set (the common single-process case: one ``is
    None`` check per generation is the whole disabled-path cost)."""
    from ..parallel import health  # function-local: parallel imports telemetry

    d = health.run_dir()
    if not d:
        return None
    try:
        return TelemetryPublisher(d)
    except OSError:
        return None


# -- aggregation (reader side) ----------------------------------------

def read_snapshots(run_dir: str) -> List[Dict]:
    """Every host snapshot under the run directory, sorted by host/pid.
    Unreadable or schema-incompatible files are skipped, not fatal —
    a crashed host must not take the fleet view down with it."""
    d = telemetry_dir(run_dir)
    out = []
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for name in sorted(names):
        if not (name.startswith(_SNAP_PREFIX) and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                snap = json.load(f)
        except (OSError, ValueError):
            continue
        if snap.get("schema_version") != SCHEMA_VERSION:
            continue
        out.append(snap)
    out.sort(key=lambda s: (str(s.get("host")), s.get("pid") or 0))
    return out


def _span_files(run_dir: str) -> List[str]:
    d = telemetry_dir(run_dir)
    try:
        names = os.listdir(d)
    except OSError:
        return []
    return sorted(os.path.join(d, n) for n in names
                  if n.startswith(_SPANS_PREFIX) and n.endswith(".jsonl"))


def _stem_of(path: str) -> str:
    name = os.path.basename(path)
    for prefix, suffix in ((_SPANS_PREFIX, ".jsonl"),
                           (_SNAP_PREFIX, ".json")):
        if name.startswith(prefix) and name.endswith(suffix):
            return name[len(prefix):-len(suffix)]
    return name


def merge_traces(run_dir: str) -> List[Dict]:
    """One clock-aligned fleet trace over every host's span file.

    Each host becomes one Chrome-trace process track: its events are
    re-stamped with ``pid = <track index>`` plus a ``process_name``
    metadata event naming the host, and shifted onto the fleet timebase
    via the snapshot clock anchors (hosts without a snapshot stay on
    their own zero — visible, just unaligned).  Returns the event list
    sorted by ``ts``; :func:`write_merged_trace` writes it in the JSON
    array form Perfetto loads directly.
    """
    anchors = {f"{s['host']}_{s['pid']}":
               float(s.get("clock", {}).get("trace_t0_unix", 0.0))
               for s in read_snapshots(run_dir)}
    known = [v for v in anchors.values() if v > 0]
    fleet_t0 = min(known) if known else 0.0
    merged: List[Dict] = []
    meta: List[Dict] = []
    for track, path in enumerate(_span_files(run_dir)):
        stem = _stem_of(path)
        shift_us = (anchors.get(stem, fleet_t0) - fleet_t0) * 1e6
        meta.append({"name": "process_name", "ph": "M", "pid": track,
                     "tid": 0, "args": {"name": stem}})
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError:
            continue
        for line in lines:
            if not line.strip():
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue  # torn tail write on a crashed host
            ev["pid"] = track
            ev["ts"] = round(float(ev.get("ts", 0.0)) + shift_us, 3)
            merged.append(ev)
    merged.sort(key=lambda e: e.get("ts", 0.0))
    return meta + merged


def write_merged_trace(run_dir: str,
                       out_path: Optional[str] = None) -> str:
    """Write :func:`merge_traces` output as ``fleet_trace.json`` (JSON
    array — loadable in Perfetto / chrome://tracing as-is)."""
    events = merge_traces(run_dir)
    if out_path is None:
        out_path = os.path.join(telemetry_dir(run_dir), "fleet_trace.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(events, f)
    os.replace(tmp, out_path)
    return out_path


def _percentile(vals: List[float], q: float) -> float:
    """Nearest-rank percentile over a small host population."""
    vals = sorted(vals)
    idx = min(len(vals) - 1, max(0, int(round(q * (len(vals) - 1)))))
    return vals[idx]


def fleet_rollup(run_dir: str) -> Dict:
    """sum/max/p50/p99 of every numeric registry metric across hosts.

    Counters roll up meaningfully as ``sum`` (fleet totals), gauges as
    ``max``/percentiles (stragglers); the rollup reports all four per
    key and lets the consumer pick, because the snapshot is a flat
    scalar dict with no type tags.
    """
    snaps = read_snapshots(run_dir)
    per_key: Dict[str, List[float]] = {}
    for s in snaps:
        for k, v in (s.get("metrics") or {}).items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            per_key.setdefault(k, []).append(float(v))
    rollup = {
        k: {"sum": sum(vals), "max": max(vals),
            "p50": _percentile(vals, 0.50),
            "p99": _percentile(vals, 0.99),
            "n_hosts": len(vals)}
        for k, vals in sorted(per_key.items())}
    # pod shard attribution: which SPMD process each snapshot belongs
    # to, its own accepted total, and the collective time it burned in
    # host-side cross-process syncs (wire_collective_seconds_total —
    # zero in the one-dispatch steady state, by contract)
    hosts = []
    gens = 0
    collective_s = 0.0
    for s in snaps:
        m = s.get("metrics") or {}
        hb = s.get("heartbeat") or {}
        pod = s.get("pod") or {}
        c = float(m.get("wire_collective_seconds_total", 0.0))
        collective_s += c
        gens = max(gens, int(hb.get("generations", 0)))
        hosts.append({"host": s["host"], "pid": s["pid"],
                      "process_index": pod.get("process_index",
                                               s.get("process_index")),
                      "accepted": int(hb.get("accepted", 0)),
                      "collective_s": c,
                      "written_unix": s.get("written_unix"),
                      "run_progress": s.get("run_progress")})
    pod_hosts = max([int((s.get("pod") or {}).get("process_count", 1))
                     for s in snaps] or [1])
    return {"n_hosts": len(snaps),
            "pod_hosts": pod_hosts,
            "collective_s_per_gen": collective_s / gens if gens else 0.0,
            "hosts": hosts,
            # the fleet-merged in-dispatch progress word (lanes.py):
            # pod processes run in lockstep, so one word speaks for all
            "run_progress": merge_progress(
                [s.get("run_progress") for s in snaps]),
            "serve": _serve_rollup(rollup),
            "sched": _sched_rollup(rollup),
            "metrics": rollup}


#: serve_* keys that are point-in-time gauges — fleet view reads their
#: max; everything else under serve_* is a counter and rolls up as sum
_SERVE_GAUGES = frozenset({
    "serve_queue_depth", "serve_engines_warm", "serve_cache_hit_ratio",
    "serve_cache_hit_ratio_t1", "serve_cache_hit_ratio_t2",
    "serve_last_study_ms", "serve_drain_requeued",
    "serve_partitions", "serve_partition_depth_max",
    "serve_slo_p99_ms",
})


def is_serve_gauge(key: str) -> bool:
    """Whether a ``serve_*`` metric is a point-in-time gauge (fleet
    max) rather than a counter (fleet sum).  Per-partition depth
    gauges (``serve_partition_p<NNNN>_depth``) are name-generated, so
    they match by shape rather than by set membership."""
    return (key in _SERVE_GAUGES
            or (key.startswith("serve_partition_p")
                and key.endswith("_depth")))


def _serve_rollup(metrics_rollup: Dict) -> Dict:
    """The serving tier's slice of the fleet rollup: every ``serve_*``
    metric collapsed to one number (counters summed across workers,
    gauges maxed), plus the per-tenant attribution table."""
    out: Dict = {}
    tenants: Dict[str, float] = {}
    for key, aggs in metrics_rollup.items():
        if not key.startswith("serve_"):
            continue
        val = aggs["max" if is_serve_gauge(key) else "sum"]
        out[key] = val
        if key.startswith("serve_tenant_") and key.endswith(
                "_studies_total"):
            tenants[key[len("serve_tenant_"):-len("_studies_total")]] \
                = val
    out["tenants"] = tenants
    # the study-trace accounting: re-fold the flat per-bucket counters
    # into fleet latency histograms and the SLO burn ledger — bucket
    # counters sum across workers, so the fleet histogram is exact, not
    # an average of percentiles
    if any(k.startswith("serve_latency_ms_") for k in out):
        from . import studytrace
        out["latency"] = studytrace.latency_histogram(
            out, "serve_latency_ms")
        out["queue_wait"] = studytrace.latency_histogram(
            out, "serve_queue_wait_ms")
        out["slo"] = studytrace.slo_ledger(out)
    return out


#: sched_* keys that are point-in-time gauges — fleet view reads their
#: max; everything else under sched_* is a counter and rolls up as sum
_SCHED_GAUGES = frozenset({
    "sched_workers_alive", "sched_workers_dead",
    "sched_desired_replicas", "sched_queue_pending",
    "sched_queue_claimed", "sched_oldest_pending_s",
    "sched_last_tick_ms", "sched_platform_replicas",
})


def _sched_rollup(metrics_rollup: Dict) -> Dict:
    """The scheduler's slice of the fleet rollup: every ``sched_*``
    metric collapsed to one number (counters summed across scheduler
    replicas, gauges maxed) — the control-plane mirror of
    :func:`_serve_rollup`."""
    out: Dict = {}
    for key, aggs in metrics_rollup.items():
        if not key.startswith("sched_"):
            continue
        out[key] = aggs["max" if key in _SCHED_GAUGES else "sum"]
    return out


def render_prometheus(run_dir: str) -> str:
    """The fleet rollup as Prometheus text: each metric exported as
    ``pyabc_tpu_fleet_<key>{agg="sum|max|p50|p99"}`` samples plus a
    ``pyabc_tpu_fleet_hosts`` gauge — the scrape surface for a whole
    run directory, complementing the per-worker exporter."""
    roll = fleet_rollup(run_dir)
    lines = [f"pyabc_tpu_fleet_hosts {roll['n_hosts']}",
             f"pyabc_tpu_fleet_pod_hosts {roll['pod_hosts']}",
             "pyabc_tpu_fleet_collective_s_per_gen "
             f"{roll['collective_s_per_gen']}"]
    prog = roll.get("run_progress")
    if prog is not None:
        lines += [
            "pyabc_tpu_fleet_run_progress_active "
            f"{1 if prog.get('active') else 0}",
            f"pyabc_tpu_fleet_run_progress_gen {prog.get('gen', 0)}",
            "pyabc_tpu_fleet_run_progress_gens_done "
            f"{prog.get('gens_done', 0)}",
            "pyabc_tpu_fleet_run_progress_rounds "
            f"{prog.get('rounds', 0)}",
        ]
    # the serving tier's first-class scrape surface: flat
    # ``pyabc_tpu_serve_*`` gauges (tenant counters already carry the
    # tenant in the key), alongside the generic fleet aggregates below
    serve = roll.get("serve") or {}
    for key, val in sorted(serve.items()):
        if key in ("tenants", "latency", "queue_wait", "slo"):
            continue  # structured blocks: rendered below / JSON-only
        if (key.endswith("_sum_total") or "_ms_le_" in key):
            continue  # flat bucket counters: rendered as histograms
        lines.append(f"pyabc_tpu_{key} {val}")
    # the per-bucket latency counters re-assembled into real
    # Prometheus histogram exposition (cumulative le labels)
    for name in ("serve_latency_ms", "serve_queue_wait_ms"):
        hist = serve.get("latency" if name == "serve_latency_ms"
                         else "queue_wait")
        if not hist or not hist.get("count"):
            continue
        for le, n in hist["buckets"].items():
            lines.append(
                f'pyabc_tpu_{name}_bucket{{le="{le}"}} {n}')
        lines.append(
            f'pyabc_tpu_{name}_bucket{{le="+Inf"}} {hist["count"]}')
        lines.append(f"pyabc_tpu_{name}_sum {hist['sum_ms']}")
        lines.append(f"pyabc_tpu_{name}_count {hist['count']}")
    # the scheduler's scrape surface: flat ``pyabc_tpu_sched_*`` lines
    # (workers alive/dead, leases lapsed, requeues, quarantines,
    # desired replicas) from the same snapshot rollup
    for key, val in sorted((roll.get("sched") or {}).items()):
        lines.append(f"pyabc_tpu_{key} {val}")
    for key, aggs in roll["metrics"].items():
        for agg in ("sum", "max", "p50", "p99"):
            lines.append(
                f'pyabc_tpu_fleet_{key}{{agg="{agg}"}} {aggs[agg]}')
    return "\n".join(lines) + "\n"
