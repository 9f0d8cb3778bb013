"""Study-trace assembly: lifecycle events -> critical-path attribution.

Port of ``pyabc_tpu/telemetry/studytrace.py`` (host code, copied).  The
serving data plane appends one structured event per study state
transition to ``<serve root>/trace/`` (:mod:`..serve.tracing`).  This
module is the read side: it folds an event stream into the study's
critical path:

========================  =============================================
phase                     interval
========================  =============================================
``queue_wait_s``          every ``submitted``/``requeued`` -> next
                          ``claimed`` interval, summed across bounces
``claim_to_dispatch_s``   ``claimed`` -> ``batched`` (spec unpickle,
                          cache probe, batch grouping)
``compile_s``             ``batched`` -> ``dispatched`` (engine build or
                          renew, study-axis program build)
``device_s``              ``dispatched`` -> ``drained`` (the dispatch,
                          result fetch included)
``drain_s``               ``drained`` -> ``published`` (summary and
                          cache publish)
``publish_s``             ``published`` -> ``tombstoned`` (tombstone
                          write; also the tail phase of a cache hit)
========================  =============================================

Phases come from consecutive event timestamps of one ordered stream, so
they are monotone, do not overlap, and sum to the study's end-to-end
latency.  Timestamps are the events' ``unix`` clocks: a bounced study's
events come from several processes.

Also here: the fleet latency histogram counters (one flat counter per
bucket, ``serve_latency_ms_le_<bucket>``, so that they sum across
workers) and the SLO burn ledger, which ``aggregate.fleet_rollup``
re-folds.

Telemetry is a leaf package: this module reads the trace directory with
``os``/``json`` and imports nothing from ``serve/``.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

from . import spans
from .metrics import REGISTRY

#: critical-path phase names, in lifecycle order
PHASES = ("queue_wait_s", "claim_to_dispatch_s", "compile_s",
          "device_s", "drain_s", "publish_s")

#: the phase a given event OPENS (closing whatever phase was open);
#: events absent here (queued, rescued, shed, rejected) mark instants
#: but do not move the phase machine
_OPENS = {
    "submitted": "queue_wait_s",
    "requeued": "queue_wait_s",
    "claimed": "claim_to_dispatch_s",
    "cache_hit": "publish_s",
    "batched": "compile_s",
    "dispatched": "device_s",
    "drained": "drain_s",
    "published": "publish_s",
}

#: latency histogram bucket upper bounds (milliseconds); flat counters
#: named ``<name>_le_<bucket>`` + ``<name>_le_inf`` + ``<name>_sum_total``
LATENCY_BUCKETS_MS = (5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                      1000.0, 2500.0, 5000.0, 10000.0)

#: the serve-root subdirectory the event log lives in (mirrors
#: serve/tracing.py without importing it — telemetry stays a leaf)
_TRACE_SUBDIR = "trace"


# ---- folding ------------------------------------------------------------

def fold_segments(events: List[dict],
                  end_unix: Optional[float] = None) -> List[dict]:
    """Fold an ordered event stream into contiguous phase segments
    ``[{"phase", "t0_unix", "dur_s"}, ...]``.

    Each event closes the open phase at its timestamp and (if it is a
    phase-opening event) starts the next — one ordered walk, so
    segments never overlap and cover submit → tombstone exactly.  A
    ``tombstoned`` event (or ``end_unix``) closes the final phase."""
    evs = sorted(events, key=lambda r: (float(r.get("unix", 0.0)),
                                        float(r.get("mono", 0.0))))
    segments: List[dict] = []
    open_phase: Optional[str] = None
    open_t0 = 0.0

    def _close(at: float):
        nonlocal open_phase
        if open_phase is not None:
            segments.append({"phase": open_phase, "t0_unix": open_t0,
                             "dur_s": max(at - open_t0, 0.0)})
            open_phase = None

    for rec in evs:
        name = rec.get("event")
        unix = float(rec.get("unix", 0.0))
        if name == "tombstoned":
            _close(unix)
            continue
        opens = _OPENS.get(name)
        if opens is None:
            continue  # instant marker (queued, rescued, shed, ...)
        _close(unix)
        open_phase, open_t0 = opens, unix
    if end_unix is not None:
        _close(float(end_unix))
    return segments


def fold_phases(events: List[dict],
                end_unix: Optional[float] = None) -> dict:
    """Per-phase totals (every :data:`PHASES` key present, seconds),
    plus ``total_s``, ``bounces`` and ``events_n`` — the critical-path
    block written into done/failed tombstones."""
    segments = fold_segments(events, end_unix=end_unix)
    phases = {p: 0.0 for p in PHASES}
    for seg in segments:
        phases[seg["phase"]] = round(
            phases[seg["phase"]] + seg["dur_s"], 6)
    first = min((float(r.get("unix", 0.0)) for r in events
                 if r.get("event") in _OPENS), default=0.0)
    last = (float(end_unix) if end_unix is not None
            else max((float(r.get("unix", 0.0)) for r in events),
                     default=first))
    phases["total_s"] = round(max(last - first, 0.0), 6) if first else 0.0
    phases["bounces"] = sum(1 for r in events
                            if r.get("event") == "requeued")
    phases["events_n"] = len(events)
    return phases


# ---- assembly -----------------------------------------------------------

def _scan_trace_dir(serve_root: str) -> Iterator[dict]:
    """Every parseable event under ``<serve root>/trace/`` —
    torn-tail tolerant (unparseable lines are a crashed emitter's
    last write, skipped)."""
    root = os.path.join(serve_root, _TRACE_SUBDIR)
    try:
        parts = sorted(os.listdir(root))
    except OSError:
        return
    for part in parts:
        pdir = os.path.join(root, part)
        try:
            names = sorted(os.listdir(pdir))
        except OSError:
            continue
        for name in names:
            if not name.endswith(".jsonl"):
                continue
            try:
                with open(os.path.join(pdir, name),
                          encoding="utf-8") as f:
                    lines = f.read().splitlines()
            except OSError:
                continue
            for line in lines:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    yield rec


@dataclass
class StudyTrace:
    """One assembled study trace: the ordered event stream plus its
    folded critical path."""

    trace_id: str
    ticket: Optional[str] = None
    digest: Optional[str] = None
    events: List[dict] = field(default_factory=list)
    phases: Dict[str, float] = field(default_factory=dict)

    @property
    def workers(self) -> List[str]:
        """Every worker that touched this study, in event order —
        length > 1 means the trace is continuous across a bounce."""
        seen: List[str] = []
        for rec in self.events:
            w = rec.get("worker")
            if w and w not in seen:
                seen.append(w)
        return seen

    def event_names(self) -> List[str]:
        return [str(r.get("event")) for r in self.events]

    # -- export --------------------------------------------------------

    def to_chrome_events(self) -> List[dict]:
        """Chrome-trace complete events: one ``"X"`` span per folded
        lifecycle phase segment (plus one instant event per raw
        lifecycle event), on a unix-anchored microsecond timebase —
        loads in Perfetto directly and merges with the fleet span
        tracks (``aggregate.merge_traces`` aligns hosts onto the same
        unix anchor)."""
        if not self.events:
            return []
        t0 = min(float(r.get("unix", 0.0)) for r in self.events)
        end = max(float(r.get("unix", 0.0)) for r in self.events)
        out = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                "args": {"name": f"study {self.ticket or self.trace_id}"}}]
        for seg in fold_segments(self.events, end_unix=end):
            out.append(spans.complete_event(
                f"study.{seg['phase'][:-2]}",
                ts_us=(seg["t0_unix"] - t0) * 1e6,
                dur_us=seg["dur_s"] * 1e6,
                args={"trace_id": self.trace_id}))
        for rec in self.events:
            ev = {"name": f"event.{rec.get('event')}",
                  "cat": "pyabc_tpu", "ph": "i", "s": "t",
                  "ts": round((float(rec.get("unix", 0.0)) - t0) * 1e6,
                              3),
                  "pid": 0, "tid": 0,
                  "args": {k: v for k, v in rec.items()
                           if k not in ("unix", "mono")}}
            out.append(ev)
        return out

    def write_chrome_trace(self, path: str) -> str:
        """The trace as a Chrome-trace JSON array file."""
        events = self.to_chrome_events()
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(events, f)
        os.replace(tmp, path)
        return path

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "ticket": self.ticket,
                "digest": self.digest, "workers": self.workers,
                "events": self.events, "phases": self.phases}

    # -- construction --------------------------------------------------

    @classmethod
    def from_events(cls, events: List[dict],
                    end_unix: Optional[float] = None) -> "StudyTrace":
        evs = sorted(events, key=lambda r: (float(r.get("unix", 0.0)),
                                            float(r.get("mono", 0.0))))
        trace_id = next((r.get("trace_id") for r in evs
                         if r.get("trace_id")), "")
        ticket = next((r.get("ticket") for r in evs
                       if r.get("ticket")), None)
        digest = next((r.get("digest") for r in evs
                       if r.get("digest")), None)
        return cls(trace_id=str(trace_id), ticket=ticket, digest=digest,
                   events=evs, phases=fold_phases(evs,
                                                  end_unix=end_unix))

    @classmethod
    def assemble(cls, serve_root: str,
                 key: str) -> Optional["StudyTrace"]:
        """Assemble ONE study's trace from the serve root's event log,
        looked up by trace id, ticket id, or digest (the newest
        matching trace when a digest key matches several).  ``None``
        when nothing matches."""
        traces = cls.assemble_all(serve_root, key)
        return traces[-1] if traces else None

    @classmethod
    def assemble_all(cls, serve_root: str,
                     key: str) -> List["StudyTrace"]:
        """Every trace matching ``key``, oldest first."""
        by_trace: Dict[str, List[dict]] = {}
        for rec in _scan_trace_dir(serve_root):
            if key in (rec.get("trace_id"), rec.get("ticket"),
                       rec.get("digest")):
                tid = str(rec.get("trace_id", ""))
                by_trace.setdefault(tid, []).append(rec)
        traces = [cls.from_events(evs) for evs in by_trace.values()]
        traces.sort(key=lambda t: min(
            (float(r.get("unix", 0.0)) for r in t.events), default=0.0))
        return traces


# ---- fleet accounting ---------------------------------------------------

def observe_latency_ms(name: str, ms: float):
    """Record one observation into the flat-bucket histogram counters
    (cumulative Prometheus ``le`` semantics; rolled back into a real
    histogram by ``aggregate.render_prometheus``)."""
    for b in LATENCY_BUCKETS_MS:
        if ms <= b:
            REGISTRY.counter(
                f"{name}_le_{b:g}",
                f"{name} observations <= {b:g} ms").inc()
    REGISTRY.counter(f"{name}_le_inf",
                     f"{name} observations (all)").inc()
    REGISTRY.counter(f"{name}_sum_total",
                     f"{name} summed milliseconds").inc(max(ms, 0.0))


def record_study_slo(e2e_ms: float, queue_wait_ms: float,
                     slo_p99_ms: Optional[float] = None):
    """One served study's latency accounting: the fleet latency and
    queue-wait histograms, plus the SLO burn ledger when an SLO is
    configured — ``over`` is burned budget, ``under`` is headroom;
    sheds are counted at admission (``serve_shed_total``), the
    shed-instead-of-burned side of the ledger."""
    observe_latency_ms("serve_latency_ms", e2e_ms)
    observe_latency_ms("serve_queue_wait_ms", queue_wait_ms)
    if not slo_p99_ms or slo_p99_ms <= 0:
        return
    REGISTRY.gauge(
        "serve_slo_p99_ms",
        "configured end-to-end latency SLO"
    ).set(float(slo_p99_ms))
    if e2e_ms > slo_p99_ms:
        REGISTRY.counter(
            "serve_slo_over_total",
            "admitted studies that finished OVER the latency SLO "
            "(burned budget)").inc()
    else:
        REGISTRY.counter(
            "serve_slo_under_total",
            "admitted studies that finished within the latency SLO"
        ).inc()


def latency_histogram(rollup_serve: Dict[str, float],
                      name: str = "serve_latency_ms") -> dict:
    """Re-assemble one flat-bucket histogram from a serve rollup
    block: ``{"buckets": {"5": n, ...}, "count", "sum_ms", "p50_ms",
    "p99_ms"}`` (percentiles are bucket-upper-bound estimates)."""
    buckets = {}
    for b in LATENCY_BUCKETS_MS:
        key = f"{name}_le_{b:g}"
        if key in rollup_serve:
            buckets[f"{b:g}"] = float(rollup_serve[key])
    count = float(rollup_serve.get(f"{name}_le_inf", 0.0))
    total = float(rollup_serve.get(f"{name}_sum_total", 0.0))

    def _pct(q: float) -> float:
        if count <= 0:
            return 0.0
        rank = q * count
        for b in LATENCY_BUCKETS_MS:
            if buckets.get(f"{b:g}", 0.0) >= rank:
                return float(b)
        return float("inf")

    return {"buckets": buckets, "count": count,
            "sum_ms": round(total, 3),
            "p50_ms": _pct(0.50), "p99_ms": _pct(0.99)}


def slo_ledger(rollup_serve: Dict[str, float]) -> dict:
    """The fleet SLO burn ledger from a serve rollup block: admitted
    studies over/under the SLO, sheds (rejected instead of burned),
    and the burn rate over admitted completions."""
    over = float(rollup_serve.get("serve_slo_over_total", 0.0))
    under = float(rollup_serve.get("serve_slo_under_total", 0.0))
    shed = float(rollup_serve.get("serve_shed_total", 0.0))
    admitted = over + under
    return {
        "slo_p99_ms": float(rollup_serve.get("serve_slo_p99_ms", 0.0)),
        "over": over, "under": under, "shed": shed,
        "burn_rate": round(over / admitted, 5) if admitted else 0.0,
    }


def waterfall_text(trace: StudyTrace, width: int = 48) -> List[str]:
    """The trace as an ASCII latency waterfall (the ``abc-top
    --study`` view): one bar per phase, scaled to the study's total
    wall clock."""
    phases = trace.phases or {}
    total = max(float(phases.get("total_s", 0.0)), 1e-9)
    lines = [f"study {trace.ticket or trace.trace_id}  "
             f"total {total * 1e3:.1f}ms  "
             f"bounces {int(phases.get('bounces', 0))}  "
             f"workers {','.join(trace.workers) or '-'}"]
    offset = 0.0
    for p in PHASES:
        dur = float(phases.get(p, 0.0))
        pad = int(round(width * offset / total))
        bar = max(int(round(width * dur / total)), 1 if dur > 0 else 0)
        lines.append(f"  {p:<20s} {dur * 1e3:>9.1f}ms "
                     f"|{' ' * pad}{'#' * bar}")
        offset += dur
    return lines


def now_unix() -> float:
    """Indirection point for tests that freeze the fold clock."""
    return time.time()
