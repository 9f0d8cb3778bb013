"""Admission load-shedding: reject fast when the fleet is saturated.

Port of ``pyabc_tpu/serve/admission.py`` (host code, copied).

Backpressure (``QueueFull``) and per-tenant quotas protect the QUEUE;
they say nothing about whether the fleet behind it is keeping up.
Under sustained overload a deep-but-under-limit queue just converts
arrival excess into unbounded latency — every admitted study waits
longer, no study is served better.  The shedding controller instead
rejects at the door, *with a price quote*: :class:`ServeOverloaded`
carries a computed ``retry_after_s`` so a well-behaved submitter backs
off proportionally to how far past the SLO the fleet is, and the
studies that ARE admitted keep their latency.

Two independent triggers, both opt-in (unset knob = disabled, zero
behavior change):

- **partition depth** — ``PYABC_TPU_SERVE_SLO_DEPTH``: shed when the
  target partition already holds this many pending studies.  Per
  partition, not global: the shard map (``serve/shards.py``) keys
  equal digests to one partition, so a hot content bucket sheds while
  the rest of the fleet keeps admitting.
- **served p99** — ``PYABC_TPU_SERVE_SLO_P99_MS``: shed when the
  fleet's rolling served-study p99 (workers publish per-worker
  snapshots under ``<serve root>/slo/``; the submitter reads the max
  of the fresh ones) breaches the latency SLO.  This is the
  closed-loop signal: depth says the queue is long, p99 says the
  users are already hurting.

A shed is **distinct from a quota rejection**: quota says *this
tenant* is over its share, shed says *the system* is over its SLO —
different counters (``serve_shed_total`` vs
``serve_queue_rejected_total``), different exception types, different
operator responses.  ``ServeOverloaded`` subclasses
:class:`~pyabc_tpu_torch.serve.queue.QueueFull` so existing retry loops
keep working, and adds ``retry_after_s``.

``retry_after_s`` scales with the breach:
``PYABC_TPU_SERVE_SHED_RETRY_S`` (default 2 s) multiplied by the
overload ratio (depth/limit or p99/SLO) — twice over the SLO quotes
twice the back-off.  All knobs documented in ``docs/serving.md``
("Data plane").
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import time
from typing import Optional, Sequence

from ..telemetry.metrics import REGISTRY
from .queue import QueueFull

#: per-partition pending-depth SLO; shed submissions past it (0/unset
#: disables depth shedding)
SLO_DEPTH_ENV = "PYABC_TPU_SERVE_SLO_DEPTH"

#: fleet rolling served-p99 SLO in milliseconds; shed while breached
#: (0/unset disables latency shedding)
SLO_P99_MS_ENV = "PYABC_TPU_SERVE_SLO_P99_MS"

#: base retry-after quote in seconds, scaled by the overload ratio
SHED_RETRY_S_ENV = "PYABC_TPU_SERVE_SHED_RETRY_S"

_DEFAULT_RETRY_S = 2.0

#: a per-worker latency snapshot older than this is a dead worker's
#: last word, not a live signal — ignored by the fleet read
_SNAPSHOT_FRESH_S = 60.0


class ServeOverloaded(QueueFull):
    """The fleet is past its SLO — come back in ``retry_after_s``."""

    def __init__(self, message: str, retry_after_s: float,
                 reason: str = "overload"):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.reason = reason


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (the worker-side rolling p99)."""
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(int(math.ceil(q * len(vs))) - 1, len(vs) - 1)
    return float(vs[max(idx, 0)])


def _slo_dir(root: str) -> str:
    return os.path.join(root, "slo")


def publish_latency_snapshot(root: str, worker_id: str,
                             walls_ms: Sequence[float],
                             now: Optional[float] = None) -> Optional[str]:
    """Worker side: atomically publish this worker's rolling served-
    latency percentiles under ``<serve root>/slo/<worker>.json`` so
    any submitter on the mount can price admission without talking to
    the worker.  Best-effort — a failed publish never fails a serve."""
    sdir = _slo_dir(root)
    path = os.path.join(sdir, f"{worker_id}.json")
    payload = {
        "worker": worker_id,
        "n": len(walls_ms),
        "p50_ms": round(percentile(walls_ms, 0.50), 3),
        "p99_ms": round(percentile(walls_ms, 0.99), 3),
        "ts": time.time() if now is None else now,
    }
    try:
        os.makedirs(sdir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=sdir, suffix=".tmp")
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path
    except OSError:
        return None


def fleet_p99_ms(root: str, now: Optional[float] = None) -> float:
    """Submitter side: the fleet's rolling served p99 — the max over
    fresh per-worker snapshots (a fleet is as slow as its slowest
    worker; max also can't be gamed down by adding idle workers)."""
    sdir = _slo_dir(root)
    now = time.time() if now is None else now
    worst = 0.0
    try:
        names = os.listdir(sdir)
    except OSError:
        return 0.0
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(sdir, name), encoding="utf-8") as f:
                snap = json.load(f)
            if now - float(snap.get("ts", 0.0)) > _SNAPSHOT_FRESH_S:
                continue
            worst = max(worst, float(snap.get("p99_ms", 0.0)))
        except (OSError, ValueError, TypeError):
            continue  # torn concurrent publish: skip
    return worst


def sweep_snapshots(root: str, liveness: Optional[dict] = None,
                    now: Optional[float] = None,
                    fresh_s: float = _SNAPSHOT_FRESH_S) -> int:
    """GC ``slo/<worker>.json`` latency snapshots (scheduler tick).

    Two reasons to unlink a snapshot, both real leaks the tombstone
    sweep never covered: (a) its worker is DEAD by the fleet liveness
    join — reaped immediately, because inside the freshness window a
    just-died worker's last (often worst) p99 still pollutes the
    fleet max and sheds traffic a healthy fleet could take; (b) it is
    simply stale past ``fresh_s`` — already ignored by
    :func:`fleet_p99_ms`, but accumulating forever on a long-lived
    serve root as workers come and go.

    ``liveness`` maps worker id (``<host>_<pid>``, the snapshot's
    filename stem) → alive, the shape
    ``sched.scheduler.worker_liveness`` returns; ``None`` skips the
    dead-worker reap and only ages out stale files."""
    sdir = _slo_dir(root)
    now = time.time() if now is None else now
    n = 0
    try:
        names = os.listdir(sdir)
    except OSError:
        return 0
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(sdir, name)
        worker = name[:-len(".json")]
        dead = (liveness is not None and worker in liveness
                and not liveness[worker])
        stale = False
        if not dead:
            try:
                with open(path, encoding="utf-8") as f:
                    snap = json.load(f)
                stale = now - float(snap.get("ts", 0.0)) > fresh_s
            except (OSError, ValueError, TypeError):
                stale = True  # unreadable: reap it
        if dead or stale:
            try:
                os.unlink(path)
                n += 1
            except OSError:
                continue  # another sweeper won the race
    if n:
        REGISTRY.counter(
            "serve_slo_snapshots_swept_total",
            "dead/stale per-worker latency snapshots reaped").inc(n)
    return n


def _env_pos(name: str) -> Optional[float]:
    raw = os.environ.get(name)
    if not raw:
        return None
    try:
        val = float(raw)
    except ValueError:
        return None
    return val if val > 0 else None


def slo_p99_ms_configured() -> Optional[float]:
    """The configured end-to-end latency SLO
    (``$PYABC_TPU_SERVE_SLO_P99_MS``), or ``None`` — shared by the
    admission controller and the trace fold's SLO burn ledger."""
    return _env_pos(SLO_P99_MS_ENV)


class AdmissionController:
    """The shed decision, evaluated at submit time (queue side).

    Disabled (both SLO knobs unset) it is a no-op — the data plane
    behaves exactly as before.  Enabled, :meth:`check` raises
    :class:`ServeOverloaded` with a computed ``retry_after_s`` when
    either trigger fires, and counts the shed in
    ``serve_shed_total``."""

    def __init__(self, root: str,
                 slo_depth: Optional[int] = None,
                 slo_p99_ms: Optional[float] = None,
                 retry_s: Optional[float] = None):
        self.root = root
        self.slo_depth = (slo_depth if slo_depth is not None
                          else _env_pos(SLO_DEPTH_ENV))
        self.slo_p99_ms = (slo_p99_ms if slo_p99_ms is not None
                           else _env_pos(SLO_P99_MS_ENV))
        retry = (retry_s if retry_s is not None
                 else _env_pos(SHED_RETRY_S_ENV))
        self.retry_s = _DEFAULT_RETRY_S if retry is None else retry

    def enabled(self) -> bool:
        return bool(self.slo_depth or self.slo_p99_ms)

    def _shed(self, reason: str, message: str, ratio: float):
        REGISTRY.counter(
            "serve_shed_total",
            "study submissions shed by SLO admission control").inc()
        raise ServeOverloaded(
            message,
            retry_after_s=round(self.retry_s * max(ratio, 1.0), 2),
            reason=reason)

    def check(self, partition_depth: int, partition: int = 0):
        """Raise :class:`ServeOverloaded` if admitting one more study
        into this partition would violate an SLO; no-op otherwise."""
        if self.slo_depth and partition_depth >= self.slo_depth:
            self._shed(
                "depth",
                f"partition p{partition:04d} at depth "
                f"{partition_depth} >= SLO {int(self.slo_depth)}",
                partition_depth / self.slo_depth)
        if self.slo_p99_ms:
            p99 = fleet_p99_ms(self.root)
            if p99 > self.slo_p99_ms:
                self._shed(
                    "p99",
                    f"fleet served p99 {p99:.0f}ms > SLO "
                    f"{self.slo_p99_ms:.0f}ms",
                    p99 / self.slo_p99_ms)
