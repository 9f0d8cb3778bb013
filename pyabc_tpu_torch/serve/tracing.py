"""Study-lifecycle event log: the serving data plane's trace backbone.

Port of ``pyabc_tpu/serve/tracing.py`` (host code, copied).

Every study admitted by :meth:`StudyQueue.submit` gets a ``trace_id``
stamped into its ticket payload and carried for its whole life.  Each
state transition — ``submitted``, ``shed``/``rejected``,
``queued(partition)``, ``claimed(worker, bounce)``,
``cache_hit(tier)``, ``batched(engine, batch_key, width)``,
``dispatched``, ``drained``, ``published``, ``tombstoned``, the
continuous-batching lane markers ``lane_joined(slot, window)`` /
``lane_retired(slot, windows)``, plus the scheduler-driven
``requeued`` and the durable resume's ``rescued(resumed_from_gen)`` —
appends ONE structured JSON line to a per-partition, append-only
event log under the serve root::

    <serve root>/trace/p0000/<bucket>.jsonl
    <serve root>/trace/p0001/<bucket>.jsonl
    ...

Design constraints, in order:

- **Events survive the process that emitted them.**  The log lives on
  the shared serve mount, not in worker memory, so a bounced study's
  trace is continuous across workers: the claim a SIGKILLed worker
  stamped is still there when the rescue worker's events arrive.
- **Appends are atomic.**  One event is one ``os.write`` of one line
  on an ``O_APPEND`` descriptor — well under ``PIPE_BUF``, so
  concurrent emitters on one partition file interleave whole lines,
  never torn ones.  A crash mid-write can still leave a torn TAIL
  (the PJN1 journal failure mode); :meth:`TraceLog.scan` drops any
  line that fails to parse instead of failing the read.
- **The log is partitioned like the queue.**  Events route to the
  study digest's partition (``serve/shards.py``), so assembly scans
  O(events / P) and emitters spread their appends across P inodes
  exactly like claim renames.
- **Segments are sweepable.**  Appends go to a time-bucketed segment
  file (one per :data:`_SEGMENT_S` window per partition); the GC
  (:meth:`TraceLog.sweep`, called from ``Scheduler.tick()``) unlinks
  whole segments older than ``PYABC_TPU_SERVE_TRACE_RETAIN_S`` — no
  rewrite-in-place, so GC never races an appender.
- **Off means off.**  ``PYABC_TPU_SERVE_TRACE=0`` disables every
  emission site: no ``trace_id`` in ticket payloads, no ``trace/``
  directory, no tombstone trace block — the data plane's on-disk
  behavior is byte-identical to the pre-tracing tier.  Default is ON:
  the overhead budget (<2 % of study wall clock, pinned by
  ``bench_serve_load``'s ``serve_trace_overhead_pct`` sentinel row) is
  cheap enough to always pay.

Two clocks per event: ``unix`` (``time.time()``) is the cross-worker
ordering key — trace assembly spans processes and hosts, so phases
are derived from wall clocks, accurate to the fleet's NTP agreement
(the same guarantee heartbeat staleness already leans on); ``mono``
(``time.monotonic()``) rides along for intra-process interval checks
that must not be perturbed by a clock step.

The reducer that folds these events into a critical path lives in
:mod:`pyabc_tpu_torch.telemetry.studytrace` (telemetry stays a leaf package;
it reads the log directory directly and imports nothing from serve/).
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Iterator, List, Optional

from . import shards

#: master switch for study-lifecycle tracing (default ON; "0" restores
#: the pre-tracing data plane byte-for-byte)
TRACE_ENV = "PYABC_TPU_SERVE_TRACE"

#: trace segment retention in seconds (0 disables the sweep)
TRACE_RETAIN_S_ENV = "PYABC_TPU_SERVE_TRACE_RETAIN_S"

_DEFAULT_TRACE_RETAIN_S = 3600.0

#: events are appended to one segment file per partition per this many
#: seconds — GC unlinks whole segments, so it never races an appender
_SEGMENT_S = 900.0

#: subdirectory of the serve root holding the event log
TRACE_SUBDIR = "trace"

#: the lifecycle event vocabulary (docs/observability.md carries the
#: field table); emit() accepts only these so a typo'd event name
#: fails loudly in tests instead of silently never assembling
EVENTS = frozenset({
    "submitted", "rejected", "shed", "queued", "claimed", "cache_hit",
    "batched", "dispatched", "drained", "published", "requeued",
    "rescued", "tombstoned", "lane_joined", "lane_retired",
})


def trace_enabled() -> bool:
    """``$PYABC_TPU_SERVE_TRACE`` — default ON."""
    return os.environ.get(TRACE_ENV, "1").lower() not in (
        "0", "false", "no", "off")


def trace_retain_s() -> float:
    try:
        return float(os.environ.get(TRACE_RETAIN_S_ENV,
                                    str(_DEFAULT_TRACE_RETAIN_S)))
    except ValueError:
        return _DEFAULT_TRACE_RETAIN_S


def trace_dir(serve_root: str) -> str:
    return os.path.join(serve_root, TRACE_SUBDIR)


class TraceLog:
    """One process's handle on the shared event log.

    Instance-owned by its :class:`StudyQueue` / :class:`ServeWorker`
    (never a module global — the study-isolation contract), but all
    instances on a mount append to the same files; the log itself is
    the shared state."""

    def __init__(self, serve_root: str,
                 partitions: Optional[int] = None,
                 enabled: Optional[bool] = None):
        self.serve_root = serve_root
        self.root = trace_dir(serve_root)
        self.partitions = (shards.partitions_default()
                           if partitions is None
                           else max(int(partitions), 1))
        self.enabled = (trace_enabled() if enabled is None
                        else bool(enabled))

    # ---- emission --------------------------------------------------------

    def new_id(self) -> Optional[str]:
        """A fresh trace id — ``None`` while tracing is disabled, so
        disabled-mode ticket payloads carry no trace field at all."""
        return uuid.uuid4().hex if self.enabled else None

    def _segment_path(self, partition: int, unix: float) -> str:
        bucket = int(unix // _SEGMENT_S)
        return os.path.join(self.root,
                            shards.partition_name(partition),
                            f"{bucket}.jsonl")

    def emit(self, trace_id: Optional[str], event: str,
             partition: Optional[int] = None,
             digest: Optional[str] = None,
             **fields) -> Optional[dict]:
        """Append one lifecycle event; returns the record written, or
        ``None`` when tracing is off / the study has no trace id / the
        mount write failed (emission is best-effort — observability
        must never fail the serve path it observes)."""
        if not self.enabled or not trace_id:
            return None
        if event not in EVENTS:
            raise ValueError(f"unknown lifecycle event {event!r}")
        unix = time.time()
        rec = {"trace_id": trace_id, "event": event, "unix": unix,
               "mono": time.monotonic(), "pid": os.getpid()}
        if digest is not None:
            rec["digest"] = digest
        rec.update(fields)
        if partition is None:
            partition = (shards.partition_of(digest, self.partitions)
                         if digest else 0)
        rec["partition"] = partition
        path = self._segment_path(partition, unix)
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY,
                         0o644)
            try:
                os.write(fd, line.encode("utf-8"))
            finally:
                os.close(fd)
        except OSError:
            return None
        return rec

    # ---- reading ---------------------------------------------------------

    def _segment_files(self) -> List[str]:
        out = []
        try:
            parts = sorted(os.listdir(self.root))
        except OSError:
            return out
        for part in parts:
            pdir = os.path.join(self.root, part)
            try:
                names = sorted(os.listdir(pdir))
            except OSError:
                continue
            out.extend(os.path.join(pdir, n) for n in names
                       if n.endswith(".jsonl"))
        return out

    def scan(self) -> Iterator[dict]:
        """Every parseable event in the log (torn-tail tolerant: a
        line that fails to parse — a crash mid-append — is skipped,
        never fatal)."""
        for path in self._segment_files():
            try:
                with open(path, encoding="utf-8") as f:
                    lines = f.read().splitlines()
            except OSError:
                continue
            for line in lines:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail from a crashed emitter
                if isinstance(rec, dict):
                    yield rec

    def events_for(self, key: str) -> List[dict]:
        """All events of one study, sorted by ``unix`` — matched by
        trace id, ticket id, or digest (the ``abc-top --study``
        lookup keys).  A digest key can match several traces; the
        caller disambiguates via each event's ``trace_id``."""
        out = [rec for rec in self.scan()
               if key in (rec.get("trace_id"), rec.get("ticket"),
                          rec.get("digest"))]
        out.sort(key=lambda r: (float(r.get("unix", 0.0)),
                                float(r.get("mono", 0.0))))
        return out

    # ---- housekeeping ----------------------------------------------------

    def sweep(self, retain_s: Optional[float] = None,
              now: Optional[float] = None) -> int:
        """Unlink whole trace segments older than the retention window
        (``PYABC_TPU_SERVE_TRACE_RETAIN_S``, default 1 h; 0 disables).
        Segment granularity means GC never rewrites a file an emitter
        may be appending to.  Called from ``Scheduler.tick()``
        alongside the tombstone sweep."""
        retain_s = trace_retain_s() if retain_s is None else retain_s
        if retain_s <= 0 or not self.enabled:
            return 0
        now = time.time() if now is None else now
        n = 0
        for path in self._segment_files():
            try:
                if now - os.path.getmtime(path) > retain_s:
                    os.unlink(path)
                    n += 1
            except OSError:
                continue  # another sweeper won the race
        return n
