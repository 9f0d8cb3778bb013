"""Always-on flight recorder: the last mile of a failed run.

Port of ``pyabc_tpu/telemetry/flight.py``.  Failures at scale are rarely
reproducible with tracing enabled — the flight recorder keeps a small bounded ring of *rare* events (retries,
degradations, injected faults, preemptions) and, on failure, dumps one
self-contained ``flight_<runid>.json`` carrying the ring plus the full
metrics registry, wire ledger, egress breakdown, recent span ring and
timeline tail.  Dump triggers:

- any exception escaping ``ABCSMC.run`` (smc.py);
- ``RetryExhausted`` at the raise site (resilience/retry.py) — this
  fires even when the orchestrator later absorbs the error into a
  degradation, so the evidence survives the recovery;
- SIGTERM / ``Preempted`` (resilience/checkpoint.py's handler);
- explicit :meth:`FlightRecorder.dump`.

Cost model: the hot loop never calls :meth:`note` — only failure paths
do — so a clean run pays nothing per round.

``PYABC_TPU_FLIGHT=0`` disables recording entirely (note() and dump()
become no-ops).  Dumps land in the run directory when one is advertised
(``$PYABC_TPU_RUN_DIR``), else ``$PYABC_TPU_FLIGHT_DIR``, else
a per-user ``pyabc_tpu_flight`` directory under the system temp dir —
never the working directory, so a crash can't litter a source
checkout.  Repeat dumps for one run overwrite the same file — the last
writer has the most context, and the ring persists across dumps.

Leaf-package rule: wire imports are function-local.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import deque
from typing import Optional

from . import spans
from .metrics import REGISTRY

FLIGHT_ENV = "PYABC_TPU_FLIGHT"
FLIGHT_DIR_ENV = "PYABC_TPU_FLIGHT_DIR"
#: the shared run directory advertised to this process (the JAX
#: package's ``parallel.health.RUN_DIR_ENV``)
RUN_DIR_ENV = "PYABC_TPU_RUN_DIR"
#: this process's fleet identity (``telemetry.aggregate.HOST_ENV``)
HOST_ENV = "PYABC_TPU_HOST_ID"

SCHEMA_VERSION = 1

#: events kept in the ring; failure paths are rare, so this covers a
#: long window of retries/faults without unbounded growth
_CAPACITY = 512

#: recent completed spans included in a dump
_SPAN_TAIL = 128


class FlightRecorder:
    """Bounded ring of failure-path events + self-contained dump."""

    def __init__(self, capacity: int = _CAPACITY):
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._run_id: Optional[str] = None
        self._timeline = None
        self.enabled = os.environ.get(FLIGHT_ENV, "1") != "0"
        self.dumps = 0

    # -- recording -----------------------------------------------------
    def note(self, kind: str, **attrs):
        """Append one event.  Called ONLY on failure paths (retry
        attempts, degradations, fired faults, preemptions) — never from
        the hot loop."""
        if not self.enabled:
            return
        ev = {"t_unix": time.time(), "kind": kind}
        ev.update(attrs)
        with self._lock:
            self._events.append(ev)

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def set_run_id(self, run_id):
        """Name subsequent dumps after the run (History id); the
        orchestrator sets this at run start."""
        self._run_id = None if run_id is None else str(run_id)

    def set_timeline(self, timeline):
        """Attach the live GenerationTimeline so dumps can include its
        tail without the trigger site having to pass it."""
        self._timeline = timeline

    def reset(self):
        """Test isolation: drop events and identity, re-read the env."""
        with self._lock:
            self._events.clear()
        self._run_id = None
        self._timeline = None
        self.enabled = os.environ.get(FLIGHT_ENV, "1") != "0"
        self.dumps = 0

    # -- dumping -------------------------------------------------------
    def _dump_dir(self) -> str:
        d = run_dir()
        if d:
            return d
        explicit = os.environ.get(FLIGHT_DIR_ENV)
        if explicit:
            return explicit
        # no run dir and no explicit override: a stable per-user temp
        # location, NOT the CWD (dumps from ad-hoc runs used to land in
        # whatever directory the process started in — repo roots
        # included)
        import getpass
        import tempfile
        try:
            user = getpass.getuser()
        except Exception:
            user = str(os.getuid()) if hasattr(os, "getuid") else "user"
        return os.path.join(tempfile.gettempdir(),
                            f"pyabc_tpu_flight_{user}")

    def _span_tail(self) -> list:
        t0 = spans.TRACER._t0
        t0_unix = spans.TRACER.t0_unix()
        out = []
        for s in spans.TRACER.spans()[-_SPAN_TAIL:]:
            out.append({
                "name": s.name, "gen": s.gen, "thread": s.thread,
                "t_start_unix": round(t0_unix + (s.t_start - t0), 6),
                "dur_s": (None if s.duration_s is None
                          else round(s.duration_s, 6)),
                "attrs": dict(s.attrs),
            })
        return out

    def dump(self, reason: str, run_id=None,
             directory: Optional[str] = None) -> Optional[str]:
        """Write the flight file; returns its path (None when disabled
        or the write failed — a recorder must never turn one failure
        into two)."""
        if not self.enabled:
            return None
        if run_id is not None:
            self.set_run_id(run_id)
        rid = self._run_id or f"{os.getpid()}"
        try:
            from ..wire import transfer  # leaf rule: function-local

            payload = {
                "schema_version": SCHEMA_VERSION,
                "reason": reason,
                "run_id": rid,
                "host": _host(),
                "pid": os.getpid(),
                "dumped_unix": time.time(),
                "events": self.events(),
                "metrics": REGISTRY.to_dict(),
                "wire": transfer.snapshot(),
                "egress": transfer.egress_breakdown(),
                "recent_spans": self._span_tail(),
            }
            # the last-polled in-dispatch progress word: a kill -9
            # flight dump says exactly which generation died even
            # though the one-dispatch run never returned
            from .lanes import PROGRESS
            payload["run_progress"] = PROGRESS.read()
            if self._timeline is not None:
                payload["timeline_tail"] = self._timeline.to_rows()[-64:]
            d = directory or self._dump_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"flight_{rid}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, default=str)
            os.replace(tmp, path)
        except Exception:
            return None
        self.dumps += 1
        REGISTRY.counter("flight_dumps_total",
                         "flight-recorder dumps written").inc()
        return path


def run_dir():
    """The shared run directory advertised to this process, if any."""
    return os.environ.get(RUN_DIR_ENV)


def _host() -> str:
    """``$PYABC_TPU_HOST_ID`` else the hostname."""
    return os.environ.get(HOST_ENV) or socket.gethostname()


#: the process-global recorder every failure site notes into
RECORDER = FlightRecorder()
