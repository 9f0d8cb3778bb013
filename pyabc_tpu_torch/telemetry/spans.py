"""Low-overhead span tracing for the SMC hot loop.

Port of ``pyabc_tpu/telemetry/spans.py``.  One process-global
:class:`SpanTracer` (:data:`TRACER`) records named,
generation-attributed wall-clock spans into a bounded in-memory ring.
Two usage shapes:

- ``with spans.span("gen.sample", gen=t):`` — same-thread spans
  (the orchestrator's stages).
- ``tok = spans.begin("ingest.queued", gen=t)`` / ``spans.end(tok)`` —
  explicit begin/end for CROSS-THREAD spans (a wire ticket queued on the
  caller thread, picked up by the ingest worker): the span records the
  thread that *began* it, and completion may happen anywhere.

Disabled is the default and must stay ~free: ``span()``/``begin()`` are
a single attribute check returning a shared no-op when the tracer is
off — the hot loop (``fetch_to_host`` runs per round) never pays for
observability it didn't ask for.

Each span records its ``parent`` (the id of the innermost ``span()``
open on the thread that began it; a cross-thread ``begin()`` takes that
thread's, and is itself no parent of later spans) and its ``run`` (the
id of the :func:`run_span` that encloses it, the span of one
``ABCSMC.run``).  :meth:`SpanTracer.add` records a span whose clock
readings the caller already took (the round loop's count reads).

Tracing turns on via ``ABCSMC(trace_path=...)`` or the
``PYABC_TPU_TRACE=/path/trace.jsonl`` environment variable.  Completed
spans are then also buffered for emission as Chrome-trace-format JSONL:
one complete-event object (``"ph": "X"``, microsecond ``ts``/``dur``)
per line, valid JSON line by line, sorted by start time at flush so
``ts`` is monotonic within a run.  Load in Perfetto / chrome://tracing
by wrapping the lines into the JSON array form::

    (echo '['; sed 's/$/,/' trace.jsonl; echo ']') > trace.json
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Optional

#: environment variable naming the Chrome-trace JSONL output path
TRACE_ENV = "PYABC_TPU_TRACE"

#: hard cap on spans buffered for file emission between flushes — a
#: tracer left enabled by a long-lived process must not grow unbounded;
#: overflow is counted (``SpanTracer.dropped``) instead of silently lost
_EMIT_CAP = 200_000


class Span:
    """One completed-or-running span.  Mutable until :meth:`SpanTracer.end`
    seals ``t_end``; usable directly as a context manager (``span()``
    returns one already started)."""

    __slots__ = ("name", "gen", "attrs", "tid", "thread", "t_start",
                 "t_end", "id", "parent", "run", "_tracer", "_stack")

    def __init__(self, tracer, name: str, gen, attrs: dict,
                 t_start: Optional[float] = None):
        self._tracer = tracer
        self.name = name
        self.gen = gen
        self.attrs = attrs
        t = threading.current_thread()
        self.tid = t.ident
        self.thread = t.name
        self.t_end = None
        #: process-unique id; ``parent`` and ``run`` are ids (or None)
        self.id = next(_IDS)
        stack = tracer._open()
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.id
        self.run = None if top is None else top.run
        #: the open-span stack this span was pushed on (``span()`` only)
        self._stack = None
        self.t_start = time.perf_counter() if t_start is None else t_start

    @property
    def duration_s(self) -> Optional[float]:
        if self.t_end is None:
            return None
        return self.t_end - self.t_start

    def set(self, **attrs) -> "Span":
        """Attach attributes after begin (e.g. nbytes known only at the
        end of a fetch)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc):
        self._tracer.end(self)
        return False


class _NullSpan:
    """Shared no-op stand-in returned while tracing is disabled."""

    __slots__ = ()

    def set(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()

#: span ids, unique in the process
_IDS = itertools.count(1)


def complete_event(name: str, ts_us: float, dur_us: float,
                   pid: Optional[int] = None, tid: int = 0,
                   args: Optional[dict] = None,
                   cat: str = "pyabc_tpu") -> dict:
    """One Chrome-trace complete event (``"ph": "X"``) — the single
    place the event shape is written down (the span tracer's JSONL
    sink)."""
    return {
        "name": name,
        "cat": cat,
        "ph": "X",
        "ts": round(ts_us, 3),
        "dur": round(dur_us, 3),
        "pid": os.getpid() if pid is None else pid,
        "tid": tid,
        "args": args or {},
    }


class SpanTracer:
    """Bounded ring of completed spans + optional Chrome-trace JSONL sink.

    Thread-safe: begin() touches only thread-local state, end() takes one
    lock to append.  The ring (``maxlen``-bounded deque) is the in-process
    view (tests, ad-hoc inspection); the emission buffer feeds
    :meth:`flush` when a trace path is configured.
    """

    def __init__(self, capacity: int = 8192):
        self.enabled = False
        self.dropped = 0
        self._path: Optional[str] = None
        self._ring: deque = deque(maxlen=capacity)
        self._emit: list = []
        self._lock = threading.Lock()
        #: per thread: the ``span()`` spans open on it, innermost last
        self._local = threading.local()
        #: perf_counter origin of the trace timebase (µs since this)
        self._t0 = time.perf_counter()

    def _open(self) -> list:
        """The calling thread's stack of open ``span()`` spans."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # -- configuration -------------------------------------------------
    def configure(self, trace_path: Optional[str] = None,
                  enabled: Optional[bool] = None,
                  capacity: Optional[int] = None):
        """Set the JSONL sink and/or toggle recording.  Passing a
        ``trace_path`` enables the tracer unless ``enabled=False`` is
        given explicitly; ``trace_path=""`` clears the sink."""
        with self._lock:
            if capacity is not None:
                self._ring = deque(self._ring, maxlen=int(capacity))
            if trace_path is not None:
                self._path = trace_path or None
            if enabled is not None:
                self.enabled = bool(enabled)
            elif trace_path is not None:
                self.enabled = self._path is not None

    def configure_from_env(self):
        """Adopt ``PYABC_TPU_TRACE`` if set (no-op otherwise, so a
        test-enabled ring-only tracer is left alone)."""
        path = os.environ.get(TRACE_ENV)
        if path:
            self.configure(trace_path=path)

    def reset(self):
        """Disable and drop all buffered state (test isolation)."""
        with self._lock:
            self.enabled = False
            self._path = None
            self._ring.clear()
            self._emit = []
            self.dropped = 0

    @property
    def capacity(self) -> int:
        with self._lock:
            return self._ring.maxlen

    def t0_unix(self) -> float:
        """Wall-clock (unix) instant of trace ``ts == 0``.

        Span ``ts`` values are microseconds since the tracer's
        ``perf_counter`` origin; the flight recorder anchors its span
        tail on this."""
        return time.time() - (time.perf_counter() - self._t0)

    # -- recording -----------------------------------------------------
    def begin(self, name: str, gen=None, **attrs) -> Span:
        """A span begun now on this thread (a cross-thread span: it is
        no parent of the spans begun after it)."""
        return Span(self, name, gen, attrs)

    def open(self, name: str, gen=None, run: bool = False,
             **attrs) -> Span:
        """A span begun now and pushed on this thread's open stack, so
        that the spans begun inside it name it as their parent (``with``
        ends it on the same thread).  ``run``: the span is a run's, and
        its id the ``run`` of every span inside it."""
        sp = Span(self, name, gen, attrs)
        if run:
            sp.run = sp.id
        sp._stack = self._open()
        sp._stack.append(sp)
        return sp

    def add(self, name: str, t_start: float, t_end: float, gen=None,
            **attrs) -> Span:
        """Record a completed span from two ``perf_counter`` readings the
        caller took (parent and run: this thread's innermost open
        span's)."""
        sp = Span(self, name, gen, attrs, t_start=t_start)
        self._seal(sp, t_end)
        return sp

    def end(self, span: Span):
        if span.t_end is not None:  # idempotent (double __exit__/end)
            return
        self._seal(span, time.perf_counter())

    def _seal(self, span: Span, t_end: float):
        span.t_end = t_end
        stack = span._stack
        if stack is not None:
            if stack and stack[-1] is span:
                stack.pop()
            else:  # ended out of order
                try:
                    stack.remove(span)
                except ValueError:
                    pass
        with self._lock:
            self._ring.append(span)
            if self._path is not None:
                if len(self._emit) < _EMIT_CAP:
                    self._emit.append(span)
                else:
                    self.dropped += 1

    def spans(self) -> list:
        """Snapshot of the completed-span ring (oldest first)."""
        with self._lock:
            return list(self._ring)

    # -- emission ------------------------------------------------------
    def _event(self, span: Span, origin_us: Optional[float] = None,
               pid: Optional[int] = None) -> dict:
        """``span`` as a Chrome-trace complete event, ``ts`` in µs since
        the tracer's origin, or, given ``origin_us`` (a trace's clock
        at ``perf_counter() == 0``), on that trace's clock."""
        args = {"thread": span.thread}
        if span.gen is not None:
            args["gen"] = span.gen
        args["parent"] = span.parent
        args["run"] = span.run
        args.update(span.attrs)
        ts = (span.t_start * 1e6 + origin_us if origin_us is not None
              else (span.t_start - self._t0) * 1e6)
        return complete_event(
            span.name,
            ts_us=ts,
            dur_us=(span.t_end - span.t_start) * 1e6,
            pid=pid,
            tid=span.tid,
            args=args,
        )

    def flush(self):
        """Append buffered spans to the JSONL sink, sorted by start time
        so ``ts`` is monotonic per flush batch (one batch per run: the
        orchestrator flushes at the end of ``ABCSMC.run``)."""
        with self._lock:
            batch, self._emit = self._emit, []
            path = self._path
        if not path or not batch:
            return
        batch.sort(key=lambda s: s.t_start)
        lines = [json.dumps(self._event(s)) for s in batch]
        with open(path, "a") as f:
            f.write("\n".join(lines) + "\n")


#: the process-global tracer every instrumentation site uses
TRACER = SpanTracer()

# A preempted or crashing process must not lose the buffered tail of its
# trace — that tail is usually the part that explains the exit.  flush()
# is a no-op when no sink is configured or the buffer is empty, so this
# costs nothing in the disabled default.
atexit.register(TRACER.flush)


def span(name: str, gen=None, **attrs):
    """Start a span (context manager) — no-op unless tracing is enabled."""
    if not TRACER.enabled:
        return _NULL
    return TRACER.open(name, gen=gen, **attrs)


def run_span(**attrs):
    """The ``run`` span of one ``ABCSMC.run`` (context manager): every
    span begun inside it on its thread carries its id as ``run``."""
    if not TRACER.enabled:
        return _NULL
    return TRACER.open("run", run=True, **attrs)


def begin(name: str, gen=None, **attrs):
    """Explicit begin for cross-thread spans; pair with :func:`end`."""
    if not TRACER.enabled:
        return _NULL
    return TRACER.begin(name, gen=gen, **attrs)


def end(tok):
    """Complete a span begun with :func:`begin` (no-op for the disabled
    placeholder)."""
    if tok is not _NULL:
        TRACER.end(tok)
