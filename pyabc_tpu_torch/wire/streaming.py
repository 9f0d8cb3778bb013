"""Bounded-depth background ingest: overlap a generation's device-to-host
fetch with the next generation's device work.

Port of ``pyabc_tpu/wire/streaming.py``.  ``StreamingIngest.submit(fn)``
runs ``fn`` (a fetch and decode) on a worker thread and returns an
:class:`IngestTicket`; the orchestrator harvests tickets with
``result()`` in generation order on its own thread, where the History
append (sqlite is thread-affine) and the stop criteria run.

Backpressure is a semaphore of ``depth`` slots, released at harvest (not
when the worker finishes), so at most ``depth`` tickets hold host memory.
``depth == 0`` runs ``fn`` inline on the caller thread: the same calls in
the same order, no thread.  The first worker error latches the engine:
it raises as :class:`WireError` at that ticket's harvest and on every
later ``submit``.  ``abandon`` waits a ticket out, drops its value and
error, and frees its slot.

Overlap accounting per ticket: ``work_s`` is the worker's time,
``wait_s`` the caller's time blocked in ``submit`` or ``result``; the
difference (at least 0) is credited to the ledger's ``overlap_s``.  An
inline ticket (``depth == 0``) counts its work as waited, so a depth-0
run credits no overlap (the JAX package credits its inline work).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

from . import transfer


class WireError(RuntimeError):
    """A streaming-ingest stage failed; the cause is chained."""


class IngestTicket:
    """One in-flight fetch-and-decode unit."""

    __slots__ = ("label", "work_s", "wait_s", "_event", "_value",
                 "_error", "_engine", "_settled")

    def __init__(self, engine, label: str = ""):
        self.label = label
        self.work_s = 0.0
        self.wait_s = 0.0
        self._event = threading.Event()
        self._value = None
        self._error = None
        self._engine = engine
        self._settled = False

    def done(self) -> bool:
        return self._event.is_set()

    def _settle(self):
        if not self._settled:
            self._settled = True
            transfer.record_overlap(max(0.0, self.work_s - self.wait_s))
            self._engine._release(self)

    def result(self, timeout: float = None):
        """Wait for the worker, credit the overlap once, free the slot,
        and return the value (or raise the worker's error)."""
        t0 = time.perf_counter()
        if not self._event.wait(timeout):
            raise WireError(f"ingest ticket timed out: {self.label}")
        self.wait_s += time.perf_counter() - t0
        self._settle()
        if self._error is not None:
            raise WireError(
                f"ingest failed for {self.label}: {self._error!r}"
            ) from self._error
        return self._value

    def abandon(self):
        """Discard a speculative ticket: wait for the worker (a fetch
        cannot be un-run), swallow its error, free the slot."""
        self._event.wait()
        self._settle()
        self._value = None


class StreamingIngest:
    """Bounded-depth executor of fetch-and-decode units."""

    def __init__(self, depth: int = 2):
        self.depth = int(depth)
        self._pool = None
        self._sem = (threading.Semaphore(self.depth)
                     if self.depth > 0 else None)
        self._lock = threading.Lock()
        self._failed = None   # first worker error (latched)
        self._outstanding = []

    def _release(self, ticket):
        with self._lock:
            if ticket in self._outstanding:
                self._outstanding.remove(ticket)
        if self._sem is not None:
            self._sem.release()

    def _run(self, ticket, fn):
        t0 = time.perf_counter()
        try:
            ticket._value = fn()
        except BaseException as err:  # latched, raised at harvest
            ticket._error = err
            with self._lock:
                if self._failed is None:
                    self._failed = err
        finally:
            ticket.work_s = time.perf_counter() - t0
            ticket._event.set()

    def submit(self, fn, label: str = "") -> IngestTicket:
        """Queue ``fn`` (no arguments, returns the payload).  Blocks while
        ``depth`` tickets are unharvested; that wait is booked to the
        ticket's ``wait_s``."""
        with self._lock:
            failed = self._failed
        if failed is not None:
            raise WireError(
                f"streaming ingest already failed: {failed!r}") from failed
        ticket = IngestTicket(self, label)
        if self._sem is not None:
            t0 = time.perf_counter()
            self._sem.acquire()
            ticket.wait_s += time.perf_counter() - t0
        with self._lock:
            self._outstanding.append(ticket)
        if self.depth <= 0:
            self._run(ticket, fn)
            # the caller ran the work itself: nothing of it overlapped
            ticket.wait_s += ticket.work_s
        else:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.depth, thread_name_prefix="wire-ingest")
            self._pool.submit(self._run, ticket, fn)
        return ticket

    def drain(self) -> int:
        """Abandon every outstanding ticket; returns how many."""
        with self._lock:
            pending = list(self._outstanding)
        for ticket in pending:
            ticket.abandon()
        return len(pending)

    def close(self):
        self.drain()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
