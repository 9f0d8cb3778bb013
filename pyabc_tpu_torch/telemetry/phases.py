"""Device time of a round's phases, and the host clocks of its count
reads.

**Phase marks.**  A round (``sampler/rounds.py``) marks its start and the
end of each of its phases (:data:`PHASES`: ``propose`` — the resampling
CDF, the model jump, the transition draw and the prior; ``simulate``;
``distance`` — the distance and the acceptor; ``density`` — the
in-round proposal density, where it is not deferred; ``compact`` — the
write into the loop's buffers, ``sampler/device_loop.py``), and the
captured finalize marks ``finalize`` around K1's deferred density.  A
mark records a ``torch.cuda.Event(enable_timing=True, external=True)``
on the current stream, and only inside :func:`recording` — which the
round program opens only while :data:`~.spans.TRACER` is enabled, on the
card.  Inside a CUDA-graph capture the records become event nodes of the
graph, and every replay records them again; in an eager round they are
plain records.  Outside :func:`recording` a mark is one thread-local
lookup: no event, no device op, and a graph captured with the tracer off
is node for node the graph without marks.

**Round clock.**  :class:`RoundClock` times every host read of a
round's count (``step`` of the rejection loop, a device block's
``one_gen``, the calibration round): ``count_wait_s``, the seconds
blocked in the read, and ``round_host_s``, from a read's return to the
next read's start (the replay launch and the loop's Python, while the
card holds no queued round).  Two ``perf_counter`` readings a read, with
the tracer off or on.  With the tracer on it also records the spans
``round.replay`` (from one read's return to the next read's start) and
``round.wait`` (the read), and after each read the device seconds
between the marks of the round the read waited for, summed into
``phase_device_s`` over ``phase_rounds`` rounds.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Callable, Optional

from .spans import TRACER

#: a round's phases, in the order it marks their ends
PHASES = ("propose", "simulate", "distance", "density", "compact")

_ACTIVE = threading.local()


class PhaseMarks:
    """The timing events of one program's phase boundaries.  ``current``
    holds the events of the program's last run in Python (an eager call,
    or the capture whose graph records them at every replay): ``(None,
    start)`` then ``(phase, end of the phase)``."""

    __slots__ = ("current",)

    def __init__(self):
        self.current: Optional[list] = None

    def start(self):
        self.current = [(None, _record())]

    def mark(self, name: str):
        if self.current is not None:
            self.current.append((name, _record()))


def _record():
    import torch
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    return ev


@contextlib.contextmanager
def recording(marks: Optional[PhaseMarks]):
    """Route this thread's :func:`start` and :func:`mark` to ``marks``
    (None: no marks) for the duration."""
    prev = getattr(_ACTIVE, "marks", None)
    _ACTIVE.marks = marks
    try:
        yield marks
    finally:
        _ACTIVE.marks = prev


def start():
    """Mark the start of a round (or of a finalize)."""
    marks = getattr(_ACTIVE, "marks", None)
    if marks is not None:
        marks.start()


def mark(name: str):
    """Mark the end of phase ``name``."""
    marks = getattr(_ACTIVE, "marks", None)
    if marks is not None:
        marks.mark(name)


def elapsed(events: list, wait: bool = False) -> dict:
    """``{phase: device seconds}`` between consecutive marks of
    ``events`` (a ``PhaseMarks.current``); ``wait``: block until the last
    one has completed first (else the caller has read past it)."""
    if wait and events:
        events[-1][1].synchronize()
    out = {}
    for (_, a), (name, b) in zip(events, events[1:]):
        out[name] = out.get(name, 0.0) + a.elapsed_time(b) * 1e-3
    return out


class RoundClock:
    """The host clocks of one round loop's count reads (one generation),
    and with the tracer on its rounds' phase device time.  ``program``
    (a ``RoundProgram``) gives the phase readings of the round a read
    waited for (:meth:`RoundProgram.take_phases`); the clock holds it
    weakly, since the program holds its clock and a cycle would keep its
    buffers on the card until a garbage collection."""

    __slots__ = ("count_wait_s", "round_host_s", "phase_device_s",
                 "phase_rounds", "finalize_device_s", "_program", "_t0",
                 "_last")

    def __init__(self, program=None):
        self.count_wait_s = 0.0
        self.round_host_s = 0.0
        self.phase_device_s: dict = {}
        self.phase_rounds = 0
        self.finalize_device_s: Optional[float] = None
        self._program = None if program is None else weakref.ref(program)
        self._t0 = time.perf_counter()
        self._last = None

    def read(self, fn: Callable, *args):
        """``fn(*args)``, a host read of a round's count, timed."""
        t0 = time.perf_counter()
        value = fn(*args)
        t1 = time.perf_counter()
        last, self._last = self._last, t1
        self.count_wait_s += t1 - t0
        if last is not None:
            self.round_host_s += t0 - last
        if TRACER.enabled:
            self._traced(last, t0, t1)
        return value

    def _traced(self, last, t0: float, t1: float):
        if last is not None:
            TRACER.add("round.replay", last, t0)
        TRACER.add("round.wait", t0, t1)
        program = None if self._program is None else self._program()
        got = program.take_phases() if program is not None else None
        if got:
            for k, v in got.items():
                self.phase_device_s[k] = self.phase_device_s.get(k, 0.0) + v
            self.phase_rounds += 1

    def add_finalize(self, seconds: float):
        self.finalize_device_s = (self.finalize_device_s or 0.0) + seconds

    def row(self) -> dict:
        """The clocks as timeline row keys: ``count_wait_s``,
        ``round_host_s`` and ``loop_s`` (the loop's wall, from its start
        to the last read's return); with phase readings ``phase_device_s``
        and ``phase_rounds``; with a timed finalize ``finalize_device_s``."""
        end = self._t0 if self._last is None else self._last
        out = {"count_wait_s": self.count_wait_s,
               "round_host_s": self.round_host_s, "loop_s": end - self._t0}
        if self.phase_rounds:
            out["phase_device_s"] = dict(self.phase_device_s)
            out["phase_rounds"] = self.phase_rounds
        if self.finalize_device_s is not None:
            out["finalize_device_s"] = self.finalize_device_s
        return out
