"""Host<->device transfer and overlap accounting: the wire's ledger.

Port of the ledger half of ``pyabc_tpu/wire/transfer.py``.  Process-wide
counters, under one lock, that the single device-to-host chokepoint
(``sampler.base.fetch_to_host``) and the streaming-ingest engine
increment, so that wire bytes and the time the host spends waiting on
them are machine-visible per generation (``ABCSMC.generation_transfer``)
and feed the batch autotuner's margin.

Ledger keys (cumulative since process start):

- ``d2h_bytes`` / ``d2h_calls`` / ``h2d_bytes`` — raw wire volume.
- ``compute_s`` — seconds a fetch waited for the PRODUCING computation
  before any byte moved.  On the card this is the host's wait on a
  ``torch.cuda.Event`` recorded on the producing stream right after the
  producer's kernels were queued (``sampler.base.mark_ready``); on the
  CPU the producer has finished when the fetch starts and it is 0.
  The JAX package books the same wait from ``block_until_ready``; its
  dispatch returns at once, so its wait covers the whole device program,
  while a port block is a Python loop that reads each round's loop
  condition and has nearly finished by the time its wire is fetched.
- ``d2h_s`` / ``fetch_s`` — the copy alone: after the event, from the
  start of the ``non_blocking`` copies into pinned host buffers on the
  fetch's own stream to that stream's synchronize (one counter, two
  names, as in the JAX package).
- ``decode_s`` — host-side decode seconds (the port has no narrow wire
  codec: nothing books here yet; kept so both ledgers have one layout).
- ``overlap_s`` — fetch seconds a background ingest worker spent while
  the caller thread was not blocked on them (``wire.streaming``).
- ``rewinds`` — speculative generations the pipelined engine discarded
  (``ABCSMC._run_pipelined``'s ``rewind_to_frontier``).

``snapshot()``/``delta()`` also report the derived ``d2h_mb_per_s``.
Every fetched byte is attributed to one ``EGRESS_SUBSYSTEMS`` bucket, the
calling thread's :func:`egress` label (``population`` by default).

Not ported: the PTW1 blob codec (History blobs stay ``.npy``; reading a
database that ``pyabc_tpu`` wrote comes with it) and the telemetry
registry the JAX package stores these counters in.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

#: ledger keys, in the order snapshots report them; ``d2h_s`` and
#: ``fetch_s`` read the same counter
_KEYS = ("d2h_bytes", "d2h_s", "d2h_calls", "h2d_bytes", "compute_s",
         "fetch_s", "decode_s", "overlap_s", "rewinds")
_INT_KEYS = frozenset({"d2h_bytes", "d2h_calls", "h2d_bytes", "rewinds"})
#: the counter behind each key
_COUNTER = {k: ("fetch_s" if k == "d2h_s" else k) for k in _KEYS}

#: d2h egress subsystems: every fetched byte is booked to one of them
EGRESS_SUBSYSTEMS = ("population", "history", "checkpoint", "summary",
                     "control", "telemetry", "other")

_lock = threading.Lock()
_counters = {k: 0 for k in _COUNTER.values()}
_egress_bytes = {name: 0 for name in EGRESS_SUBSYSTEMS}
_egress_tls = threading.local()


def current_egress() -> str:
    """The subsystem the calling thread's next d2h bytes are booked to."""
    return getattr(_egress_tls, "label", "population")


@contextmanager
def egress(subsystem: str):
    """Book d2h bytes this thread records inside the block to
    ``subsystem`` (an unknown name books to ``other``)."""
    if subsystem not in EGRESS_SUBSYSTEMS:
        subsystem = "other"
    prev = current_egress()
    _egress_tls.label = subsystem
    try:
        yield
    finally:
        _egress_tls.label = prev


def egress_breakdown() -> dict:
    """Cumulative d2h bytes per subsystem; sums to ``d2h_bytes``."""
    with _lock:
        return dict(_egress_bytes)


def _inc(key: str, value):
    with _lock:
        _counters[key] += value


def record_d2h(nbytes: int, seconds: float):
    with _lock:
        _counters["d2h_bytes"] += int(nbytes)
        _counters["fetch_s"] += float(seconds)
        _counters["d2h_calls"] += 1
        _egress_bytes[current_egress()] += int(nbytes)


def record_h2d(nbytes: int):
    _inc("h2d_bytes", int(nbytes))


def record_compute(seconds: float):
    """Charge a fetch's wait on its producer."""
    _inc("compute_s", float(seconds))


def record_decode(seconds: float):
    _inc("decode_s", float(seconds))


def record_overlap(seconds: float):
    """Credit fetch seconds a background worker spent while the caller
    thread was not waiting on them."""
    _inc("overlap_s", float(seconds))


def record_rewind(count: int = 1):
    """Count speculative generations a pipeline rewind discarded."""
    _inc("rewinds", int(count))


def _derived(d: dict) -> dict:
    d["d2h_mb_per_s"] = (d["d2h_bytes"] / 1e6 / d["fetch_s"]
                         if d["fetch_s"] > 1e-9 else 0.0)
    return d


def snapshot() -> dict:
    with _lock:
        return _derived({k: (int if k in _INT_KEYS else float)(
            _counters[_COUNTER[k]]) for k in _KEYS})


def delta(before: dict, after: dict = None) -> dict:
    """Counter difference ``after - before`` (``after`` defaults to now),
    with ``d2h_mb_per_s`` over the window."""
    after = after if after is not None else snapshot()
    return _derived({k: after[k] - before.get(k, 0) for k in _KEYS})


def tree_nbytes(tree) -> int:
    """Bytes of the arrays in a nested dict / list / tuple."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    return int(getattr(tree, "nbytes", 0))


class timed_d2h:
    """Times one device-to-host transaction; ``commit(tree)`` books the
    tree's bytes and the seconds.  The caller waits for the producer
    before entering, so the seconds are the copy alone."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False

    def commit(self, tree):
        record_d2h(tree_nbytes(tree), self.seconds)
        return tree
