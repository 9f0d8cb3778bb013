"""CompiledLadder: a bounded, thread-safe store of built engine programs
with background prewarm, and the port's program-build accounting.

Port of ``pyabc_tpu/autotune/ladder.py:264-419``.  In the JAX package an
entry is an XLA executable; here it is a built engine closure (a fused
block, a one-dispatch run, a study-axis window), which may hold device
buffers of its own.  The ladder is what the JAX package's is:

- **Bounded.**  An LRU of ``capacity`` entries (default 16); every
  eviction counts ``autotune_ladder_evictions_total``.
- **Thread-safe with single-flight builds.**  A ``get`` for a key that is
  already being built (by the prewarm worker or another thread) waits
  for that build instead of building the same program twice.
- **Shared.**  One ladder on the sampler serves every engine the
  orchestrator builds for it (``smc.ABCSMC._block_fn``); the keys carry
  the round kernel's ``_uid``, so a rebind never reuses a stale program.

Build accounting: the port compiles no device program at run time (the
kernels are built once by ``ops/_build.py``), so the JAX package's
``xla_compiles_total`` / ``xla_compile_seconds_total`` count the port's
own program builds — ladder misses and prewarms, and the study axis's
window builds (``serve/multiplex.py``) — through :func:`record_build`.
:func:`install_compile_listener` has nothing to listen to; it registers
the counters so that :func:`compile_counters` reads zeros before the
first build, and is kept for the callers of the JAX package's name.

The JAX package's ``jit_compile``, ``aot_compile``, ``AotGuard`` and
``avals_like`` belong to its ahead-of-time compile path and have no
counterpart until a round is captured as a CUDA graph.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

from ..telemetry import spans as _spans
from ..telemetry.metrics import REGISTRY

logger = logging.getLogger("ABC.Autotune")

_COMPILES = ("xla_compiles_total",
             "program builds (engine closures, study-axis windows)")
_COMPILE_S = ("xla_compile_seconds_total",
              "seconds spent building programs")


def install_compile_listener():
    """Register the build counters (idempotent); see the module
    docstring for why there is no listener."""
    REGISTRY.counter(*_COMPILES)
    REGISTRY.counter(*_COMPILE_S)


def record_build(seconds: float):
    """Count one program build of ``seconds``."""
    REGISTRY.counter(*_COMPILES).inc()
    REGISTRY.counter(*_COMPILE_S).inc(max(float(seconds), 0.0))


def compile_counters() -> dict:
    """Scalar snapshot of the build accounting, with the JAX package's
    keys (the persistent-cache counters stay 0: the kernel build cache
    is not consulted per program)."""
    d = REGISTRY.to_dict()
    return {
        "n_compiles": int(d.get("xla_compiles_total", 0)),
        "compile_s": float(d.get("xla_compile_seconds_total", 0.0)),
        "cache_hits": int(d.get("xla_cache_hits_total", 0)),
        "cache_misses": int(d.get("xla_cache_misses_total", 0)),
    }


def compile_delta(before: dict, after: Optional[dict] = None) -> dict:
    """Elementwise ``after - before`` over :func:`compile_counters`
    snapshots (``after`` defaults to now)."""
    if after is None:
        after = compile_counters()
    return {k: after[k] - before.get(k, 0) for k in after}


def _timed_build(build: Callable):
    t0 = time.perf_counter()
    value = build()
    record_build(time.perf_counter() - t0)
    return value


class CompiledLadder:
    """Bounded LRU of built programs with single-flight builds and a
    background prewarm worker.

    ``get(key, build)`` returns the cached program, or builds it on the
    calling thread (a ``compile.miss`` span); if the same key is already
    building, it waits for that build.  ``prewarm(key, build)`` enqueues
    the build on the daemon worker (a ``compile.aot`` span); cached and
    in-flight keys are dropped.  A failed prewarm is counted and logged,
    never raised: the eventual ``get`` builds synchronously.
    """

    def __init__(self, capacity: int = 16):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1 (got {capacity})")
        self.capacity = int(capacity)
        self._cache: "OrderedDict" = OrderedDict()
        self._lock = threading.RLock()
        self._inflight: dict = {}        # key -> threading.Event
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        install_compile_listener()

    # ---- introspection ---------------------------------------------------

    def __len__(self):
        with self._lock:
            return len(self._cache)

    def __contains__(self, key):
        with self._lock:
            return key in self._cache

    def keys(self):
        with self._lock:
            return list(self._cache)

    def clear(self):
        with self._lock:
            self._cache.clear()

    def summary(self) -> dict:
        """Hits (a warm program served without a build), misses
        (synchronous builds on the calling thread), evictions, occupancy
        and capacity."""
        with self._lock:
            return {
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "size": len(self._cache),
                "capacity": self.capacity,
            }

    # ---- core ------------------------------------------------------------

    def _insert(self, key, value):
        with self._lock:
            self._cache[key] = value
            self._cache.move_to_end(key)
            while len(self._cache) > self.capacity:
                evicted, _ = self._cache.popitem(last=False)
                self._evictions += 1
                REGISTRY.counter(
                    "autotune_ladder_evictions_total",
                    "built programs dropped by the ladder LRU").inc()
                logger.info("ladder evicted %r (capacity %d)",
                            evicted, self.capacity)

    def get(self, key, build: Callable):
        """Serve ``key``, building on this thread on a miss; waits for an
        in-flight build of the same key rather than duplicating it."""
        while True:
            with self._lock:
                if key in self._cache:
                    self._cache.move_to_end(key)
                    self._hits += 1
                    REGISTRY.counter(
                        "autotune_ladder_hits_total",
                        "warm programs served by the ladder").inc()
                    return self._cache[key]
                ev = self._inflight.get(key)
                if ev is None:
                    ev = self._inflight[key] = threading.Event()
                    owner = True
                else:
                    owner = False
            if not owner:
                ev.wait()
                continue  # built (or failed: then this thread owns it)
            try:
                with _spans.span("compile.miss", key=str(key)):
                    value = _timed_build(build)
                with self._lock:
                    self._misses += 1
                REGISTRY.counter(
                    "autotune_compile_misses_total",
                    "synchronous ladder builds").inc()
                self._insert(key, value)
                return value
            finally:
                with self._lock:
                    self._inflight.pop(key, None)
                ev.set()

    def prewarm(self, key, build: Callable) -> bool:
        """Schedule a background build of ``key``; True when enqueued
        (False: cached or already in flight)."""
        with self._lock:
            if key in self._cache or key in self._inflight:
                return False
            self._inflight[key] = threading.Event()
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._worker_loop,
                    name="pyabc-tpu-torch-prewarm", daemon=True)
                self._worker.start()
        self._queue.put((key, build))
        return True

    def _worker_loop(self):
        while True:
            key, build = self._queue.get()
            try:
                with _spans.span("compile.aot", key=str(key)):
                    value = _timed_build(build)
                REGISTRY.counter(
                    "autotune_aot_builds_total",
                    "background program prewarms").inc()
                self._insert(key, value)
            except Exception:
                REGISTRY.counter(
                    "autotune_aot_errors_total",
                    "failed background program builds").inc()
                logger.warning("prewarm of %r failed (the program is "
                               "built on demand)", key, exc_info=True)
            finally:
                with self._lock:
                    ev = self._inflight.pop(key, None)
                if ev is not None:
                    ev.set()
                self._queue.task_done()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every scheduled prewarm has finished; False on
        timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                events = list(self._inflight.values())
            if not events:
                return True
            for ev in events:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                ev.wait(remaining)
