"""Retry with exponential backoff + jitter for the device hot loop.

Port of ``pyabc_tpu/resilience/retry.py``.  Every device dispatch
(``Sampler._dispatch``, the fused / one-dispatch / pipelined dispatches
in smc.py), the d2h chokepoint (``sampler.base.fetch_to_host``) and the
History's durable writes route through :meth:`RetryPolicy.call`.  A
transient failure (a dropped connection, a locked sqlite, a CUDA
out-of-memory) is retried a bounded number of times with exponential
backoff and seeded jitter; a fatal error (a shape or type bug, a sticky
CUDA error) raises immediately.

When the budget is exhausted on a *transient* error the wrapper raises
:class:`RetryExhausted` — the orchestrator's graceful-degradation
signal: the sequential path drops the sampler one batch rung
(``VectorizedSampler.degrade_rung``) and restarts the generation, the
fused and one-dispatch engines disable themselves for the rest of the
run, and the pipelined engine falls back to the sequential loop.

Two things differ from the JAX package, because a PyTorch dispatch is
not a pure function of a key:

- **The same dispatch on retry.**  A port dispatch advances the run's
  ``torch.Generator``.  :meth:`RetryPolicy.call` takes
  ``generator.get_state()`` before each attempt (``rng=``) and restores
  it before the next, and runs ``restore`` (the caller's rewind of any
  state the attempt advanced, e.g. the sampler's accept cursor) — so a
  failure after rounds have drawn retries the same draws.
- **CUDA errors are not XLA errors.**  ``torch.cuda.OutOfMemoryError``
  and "CUDA error: out of memory" are the port's ``resource_exhausted``:
  transient (the failed attempt's frames are cleared before the backoff
  so the caching allocator can reuse their blocks, and the degrade rung
  halves the batch).  Sticky errors that poison the CUDA context
  (:data:`STICKY_CUDA_MARKERS`) are fatal: every later call would raise
  them again, so there is no retry and no engine fallback.  An
  asynchronous CUDA error surfaces at the next synchronization, usually
  a fetch's event wait: the site that sees it is not the site that
  caused it.

Every retry feeds the telemetry registry (``resilience_retries_total``
+ a per-site counter) and emits a ``retry.backoff`` span.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
import traceback

from .faults import fault_point

logger = logging.getLogger("ABC.Resilience")

_HELP = "retry ledger; see resilience/retry.py"

RETRIES_ENV = "PYABC_TPU_RETRIES"
RETRY_BASE_ENV = "PYABC_TPU_RETRY_BASE_S"


def _counter(name: str):
    # create-or-return each call: survives REGISTRY.reset() in tests
    from ..telemetry.metrics import REGISTRY
    return REGISTRY.counter(name, _HELP)


class RetryExhausted(RuntimeError):
    """A retry-wrapped site kept failing transiently until the attempt
    budget ran out.  Carries the site and attempt count; the last
    transient error is chained as ``__cause__``."""

    def __init__(self, site: str, attempts: int):
        super().__init__(
            f"{site} still failing after {attempts} attempts")
        self.site = site
        self.attempts = attempts


#: OSError subclasses that mean a *caller* bug, not infrastructure
_FATAL_OSERRORS = (FileNotFoundError, PermissionError, IsADirectoryError,
                   NotADirectoryError, FileExistsError)

#: XLA runtime status markers that mean the backend (not the program)
#: failed — kept from the JAX package so one table of errors classifies
#: the same in both packages
_TRANSIENT_XLA_MARKERS = ("unavailable", "deadline", "resource_exhausted",
                          "aborted", "cancelled", "internal", "connection",
                          "socket", "preempt")

#: CUDA errors that leave the context unusable: every later CUDA call in
#: the process raises again, so retrying (or falling back to another
#: engine on the same card) cannot help
STICKY_CUDA_MARKERS = ("illegal memory access", "device-side assert",
                       "unspecified launch failure", "misaligned address",
                       "illegal instruction")


def is_cuda_oom(err: BaseException) -> bool:
    """The port's ``resource_exhausted``: the caching allocator could
    not serve a request."""
    type_names = {c.__name__ for c in type(err).__mro__}
    return ("OutOfMemoryError" in type_names
            or "cuda error: out of memory" in str(err).lower())


def is_sticky_cuda_error(err: BaseException, _depth: int = 0) -> bool:
    """A context-poisoning CUDA error, here or in the cause chain (an
    ingest worker's ``WireError`` wraps what its fetch saw)."""
    msg = str(err).lower()
    if any(k in msg for k in STICKY_CUDA_MARKERS):
        return True
    cause = err.__cause__
    return (cause is not None and cause is not err and _depth < 4
            and is_sticky_cuda_error(cause, _depth + 1))


def is_transient(err: BaseException, _depth: int = 0) -> bool:
    """Transient (infrastructure, worth retrying) vs fatal (program
    bug or poisoned context, raise immediately) classification.

    A donated-buffer error is always fatal (the JAX package's rule, kept
    for the shared table); so is a sticky CUDA error."""
    msg = str(err).lower()
    if "donat" in msg or "buffer has been deleted" in msg:
        return False
    if is_sticky_cuda_error(err):
        return False
    if is_cuda_oom(err):
        return True
    from .journal import IntegrityError
    if isinstance(err, IntegrityError):
        # re-reading the same corrupt bytes cannot help; recovery is the
        # History's ladder, not a retry loop
        return False
    from concurrent.futures import BrokenExecutor
    if isinstance(err, BrokenExecutor):
        return True
    if isinstance(err, (ConnectionError, TimeoutError, InterruptedError)):
        return True
    import sqlite3
    if isinstance(err, sqlite3.OperationalError):
        return ("locked" in msg or "busy" in msg or "disk i/o" in msg)
    if isinstance(err, OSError):
        return not isinstance(err, _FATAL_OSERRORS)
    type_names = {c.__name__ for c in type(err).__mro__}
    if "XlaRuntimeError" in type_names or "JaxRuntimeError" in type_names:
        return any(k in msg for k in _TRANSIENT_XLA_MARKERS)
    if "WireError" in type_names:
        # the streaming engine's wrapper: transient iff its cause is
        cause = err.__cause__
        return True if cause is None else is_transient(cause, _depth + 1)
    cause = err.__cause__
    if cause is not None and cause is not err and _depth < 4:
        return is_transient(cause, _depth + 1)
    return False


class RetryPolicy:
    """Bounded retry with exponential backoff and seeded jitter.

    ``max_attempts`` counts total tries (1 = no retries).  The backoff
    before try ``k`` (k >= 2) is ``min(max_delay_s, base_delay_s *
    2^(k-2)) * (1 + jitter * u)`` with ``u ~ U[0, 1)`` from a seeded,
    lock-protected RNG — deterministic in tests, thread-safe under the
    streaming-ingest workers.
    """

    def __init__(self, max_attempts: int = 3, base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0, jitter: float = 0.5,
                 seed: int = 0):
        self.max_attempts = max(int(max_attempts), 1)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        #: attempts made by the last :meth:`call` (tests, smoke gates)
        self.last_attempts = 0

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        """Policy from ``PYABC_TPU_RETRIES`` (total attempts, default 3)
        and ``PYABC_TPU_RETRY_BASE_S`` (first backoff, default 0.05)."""
        try:
            attempts = int(os.environ.get(RETRIES_ENV, "3"))
        except ValueError:
            attempts = 3
        try:
            base = float(os.environ.get(RETRY_BASE_ENV, "0.05"))
        except ValueError:
            base = 0.05
        return cls(max_attempts=attempts, base_delay_s=base)

    def delay_s(self, failures: int) -> float:
        """Backoff after ``failures`` consecutive failures (>= 1)."""
        with self._lock:
            u = self._rng.random()
        base = min(self.max_delay_s,
                   self.base_delay_s * (2.0 ** (failures - 1)))
        return base * (1.0 + self.jitter * u)

    def call(self, fn, site: str, *args, rng=None, restore=None,
             **kwargs):
        """Run ``fn(*args, **kwargs)`` under this policy at ``site``.

        The fault point fires at the START of each attempt, before the
        dispatch runs.  ``rng`` (a ``torch.Generator`` the dispatch
        draws from) has its state taken before the first attempt and
        put back before every retry; ``restore()`` rewinds whatever
        else an attempt advanced.  Together they make a retry the same
        dispatch as the attempt it replaces, wherever that attempt
        failed."""
        from ..telemetry import spans
        rng_state = rng.get_state() if rng is not None else None
        failures = 0
        while True:
            self.last_attempts = failures + 1
            try:
                fault_point(site)
                return fn(*args, **kwargs)
            except Exception as err:
                if isinstance(err, RetryExhausted) or not is_transient(err):
                    raise
                failures += 1
                _counter("resilience_retries_total").inc()
                _counter("resilience_retry_"
                         + site.replace(".", "_")).inc()
                from ..telemetry.flight import RECORDER
                RECORDER.note("retry", site=site, attempt=failures,
                              err=f"{type(err).__name__}: {err}")
                if failures >= self.max_attempts:
                    # dump at the RAISE: the orchestrator may absorb this
                    # into a degradation and the evidence must survive
                    RECORDER.note("retry_exhausted", site=site,
                                  attempts=failures)
                    RECORDER.dump(reason=f"RetryExhausted:{site}")
                    raise RetryExhausted(site, failures) from err
                if is_cuda_oom(err) and err.__traceback__ is not None:
                    # the failed attempt's frames hold its tensors: free
                    # them before the retry allocates again
                    traceback.clear_frames(err.__traceback__)
                backoff = self.delay_s(failures)
                logger.warning(
                    "transient failure at %s (%s: %s) — retry %d/%d in "
                    "%.3gs", site, type(err).__name__, err, failures,
                    self.max_attempts - 1, backoff)
                del err
                with spans.span("retry.backoff", site=site,
                                attempt=failures):
                    time.sleep(backoff)
                if rng_state is not None:
                    rng.set_state(rng_state)
                if restore is not None:
                    restore()


_SHARED: RetryPolicy = None


def shared_policy() -> RetryPolicy:
    """The process-global policy used by module-level chokepoints that
    have no sampler/orchestrator instance to hang one on
    (``fetch_to_host``, ``History.append_population``)."""
    global _SHARED
    if _SHARED is None:
        _SHARED = RetryPolicy.from_env()
    return _SHARED


def record_degrade(kind: str = ""):
    """Count one graceful-degradation step (batch-rung drop or engine
    fallback) in the telemetry registry, and note it in the flight
    recorder so a dump explains WHY throughput changed mid-run."""
    _counter("resilience_degrade_total").inc()
    from ..telemetry.flight import RECORDER
    RECORDER.note("degrade", degradation=kind or "unspecified")


def retry_counters() -> dict:
    """The resilience ledger as plain numbers (bench / heartbeats)."""
    from ..telemetry.metrics import REGISTRY
    snap = REGISTRY.to_dict()
    return {k: v for k, v in snap.items()
            if k.startswith("resilience_")}
