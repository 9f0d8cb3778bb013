"""Typed counter/gauge/histogram registry — the single metrics store.

Port of ``pyabc_tpu/telemetry/metrics.py``.  The wire ledger
(``pyabc_tpu_torch/wire/transfer.py``) keeps its public
``snapshot()``/``delta()`` API but stores its counters here; the
orchestrator adds its own (generations, evaluations, acceptance rate,
block rounds) through :func:`record_generation`, and the resilience
layer its retries, degradations, checkpoints and journal writes.
``to_dict()`` feeds bench JSON; :meth:`MetricsRegistry.render_prometheus`
renders the Prometheus text exposition.

Import direction: telemetry is a LEAF package — nothing here imports
from the rest of the port, so wire/, sampler/ and smc.py may all import
telemetry freely.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                    10.0, 60.0)


class Counter:
    """Monotonically increasing value (float-valued; cast at read time
    by callers that want ints, e.g. byte counts)."""

    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str, lock: threading.RLock):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = lock

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value that can move both ways (queue depth,
    acceptance rate of the latest generation)."""

    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str, lock: threading.RLock):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = lock

    def set(self, value: float):
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus semantics: each
    bucket counts observations ``<= le``, plus implicit +Inf)."""

    __slots__ = ("name", "help", "buckets", "_counts", "_sum", "_count",
                 "_lock")

    def __init__(self, name: str, help: str, lock: threading.RLock,
                 buckets=_DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * len(self.buckets)
        self._sum = 0.0
        self._count = 0
        self._lock = lock

    def observe(self, value: float):
        with self._lock:
            self._sum += value
            self._count += 1
            for i, le in enumerate(self.buckets):
                if value <= le:
                    self._counts[i] += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def bucket_counts(self):
        """Cumulative per-bucket counts aligned with ``self.buckets``
        (+Inf is ``self.count``)."""
        with self._lock:
            return list(self._counts)


class MetricsRegistry:
    """Create-or-return store of named metrics behind one RLock.

    Getter calls are idempotent: ``counter("x")`` twice returns the same
    object; asking for an existing name as a different type raises, so a
    typo can't silently fork a metric.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, name: str, cls, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name=name, lock=self._lock, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(name, Histogram, help=help,
                                   buckets=buckets)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def to_dict(self) -> dict:
        """Flat scalar snapshot: counters/gauges as their value,
        histograms as ``<name>_count`` and ``<name>_sum``."""
        with self._lock:
            out = {}
            for name, m in sorted(self._metrics.items()):
                if isinstance(m, Histogram):
                    out[name + "_count"] = m.count
                    out[name + "_sum"] = m.sum
                else:
                    out[name] = m.value
            return out

    def delta(self, before: dict, after: Optional[dict] = None) -> dict:
        """Elementwise ``after - before`` over :meth:`to_dict` snapshots
        (``after`` defaults to now); keys new since ``before`` count from
        zero."""
        if after is None:
            after = self.to_dict()
        return {k: v - before.get(k, 0) for k, v in after.items()}

    def render_prometheus(self) -> str:
        """Prometheus text exposition of every registered metric."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines = []
        for name, m in items:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {m.value}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {name} histogram")
                for le, c in zip(m.buckets, m.bucket_counts()):
                    lines.append(f'{name}_bucket{{le="{le}"}} {c}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{name}_sum {m.sum}")
                lines.append(f"{name}_count {m.count}")
        return "\n".join(lines) + "\n"

    def reset(self):
        """Drop every metric (test isolation; the wire ledger re-creates
        its counters lazily on next use)."""
        with self._lock:
            self._metrics.clear()


#: the process-global registry everything records into
REGISTRY = MetricsRegistry()

def record_generation(evals: int, accepted: int, acc_rate: float,
                      rounds: Optional[int] = None,
                      wall_s: Optional[float] = None,
                      sims_low: Optional[int] = None,
                      sims_full: Optional[int] = None,
                      screen_pass: Optional[int] = None):
    """One call per completed SMC generation, from any run path.

    ``sims_low``/``sims_full``/``screen_pass`` are set only by
    fidelity-screened runs: low-fidelity candidate simulations,
    full-fidelity survivor simulations, and screen survivors — their
    ratio is the realized screen rate (``abc_screen_rate``).
    """
    REGISTRY.counter("abc_generations_total",
                     "completed SMC generations").inc()
    REGISTRY.counter("abc_evaluations_total",
                     "total model evaluations").inc(evals)
    REGISTRY.counter("abc_accepted_total",
                     "total accepted particles").inc(accepted)
    REGISTRY.gauge("abc_acceptance_rate",
                   "acceptance rate of latest generation").set(acc_rate)
    if rounds is not None:
        REGISTRY.counter("abc_block_rounds_total",
                         "vectorized acceptance-loop rounds").inc(rounds)
    if wall_s is not None:
        REGISTRY.histogram("abc_generation_seconds",
                           "wall time per generation").observe(wall_s)
    if sims_low is not None:
        REGISTRY.counter("abc_sims_low_total",
                         "low-fidelity screening simulations").inc(
                             sims_low)
    if sims_full is not None:
        REGISTRY.counter("abc_sims_full_total",
                         "full-fidelity survivor simulations").inc(
                             sims_full)
    if screen_pass is not None:
        REGISTRY.counter("abc_screen_pass_total",
                         "candidates surviving the fidelity screen").inc(
                             screen_pass)
        if sims_low:
            REGISTRY.gauge(
                "abc_screen_rate",
                "fidelity-screen survival rate of latest generation"
            ).set(screen_pass / max(sims_low, 1))


_STARTED_AT = time.time()


def heartbeat_summary() -> dict:
    """Compact per-process snapshot for heartbeat payloads: sampler
    throughput plus the wire ledger, all plain scalars."""
    from ..wire import transfer  # function-local: wire imports telemetry

    d = REGISTRY.to_dict()
    tr = transfer.snapshot()
    evals = d.get("abc_evaluations_total", 0)
    acc = d.get("abc_accepted_total", 0)
    return {
        "uptime_s": round(time.time() - _STARTED_AT, 3),
        "generations": int(d.get("abc_generations_total", 0)),
        "evaluations": int(evals),
        "accepted": int(acc),
        "acceptance_rate": round(acc / evals, 6) if evals else 0.0,
        "d2h_mb": round(tr["d2h_bytes"] / 1e6, 3),
        "d2h_mb_per_s": tr["d2h_mb_per_s"],
        "compute_s": round(tr["compute_s"], 3),
        "fetch_s": round(tr["fetch_s"], 3),
        "decode_s": round(tr["decode_s"], 3),
        "overlap_s": round(tr["overlap_s"], 3),
        "rewinds": int(tr["rewinds"]),
        "ingest_inflight": int(d.get("wire_ingest_inflight", 0)),
        # resilience ledger: non-zero retries/degrades on a healthy run
        # are the early warning a fleet reader looks for
        "retries": int(d.get("resilience_retries_total", 0)),
        "degrades": int(d.get("resilience_degrade_total", 0)),
        "checkpoints": int(d.get("resilience_checkpoints_total", 0)),
    }

