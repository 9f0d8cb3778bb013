"""Mid-generation sub-checkpointing: survive preemption inside a gen.

Port of ``pyabc_tpu/resilience/checkpoint.py``.  The History already
gives durable generation-granular resume
(``ABCSMC.load`` restarts at ``max_t + 1``), but at north-star scale a
single generation is minutes of preemptible-TPU work — a SIGTERM
mid-generation used to throw away every accepted particle since the
last ``append_population``.  This module adds a **round-granular
accepted-particle ledger**: the sequential run path hands the sampler a
:class:`GenCheckpointer`, and every N device rounds (``ABCSMC(
checkpoint_every_rounds=...)`` / ``$PYABC_TPU_CKPT_ROUNDS``) — or
immediately on a preemption signal or the run directory's ``STOP``
sentinel — the sampler flushes its cumulative accepted buffer into the
``sub_checkpoints`` History table (one REPLACE'd row per generation).

On resume, the orchestrator splices the flushed rows back in front of a
fresh sample that only needs ``n - k`` more particles
(``Sample.splice_front``), with exact ``nr_evaluations_`` and raw
log-weight accounting across the splice: both halves are draws from the
same proposal at the same eps (the schedule is deterministic from the
last durable generation — the checkpointer records its eps and the
splice is discarded on mismatch), and weight normalization happens once
over the concatenated rows, so the spliced population is statistically
identical to an uninterrupted one.  At most one flush interval of
accepted rounds is ever lost.

SIGTERM handling: :func:`install_signal_handlers` (armed by ``run()``
when checkpointing is on) only sets a flag — the sampler loop notices
at the next device-call boundary, flushes, and raises
:class:`Preempted` so the process can exit with a durable ledger.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Optional

logger = logging.getLogger("ABC.Resilience")

CKPT_ROUNDS_ENV = "PYABC_TPU_CKPT_ROUNDS"

_HELP = "sub-checkpoint ledger; see resilience/checkpoint.py"


def _counter(name: str):
    from ..telemetry.metrics import REGISTRY
    return REGISTRY.counter(name, _HELP)


class Preempted(RuntimeError):
    """Raised by the sampler loop after the preemption flush: the
    sub-checkpoint is durable, the process should exit now.  A later
    ``ABCSMC.load(db).run(...)`` resumes from the flushed rounds."""


_PREEMPT = threading.Event()
_PREV_HANDLER = None
_INSTALLED = False


def install_signal_handlers() -> bool:
    """Route SIGTERM to the preemption flag (main thread only; a
    worker-thread caller is a no-op).  The previous handler is chained
    so embedding applications keep their own cleanup.  Returns whether
    the handler is installed."""
    global _PREV_HANDLER, _INSTALLED
    if _INSTALLED:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False
    prev = signal.getsignal(signal.SIGTERM)

    def _handler(signum, frame):
        _PREEMPT.set()
        # Evidence first: flush the trace tail and note the preemption
        # in the flight recorder NOW — the sampler loop will exit via
        # Preempted at the next device-call boundary, but if the kill
        # timeout races the unwind, the spans and the flight note are
        # the only record of what the run was doing when it died.
        try:
            from ..telemetry import spans
            from ..telemetry.flight import RECORDER
            RECORDER.note("preempt", signal="SIGTERM")
            RECORDER.dump(reason="SIGTERM")
            spans.TRACER.flush()
        except Exception:
            pass  # a handler must never turn a preemption into a crash
        if callable(prev) and prev not in (signal.SIG_DFL, signal.SIG_IGN):
            prev(signum, frame)

    signal.signal(signal.SIGTERM, _handler)
    _PREV_HANDLER = prev
    _INSTALLED = True
    return True


def preempt_requested() -> bool:
    return _PREEMPT.is_set()


def request_preempt():
    """Set the preemption flag directly (in-process tests)."""
    _PREEMPT.set()


def clear_preempt():
    _PREEMPT.clear()


def default_every_rounds() -> int:
    """Flush cadence from ``$PYABC_TPU_CKPT_ROUNDS``; 0 = disabled."""
    try:
        return max(int(os.environ.get(CKPT_ROUNDS_ENV, "0")), 0)
    except ValueError:
        return 0


def _local_stop_requested() -> bool:
    """A local STOP-sentinel poll for mid-generation use: the
    ``STOP`` file in ``$PYABC_TPU_RUN_DIR``, read without any
    collective."""
    from ..parallel import health
    directory = health.run_dir()
    return bool(directory) and os.path.exists(
        os.path.join(directory, health.STOP_SENTINEL))


class GenCheckpointer:
    """Round-granular accepted-particle ledger for one generation.

    Created by the sequential run path (smc.py) and handed to the
    sampler via ``sampler.checkpointer``; the sampler's per-call host
    loop asks :meth:`should_flush` after each device call and flushes
    its CUMULATIVE accepted buffer — the ledger row is replaced, never
    appended, so a crash between flushes loses at most
    ``every_rounds`` rounds of accepted particles.
    """

    def __init__(self, history, t: int, every_rounds: int,
                 eps: Optional[float] = None):
        self.history = history
        self.t = int(t)
        self.every_rounds = max(int(every_rounds), 1)
        self.eps = eps
        self._last_flush_rounds = 0
        #: rows restored by a resume splice — re-flushed in front of the
        #: new rows so a SECOND preemption still has the full ledger
        self._base_batch: Optional[dict] = None
        self._base_evals = 0
        self.flushes = 0
        #: lazy-History mode: a callable returning the DeviceRunStore
        #: manifest.  When set, steady-state cadence flushes write a
        #: manifest-only ledger row (no finalize dispatch, no raw d2h);
        #: the raw batch ships only when :meth:`raw_required` — an
        #: actual preemption/stop, or a resume splice base that must
        #: stay durable.
        self.manifest_source = None

    def set_base(self, batch: dict, nr_evaluations: int):
        self._base_batch = batch
        self._base_evals = int(nr_evaluations)

    def raw_required(self) -> bool:
        """Whether the NEXT flush must ship the raw accepted batch even
        in manifest mode: a preemption or stop is in progress (this is
        the 'actual preemption' the ledger exists for), or the ledger
        carries resume-splice base rows that only exist host-side."""
        return (preempt_requested() or _local_stop_requested()
                or self._base_batch is not None)

    def should_flush(self, rounds: int) -> bool:
        if rounds - self._last_flush_rounds >= self.every_rounds:
            return True
        if rounds <= self._last_flush_rounds:
            return False  # nothing new since the last flush
        return preempt_requested() or _local_stop_requested()

    def flush(self, batch: dict, rounds: int, nr_evaluations: int):
        """Persist the cumulative ledger for this generation.  ``batch``
        is the host view of the accepted buffer (``m``, ``theta``,
        ``distance``, ``log_weight``, ``stats``); evaluations are the
        sampler's own ``rounds * B``."""
        t0 = time.perf_counter()
        if self._base_batch is not None:
            import numpy as np
            base = self._base_batch
            keys = [k for k in ("m", "theta", "distance", "log_weight",
                                "stats") if k in base and k in batch]
            batch = {k: np.concatenate([base[k], batch[k]])
                     for k in keys}
            nr_evaluations = int(nr_evaluations) + self._base_evals
        self.history.save_sub_checkpoint(
            self.t, batch, rounds=rounds,
            nr_evaluations=int(nr_evaluations), eps=self.eps)
        self._last_flush_rounds = rounds
        self.flushes += 1
        dt = time.perf_counter() - t0
        _counter("resilience_checkpoints_total").inc()
        _counter("resilience_checkpoint_seconds_total").inc(dt)
        logger.info(
            "sub-checkpoint t=%d: %d accepted rows through round %d "
            "(%.3gs)", self.t, int(batch["m"].shape[0]), rounds, dt)

    def flush_manifest(self, rounds: int, nr_evaluations: int):
        """Manifest-only ledger heartbeat (lazy-History steady state):
        records progress + the device-store manifest with ZERO raw
        bytes.  A resumed run cannot splice from it (nothing host-side
        existed), but at most one flush interval is lost on a hard kill
        — same bound as the raw ledger — while the common case (no
        preemption) never pays the finalize fetch."""
        t0 = time.perf_counter()
        manifest = None
        if self.manifest_source is not None:
            try:
                manifest = self.manifest_source()
            except Exception:
                logger.exception("store manifest snapshot failed; "
                                 "writing a bare heartbeat row")
        self.history.save_sub_checkpoint(
            self.t, None, rounds=rounds,
            nr_evaluations=int(nr_evaluations), eps=self.eps,
            manifest=manifest)
        self._last_flush_rounds = rounds
        self.flushes += 1
        dt = time.perf_counter() - t0
        _counter("resilience_checkpoints_total").inc()
        _counter("resilience_checkpoint_seconds_total").inc(dt)
        logger.info(
            "sub-checkpoint t=%d: manifest-only through round %d "
            "(%.3gs)", self.t, rounds, dt)

    def maybe_raise_preempted(self):
        """After a flush: if a preemption signal arrived, stop NOW —
        the ledger is durable, finishing the generation would race the
        platform's kill timeout."""
        if preempt_requested():
            # lazy-History runs: previous generations may still be
            # device-resident summary rows — anchor them before the
            # process exits, or the resume purges them.  The persist is
            # a bounded-deadline barrier ($PYABC_TPU_PREEMPT_DEADLINE_S)
            # that journals the packed bytes FIRST (newest-first, cheap
            # fsync'd appends) and only then materializes best-effort —
            # a second kill mid-flush still leaves a replayable journal
            persist = getattr(self.history, "persist_lazy_tail", None)
            if persist is not None:
                try:
                    persist()
                except Exception:
                    logger.exception("lazy-tail persist on preemption "
                                     "failed; resume replays the "
                                     "journal or regenerates")
            raise Preempted(
                f"preemption signal during generation {self.t}; "
                f"sub-checkpoint flushed through round "
                f"{self._last_flush_rounds} — resume with ABCSMC.load()")
