"""Observability for the PyTorch port: span tracing, a typed metrics
registry, the per-generation run timeline, device telemetry lanes and
the flight recorder.

Port of ``pyabc_tpu/telemetry``:

- :mod:`.spans` — Chrome-trace-emitting span tracer (``span("gen.sample",
  gen=t)``), enabled by ``PYABC_TPU_TRACE`` or ``ABCSMC(trace_path=...)``.
- :mod:`.metrics` — counter/gauge/histogram registry backing the wire
  transfer ledger and the orchestrator's counters; Prometheus text.
- :mod:`.timeline` — :class:`GenerationTimeline`, fed by the
  orchestrator at generation boundaries.
- :mod:`.lanes` — ``tl_*`` device lanes of the fused and one-dispatch
  engines, their per-phase attribution, and the progress word.
- :mod:`.flight` — always-on bounded flight recorder dumping
  ``flight_<runid>.json`` on crash / ``RetryExhausted`` / SIGTERM.
- :mod:`.aggregate` — fleet snapshots, their rollup, the progress
  poller and the Prometheus rendering of a run directory.
- :mod:`.studytrace` — a served study's lifecycle events folded into its
  critical path, the fleet latency histogram and the SLO burn ledger.
- :func:`profile_generation` — a ``torch.profiler`` trace of one
  generation (``PYABC_TPU_PROFILE_GEN=<t>``).
"""

from __future__ import annotations

import contextlib
import os

from . import aggregate, flight, lanes, metrics, spans, timeline
from .flight import RECORDER
from .metrics import REGISTRY
from .spans import TRACER, begin, end, span
from .timeline import GenerationTimeline

#: generation index to wrap in a profiler trace (unset = off)
PROFILE_GEN_ENV = "PYABC_TPU_PROFILE_GEN"
#: where the profiler writes its Chrome trace
PROFILE_DIR_ENV = "PYABC_TPU_PROFILE_DIR"


@contextlib.contextmanager
def profile_generation(t: int):
    """Wrap generation ``t`` in a ``torch.profiler.profile`` (CPU and,
    when a card is present, CUDA activities) when
    ``PYABC_TPU_PROFILE_GEN`` names it; otherwise free (one env lookup).

    The Chrome trace is written to ``$PYABC_TPU_PROFILE_DIR`` (default
    ``pyabc_tpu_profile`` under the system temp dir) as
    ``gen_<t>_<pid>.json``; view it in Perfetto or chrome://tracing."""
    want = os.environ.get(PROFILE_GEN_ENV)
    if want is None or str(t) != want:
        yield
        return
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = os.environ.get(PROFILE_DIR_ENV) or os.path.join(
        tempfile.gettempdir(), "pyabc_tpu_profile")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"gen_{t}_{os.getpid()}.json"))


__all__ = [
    "GenerationTimeline", "RECORDER", "REGISTRY", "TRACER", "aggregate",
    "begin", "end", "flight", "lanes", "metrics", "profile_generation",
    "span", "spans", "timeline",
]
