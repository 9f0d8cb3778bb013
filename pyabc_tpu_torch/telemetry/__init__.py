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
- :mod:`.phases` — the round's phase marks (CUDA timing events while
  the tracer is on) and the clocks of its count reads.
- :func:`profile_generation` — a ``torch.profiler`` trace of one
  generation (``PYABC_TPU_PROFILE_GEN=<t>``), with the tracer's spans
  of the generation on the profiler's clock.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

from . import aggregate, flight, lanes, metrics, phases, spans, timeline
from .flight import RECORDER
from .metrics import REGISTRY
from .spans import TRACER, begin, end, span
from .timeline import GenerationTimeline

#: generation index to wrap in a profiler trace (unset = off)
PROFILE_GEN_ENV = "PYABC_TPU_PROFILE_GEN"
#: where the profiler writes its Chrome trace
PROFILE_DIR_ENV = "PYABC_TPU_PROFILE_DIR"
#: the annotation that ties the profiler's clock to ``perf_counter``
ANCHOR = "pyabc_tpu.anchor"


@contextlib.contextmanager
def profile_generation(t: int):
    """Wrap generation ``t`` in a ``torch.profiler.profile`` (CPU and,
    when a card is present, CUDA activities) when
    ``PYABC_TPU_PROFILE_GEN`` names it; otherwise free (one env lookup).

    The Chrome trace is written to ``$PYABC_TPU_PROFILE_DIR`` (default
    ``pyabc_tpu_profile`` under the system temp dir) as
    ``gen_<t>_<pid>.json``; view it in Perfetto or chrome://tracing.

    One clock for spans and kernels: on entry (after a
    ``torch.cuda.synchronize()`` where there is a card, and a warm-up
    annotation) the profiler records the annotation :data:`ANCHOR` at a
    known ``perf_counter`` reading; the tracer's spans of the generation
    (those begun inside the profile, with the tracer on) are shifted onto
    the profiler's clock by that anchor and written into the same trace
    (``cat: "pyabc_tpu"``), each host span above the kernels it
    launched."""
    want = os.environ.get(PROFILE_GEN_ENV)
    if want is None or str(t) != want:
        yield
        return
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    log_dir = os.environ.get(PROFILE_DIR_ENV) or os.path.join(
        tempfile.gettempdir(), "pyabc_tpu_profile")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        # a profile's first annotation pays its set-up inside its
        # interval: the anchor is the second
        with record_function(ANCHOR + ".warm"):
            pass
        anchor_pc = time.perf_counter()
        with record_function(ANCHOR):
            pass
        yield
    path = os.path.join(log_dir, f"gen_{t}_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    _merge_spans(path, anchor_pc)


def _merge_spans(path: str, anchor_pc: float) -> int:
    """Write the tracer's completed spans begun at or after
    ``anchor_pc`` into the Chrome trace at ``path``, on its clock: the
    :data:`ANCHOR` event there was taken at ``anchor_pc``.  Returns the
    spans written (0: none, or no anchor in the trace)."""
    sps = [s for s in TRACER.spans()
           if s.t_end is not None and s.t_start >= anchor_pc]
    if not sps:
        return 0
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    anchor = next((e for e in events
                   if e.get("name") == ANCHOR and e.get("ph") == "X"
                   and "gpu" not in str(e.get("cat", ""))), None)
    if anchor is None:
        return 0
    origin = float(anchor["ts"]) - anchor_pc * 1e6
    events.extend(TRACER._event(s, origin_us=origin, pid=anchor.get("pid"))
                  for s in sps)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(sps)


__all__ = [
    "GenerationTimeline", "RECORDER", "REGISTRY", "TRACER", "aggregate",
    "begin", "end", "flight", "lanes", "metrics", "phases",
    "profile_generation", "span", "spans", "timeline",
]
