"""The traced run's device trace: ``torch.profiler`` around one
inference, reduced to what the per-layer readers and ``breakdown``
need.

Host spans (the port's ``TRACER`` ring and the harness's own ``infer``
span) carry ``time.perf_counter`` times; a ``record_function`` anchor
taken at a known ``perf_counter`` reading puts them on the trace's
clock, so each idle gap of the device can be named by the innermost
host span open over it.
"""

from __future__ import annotations

import time
from collections import defaultdict


class DeviceTrace:
    """``with DeviceTrace(torch) as tr: <work>``; afterwards ``reduce``."""

    def __init__(self, torch, device: str = "cuda"):
        self.torch = torch
        self.cuda = device == "cuda"
        self.prof = None
        self.anchor_pc = None
        self.stop_s = None   # seconds the profiler took to stop

    def __enter__(self):
        prof = self.torch.profiler
        acts = [prof.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(prof.ProfilerActivity.CUDA)
        self.prof = prof.profile(activities=acts)
        self.prof.__enter__()
        self._sync()
        self.anchor_pc = time.perf_counter()
        with prof.record_function("pbench.anchor"):
            pass
        return self

    def _sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def __exit__(self, *exc):
        self._sync()
        with self.torch.profiler.record_function("pbench.end"):
            pass
        mark = time.perf_counter()
        self.prof.__exit__(*exc)
        self.stop_s = time.perf_counter() - mark
        return False

    def reduce(self, host_spans) -> dict:
        """``host_spans``: ``(label, start_pc, end_pc)``.  Returns
        ``device_ops`` (name -> device seconds), ``busy_s``,
        ``window_s``, ``idle_gaps`` (the 10 longest, labelled) and
        ``top_ops`` (the 10 costliest)."""
        return reduce_events(profiler_events(self.prof, self.torch),
                             self.anchor_pc, host_spans)


def profiler_events(prof, torch):
    """``(name, start_us, end_us, on_device)`` of every event, read from
    the profiler's raw results (building ``prof.events()`` costs some
    90 us an event, minutes for an inference's million kernels).  An
    annotation's mirror on the device's timeline is no device work: the
    harness's own (``pbench.*``) are the only annotations in the run,
    and a torch that names the event's kind says so."""
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start, name = e.start_ns(), e.name()
        kind = getattr(e, "activity_type", None)
        annotation = ("annotation" in kind() if kind is not None
                      else name.startswith("pbench."))
        on_device = e.device_type() == cuda and not annotation
        yield name, start / 1e3, (start + e.duration_ns()) / 1e3, on_device


def reduce_events(events, anchor_pc: float, host_spans) -> dict:
    """The reduction of ``DeviceTrace.reduce`` over ``(name, start_us,
    end_us, on_device)`` events."""
    intervals, ops = [], defaultdict(float)
    anchor = end = None
    for name, a, b, on_device in events:
        if on_device:
            intervals.append((a, b))
            ops[name] += (b - a) * 1e-6
        elif name == "pbench.anchor":
            anchor = a
        elif name == "pbench.end":
            end = a
    if anchor is None or end is None or not intervals:
        return {}
    offset = anchor - anchor_pc * 1e6
    intervals.sort()
    merged = []
    for a, b in intervals:
        a, b = max(a, anchor), min(b, end)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_us = sum(b - a for a, b in merged)
    gaps, last = [], anchor
    for a, b in merged + [[end, end]]:
        if a > last:
            gaps.append((a - last, last, a))
        last = max(last, b)
    gaps.sort(reverse=True)
    spans = [(label, s * 1e6 + offset, e * 1e6 + offset)
             for label, s, e in host_spans]

    def label(mid):
        open_ = [(e - s, lab) for lab, s, e in spans if s <= mid <= e]
        return min(open_)[1] if open_ else "no host span"

    return {
        "device_ops": dict(ops),
        "busy_s": busy_us * 1e-6,
        "window_s": (end - anchor) * 1e-6,
        "top_ops": sorted(([n, s] for n, s in ops.items()),
                          key=lambda x: -x[1])[:10],
        "idle_gaps": [[label((a + b) / 2), d * 1e-6]
                      for d, a, b in gaps[:10]],
    }


def tracer_spans(tracer) -> list:
    """The completed spans of the port's ``TRACER`` ring as
    ``(label, start_pc, end_pc)``."""
    out = []
    for sp in tracer.spans():
        if sp.t_end is None:
            continue
        label = sp.name if sp.gen is None else f"{sp.name} t={sp.gen}"
        out.append((label, sp.t_start, sp.t_end))
    return out
