"""The round's phase marks on the card: what the captured graphs hold
with the span tracer off and on, and the phase readings against the
profiler's device time between consecutive count reads (the card's wall
across each round's kernels: an event pair times the gaps between
kernels too, which the union of kernel intervals leaves out).

Marked ``cuda``: without a card every test here skips.  The file imports
neither JAX nor the JAX package, so it runs on the machine with the card
(which has no JAX), from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_phases_cuda.py
"""

import ctypes
import time

import pytest
import torch

import pyabc_tpu_torch as pt
from pyabc_tpu_torch.autotune import ladder
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.telemetry import phases, spans

pytestmark = pytest.mark.cuda

#: timing events a captured round holds with the tracer on: its start and
#: the end of each phase
ROUND_MARKS = 1 + len(phases.PHASES)
#: and a captured finalize: its start and its end
FINALIZE_MARKS = 2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (see the module docstring)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _tracer_off():
    spans.TRACER.reset()
    yield
    spans.TRACER.reset()


def _run(pop=20000, gens=3, seed=5):
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=pop,
                    eps=pt.MedianEpsilon(),
                    sampler=pt.VectorizedSampler(min_batch_size=1 << 14,
                                                 max_batch_size=1 << 14,
                                                 max_rounds_per_call=4,
                                                 device="cuda"),
                    stores_sum_stats=False, seed=seed, history_mode="eager",
                    ingest_mode="sequential", device="cuda")
    abc.new("sqlite://", observed)
    abc.run(max_nr_populations=gens)
    torch.cuda.synchronize()
    return abc


def _nodes(graph) -> int:
    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    assert rc == 0
    return n.value


def _captured_nodes(monkeypatch, tracer_on: bool, inert: bool = False):
    """``{label: nodes}`` of every graph a fresh 3-generation run
    captures; ``inert``: the phase marks replaced by no-ops (the graphs
    of a program without them)."""
    made = []
    capture = ladder._Graph._capture

    def keep(self, *args, **kwargs):
        capture(self, *args, **kwargs)
        made.append(self)

    graph = torch.cuda.CUDAGraph

    def keep_graph(keep_graph=False):
        # a graph that keeps its cudaGraph_t, to count its nodes
        return graph(keep_graph=True)

    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "CUDAGraph", keep_graph)
        mp.setattr(ladder._Graph, "_capture", keep)
        if inert:
            mp.setattr(phases, "start", lambda: None)
            mp.setattr(phases, "mark", lambda name: None)
        spans.TRACER.configure(enabled=tracer_on)
        try:
            _run()
        finally:
            spans.TRACER.reset()
    out = {}
    for g in made:
        out.setdefault(g.label, []).append(_nodes(g.graph))
    return out


def test_off_captures_the_graphs_without_marks_and_on_adds_only_events(
        dev, monkeypatch):
    inert = _captured_nodes(monkeypatch, tracer_on=False, inert=True)
    off = _captured_nodes(monkeypatch, tracer_on=False)
    on = _captured_nodes(monkeypatch, tracer_on=True)
    assert off == inert
    assert set(on) == set(off)
    rounds = [k for k in off if "_round[" in k and not k.endswith(
        (".reset", ".finalize"))]
    finals = [k for k in off if k.endswith(".finalize")]
    assert rounds and finals
    for label, counts in off.items():
        extra = (ROUND_MARKS if label in rounds
                 else FINALIZE_MARKS if label in finals else 0)
        assert on[label] == [c + extra for c in counts], label


def test_off_creates_no_event(dev, monkeypatch):
    made = []
    event = torch.cuda.Event

    def counted(*args, **kwargs):
        made.append(kwargs)
        return event(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "Event", counted)
    abc = _run()
    timing = [k for k in made if k.get("enable_timing")]
    assert not timing
    assert all("phase_device_s" not in r for r in abc.timeline)


def _kernels(prof):
    """``(start_us, end_us)`` of every kernel the card ran, and the
    host-side start of the anchor annotation."""
    cuda = torch.autograd.DeviceType.CUDA
    out, anchor = [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns() / 1e3
        if name == "phases.anchor" and e.device_type() != cuda:
            anchor = a
        elif (e.device_type() == cuda and not name.startswith("phases.")
              and not name.startswith(("Memcpy", "Memset"))):
            out.append((a, a + e.duration_ns() / 1e3))
    return sorted(out), anchor


def _kernel_span(kernels, lo: float, hi: float) -> float:
    """Seconds from the first kernel's start to the last kernel's end
    among those that start in ``[lo, hi)`` (µs): the card's wall across
    a round's kernels, the gaps between them included, as an event pair
    times it."""
    inside = [(a, b) for a, b in kernels if lo <= a < hi]
    if not inside:
        return 0.0
    return (max(b for _, b in inside) - inside[0][0]) * 1e-6


def test_phase_readings_match_the_device_time_between_count_reads(
        dev, monkeypatch):
    from pyabc_tpu_torch.sampler.device_loop import RoundProgram

    taken = []
    take = RoundProgram.take_phases

    def kept(self):
        got = take(self)
        taken.append(got)
        return got

    monkeypatch.setattr(RoundProgram, "take_phases", kept)
    spans.TRACER.configure(enabled=True, capacity=1 << 17)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        with torch.profiler.record_function("phases.warm"):
            pass
        anchor_pc = time.perf_counter()
        with torch.profiler.record_function("phases.anchor"):
            pass
        abc = _run()
    sps = [s for s in spans.TRACER.spans() if s.t_start >= anchor_pc]
    kernels, anchor = _kernels(prof)
    assert anchor is not None
    offset = anchor - anchor_pc * 1e6
    # the generations' count reads (the calibration's round has no
    # program and marks no phase), in order: one phase reading each
    samples = {s.id for s in sps if s.name == "gen.sample"}
    reads = [i for i, s in enumerate(sps)
             if s.name == "round.wait" and s.parent in samples]
    assert len(reads) == len(taken)
    phase_s = span_s = 0.0
    compared = 0
    for i, got in zip(reads, taken):
        prev, cur = sps[i - 1], sps[i]
        # a round launched between two reads: from one read's return to
        # the next one's (the first round of a rung runs before the
        # first read of its loop, eagerly, and is left out)
        if not got or prev.name != "round.replay" \
                or abs(cur.t_start - prev.t_end) > 1e-9:
            continue
        span = _kernel_span(kernels, prev.t_start * 1e6 + offset,
                            cur.t_end * 1e6 + offset)
        phase_s += sum(got.values())
        span_s += span
        compared += 1
    assert compared >= 5 and span_s > 0
    assert abs(phase_s - span_s) <= 0.10 * span_s, (phase_s, span_s)
    rows = [r for r in abc.timeline if "phase_device_s" in r]
    assert len(rows) == len(abc.timeline)
    for r in rows:
        assert set(r["phase_device_s"]) == set(phases.PHASES)
        assert r["phase_rounds"] >= 1
        if r["t"] > 0:
            assert r["finalize_device_s"] > 0
