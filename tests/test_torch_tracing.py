"""The port's round and History instrumentation on the CPU: spans name
their parent and their run, the profiler trace carries the tracer's
spans on its own clock, the stage table's capture columns book each
generation's program builds, every sequential and pipelined row carries
its count-read clocks and its pack seconds, and with the tracer off no
CUDA event is made and no phase mark records."""

import gc
import json
import math
import threading
import weakref

import pytest
import torch

import pyabc_tpu_torch as pt
from pyabc_tpu_torch import telemetry
from pyabc_tpu_torch.autotune import ladder
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.population import Population
from pyabc_tpu_torch.sampler.base import RoundResult
from pyabc_tpu_torch.sampler.device_loop import RoundProgram
from pyabc_tpu_torch.storage.history import History
from pyabc_tpu_torch.telemetry import phases, spans


@pytest.fixture(autouse=True)
def _tracer_reset():
    spans.TRACER.reset()
    yield
    spans.TRACER.reset()


def _run(pop=2000, gens=3, batch=1 << 12, **kw):
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=pop,
                    eps=pt.MedianEpsilon(),
                    sampler=pt.VectorizedSampler(min_batch_size=batch,
                                                 max_batch_size=batch,
                                                 max_rounds_per_call=4,
                                                 device="cpu"),
                    seed=7, device="cpu", **kw)
    abc.new("sqlite://", observed)
    abc.run(max_nr_populations=gens)
    return abc


def _population(n=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = torch.rand(n, generator=g).numpy() + 0.1
    return Population(m=torch.zeros(n, dtype=torch.int32).numpy(),
                      theta=torch.randn(n, 1, generator=g).numpy(),
                      weight=(w / w.sum()).astype("float32"),
                      distance=torch.rand(n, generator=g).numpy(),
                      sum_stats={})


def test_nested_append_spans_name_their_parent_and_run():
    spans.TRACER.configure(enabled=True)
    h = History("sqlite://")
    h.store_initial_data(None, {}, {"y": 1.0}, {}, ["m0"], "", "", "")
    with spans.run_span() as run, spans.span("gen.append", gen=0) as app:
        h.append_population(0, 1.0, _population(), 64, ["m0"], ["p"])
    by = {s.name: s for s in spans.TRACER.spans()}
    for step in ("history.pack", "history.crc", "history.write"):
        assert by[step].parent == app.id, step
        assert by[step].run == run.id
        assert by[step].gen == 0
    assert app.parent == run.id and run.run == run.id
    assert run.parent is None
    assert h.pack_s[0] > 0


def test_cross_thread_span_keeps_its_begin_thread_parent():
    spans.TRACER.configure(enabled=True)
    with spans.span("gen.sample", gen=1) as outer:
        tok = spans.begin("ingest.queued", gen=1)
    # begun inside outer, ended on another thread after outer closed
    done = threading.Thread(target=spans.end, args=(tok,))
    done.start()
    done.join()
    assert tok.t_end is not None and tok.parent == outer.id
    # a cross-thread span is no parent of later spans
    tok2 = spans.begin("ingest.queued", gen=2)
    with spans.span("gen.append", gen=2) as app:
        pass
    spans.end(tok2)
    assert app.parent is None


def test_disabled_tracer_returns_the_shared_null():
    assert spans.span("x") is spans._NULL
    assert spans.run_span() is spans._NULL
    assert spans.begin("x") is spans._NULL


def test_jsonl_writes_parent_and_run(tmp_path):
    path = tmp_path / "trace.jsonl"
    spans.TRACER.configure(trace_path=str(path))
    with spans.run_span(path="x") as run, spans.span("gen.sample", gen=0):
        pass
    spans.TRACER.flush()
    events = {e["name"]: e for e in map(json.loads,
                                        path.read_text().splitlines())}
    assert events["gen.sample"]["args"]["parent"] == run.id
    assert events["gen.sample"]["args"]["run"] == run.id
    assert events["run"]["args"]["parent"] is None


def test_profile_trace_holds_the_spans_on_its_clock(monkeypatch, tmp_path):
    monkeypatch.setenv(telemetry.PROFILE_DIR_ENV, str(tmp_path))
    monkeypatch.setenv(telemetry.PROFILE_GEN_ENV, "4")
    spans.TRACER.configure(enabled=True)
    x = torch.ones(4096)
    with telemetry.profile_generation(4):
        with spans.span("gen.sample", gen=4):
            with torch.profiler.record_function("x"):
                for _ in range(20):
                    x = torch.sin(x)
    (out,) = tmp_path.glob("gen_4_*.json")
    events = json.loads(out.read_text())["traceEvents"]
    (kern,) = [e for e in events if e.get("name") == "x"
               and e.get("cat") != "pyabc_tpu"]
    (host,) = [e for e in events if e.get("cat") == "pyabc_tpu"]
    assert host["name"] == "gen.sample" and host["args"]["gen"] == 4
    # the span opened just before x and closed after it: on one clock its
    # start lies within 50 us of x's, and it holds x's interval
    assert abs(host["ts"] - kern["ts"]) < 50
    assert host["ts"] + host["dur"] > kern["ts"] + kern["dur"] - 50


def _stage_rows(monkeypatch, capture_at=None):
    """A run's stage rows; ``capture_at``: the sampler call (counted from
    1) during which a capture of 0.25 s is booked."""
    samp_cls = pt.VectorizedSampler
    sample = samp_cls.sample_until_n_accepted
    calls = []

    def booked(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == capture_at:
            ladder.record_build(0.25)
        return sample(self, *args, **kwargs)

    with monkeypatch.context() as mp:
        mp.setattr(samp_cls, "sample_until_n_accepted", booked)
        abc = _run(ingest_mode="sequential", history_mode="eager")
    return abc.timeline.to_rows()


def test_stage_table_books_a_generations_capture_in_its_row(monkeypatch):
    base = _stage_rows(monkeypatch)
    # call 1 is the calibration, call 3 generation 1
    got = _stage_rows(monkeypatch, capture_at=3)
    assert [r["gen"] for r in got] == [0, 1, 2]
    for b, r in zip(base, got):
        booked = r["gen"] == 1
        assert r["n_compiles"] == b["n_compiles"] + booked
        # the booked 0.25 s, beside the CPU's engine builds (milliseconds)
        assert (r["compile_s"] >= 0.25) == booked
    # the rejection loops' builds of this run are booked too
    assert sum(r["n_compiles"] for r in base) >= 1


@pytest.mark.parametrize("mode,history", [("sequential", "eager"),
                                          ("overlap", "eager"),
                                          ("overlap", "lazy")])
def test_every_row_carries_its_clocks_and_pack_seconds(mode, history):
    abc = _run(ingest_mode=mode, history_mode=history)
    paths = {r["path"] for r in abc.timeline}
    assert paths == ({"sequential"} if mode == "sequential"
                     else {"sequential", "pipelined"})
    for r in abc.timeline:
        assert r["count_wait_s"] >= 0 and r["round_host_s"] >= 0, r["t"]
        assert r["count_wait_s"] + r["round_host_s"] <= r["loop_s"] + 1e-9
        assert r["pack_s"] > 0, r["t"]
        assert "phase_device_s" not in r


def test_off_makes_no_event_and_marks_nothing(monkeypatch):
    """A seeded config-#2-shaped run at pop 2e4 with the tracer off (and
    on: the CPU has no card to time): no CUDA event, no mark recorded."""
    recorded = []

    def no_event(*args, **kwargs):
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(phases.PhaseMarks, "start",
                        lambda self: recorded.append("start"))
    monkeypatch.setattr(phases.PhaseMarks, "mark",
                        lambda self, name: recorded.append(name))
    for traced in (False, True):
        spans.TRACER.configure(enabled=traced)
        abc = _run(pop=20000, gens=2, batch=1 << 14,
                   ingest_mode="sequential", history_mode="eager")
        assert len(abc.timeline) == 2
    assert recorded == []


def test_round_clock_times_reads_and_traces_them():
    clock = phases.RoundClock()
    assert clock.read(int, torch.tensor(3)) == 3
    assert clock.read(bool, torch.tensor(True)) is True
    row = clock.row()
    assert row["count_wait_s"] > 0 and row["round_host_s"] > 0
    assert row["count_wait_s"] + row["round_host_s"] <= row["loop_s"]
    assert "phase_device_s" not in row
    spans.TRACER.configure(enabled=True)
    traced = phases.RoundClock()
    with spans.span("gen.sample", gen=0) as outer:
        for _ in range(3):
            traced.read(int, torch.tensor(1))
    names = [s.name for s in spans.TRACER.spans() if s.parent == outer.id]
    assert names == ["round.wait", "round.replay", "round.wait",
                     "round.replay", "round.wait"]


def test_marks_outside_recording_are_inert_and_inside_route_to_marks():
    seen = []

    class Marks(phases.PhaseMarks):
        def start(self):
            seen.append("start")

        def mark(self, name):
            seen.append(name)

    marks = Marks()
    phases.start()
    phases.mark("propose")
    assert seen == []
    with phases.recording(marks):
        phases.start()
        phases.mark("propose")
        with phases.recording(None):
            phases.mark("simulate")
        phases.mark("distance")
    phases.mark("density")
    assert seen == ["start", "propose", "distance"]


class _Event:
    """A timing event's stand-in on the CPU: recorded one millisecond
    after the one made before it."""

    made = 0

    def __init__(self):
        _Event.made += 1
        self.at = _Event.made

    def elapsed_time(self, other):
        return float(other.at - self.at)

    def synchronize(self):
        pass


_B = 8


def _raw_round(generator, params):
    """A round of ``_B`` candidates that marks its start and ``propose``
    (``params["x"]``: its argument spec)."""
    phases.start()
    u = torch.rand(_B, generator=generator) + params["x"].sum()
    phases.mark("propose")
    acc = u < 0.5
    return RoundResult(m=torch.zeros(_B, dtype=torch.int64),
                       theta=u[:, None], distance=u, accepted=acc,
                       log_weight=torch.where(acc, -u, -math.inf),
                       stats=u[:, None])


def test_a_recapture_with_the_tracer_off_drops_the_old_graphs_marks(
        monkeypatch):
    """A round captured with the tracer on and captured again (new specs)
    with it off: once the tracer is back on, no phases are read from the
    events of the graph that is gone."""
    monkeypatch.setattr(phases, "_record", _Event)
    prog = RoundProgram(_raw_round, _B, 1000, graphs=True)
    gen = torch.Generator().manual_seed(0)
    spans.TRACER.configure(enabled=True)
    for _ in range(2):   # the eager round and the capture, then a replay
        prog.run(gen, {"x": torch.zeros(1)})
    assert set(prog.take_phases()) == {"propose", "compact"}
    prog.reset()
    spans.TRACER.configure(enabled=False)
    prog.run(gen, {"x": torch.zeros(2)})
    assert prog._round.captures == 2
    spans.TRACER.configure(enabled=True)
    prog.run(gen, {"x": torch.zeros(2)})
    assert prog.take_phases() is None


def test_a_round_program_is_freed_without_a_collection():
    """The program holds its clock and the clock the program (for the
    phase readings), weakly: dropping the program frees its buffers at
    once, with no garbage collection."""
    prog = RoundProgram(_raw_round, _B, 1000)
    gen = torch.Generator().manual_seed(0)
    clock = prog.new_clock()
    prog.run(gen, {"x": torch.zeros(1)})
    clock.read(int, prog.state["count"])
    freed = weakref.ref(prog)
    gc.disable()
    try:
        del prog, clock
        assert freed() is None
    finally:
        gc.enable()
