"""The port's telemetry layer held to the JAX package's
(``pyabc_tpu/telemetry``): the metrics registry's Prometheus text,
``to_dict`` and ``delta`` after one sequence of operations, the Chrome
trace event shape, ``GenerationTimeline`` rows and medians, the
per-phase cost model and its attribution, the transfer ledger on the
registry, and a seeded config #2 run in each package giving the same
timeline layout and engine paths.  A traced port run emits the JAX
package's span names and the profiler hook writes a Chrome trace."""

import json

import numpy as np
import pytest

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem
from pyabc_tpu.telemetry import lanes as jax_lanes
from pyabc_tpu.telemetry import metrics as jax_metrics
from pyabc_tpu.telemetry import spans as jax_spans
from pyabc_tpu.telemetry import timeline as jax_timeline
from pyabc_tpu_torch import smc, telemetry
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.ops import kde as kde_ops
from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda
from pyabc_tpu_torch.telemetry import lanes, metrics, spans, timeline
from pyabc_tpu_torch.wire import transfer


def _ops(reg):
    """One sequence of registry operations, snapshots along the way."""
    reg.counter("c_total", "a counter").inc(3)
    reg.gauge("g", "a gauge").set(2.5)
    before = reg.to_dict()
    reg.counter("c_total").inc()
    reg.gauge("g").inc(1.5)
    reg.gauge("g").dec(0.25)
    h = reg.histogram("h_seconds", "a histogram")
    for v in (0.0005, 0.02, 0.3, 7.0, 120.0):
        h.observe(v)
    reg.counter("late_total").inc(2)
    return before


def test_registry_prometheus_dict_and_delta_equal_jax():
    ours, theirs = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    b_ours, b_theirs = _ops(ours), _ops(theirs)
    assert ours.render_prometheus() == theirs.render_prometheus()
    assert ours.to_dict() == theirs.to_dict()
    assert ours.delta(b_ours) == theirs.delta(b_theirs)
    with pytest.raises(TypeError):
        ours.gauge("c_total")
    with pytest.raises(ValueError):
        ours.counter("c_total").inc(-1)


def test_record_generation_books_the_jax_names():
    ours, theirs = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    for mod, reg in ((metrics, ours), (jax_metrics, theirs)):
        saved = mod.REGISTRY
        mod.REGISTRY = reg
        try:
            mod.record_generation(4096, 300, 300 / 4096, rounds=2,
                                  wall_s=0.25, sims_low=4096,
                                  sims_full=1024, screen_pass=900)
        finally:
            mod.REGISTRY = saved
    assert ours.render_prometheus() == theirs.render_prometheus()


def test_chrome_trace_event_keys_equal_jax(tmp_path):
    events = {}
    for name, mod in (("ours", spans), ("jax", jax_spans)):
        tracer = mod.SpanTracer()
        path = tmp_path / f"{name}.jsonl"
        tracer.configure(trace_path=str(path))
        with tracer.begin("gen.sample", gen=3, k=2):
            pass
        tok = tracer.begin("ingest.queued", gen=4)
        tracer.end(tok)
        tracer.end(tok)  # idempotent
        tracer.flush()
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        assert [e["name"] for e in lines] == ["gen.sample", "ingest.queued"]
        events[name] = lines
    for ours, theirs in zip(events["ours"], events["jax"]):
        assert ours.keys() == theirs.keys()
        # the port's spans also name their parent span and their run
        assert ours["args"].keys() == theirs["args"].keys() | {"parent",
                                                                "run"}
        assert ours["ph"] == theirs["ph"] == "X"
        assert ours["cat"] == theirs["cat"]
    assert (spans.complete_event("x", 1.0, 2.0, pid=1).keys()
            == jax_spans.complete_event("x", 1.0, 2.0, pid=1).keys())


def test_disabled_span_is_the_shared_null():
    spans.TRACER.reset()
    assert spans.span("x") is spans._NULL
    assert spans.begin("x") is spans._NULL
    spans.end(spans._NULL)


def _timeline_rows(tl):
    tl.history_mode = "lazy"
    tl.stop_reason = "Stopping: minimum epsilon reached"
    tl.capacity = {"precision": "f32", "predicted_bytes": 3 << 20,
                   "budget_bytes": 9 << 20, "measured_bytes": 2 << 20}
    tl.record(0, path="sequential", wall_s=0.5,
              stages={"adapt": 0.1, "dispatch": 0.2, "append": 0.05},
              eps=1.5, accepted=300, total=4096, overlap_s=0.0)
    tl.record(1, path="onedispatch", wall_s=0.25,
              stages={"dispatch": 0.1, "fetch": 0.02, "compute": 0.01},
              eps=0.2, accepted=300, total=2048, overlap_s=0.03,
              engine="onedispatch",
              phases={"simulate": 0.1, "distance": 0.1, "resample": 0.05})
    tl.record(2, path="onedispatch", wall_s=0.75,
              stages={"dispatch": 0.4, "append": 0.5},
              eps=0.2, accepted=300, total=6144, overlap_s=0.1,
              engine="onedispatch", phases={"simulate": 0.7})


def test_generation_timeline_rows_and_summary_equal_jax():
    ours, theirs = timeline.GenerationTimeline(), \
        jax_timeline.GenerationTimeline()
    _timeline_rows(ours)
    _timeline_rows(theirs)
    assert ours.to_rows() == theirs.to_rows()
    assert ours.summary() == theirs.summary()
    assert ours.render_ascii() == theirs.render_ascii()
    # the stage sum equals the wall (other_s takes the remainder)
    for row in ours.to_rows():
        named = sum(row[s + "_s"] for s in timeline.STAGES)
        assert named + row["other_s"] == pytest.approx(
            max(row["wall_s"], named), abs=1e-5)
    with pytest.raises(KeyError):
        ours.record(3, path="x", wall_s=1.0, stages={"bogus": 1.0})
    with pytest.raises(KeyError):
        ours.record(3, path="x", wall_s=1.0, phases={"bogus": 1.0})
    # the port's timeline is also the list of the orchestrator's rows
    ours.append({"t": 0})
    assert len(ours) == 1 and ours[0] == {"t": 0}
    ours.clear()
    assert len(ours) == 0 and ours.to_rows() == []


@pytest.mark.parametrize("eps_mode,adaptive,fidelity", [
    ("constant", False, False), ("quantile", True, False),
    ("temperature", False, True)])
def test_phase_cost_model_and_attribution_equal_jax(eps_mode, adaptive,
                                                    fidelity):
    kw = dict(B=1 << 13, n_target=5000, d=2, s=3, M=2, eps_mode=eps_mode,
              support_rows=4096, adaptive=adaptive, fidelity=fidelity)
    ours = lanes.phase_cost_model(**kw)
    theirs = jax_lanes.phase_cost_model(**kw)
    assert ours.keys() == theirs.keys()
    for k in ours:
        for part in ("per_round", "fixed"):
            assert ours[k][part] == pytest.approx(theirs[k][part],
                                                  rel=1e-12, abs=0)
    rng = np.random.default_rng(3)
    for vec in (rng.uniform(0, 1e6, len(lanes.PHASES)),
                np.zeros(len(lanes.PHASES))):
        a = lanes.attribute_phases(vec, 1.75)
        b = jax_lanes.attribute_phases(vec, 1.75)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-12, abs=1e-12)
        assert sum(a.values()) == pytest.approx(1.75, rel=1e-12)


def test_transfer_ledger_lives_on_the_registry():
    before = transfer.snapshot()
    reg_before = telemetry.REGISTRY.to_dict()
    with transfer.egress("telemetry"):
        transfer.record_d2h(1234, 0.5)
    d = transfer.delta(before)
    assert d["d2h_bytes"] == 1234 and d["d2h_calls"] == 1
    assert isinstance(d["d2h_bytes"], int)
    reg = telemetry.REGISTRY.delta(reg_before)
    assert reg["wire_d2h_bytes_total"] == 1234
    assert reg["wire_egress_telemetry_bytes_total"] == 1234
    assert sum(transfer.egress_breakdown().values()) == \
        transfer.snapshot()["d2h_bytes"]


def _run_both(run_mode, pop=200, gens=4):
    kw = dict(population_size=pop, seed=7, eps=None)
    rows = {}
    for name, pkg, problem in (("ours", pt, make_two_gaussians_problem),
                               ("jax", jpt, jax_problem)):
        models, priors, distance, observed, _ = problem()
        samp = {"min_batch_size": 2048, "max_batch_size": 2048}
        if name == "ours":
            samp["device"] = "cpu"
        extra = {}
        if run_mode == "onedispatch":
            extra = dict(fuse_generations=2, run_mode="onedispatch",
                         eps=pkg.ConstantEpsilon(0.2))
        abc = pkg.ABCSMC(models, priors, distance,
                         population_size=kw["population_size"],
                         sampler=pkg.VectorizedSampler(**samp),
                         seed=kw["seed"], **extra)
        abc.new("sqlite://", observed)
        abc.run(max_nr_populations=gens)
        rows[name] = abc.timeline.to_rows()
    return rows


@pytest.mark.parametrize("run_mode", ["classic", "onedispatch"])
def test_config2_run_timeline_layout_and_paths_equal_jax(run_mode):
    rows = _run_both(run_mode)
    assert [r["path"] for r in rows["ours"]] == \
        [r["path"] for r in rows["jax"]]
    assert [set(r) for r in rows["ours"]] == [set(r) for r in rows["jax"]]
    # the port's builds (rejection loops, engines) are booked in the rows
    # of the generations that made them
    builds = [r["n_compiles"] for r in rows["ours"]]
    assert builds[0] >= 1 and all(b >= 0 for b in builds)
    assert all((r["compile_s"] > 0) == (r["n_compiles"] > 0)
               for r in rows["ours"])


@pytest.mark.parametrize("ingest_mode", ["sequential", "overlap"])
def test_config2_rows_share_out_the_run_between_their_marks(ingest_mode,
                                                            monkeypatch):
    """Each row closes at a restart of the run's row marks: the rows'
    walls, wire shares and K1 launches add up to the run's between the
    first restart and the last (every plain KDE call stands in for a K1
    launch here), and off the card no row has an engine or a peak."""
    cuts = []
    restart = smc._RowMarks.restart

    def cut(self, now=None):
        restart(self, now)
        cuts.append((self.mark, self._wire, self._launches))

    def kde(*args, **kw):
        weighted_kde_logpdf_cuda.launches += 1
        return plain_kde(*args, **kw)

    plain_kde = kde_ops.weighted_kde_logpdf
    monkeypatch.setattr(smc._RowMarks, "restart", cut)
    monkeypatch.setattr(kde_ops, "weighted_kde_logpdf", kde)
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=200,
                    sampler=pt.VectorizedSampler(device="cpu",
                                                 min_batch_size=2048,
                                                 max_batch_size=2048),
                    ingest_mode=ingest_mode, seed=7)
    abc.new("sqlite://", observed)
    abc.run(max_nr_populations=5)
    rows = list(abc.timeline)
    assert len(rows) == 5
    assert ({r["path"] for r in rows} == {"sequential"}) == (
        ingest_mode == "sequential")
    (t0, wire0, k1_0), (t1, wire1, k1_1) = cuts[0], cuts[-1]
    assert sum(r["wall_s"] for r in rows) == pytest.approx(t1 - t0,
                                                           rel=1e-12)
    wire = transfer.delta(wire0, wire1)
    assert wire["d2h_calls"] > 0
    for key in ("d2h_bytes", "d2h_calls", "d2h_s", "compute_s",
                "overlap_s"):
        assert sum(abc.generation_transfer[r["t"]][key] for r in rows) \
            == pytest.approx(wire[key], rel=1e-9, abs=1e-12)
    assert k1_1 - k1_0 >= len(rows) - 1
    assert sum(r["kde_launches"] for r in rows) == k1_1 - k1_0
    assert all(r["engine"] is None and r["peak_mem_gb"] is None
               for r in rows)


def test_traced_run_emits_the_jax_span_names(tmp_path):
    path = tmp_path / "trace.jsonl"
    spans.TRACER.reset()
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=200,
                    eps=pt.ConstantEpsilon(0.2), fuse_generations=2,
                    run_mode="onedispatch", trace_path=str(path),
                    sampler=pt.VectorizedSampler(device="cpu",
                                                 min_batch_size=2048,
                                                 max_batch_size=2048),
                    seed=2)
    abc.new("sqlite://", observed)
    try:
        abc.run(max_nr_populations=4)
    finally:
        spans.TRACER.reset()
    events = [json.loads(x) for x in path.read_text().splitlines()]
    names = {e["name"] for e in events}
    assert {"run", "calibrate", "gen.sample", "onedispatch.dispatch",
            "onedispatch.ingest", "gen.append", "wire.fetch"} <= names
    appended = {e["args"]["gen"] for e in events if e["name"] == "gen.append"}
    assert appended == {0, 1, 2, 3}
    ts = [e["ts"] for e in events]
    assert ts == sorted(ts)


def test_profile_generation_writes_a_chrome_trace(monkeypatch, tmp_path):
    monkeypatch.setenv(telemetry.PROFILE_DIR_ENV, str(tmp_path))
    monkeypatch.setenv(telemetry.PROFILE_GEN_ENV, "1")
    with telemetry.profile_generation(0):
        pass
    assert not list(tmp_path.iterdir())
    import torch
    with telemetry.profile_generation(1):
        torch.ones(64).sum()
    out = list(tmp_path.glob("gen_1_*.json"))
    assert len(out) == 1
    assert "traceEvents" in json.loads(out[0].read_text())
