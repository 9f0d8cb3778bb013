"""The adaptive distance's refit is traced: one span ``distance.refit``
a generation (the calibration's for the first, then each
``_prepare_next_iteration``'s), its seconds in the rows' ``distance_s``;
a distance that does not adapt has neither."""

import pytest

import pyabc_tpu_torch as pt
from pyabc_tpu_torch.models import (make_lotka_volterra_problem,
                                    make_two_gaussians_problem)
from pyabc_tpu_torch.telemetry import spans

GENS = 3


@pytest.fixture(autouse=True)
def _tracer_reset():
    spans.TRACER.reset()
    yield
    spans.TRACER.reset()


def _run(made, traced, **kw):
    models, priors, distance, observed = made[:4]
    spans.TRACER.configure(enabled=traced)
    abc = pt.ABCSMC(models, priors, distance, population_size=400,
                    eps=pt.MedianEpsilon(),
                    sampler=pt.VectorizedSampler(min_batch_size=1 << 11,
                                                 max_batch_size=1 << 11,
                                                 max_rounds_per_call=4,
                                                 device="cpu"),
                    seed=5, device="cpu", **kw)
    abc.new("sqlite://", observed)
    abc.run(max_nr_populations=GENS)
    return abc


def _refits():
    return [s for s in spans.TRACER.spans() if s.name == "distance.refit"]


@pytest.mark.parametrize("mode", ["sequential", "overlap"])
def test_an_adaptive_run_traces_one_refit_a_host_generation(mode):
    """Sequentially every generation refits on the host; the pipelined
    engine's device blocks refit in the block, so their rows carry no
    ``distance_s`` and no span is theirs."""
    abc = _run(make_lotka_volterra_problem(), True, ingest_mode=mode,
               history_mode="eager")
    assert len(abc.timeline) == GENS
    host = [r for r in abc.timeline if r["path"] == "sequential"]
    if mode == "sequential":
        assert len(host) == GENS
    refits = _refits()
    assert [s.gen for s in refits] == [r["t"] for r in host]
    by_id = {s.id: s for s in spans.TRACER.spans()}
    # the first is the calibration's, the others refit for the next
    # generation
    assert by_id[refits[0].parent].name == "calibrate"
    for s in refits[1:]:
        assert by_id[s.parent].name in ("gen.adapt", "pipeline.prepare")
    for row, s in zip(host, refits):
        assert row["distance_s"] == pytest.approx(s.t_end - s.t_start)
        assert row["distance_s"] >= row["refit_s"] >= 0
    assert all("distance_s" not in r for r in abc.timeline
               if r["path"] != "sequential")


def test_tracer_off_rows_carry_the_refit_seconds_and_no_span():
    abc = _run(make_lotka_volterra_problem(), False,
               ingest_mode="sequential", history_mode="eager")
    assert _refits() == []
    assert [r["distance_s"] >= 0 for r in abc.timeline] == [True] * GENS


def test_a_fixed_distance_has_no_refit_span():
    abc = _run(make_two_gaussians_problem(), True,
               ingest_mode="sequential", history_mode="eager")
    assert len(abc.timeline) == GENS
    assert _refits() == []
    assert all("distance_s" not in r for r in abc.timeline)


def test_a_resumed_run_traces_its_refit_from_the_history(tmp_path):
    db = "sqlite:///" + str(tmp_path / "lv.db")
    made = make_lotka_volterra_problem()

    def make():
        return pt.ABCSMC(*made[:3], population_size=400,
                         eps=pt.MedianEpsilon(),
                         sampler=pt.VectorizedSampler(
                             min_batch_size=1 << 11, max_batch_size=1 << 11,
                             device="cpu"),
                         seed=5, device="cpu", ingest_mode="sequential",
                         history_mode="eager")

    abc = make()
    abc.new(db, made[3])
    abc.run(max_nr_populations=2)
    spans.TRACER.configure(enabled=True)
    again = make()
    again.load(db)
    again.run(max_nr_populations=1)
    refits = _refits()
    by_id = {s.id: s for s in spans.TRACER.spans()}
    assert [s.gen for s in refits] == [2]
    assert by_id[refits[0].parent].name == "calibrate"
    (row,) = again.timeline
    assert row["t"] == 2
    assert row["distance_s"] == pytest.approx(refits[0].t_end
                                              - refits[0].t_start)
