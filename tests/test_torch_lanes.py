"""The port's device telemetry lanes and progress word, held to the JAX
package's ``pyabc_tpu/telemetry/lanes.py`` and ``tests/test_lanes.py``:
``phase_wire_lanes`` gives the JAX values for the same rounds, lanes on
and off give bit-identical populations in the fused and one-dispatch
engines, every device row carries ``tl_sims = rounds · B`` and a phase
attribution that sums to its wall, the lanes travel under
``egress("telemetry")``, and the progress word after a run carries the
JAX package's fields and values."""

import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem
from pyabc_tpu.telemetry import lanes as jax_lanes
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.telemetry import flight, lanes
from pyabc_tpu_torch.wire import transfer

BATCH = 2048


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv(lanes.LANES_ENV, raising=False)
    lanes.PROGRESS.reset()
    jax_lanes.PROGRESS.reset()
    yield
    lanes.PROGRESS.reset()
    jax_lanes.PROGRESS.reset()


def _abc(pkg=pt, problem=make_two_gaussians_problem, run_mode="onedispatch",
         fuse=2, pop=400, seed=0, **kwargs):
    models, priors, distance, observed, _ = problem()
    samp = {"min_batch_size": BATCH, "max_batch_size": BATCH}
    if pkg is pt:
        samp["device"] = "cpu"
    abc = pkg.ABCSMC(models, priors, distance, population_size=pop,
                     eps=pkg.ConstantEpsilon(0.2),
                     sampler=pkg.VectorizedSampler(**samp),
                     fuse_generations=fuse, run_mode=run_mode, seed=seed,
                     **kwargs)
    abc.new("sqlite://", observed)
    return abc


@pytest.mark.parametrize("rounds", [1, 2, 7, 64, 300])
def test_phase_wire_lanes_equal_jax(rounds):
    import jax.numpy as jnp
    kw = dict(B=BATCH, n_target=1000, d=1, s=1, M=2, eps_mode="quantile",
              support_rows=1000, adaptive=False, fidelity=True)
    ours = lanes.phase_wire_lanes(
        torch.tensor(rounds, dtype=torch.int64), BATCH,
        lanes.phase_cost_model(**kw))
    theirs = jax_lanes.phase_wire_lanes(
        jnp.int32(rounds), BATCH, jax_lanes.phase_cost_model(**kw))
    assert int(ours["tl_sims"]) == int(theirs["tl_sims"]) == rounds * BATCH
    assert ours["tl_sims"].dtype == torch.int32
    assert ours["tl_phase"].dtype == torch.float32
    np.testing.assert_array_equal(ours["tl_phase"].numpy(),
                                  np.asarray(theirs["tl_phase"]))


@pytest.mark.parametrize("run_mode", ["onedispatch", "classic"])
def test_lanes_on_off_bit_identical_populations(run_mode):
    on = _abc(run_mode=run_mode)
    h_on = on.run(max_nr_populations=5)
    off = _abc(run_mode=run_mode)
    off.telemetry_lanes = False
    h_off = off.run(max_nr_populations=5)
    device_path = "onedispatch" if run_mode == "onedispatch" else "fused"
    assert [r["path"] for r in on.timeline][1:] == [device_path] * 4
    assert [r["path"] for r in off.timeline] == \
        [r["path"] for r in on.timeline]
    for t in range(5):
        a, b = h_on.get_population(t), h_off.get_population(t)
        for key in ("m", "theta", "weight", "distance"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    assert [(r["eps"], r["evaluations"], r["rounds"] if "rounds" in r
             else None) for r in on.timeline] == \
        [(r["eps"], r["evaluations"], r["rounds"] if "rounds" in r
          else None) for r in off.timeline]
    for row in on.timeline:
        if row["path"] != device_path:
            continue
        ph = [row["ph_" + p + "_s"] for p in lanes.PHASES]
        assert all(v >= 0 for v in ph)
        assert sum(ph) == pytest.approx(row["wall_s"], rel=1e-9)
        if run_mode == "onedispatch":
            assert row["host_reads"] == row["rounds"] + 1
    assert all("ph_simulate_s" not in r for r in off.timeline)


def test_lanes_carry_sims_and_travel_as_telemetry_egress():
    before = transfer.egress_breakdown()
    abc = _abc()
    seen = []
    orig = lanes.attribute_phases

    def spy(tl_phase, wall_s):
        seen.append(np.asarray(tl_phase).copy())
        return orig(tl_phase, wall_s)

    lanes.attribute_phases = spy
    try:
        abc.run(max_nr_populations=4)
    finally:
        lanes.attribute_phases = orig
    after = transfer.egress_breakdown()
    rows = [r for r in abc.timeline if r["path"] == "onedispatch"]
    assert len(seen) == len(rows) == 3
    # 4 bytes of tl_sims + 6 float32 phases per generation, nothing else
    assert after["telemetry"] - before["telemetry"] == len(rows) * (4 + 24)
    cost = lanes.phase_cost_model(
        B=BATCH, n_target=400, d=1, s=1, M=2, eps_mode="constant",
        support_rows=400, adaptive=False, fidelity=False)
    for row, vec in zip(rows, seen):
        want = [cost[p]["per_round"] * row["rounds"] + cost[p]["fixed"]
                for p in lanes.PHASES]
        np.testing.assert_allclose(vec, np.float32(want), rtol=1e-6)


def test_progress_word_matches_the_jax_fields():
    ours = _abc()
    ours.run(max_nr_populations=6)
    theirs = _abc(pkg=jpt, problem=jax_problem)
    theirs.run(max_nr_populations=6)
    w_ours, w_jax = lanes.PROGRESS.read(), jax_lanes.PROGRESS.read()
    assert w_ours.keys() == w_jax.keys()
    for key in ("active", "t0", "t_limit", "gen", "gens_done"):
        assert w_ours[key] == w_jax[key], key
    assert np.float32(w_ours["eps"]) == np.float32(w_jax["eps"])
    # the accepted count is the generation's raw count (both packages:
    # every acceptance of its last round included)
    last, last_stage = ours.timeline[-1], ours.timeline.to_rows()[-1]
    assert w_ours["gen"] == last["t"] == 5
    assert np.float32(w_ours["eps"]) == np.float32(last["eps"])
    assert w_ours["accepted"] == last_stage["accepted"] >= 400
    assert w_ours["rounds"] == sum(r["rounds"] for r in ours.timeline
                                   if r["path"] == "onedispatch")


def test_progress_word_monotone_tagged_and_evicted():
    p = lanes.RunProgress()
    a = p.begin(t0=1, t_limit=5)
    b = p.begin(t0=10, t_limit=3)
    p.update(2, 0.5, 100, 7, tag=a)
    p.update(1, 0.4, 90, 3, tag=a)  # older: ignored
    p.update(1, 0.9, 50, 2, tag=b)
    assert p.read(a)["gen"] == 2 and p.read(a)["eps"] == 0.5
    assert p.read(b)["gen"] == 10
    p.finish(b)
    assert p.read()["tag"] == a  # the freshest ACTIVE word
    for _ in range(12):
        p.finish(p.begin(t0=0, t_limit=1))
    assert len(p.read_all()) <= 1 + p._KEEP_FINISHED + 1


def test_flight_dump_embeds_the_progress_word(tmp_path):
    rec = flight.FlightRecorder()
    tag = lanes.PROGRESS.begin(t0=3, t_limit=4, run_id="r1")
    lanes.device_progress_update(2, 0.25, 300, 11, True, run_tag=tag)
    rec.note("retry", site="device.dispatch", attempt=1)
    path = rec.dump(reason="test", run_id="r1", directory=str(tmp_path))
    import json
    payload = json.loads(open(path).read())
    assert payload["run_progress"]["gen"] == 4
    assert payload["events"][0]["kind"] == "retry"
    assert payload["reason"] == "test"
    assert set(payload) >= {"metrics", "wire", "egress", "recent_spans"}
