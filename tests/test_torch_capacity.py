"""The port's capacity model, occupancy tuner and carry precision in runs
(``pyabc_tpu_torch/capacity/``, ``autotune/occupancy.py``), twins of
``tests/test_capacity.py``.

- the port's ledger, checked lane by lane by hand arithmetic;
- ``plan`` equal to the JAX package's ``plan`` when both read one shared
  ledger table (each module's ``ledger`` attribute monkeypatched here);
- completability and the ``CapacityError`` fields;
- ``OccupancyTuner`` proposals equal to the JAX package's over one
  telemetry sequence;
- f32 runs bit-identical to the same runs before the codec existed
  (digests of the parent commit's populations) and to an explicit
  ``PYABC_TPU_CARRY_PRECISION=f32``; bf16 and int8 runs complete and
  repeat; a tight budget clamps the geometry, and a budget between the
  f32 and bf16 minima makes f32 raise where ``auto`` completes.
"""

import hashlib
import math
from collections import OrderedDict

import numpy as np
import pytest
import torch

import pyabc_tpu_torch as pt
from pyabc_tpu.autotune.occupancy import OccupancyTuner as JOccupancyTuner
from pyabc_tpu.capacity import model as jcap
from pyabc_tpu_torch.autotune.occupancy import OccupancyTuner
from pyabc_tpu_torch.capacity import (ROUND_HEADROOM, CapacityError, ledger,
                                      parse_bytes, plan, predict_peak_bytes,
                                      resolved_budget_bytes)
from pyabc_tpu_torch.capacity import model as pcap
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.models.sir import SIRTauLeap
from pyabc_tpu_torch.ops.kde_cuda import split_plan
from pyabc_tpu_torch.random_variables import RV, Distribution


@pytest.fixture(autouse=True)
def _clean_capacity_env(monkeypatch):
    for var in ("PYABC_TPU_HBM_BUDGET", "PYABC_TPU_HBM_HEADROOM",
                "PYABC_TPU_CARRY_PRECISION", "PYABC_TPU_CAPACITY_MEASURE",
                "PYABC_TPU_JOINT_AUTOTUNE", "PYABC_TPU_FIDELITY"):
        monkeypatch.delenv(var, raising=False)
    yield


# ---------------------------------------------------------------------------
# budget resolution
# ---------------------------------------------------------------------------

def test_parse_bytes_matches_jax():
    for text in ("12G", "900M", "64k", "2T", "1.5G", "2GiB", "512mb", "123",
                 4096, 2.5, ""):
        assert parse_bytes(text) == jcap.parse_bytes(text)
    with pytest.raises(ValueError, match="PYABC_TPU_HBM_BUDGET"):
        parse_bytes("12 gigs")


def test_budget_env_verbatim_and_cpu_unconstrained(monkeypatch):
    assert resolved_budget_bytes("cpu") == 0
    monkeypatch.setenv("PYABC_TPU_HBM_BUDGET", "2M")
    assert resolved_budget_bytes("cpu") == 2 * 1024 ** 2


# ---------------------------------------------------------------------------
# the port's ledger, by hand
# ---------------------------------------------------------------------------

_SHAPE = dict(population=1000, param_dim=2, stat_dim=4, batch=256, K=3,
              max_T=32)
#: bytes of one accept-buffer row: int64 m + float32 theta[2], distance,
#: log weight, stats[4]
_ROW = 8 + 4 * 2 + 4 + 4 + 4 * 4
_CAP_ROWS = 1000 + 256 + 1


def _kde_scratch(m, n, d, p):
    splits = split_plan(m, n, d)[1]
    n_pad = -(-n // 16) * 16
    # the params block: a mean and a factor of up to 32 dimensions
    return 4 * (m + 32 + 32 * 32 + n_pad * p + 2 * splits * m)


def test_ledger_fused_f32_by_hand():
    led = ledger(engine="fused", carry_precision="f32", **_SHAPE)
    assert _ROW == 40
    assert led["carry_at_rest"] == _CAP_ROWS * 40 + 4 * 1000
    assert led["accept_window"] == _CAP_ROWS * 40
    assert led["round_batch"] == 256 * 4 * (16 + 4 * (2 + 4 + 4))
    assert led["generation_scratch"] == 24 * 1000
    # d = 2: 4 floats per packed support row
    assert led["kde_scratch"] == _kde_scratch(1000, 1000, 2, 4)
    assert led["refit_support"] == 1000 * (8 + 8)
    # K slots of m(8) + theta(8) + distance(4) + log_weight(4) + stats(16)
    assert led["wire_egress"] == 3 * 1000 * 40
    assert led["record_ring"] == 0
    assert led["fidelity_rings"] == 0
    assert led["store_ring"] == 0
    assert led["loop_states"] == 2 * _CAP_ROWS * 40
    assert led["runtime"] == 48 * 1024 ** 2
    assert predict_peak_bytes(engine="fused", carry_precision="f32",
                              **_SHAPE) == sum(led.values())


def test_ledger_narrowed_carry_by_hand():
    for mode, w in (("bf16", 2), ("int8", 1)):
        led = ledger(engine="fused", carry_precision=mode, **_SHAPE)
        # the model-index buffer, the log weights, the narrowed theta,
        # distance and stats, in and out
        assert led["carry_at_rest"] == (_CAP_ROWS * 8 + 4 * 1000
                                        + 2 * w * 1000 * 7)
        f32 = ledger(engine="fused", carry_precision="f32", **_SHAPE)
        for col in led:
            if col != "carry_at_rest":
                assert led[col] == f32[col], col


def test_ledger_engines_slots_and_sequential():
    od = ledger(engine="onedispatch", carry_precision="f32", **_SHAPE)
    assert od["wire_egress"] == 32 * 1000 * 40
    seq = ledger(engine="sequential", carry_precision="bf16", **_SHAPE)
    # no device carry and no wire slots; the request reads as f32
    assert seq["carry_at_rest"] == 0
    assert seq["wire_egress"] == 0
    assert seq["accept_window"] == _CAP_ROWS * 40


@pytest.mark.parametrize("wire_slots,slots", [(1, 1), (3, 3), (32, 32),
                                               (64, 32)])
def test_ledger_onedispatch_counts_the_generations_it_may_write(wire_slots,
                                                                slots):
    """A one-dispatch run allocates a slot per generation left, at most
    ``max_T``; a fused block's K slots ignore the lane."""
    od = ledger(engine="onedispatch", carry_precision="f32",
                wire_slots=wire_slots, **_SHAPE)
    assert od["wire_egress"] == slots * 1000 * 40
    fused = ledger(engine="fused", carry_precision="f32",
                   wire_slots=wire_slots, **_SHAPE)
    assert fused["wire_egress"] == 3 * 1000 * 40


def test_short_dispatch_plans_the_slots_it_writes():
    """A dispatch from t = 1 of a 4-generation run writes 3 generations:
    the consult's ledger counts 3 wire slots, not ``onedispatch_max_t``."""
    abc = _gauss(fuse_generations=2, run_mode="onedispatch",
                 eps=pt.MedianEpsilon())
    abc.run(max_nr_populations=4)
    assert [r["path"] for r in abc.timeline].count("onedispatch") == 3
    cap = abc.timeline.capacity
    assert cap["engine"] == "onedispatch" and cap["max_T"] == 32
    kw = abc._capacity_kwargs("onedispatch", 256, cap["batch"])
    one = ledger(batch=cap["batch"], K=cap["K"], max_T=32,
                 carry_precision="f32", wire_slots=1, **kw)
    assert one["wire_egress"] > 0
    assert cap["ledger"]["wire_egress"] == 3 * one["wire_egress"]


def test_ledger_lane_toggles_by_hand():
    kw = dict(engine="fused", carry_precision="f32", **_SHAPE)
    assert ledger(wire_stats=False, **kw)["wire_egress"] == 3 * 1000 * 24
    base = ledger(**kw)
    assert ledger(models=3, **kw)["refit_support"] == \
        3 * base["refit_support"]
    capped = ledger(support_cap=100, **kw)
    assert capped["refit_support"] == 100 * 16
    assert capped["kde_scratch"] == _kde_scratch(1000, 100, 2, 4)
    assert ledger(record_rows=10, **kw)["record_ring"] == 2 * 10 * 28
    assert ledger(cal_rows=5, **kw)["fidelity_rings"] == 2 * 2 * 5 * 4
    assert ledger(store_gens=12, **kw)["store_ring"] == 12 * 1000 * 40
    assert ledger(loop_states=1, **kw)["loop_states"] == _CAP_ROWS * 40
    assert ledger(sim_mult=2, **kw)["round_batch"] == \
        base["round_batch"] // 2


def test_ledger_devices_divide_population_not_support():
    led = ledger(engine="fused", carry_precision="f32", devices=4,
                 **_SHAPE)
    assert led["accept_window"] == (250 + 64 + 1) * 40
    assert led["wire_egress"] == 3 * 250 * 40
    assert led["refit_support"] == 1000 * 16


def test_ledger_rejects_auto_and_unknown_engine():
    with pytest.raises(ValueError, match="concrete carry_precision"):
        ledger(engine="fused", carry_precision="auto", **_SHAPE)
    with pytest.raises(ValueError, match="unknown engine"):
        ledger(engine="warp", carry_precision="f32", **_SHAPE)


# ---------------------------------------------------------------------------
# plan(): the JAX package's search over one shared ledger table
# ---------------------------------------------------------------------------

def _shared_ledger(**kw):
    """One ledger table both packages' plan() read: every input moves a
    column, so each search decision shows."""
    w = {"f32": 4, "bf16": 2, "int8": 1}[kw["carry_precision"]]
    n = kw["population"]
    return OrderedDict(
        carry=n * w * (kw["param_dim"] + 1 + kw["stat_dim"]),
        batch=kw["batch"] * 48 // kw.get("devices", 1),
        block=kw["K"] * n * 3,
        slots=kw["max_T"] * n * (2 if kw["engine"] == "onedispatch"
                                 else 0),
        extra=kw.get("cal_rows", 0) * 8)


def _outcome(mod, **kw):
    try:
        p = mod.plan(**kw)
    except mod.CapacityError as err:
        return ("error", str(err).splitlines()[0], err.predicted,
                err.budget, err.hint, dict(err.ledger),
                err.request["carry_precision"])
    return ("plan", p.carry_precision, p.batch, p.K, p.max_T,
            p.predicted_bytes, p.budget_bytes, p.note, dict(p.ledger))


@pytest.mark.parametrize("engine", ["fused", "onedispatch", "sequential"])
@pytest.mark.parametrize("prec", ["auto", "f32", "bf16"])
def test_plan_matches_jax_on_a_shared_ledger(monkeypatch, engine, prec):
    monkeypatch.setattr(jcap, "ledger", _shared_ledger)
    monkeypatch.setattr(pcap, "ledger", _shared_ledger)
    base = dict(population=4096, param_dim=2, stat_dim=4, engine=engine,
                batch=8192, K=4, max_T=32, carry_precision=prec,
                cal_rows=64)
    full = sum(_shared_ledger(**{**base, "carry_precision": "f32"})
               .values())

    def rounder(b):
        return max((int(b) // 512) * 512, 512)

    budgets = [0, 10 ** 12, full, full - 1, full // 2, full // 4,
               full // 8, 1]
    outcomes = []
    for budget in budgets:
        for extra in ({}, {"round_to_batch": rounder},
                      {"round_headroom": 1.0}):
            kw = dict(base, budget=budget, **extra)
            j, p = _outcome(jcap, **kw), _outcome(pcap, **kw)
            assert p == j, (budget, extra)
            outcomes.append(p[0])
    # the grid reaches plans and errors alike
    assert "plan" in outcomes
    assert engine == "sequential" or "error" in outcomes


def test_plan_unconstrained_returns_request_verbatim():
    p = plan(population=4096, param_dim=2, stat_dim=4, engine="onedispatch",
             batch=8192, K=4, max_T=32, carry_precision="auto", budget=0)
    assert (p.carry_precision, p.batch, p.K, p.max_T, p.note) == \
        ("f32", 8192, 4, 32, "unconstrained")


_PLAN_KW = dict(population=4096, param_dim=2, stat_dim=4,
                engine="onedispatch")


def _mins():
    out = {}
    for prec in ("f32", "bf16"):
        with pytest.raises(CapacityError) as ei:
            plan(batch=8192, K=4, max_T=32, budget=1, carry_precision=prec,
                 **_PLAN_KW)
        out[prec] = int(ei.value.predicted)
    return out


def test_plan_descends_to_bf16_at_the_discriminating_budget():
    mins = _mins()
    assert 0 < mins["bf16"] < mins["f32"]
    budget = (mins["f32"] + mins["bf16"]) // 2
    p = plan(batch=8192, K=4, max_T=32, carry_precision="auto",
             budget=budget, **_PLAN_KW)
    assert p.carry_precision == "bf16"
    assert p.note == "clamped to fit budget"
    assert p.predicted_bytes <= budget
    # completable: the clamped geometry can still fill the population
    assert math.ceil(ROUND_HEADROOM * 4096 / p.batch) <= p.max_T


def test_plan_raises_when_no_geometry_can_fill_the_population():
    with pytest.raises(CapacityError, match="can fill population") as ei:
        plan(population=100_000, param_dim=2, stat_dim=4,
             engine="onedispatch", batch=256, K=1, max_T=8,
             budget=10 ** 12, carry_precision="f32")
    assert ei.value.hint is None


def test_capacity_error_fields_and_hint():
    mins = _mins()
    budget = (mins["f32"] + mins["bf16"]) // 2
    with pytest.raises(CapacityError) as ei:
        plan(batch=8192, K=4, max_T=32, carry_precision="f32",
             budget=budget, **_PLAN_KW)
    err = ei.value
    assert err.budget == budget
    assert err.predicted == mins["f32"]
    assert err.request["carry_precision"] == "f32"
    assert err.request["engine"] == "onedispatch"
    assert set(err.ledger) == set(ledger(carry_precision="f32", batch=256,
                                         **_PLAN_KW))
    assert "PYABC_TPU_CARRY_PRECISION=bf16 would fit" in err.hint
    assert "carry_at_rest" in str(err) and "hint:" in str(err)


# ---------------------------------------------------------------------------
# the occupancy tuner: the JAX package's proposals
# ---------------------------------------------------------------------------

def _pow2_rung(b):
    return max(256, 1 << int(round(math.log2(max(float(b), 1.0)))))


def test_occupancy_tuner_sequence_matches_jax():
    tuners = (OccupancyTuner(k_max=4), JOccupancyTuner(k_max=4))
    blocks = [(2, 4096, [4, 6], 1.0, 2), (3, 2048, [3, 5, 9], 0.8, 2),
              (4, 8192, [2, 2, 3, 4], 0.5, 4), (1, 4096, [7], 0.3, 1),
              (4, 4096, [3, 4, 6, 12], 1.4, 3)]
    feas = [None, lambda K, T, B: B <= 2048, lambda K, T, B: K <= 2,
            lambda K, T, B: B <= 512, None]
    seen = []
    for (K, B, rounds, wall, written), feasible in zip(blocks, feas):
        props = [t.propose(n=8192, rate=0.4, B0=B, round_to_rung=_pow2_rung,
                           feasible=feasible) for t in tuners]
        assert props[0] == props[1]
        seen.append(props[0])
        for t in tuners:
            t.observe_block(K=K, B=B, rounds_per_gen=rounds, wall_s=wall,
                            written=written)
        assert tuners[0].stats() == tuners[1].stats()
    assert len(set(seen)) > 1


def test_occupancy_fallback_shrinks_rung_to_feasible_set():
    tuner = OccupancyTuner(k_max=4)
    assert tuner.propose(n=8192, rate=0.5, B0=4096, round_to_rung=_pow2_rung,
                         feasible=lambda K, T, B: B <= 1024) == \
        (1, tuner.t_choices[-1], 1024)


# ---------------------------------------------------------------------------
# runs
# ---------------------------------------------------------------------------

def _digest(h):
    m = hashlib.sha256()
    pops = h.get_all_populations()
    m.update(np.asarray(pops.epsilon, np.float64).tobytes())
    for t in range(h.max_t + 1):
        for mm in range(2):
            try:
                df, w = h.get_distribution(m=mm, t=t)
            except Exception:
                continue
            m.update(np.ascontiguousarray(df.to_numpy(np.float64)).tobytes())
            m.update(np.asarray(w, np.float64).tobytes())
    return m.hexdigest()[:16]


def _gauss(pop=256, seed=3, **kw):
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=pop,
                    sampler=pt.VectorizedSampler(device="cpu"), seed=seed,
                    device="cpu", **kw)
    abc.new("sqlite://", observed)
    return abc


def _sir(**kw):
    model = SIRTauLeap(n_steps=40, n_obs=8)
    prior = Distribution(log_beta=RV("uniform", -2.0, 3.0),
                         log_gamma=RV("uniform", -3.0, 3.0))
    g = torch.Generator()
    g.manual_seed(11)
    obs = model.simulate(g, torch.log(torch.tensor([[0.8, 0.2]])))
    abc = pt.ABCSMC([model], [prior], pt.PNormDistance(p=2),
                    population_size=200,
                    sampler=pt.VectorizedSampler(device="cpu"), seed=5,
                    device="cpu", **kw)
    abc.new("sqlite://", {k: v[0].numpy() for k, v in obs.items()})
    return abc


#: digests of these runs' populations on the commit before the codec,
#: the capacity model and the wire slots existed (CPU, float32)
_PARENT = {
    "fused": ("04dfbbb5fb3aa2b4",
              lambda: _gauss(fuse_generations=2,
                             eps=pt.ConstantEpsilon(0.3)), 5, "fused"),
    "onedispatch": ("99c896aa78845538",
                    lambda: _gauss(fuse_generations=2,
                                   run_mode="onedispatch",
                                   eps=pt.MedianEpsilon()), 6,
                    "onedispatch"),
    "pipelined": ("69a16557cb9e9e63",
                  lambda: _sir(fuse_generations=3, ingest_mode="overlap"), 6,
                  "pipelined"),
    "fused_eager": ("ae7a66257d00ec3a",
                    lambda: _sir(fuse_generations=3, history_mode="eager",
                                 ingest_mode="sequential"), 5, "fused"),
}


@pytest.mark.parametrize("engine", sorted(_PARENT))
@pytest.mark.parametrize("explicit", [False, True])
def test_f32_runs_equal_the_parent_commit(engine, explicit, monkeypatch):
    if explicit:
        monkeypatch.setenv("PYABC_TPU_CARRY_PRECISION", "f32")
    digest, make, gens, path = _PARENT[engine]
    abc = make()
    h = abc.run(max_nr_populations=gens)
    assert path in {r["path"] for r in abc.timeline}
    assert abc.timeline.capacity["precision"] == "f32"
    assert abc.timeline.capacity["note"] == "unconstrained"
    assert _digest(h) == digest


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("run_mode", ["auto", "onedispatch"])
def test_narrowed_runs_complete_and_repeat(mode, run_mode, monkeypatch):
    monkeypatch.setenv("PYABC_TPU_CARRY_PRECISION", mode)
    digests = []
    for _ in range(2):
        abc = _gauss(seed=5, fuse_generations=2, run_mode=run_mode,
                     eps=pt.MedianEpsilon())
        h = abc.run(max_nr_populations=5)
        assert abc.timeline.capacity["precision"] == mode
        assert [len(h.get_population(t)) for t in range(5)] == [256] * 5
        digests.append(_digest(h))
    assert digests[0] == digests[1]


def _fused_mins(abc, engine="fused", max_T=None):
    samp = abc.sampler
    samp.fetch_stats = abc.stores_sum_stats
    B = samp.choose_batch(256)
    kw = abc._capacity_kwargs(engine, 256, B)
    out = {}
    for prec in ("f32", "bf16"):
        with pytest.raises(CapacityError) as ei:
            plan(batch=B, K=abc.fuse_generations,
                 max_T=max_T or abc._block_max_rounds(256, B), budget=1,
                 carry_precision=prec, **kw)
        out[prec] = int(ei.value.predicted)
    return out


def test_tight_budget_clamps_and_run_completes(monkeypatch):
    ref = _gauss(fuse_generations=2, eps=pt.ConstantEpsilon(0.3))
    ref.run(max_nr_populations=3)
    cap_ref = dict(ref.timeline.capacity)
    assert cap_ref["note"] == "unconstrained"
    monkeypatch.setenv("PYABC_TPU_HBM_BUDGET",
                       str(cap_ref["predicted_bytes"] - 1))
    abc = _gauss(fuse_generations=2, eps=pt.ConstantEpsilon(0.3))
    h = abc.run(max_nr_populations=3)
    cap = abc.timeline.capacity
    assert cap["note"] == "clamped to fit budget"
    assert (cap["batch"], cap["K"], cap["max_T"]) != \
        (cap_ref["batch"], cap_ref["K"], cap_ref["max_T"])
    assert cap["predicted_bytes"] < cap_ref["predicted_bytes"]
    assert len(h.get_all_populations()) == 4


def test_f32_raises_where_auto_completes_narrowed(monkeypatch):
    mins = _fused_mins(_gauss(fuse_generations=2,
                              eps=pt.ConstantEpsilon(0.3)))
    assert 0 < mins["bf16"] < mins["f32"]
    monkeypatch.setenv("PYABC_TPU_HBM_BUDGET",
                       str((mins["f32"] + mins["bf16"]) // 2))
    monkeypatch.setenv("PYABC_TPU_CARRY_PRECISION", "f32")
    with pytest.raises(CapacityError) as ei:
        _gauss(fuse_generations=2,
               eps=pt.ConstantEpsilon(0.3)).run(max_nr_populations=3)
    assert "PYABC_TPU_CARRY_PRECISION=bf16" in (ei.value.hint or "")
    monkeypatch.setenv("PYABC_TPU_CARRY_PRECISION", "auto")
    abc = _gauss(fuse_generations=2, eps=pt.ConstantEpsilon(0.3))
    h = abc.run(max_nr_populations=3)
    assert abc.timeline.capacity["precision"] == "bf16"
    assert abc._carry_mode == "bf16"
    assert len(h.get_all_populations()) == 4


def test_joint_autotune_runs_and_observes(monkeypatch):
    monkeypatch.setenv("PYABC_TPU_JOINT_AUTOTUNE", "1")
    abc = _gauss(fuse_generations=3, eps=pt.MedianEpsilon())
    assert abc._occupancy is not None
    h = abc.run(max_nr_populations=7)
    assert "fused" in {r["path"] for r in abc.timeline}
    assert abc._occupancy.stats()["shape"] is not None
    assert [len(h.get_population(t)) for t in range(7)] == [256] * 7
