"""Blobs packed while the card computes the weights: the same bytes.

The sequential sampler hands the History the accepted rows that its
finalize does not change (``m``, ``theta``, ``distance`` and the stats
it fetches) before the finalize runs, and their PTW1 blobs pack on
threads (``History.prepack``) while the card computes the weights; the
eager append packs the ``weight`` blobs, joins the early ones and
commits where it did.  Every blob and the ``digest`` column are the
one-shot write's (``_pack_all``), and so the JAX package's; every other
writer (a resume splice, a restarted attempt, the calibration, the lazy
History) keeps the one-shot pack.
"""

import signal
import sqlite3

import numpy as np
import pytest

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.resilience import checkpoint as ckpt
from pyabc_tpu_torch.resilience import faults, retry
from pyabc_tpu_torch.sampler import vectorized
from pyabc_tpu_torch.storage import History
from pyabc_tpu_torch.storage import history as history_mod
from pyabc_tpu_torch.telemetry import REGISTRY
from pyabc_tpu_torch.wire import transfer

NAMES = {1: ["m0"], 2: ["m0", "m1"]}


@pytest.fixture(params=[None, "raw"], ids=["ptw1", "raw"])
def codec(request, monkeypatch):
    if request.param is None:
        monkeypatch.delenv(transfer.WIRE_CODEC_ENV, raising=False)
    else:
        monkeypatch.setenv(transfer.WIRE_CODEC_ENV, request.param)
    return request.param


@pytest.fixture(autouse=True)
def _clean_fault_state():
    # a run with sub-checkpoints arms the port's SIGTERM handler for the
    # process: put it back, or an in-process SIGTERM of a later test in
    # this worker stops every later run
    handler = (signal.getsignal(signal.SIGTERM), ckpt._INSTALLED,
               ckpt._PREV_HANDLER)
    faults.uninstall()
    ckpt.clear_preempt()
    yield
    faults.uninstall()
    signal.signal(signal.SIGTERM, handler[0])
    ckpt._INSTALLED, ckpt._PREV_HANDLER = handler[1:]
    ckpt.clear_preempt()


def _population(pkg, n, models, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.integers(0, models, n).astype(np.int32)
    return pkg.Population(
        m, rng.normal(size=(n, 2)).astype(np.float32),
        rng.uniform(0.1, 1.0, n).astype(np.float32),
        rng.uniform(size=n).astype(np.float32),
        {"__flat__": rng.normal(size=(n, 3)).astype(np.float32)})


def _rows_of(pop):
    """The host columns a sampler hands over before its finalize."""
    return {"m": np.asarray(pop.m).astype(np.int64),
            "theta": np.asarray(pop.theta),
            "distance": np.asarray(pop.distance),
            "stats": pop.sum_stats["__flat__"]}


def _write(pkg, db, pop, models, stores, prepack=False):
    h = pkg.History("sqlite:///" + db, stores_sum_stats=stores)
    h.store_initial_data(None, {}, {"y": np.float32(1.0)}, None,
                         NAMES[models])
    kw = {}
    if prepack:
        kw["prepacked"] = h.prepack(0, _rows_of(pop))
    h.append_population(0, 0.5, pop, 400, NAMES[models],
                        [["a", "b"]] * models, stat_spec={"s": (3,)}, **kw)
    h.close()
    return h


def _model_rows(db):
    with sqlite3.connect(db) as conn:
        return conn.execute(
            "SELECT t, m, theta, weight, distance, stats, digest FROM "
            "model_populations ORDER BY t, m").fetchall()


@pytest.mark.parametrize("stores", [True, False], ids=["stats", "nostats"])
@pytest.mark.parametrize("models", [1, 2])
@pytest.mark.parametrize("n", [40, 100_000])
def test_prepacked_write_equals_the_one_shot_and_the_jax_packages(
        codec, tmp_path, n, models, stores):
    """Early ``theta``/``distance`` (and ``stats``), late ``weight``:
    every blob and the digest column equal ``_pack_all``'s one-shot
    write and the JAX package's ``History``."""
    pre_db, one_db, jax_db = (str(tmp_path / f"{k}.db")
                              for k in ("pre", "one", "jax"))
    h = _write(pt, pre_db, _population(pt, n, models), models, stores,
               prepack=True)
    _write(pt, one_db, _population(pt, n, models), models, stores)
    _write(jpt, jax_db, _population(jpt, n, models), models, stores)
    pre, one, ref = (_model_rows(d) for d in (pre_db, one_db, jax_db))
    assert len(pre) == models
    assert pre == one == ref
    assert all((row[5] is not None) == stores for row in pre)
    # theta (2 floats) + distance (+ 3 stats) of a row's 4 + 4 bytes
    # weight and distance
    early = 8 + 4 + (12 if stores else 0)
    assert h.prepacked_share[0] == pytest.approx(early / (early + 4))
    assert h.prepack_s[0] >= 0


def test_a_population_the_blobs_do_not_cover_takes_the_one_shot_pack(
        tmp_path):
    """Blobs of other rows (a splice joins rows to the front) are
    dropped, and the write packs every blob itself."""
    pop = _population(pt, 1000, 2)
    other = _population(pt, 1000, 2, seed=1)
    h = History("sqlite:///" + str(tmp_path / "a.db"))
    h.store_initial_data(None, {}, {"y": np.float32(1.0)}, None, NAMES[2])
    handle = h.prepack(0, _rows_of(other))
    h.append_population(0, 0.5, pop, 400, NAMES[2], [["a", "b"]] * 2,
                        stat_spec={"s": (3,)}, prepacked=handle)
    h.close()
    _write(pt, str(tmp_path / "b.db"), pop, 2, True)
    assert _model_rows(str(tmp_path / "a.db")) == \
        _model_rows(str(tmp_path / "b.db"))
    assert h.prepacked_share[0] == 0.0 and 0 not in h.prepack_s


# ---- the sequential engine ------------------------------------------------


def _abc(db, seed=7, pop=400, stores=False, **kw):
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    sampler_kw = kw.pop("sampler_kw", {})
    abc = pt.ABCSMC(models, priors, distance, population_size=pop,
                    sampler=pt.VectorizedSampler(device="cpu", **sampler_kw),
                    seed=seed, device="cpu", stores_sum_stats=stores,
                    ingest_mode="sequential", **kw)
    if db is not None:
        abc.new(db, observed)
    return abc


def _one_shot_only(monkeypatch):
    """The History hands out no early blobs: every write packs alone."""
    monkeypatch.setattr(History, "prepack", lambda self, t, rows: None)


def _spy_prepack(monkeypatch):
    """The generations ``History.prepack`` was called for."""
    calls = []
    real = History.prepack

    def spy(self, t, rows):
        calls.append(t)
        return real(self, t, rows)

    monkeypatch.setattr(History, "prepack", spy)
    return calls


@pytest.mark.parametrize("stores", [False, True], ids=["nostats", "stats"])
def test_eager_sequential_rows_take_early_blobs_of_the_same_bytes(
        tmp_path, monkeypatch, stores):
    db_pre, db_one = (str(tmp_path / f"{k}.db") for k in ("pre", "one"))
    before = REGISTRY.to_dict().get("history_prepacked_blobs_total", 0)
    with monkeypatch.context() as mp:
        calls = _spy_prepack(mp)
        abc = _abc("sqlite:///" + db_pre, stores=stores,
                   history_mode="eager")
        abc.run(max_nr_populations=3)
    gens = [r["t"] for r in abc.timeline]
    assert calls == gens == [0, 1, 2]
    # the calibration re-evaluates its distances: one-shot
    assert abc.history.prepacked_share[-1] == 0.0
    # two models, each a blob of theta and distance (and stats) a
    # generation
    blobs = 3 * 2 * (3 if stores else 2)
    assert REGISTRY.to_dict()["history_prepacked_blobs_total"] - before \
        == blobs
    rows = _model_rows(db_pre)
    for row in abc.timeline:
        size = {k: sum(history_mod._unpack(r[i]).nbytes
                       for r in rows if r[0] == row["t"])
                for i, k in ((2, "theta"), (3, "weight"), (4, "distance"))}
        size["stats"] = sum(history_mod._unpack(r[5]).nbytes
                            for r in rows if r[0] == row["t"] and stores)
        early = size["theta"] + size["distance"] + size["stats"]
        assert row["prepacked_share"] == pytest.approx(
            early / (early + size["weight"]))
        assert row["prepack_s"] > 0 and row["pack_s"] > 0
    _one_shot_only(monkeypatch)
    one = _abc("sqlite:///" + db_one, stores=stores, history_mode="eager")
    one.run(max_nr_populations=3)
    assert all(r["prepacked_share"] == 0.0 and "prepack_s" not in r
               for r in one.timeline)
    assert _model_rows(db_pre) == _model_rows(db_one)


def test_the_lazy_history_keeps_the_one_shot_pack(tmp_path, monkeypatch):
    """Lazy rows defer the fetch: nothing is packed ahead, and the
    materialized blobs are the eager run's, which took early blobs."""
    db_lazy, db_eager = (str(tmp_path / f"{k}.db")
                         for k in ("lazy", "eager"))
    with monkeypatch.context() as mp:
        calls = _spy_prepack(mp)
        lazy = _abc("sqlite:///" + db_lazy, history_mode="lazy")
        lazy.run(max_nr_populations=3)
        assert calls == []
    assert all(v == 0.0 for v in lazy.history.prepacked_share.values())
    assert all(not r.get("prepacked_share") for r in lazy.timeline)
    eager = _abc("sqlite:///" + db_eager, history_mode="eager")
    eager.run(max_nr_populations=3)
    assert eager.history.prepacked_share[2] > 0
    assert _model_rows(db_lazy) == _model_rows(db_eager)


def _restart_at(monkeypatch, t_fail, one_shot=False):
    """The first finalize of generation ``t_fail`` exhausts its retries:
    ``_sample_generation`` drops a batch rung and restarts.  Returns the
    state, whose ``calls`` are the generations the sampler handed rows
    for; ``one_shot``: the History hands out no early blobs."""
    state = {"calls": [], "failed": False}
    real_dispatch = vectorized.VectorizedSampler._dispatch
    real_prepack = History.prepack

    def prepack(self, t, rows):
        state["calls"].append(t)
        return None if one_shot else real_prepack(self, t, rows)

    def dispatch(self, fn, *args, **kwargs):
        if (getattr(fn, "__name__", "") == "finalize"
                and state["calls"][-1:] == [t_fail]
                and not state["failed"]):
            state["failed"] = True
            raise retry.RetryExhausted("device.dispatch", 3)
        return real_dispatch(self, fn, *args, **kwargs)

    monkeypatch.setattr(vectorized.VectorizedSampler, "_dispatch", dispatch)
    monkeypatch.setattr(History, "prepack", prepack)
    return state


def test_a_restarted_attempt_drops_its_blobs(tmp_path, monkeypatch):
    """The failed attempt's blobs go with its ``Sample``; the restarted
    attempt hands over its own rows, and the bytes are those of a twin
    that packs every write in one go."""
    db_pre, db_one = (str(tmp_path / f"{k}.db") for k in ("pre", "one"))
    kw = dict(history_mode="eager",
              sampler_kw={"min_batch_size": 64, "max_batch_size": 256})
    with monkeypatch.context() as mp:
        state = _restart_at(mp, 1)
        abc = _abc("sqlite:///" + db_pre, **kw)
        abc.run(max_nr_populations=3)
    assert state["failed"] and state["calls"] == [0, 1, 1, 2]
    assert abc.sampler.max_batch_size == 128
    assert abc.history.prepacked_share[1] > 0
    # the one-shot twin fails at the same finalize and draws the same
    with monkeypatch.context() as mp:
        state = _restart_at(mp, 1, one_shot=True)
        one = _abc("sqlite:///" + db_one, **kw)
        one.run(max_nr_populations=3)
    assert state["failed"] and state["calls"] == [0, 1, 1, 2]
    assert all(v == 0.0 for v in one.history.prepacked_share.values())
    assert _model_rows(db_pre) == _model_rows(db_one)


def test_a_resume_splice_takes_the_one_shot_pack(tmp_path, monkeypatch):
    """A SIGTERM mid-generation flushes the accepted rows; the resumed
    process splices them to the front of generation 1, whose blobs are
    then packed in one go (the early rows are this process's alone)."""
    db = str(tmp_path / "preempt.db")
    kw = dict(pop=300, checkpoint_every_rounds=1, history_mode="eager",
              sampler_kw={"min_batch_size": 8, "max_batch_size": 64,
                          "max_rounds_per_call": 1})
    probe_plan = faults.install(
        faults.FaultPlan.parse("preempt@1000000:sigterm"))
    probe = _abc("sqlite:///" + str(tmp_path / "probe.db"), seed=31, **kw)
    probe.run(max_nr_populations=1)
    v0 = probe_plan.visits(faults.SITE_PREEMPT)
    faults.install(faults.FaultPlan.parse(f"preempt@{v0 + 2}:sigterm"))
    abc = _abc("sqlite:///" + db, seed=31, **kw)
    with pytest.raises(ckpt.Preempted):
        abc.run(max_nr_populations=3)
    faults.uninstall()
    ckpt.clear_preempt()
    assert abc.history.max_t == 0
    assert abc.history.load_sub_checkpoint(1) is not None
    calls = _spy_prepack(monkeypatch)
    again = _abc(None, seed=32, **kw)
    again.load("sqlite:///" + db)
    h = again.run(max_nr_populations=2)
    assert h.max_t == 2 and calls == [2]
    assert h.prepacked_share[1] == 0.0 and h.prepacked_share[2] > 0
    # generation 1's blobs: what a one-shot write of its population packs
    pop = h.get_population(t=1)
    redo = str(tmp_path / "redo.db")
    r = History("sqlite:///" + redo, stores_sum_stats=False)
    r.store_initial_data(None, {}, {"y": np.float32(1.0)}, None, NAMES[2])
    r.append_population(1, 0.5, pop, 1, NAMES[2])
    r.close()
    stored = [row for row in _model_rows(db) if row[0] == 1]
    assert [row[2:] for row in stored] == \
        [row[2:] for row in _model_rows(redo)]


def test_generation_t_commits_before_generation_t_plus_1_runs(
        tmp_path, monkeypatch):
    """Each call of the sampler for generation t + 1 finds generation
    t's rows committed: a second connection reads them."""
    db = str(tmp_path / "order.db")
    abc = _abc("sqlite:///" + db, history_mode="eager")
    seen = []
    real = abc.sampler.sample_until_n_accepted

    def sample(n, round_fn, *args, **kwargs):
        if not kwargs.get("all_accepted"):
            with sqlite3.connect(db) as conn:
                seen.append(conn.execute(
                    "SELECT MAX(t) FROM model_populations").fetchone()[0])
        return real(n, round_fn, *args, **kwargs)

    monkeypatch.setattr(abc.sampler, "sample_until_n_accepted", sample)
    abc.run(max_nr_populations=4)
    assert seen == [-1, 0, 1, 2]
    assert all(abc.history.prepacked_share[t] > 0 for t in range(4))
