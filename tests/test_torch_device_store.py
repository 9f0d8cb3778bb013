"""The port's device store (``pyabc_tpu_torch/wire/store.py``) and lazy
History rows (``storage/history.py``) on the CPU.

Twins of ``tests/test_device_store.py``: the ring's deposit, eviction,
spill, ``drop_from`` and manifest; a lazy History bit-identical to an
eager one on every engine (the classic loop, fused blocks, the pipeline
and one-dispatch), after a reload from file, and under eviction pressure
with a ring of one; the ``history_mode`` default and its validation.
The summary lanes are held against the JAX package's on one input
(float32 reductions: relative 1e-5) and against the population they
summarize; an end-to-end twin runs config #2 through both packages'
pipelined, lazy engines and holds each generation's summary packet to
the sampling tolerances stated at :func:`test_summary_packets_agree_\
with_the_jax_package`.
"""

import json

import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu.wire.store as jax_store
import pyabc_tpu_torch as pt
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.sampler.base import Sample
from pyabc_tpu_torch.wire import store as wire_store
from pyabc_tpu_torch.wire import transfer
from pyabc_tpu_torch.wire.ingest import batch_to_population


def _dummy_wire(t):
    return {"theta": torch.full((8, 2), float(t)),
            "m": torch.zeros(8, dtype=torch.int64)}


# ---- the ring ----------------------------------------------------------------


def test_store_ring_eviction_spill_and_drop():
    store = wire_store.DeviceRunStore(max_gens=2)
    for t in range(3):
        store.deposit(t, _dummy_wire(t), n=8, count=8, eps=1.0 - t * 0.1,
                      norm="stream")
    assert store.resident_ts() == [1, 2]
    assert store.deposits == 3 and store.evictions == 1
    assert [e["t"] for e in store.take_spills()] == [0]
    assert store.take_spills() == []
    meta = store.entry_meta(2)
    assert meta["n"] == 8 and meta["count"] == 8
    assert meta["norm"] == "stream" and meta["nbytes"] == 8 * 2 * 4 + 8 * 8
    assert store.entry_meta(0) is None
    # a repeat deposit replaces, and control lanes never enter
    store.deposit(2, {**_dummy_wire(2), "live": torch.ones(())}, n=8,
                  count=4, norm="stream")
    assert store.resident_ts() == [1, 2]
    assert store.entry_meta(2)["count"] == 4
    assert "live" not in store._entries[2]["wire"]
    assert store.drop(1) and not store.drop(1)
    assert store.resident_ts() == [2]
    store.clear()
    assert store.resident_ts() == [] and store.take_spills() == []


def test_store_drop_from_covers_spills_and_requeue_keeps_order():
    store = wire_store.DeviceRunStore(max_gens=2)
    for t in range(4):
        store.deposit(t, _dummy_wire(t), n=8, count=8, norm="stream")
    assert store.resident_ts() == [2, 3]
    assert sorted(store.manifest()["spill_pending"]) == [0, 1]
    assert store.drop_from(1) == 3
    assert store.resident_ts() == []
    spills = store.take_spills()
    assert [e["t"] for e in spills] == [0]
    store.deposit(5, _dummy_wire(5), n=8, count=8)
    store.deposit(6, _dummy_wire(6), n=8, count=8)
    store.deposit(7, _dummy_wire(7), n=8, count=8)
    store.requeue_spills(spills)
    assert [e["t"] for e in store.take_spills()] == [0, 5]


def test_store_manifest_snapshot(monkeypatch):
    monkeypatch.setenv(wire_store.STORE_GENS_ENV, "4")
    store = wire_store.DeviceRunStore()
    store.deposit(5, _dummy_wire(5), n=8, count=7, eps=0.25, norm="sample")
    man = store.manifest()
    assert man["max_gens"] == 4 and man["deposits"] == 1
    (entry,) = man["resident"]
    assert entry["t"] == 5 and entry["count"] == 7
    assert entry["eps"] == 0.25 and entry["norm"] == "sample"
    json.dumps(man)
    monkeypatch.setenv(wire_store.STORE_GENS_ENV, "nope")
    assert wire_store.default_max_gens() == 12


# ---- the summary lanes and the decode -------------------------------------------


def _gen(rng, n=256, d=2, count=200):
    m = rng.integers(0, 3, n)
    theta = rng.normal(size=(n, d)).astype(np.float32)
    dist = rng.random(n).astype(np.float32)
    lw = (rng.normal(size=n) * 2 - 40).astype(np.float32)
    lw[:3] = -np.inf
    valid = np.arange(n) < count
    return m, theta, dist, lw, valid


def test_summary_lanes_match_the_jax_package():
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    m, theta, dist, lw, valid = _gen(rng)
    ours = wire_store.summary_wire_lanes(
        torch.as_tensor(m), torch.as_tensor(theta), torch.as_tensor(dist),
        torch.as_tensor(lw), torch.as_tensor(valid), 3)
    ref = jax_store.summary_wire_lanes(
        jnp.asarray(m, jnp.int32), jnp.asarray(theta), jnp.asarray(dist),
        jnp.asarray(lw), jnp.asarray(valid), 3)
    assert set(ours) == set(ref) == set(wire_store.SUMMARY_LANE_KEYS)
    for key in ours:
        got, want = ours[key].numpy(), np.asarray(ref[key])
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=key)
    host = {k: v.numpy() for k, v in ours.items()}
    assert wire_store.summary_from_lanes(host) == \
        jax_store.summary_from_lanes(host)


def test_summary_packet_describes_its_population():
    """The device packet of a sequential generation against the host
    population it summarizes (float32 sums on the device)."""
    rng = np.random.default_rng(4)
    m, theta, dist, lw, _ = _gen(rng, count=256)
    lw[:3] = -5.0
    dp = {"m": torch.as_tensor(m), "theta": torch.as_tensor(theta),
          "distance": torch.as_tensor(dist), "log_weight": torch.as_tensor(lw)}
    before = transfer.egress_breakdown()["summary"]
    packet = wire_store.summarize_device_population(dp, 3)
    assert transfer.egress_breakdown()["summary"] > before
    pop = batch_to_population({"m": m, "theta": theta, "distance": dist,
                               "log_weight": lw})
    w = pop.weight.astype(np.float64)
    w /= w.sum()
    mean = (w[:, None] * theta).sum(0)
    np.testing.assert_allclose(packet["mean"], mean, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        packet["var"], (w[:, None] * (theta - mean) ** 2).sum(0), rtol=1e-4)
    np.testing.assert_allclose(packet["ess"], 1 / np.sum(w * w), rtol=1e-4)
    np.testing.assert_allclose(packet["model_w"],
                               pop.get_model_probabilities(3), rtol=1e-5)
    assert packet["model_n"] == np.bincount(m, minlength=3).tolist()
    assert packet["dist_min"] == float(dist.min())
    np.testing.assert_allclose(packet["dist_mean"], np.sum(w * dist),
                               rtol=1e-5)


@pytest.mark.parametrize("norm", ["sample", "stream"])
def test_hydrate_entry_replays_the_eager_decode(norm):
    """``sample``: ``Sample.get_accepted_population``'s float32 shift;
    ``stream``: ``batch_to_population``'s float64 shift — each the same
    bits as the eager path, the fetch booked to ``history``."""
    rng = np.random.default_rng(5)
    m, theta, dist, lw, _ = _gen(rng, n=64)
    lw[:3] = 3.0
    wire = {"m": torch.as_tensor(m), "theta": torch.as_tensor(theta),
            "distance": torch.as_tensor(dist),
            "log_weight": torch.as_tensor(lw),
            "sm_ess": torch.ones(())}
    host = {k: v.numpy() for k, v in wire.items() if k != "sm_ess"}
    if norm == "stream":
        wire.update(count=torch.tensor(70), rounds=torch.tensor(2),
                    eps=torch.tensor(0.5))
        want = batch_to_population(host)
    else:
        smp = Sample()
        smp._acc.append(host)
        want = smp.get_accepted_population(64)
    store = wire_store.DeviceRunStore()
    store.deposit(3, wire, n=64, count=64, norm=norm)
    before = transfer.egress_breakdown()["history"]
    got = store.hydrate(3)
    assert transfer.egress_breakdown()["history"] > before
    assert store.hydrations == 1 and store.has(3)
    for key in ("m", "theta", "distance", "weight"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    assert store.hydrate(99) is None


# ---- lazy History bit-identical to eager ----------------------------------------


def _run(mode, pop=256, gens=4, seed=7, db="sqlite://", **kw):
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=pop,
                    sampler=pt.VectorizedSampler(device="cpu"), seed=seed,
                    history_mode=mode, device="cpu", **kw)
    abc.new(db, observed)
    abc.run(max_nr_populations=gens)
    return abc


def _assert_bit_identical(h_e, h_l, label):
    assert h_e.max_t == h_l.max_t
    for t in range(h_e.max_t + 1):
        for m in range(2):
            de, we = h_e.get_distribution(m, t)
            dl, wl = h_l.get_distribution(m, t)
            assert np.array_equal(np.asarray(de["mu"]),
                                  np.asarray(dl["mu"])), \
                f"{label}: theta differs at t={t} m={m}"
            assert np.array_equal(we, wl), \
                f"{label}: weights differ at t={t} m={m}"
        pe, pl = h_e.get_population(t=t), h_l.get_population(t=t)
        assert np.array_equal(pe.distance, pl.distance)
        assert np.array_equal(pe.m, pl.m)
    assert h_e.get_model_probabilities().equals(
        h_l.get_model_probabilities())


ENGINES = {
    "sequential": {"ingest_mode": "sequential"},
    "fused": {"fuse_generations": 3, "ingest_mode": "sequential"},
    "pipelined": {"fuse_generations": 2, "ingest_mode": "overlap"},
    "onedispatch": {"fuse_generations": 2, "run_mode": "onedispatch",
                    "eps": pt.ConstantEpsilon(0.5)},
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_lazy_bit_identical_to_eager(engine):
    kw = ENGINES[engine]
    abc_e = _run("eager", **kw)
    abc_l = _run("lazy", **kw)
    paths = {r["path"] for r in abc_l.timeline}
    assert paths - {"sequential"} or engine == "sequential", paths
    _assert_bit_identical(abc_e.history, abc_l.history, engine)
    assert {r["history_mode"] for r in abc_l.timeline} == {"lazy"}
    assert {r["history_mode"] for r in abc_e.timeline} == {"eager"}
    # every lazy row keeps its packet after materializing; eager rows
    # have none, and neither has the pipeline's sequential generation,
    # whose fetch the engine took (as in the JAX package)
    for row in abc_l.timeline:
        packet = abc_l.history.get_population_summary(row["t"])
        assert abc_e.history.get_population_summary(row["t"]) is None
        if engine == "pipelined" and row["path"] == "sequential":
            assert packet is None
            continue
        assert packet["ess"] > 0
        assert np.isclose(sum(packet["model_w"]), 1.0)
        assert len(packet["mean"]) == 1
    assert abc_l._store.resident_ts() == []


def test_fused_lazy_reload_from_file(tmp_path):
    """A fresh History on the lazy run's file reads the eager bits."""
    db = "sqlite:///" + str(tmp_path / "lazy.db")
    abc_e = _run("eager", fuse_generations=3, ingest_mode="sequential")
    abc_l = _run("lazy", fuse_generations=3, ingest_mode="sequential",
                 db=db)
    h2 = pt.History(db, abc_id=abc_l.history.id)
    _assert_bit_identical(abc_e.history, h2, "fused/reload")
    assert h2.get_population_summary(1) is not None
    # a detached History reads the durable blobs only
    abc_l.history.detach_store()
    assert abc_l.history._store is None
    _assert_bit_identical(abc_e.history, abc_l.history, "fused/detached")


def test_eviction_pressure_falls_back_bit_identically(monkeypatch):
    """A ring of one under 3-generation fused blocks: every block spills
    two generations to the drain, and nothing changes by a bit."""
    monkeypatch.setenv(wire_store.STORE_GENS_ENV, "1")
    abc_l = _run("lazy", fuse_generations=3, ingest_mode="sequential",
                 gens=7)
    assert abc_l._store.evictions >= 2
    monkeypatch.delenv(wire_store.STORE_GENS_ENV)
    abc_e = _run("eager", fuse_generations=3, ingest_mode="sequential",
                 gens=7)
    _assert_bit_identical(abc_e.history, abc_l.history, "evicted")


def test_history_mode_default_and_validation(monkeypatch):
    models, priors, distance, _, _ = make_two_gaussians_problem()
    monkeypatch.setenv(wire_store.HISTORY_MODE_ENV, "eager")
    abc = pt.ABCSMC(models, priors, distance, population_size=64,
                    device="cpu")
    assert abc.history_mode == "eager"
    monkeypatch.delenv(wire_store.HISTORY_MODE_ENV)
    abc = pt.ABCSMC(models, priors, distance, population_size=64,
                    device="cpu")
    assert abc.history_mode == "lazy"
    with pytest.raises(ValueError, match="history_mode"):
        pt.ABCSMC(models, priors, distance, population_size=64,
                  history_mode="nope", device="cpu")


def test_resume_purges_unhydratable_summary_rows(tmp_path):
    """A summary row whose store died with its process is purged on
    ``load``: ``max_t`` anchors on durable blobs."""
    db = "sqlite:///" + str(tmp_path / "resume.db")
    abc = _run("lazy", pop=128, gens=2, db=db, ingest_mode="sequential")
    h = abc.history
    max_t = h.max_t
    h._conn.execute(
        "INSERT INTO populations (abc_smc_id, t, epsilon, nr_samples,"
        " population_end_time, lazy, summary) VALUES (?,?,?,?,?,1,?)",
        (h.id, max_t + 1, 0.1, 999, "x",
         json.dumps({"ess": 1.0, "model_w": [1.0]})))
    h._conn.commit()
    assert h.max_t == max_t + 1
    models, priors, distance, _, _ = make_two_gaussians_problem()
    abc2 = pt.ABCSMC(models, priors, distance, population_size=128,
                     sampler=pt.VectorizedSampler(device="cpu"), seed=4,
                     device="cpu")
    assert abc2.load(db).max_t == max_t
    abc2.run(max_nr_populations=1)
    assert abc2.history.max_t == max_t + 1


def test_egress_lazy_ships_summaries_eager_ships_populations():
    """Per-generation egress of the fused engine: eager fetches every
    population, lazy ships O(KB) packets and fetches each block's last
    generation (the host continuation) and, at ``done``, the rest, booked
    to ``history``."""
    def egress(mode):
        b0 = transfer.egress_breakdown()
        _run(mode, pop=512, gens=7, fuse_generations=3,
             ingest_mode="sequential")
        b1 = transfer.egress_breakdown()
        return {k: b1[k] - b0[k] for k in b1}

    eager, lazy = egress("eager"), egress("lazy")
    assert lazy["summary"] > 0 and eager["summary"] == 0
    assert 0 < lazy["summary"] < eager["population"] / 10
    assert lazy["history"] > 0 and eager["history"] == 0
    assert lazy["population"] < eager["population"]


# ---- summary packets against the JAX package -------------------------------------

#: sampling tolerances of two independent runs at pop 800 (the posterior
#: bound of the JAX package's test_overlap_posterior_matches_sequential_
#: mode for the mean; model mass and ESS fraction alike)
TWIN_POP = 800
TOL_MEAN = 0.15
TOL_MODEL_W = 0.1
TOL_ESS_FRAC = 0.2


def _packets(pkg):
    problem = jax_problem if pkg is jpt else make_two_gaussians_problem
    kw = {"device": "cpu"} if pkg is pt else {}
    models, priors, distance, observed, _ = problem()
    abc = pkg.ABCSMC(models, priors, distance, population_size=TWIN_POP,
                     sampler=pkg.VectorizedSampler(**kw), seed=3,
                     ingest_mode="overlap", history_mode="lazy", **kw)
    abc.new("sqlite://", observed)
    abc.run(max_nr_populations=4)
    h = abc.history
    return [h.get_population_summary(t) for t in range(1, h.max_t + 1)]


def test_summary_packets_agree_with_the_jax_package():
    """Config #2 through both packages' pipelined engines with lazy
    rows: every block generation has a packet, and the packets agree
    within sampling error — the mean within 0.15, the model masses within
    0.1, the ESS fraction within 0.2."""
    ours, ref = _packets(pt), _packets(jpt)
    assert len(ours) == len(ref) == 3
    for t, (a, b) in enumerate(zip(ours, ref), start=1):
        assert a is not None and b is not None, t
        assert abs(a["mean"][0] - b["mean"][0]) < TOL_MEAN, (t, a, b)
        assert np.max(np.abs(np.subtract(a["model_w"], b["model_w"]))) \
            < TOL_MODEL_W, (t, a, b)
        assert abs(a["ess"] - b["ess"]) / TWIN_POP < TOL_ESS_FRAC, (t, a, b)
        assert a["model_n"] and sum(a["model_n"]) == TWIN_POP
