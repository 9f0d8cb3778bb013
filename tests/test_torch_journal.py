"""The port's spill journal, content digests and crash recovery, held to
the JAX package's (``pyabc_tpu/resilience/journal.py``,
``tests/test_journal.py``, ``tests/test_fault_tolerance.py``,
``tests/test_fidelity.py``): a journal either package writes is the
same bytes and reads back with equal ``pending()`` payloads in the
other, corrupt bytes raise ``IntegrityError`` in both, a History CRC
column the JAX package wrote verifies in the port, and the kill -9 /
SIGTERM recoveries run in child processes that import no JAX."""

import os
import signal
import sqlite3
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.resilience import journal as jax_journal
from pyabc_tpu_torch.fidelity.calibrate import screen_threshold
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.resilience import checkpoint as ckpt
from pyabc_tpu_torch.resilience import journal
from pyabc_tpu_torch.telemetry import REGISTRY

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_sigterm():
    """A resumed run with sub-checkpoints arms the port's SIGTERM handler
    for the process: put it back, so that an in-process SIGTERM of a
    later test (the JAX package's preemption tests) cannot set the
    port's flag and stop every later port run in this worker."""
    handler = (signal.getsignal(signal.SIGTERM), ckpt._INSTALLED,
               ckpt._PREV_HANDLER)
    yield
    signal.signal(signal.SIGTERM, handler[0])
    ckpt._INSTALLED, ckpt._PREV_HANDLER = handler[1:]
    ckpt.clear_preempt()


def _wire(seed):
    rng = np.random.default_rng(seed)
    return {"m": rng.integers(0, 2, 50).astype(np.int8),
            "theta": rng.normal(size=(50, 2)).astype(np.float16),
            "log_weight": rng.normal(size=50).astype(np.float32),
            "scale": np.float32(3.5).reshape(()),
            "count": np.int64(50).reshape(())}


def _write(mod, directory):
    j = mod.SpillJournal(str(directory))
    j.append_manifest({"t": 1, "n": 50, "count": 50, "eps": 0.5,
                       "norm": "stream", "nbytes": 123,
                       "digest": {"crc": None,
                                  "manifest": mod.manifest_of(_wire(1))}})
    for t in (1, 2, 3):
        j.append_payload(t, _wire(t), {"n": 50, "count": 50,
                                       "eps": 0.5 / t, "norm": "stream"})
    j.mark_materialized(2)
    j.close()


def _same_pending(a, b):
    assert a.keys() == b.keys() == {1, 3}
    for t in a:
        ea, eb = a[t], b[t]
        assert {k: v for k, v in ea.items() if k != "host_wire"} == \
            {k: v for k, v in eb.items() if k != "host_wire"}
        assert ea["host_wire"].keys() == eb["host_wire"].keys()
        for k in ea["host_wire"]:
            x, y = ea["host_wire"][k], eb["host_wire"][k]
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_interop_both_ways(tmp_path, writer):
    d = tmp_path / "j"
    _write(jax_journal if writer == "jax" else journal, d)
    _same_pending(journal.SpillJournal(str(d)).pending(),
                  jax_journal.SpillJournal(str(d)).pending())


def test_both_packages_write_the_same_bytes(tmp_path):
    _write(jax_journal, tmp_path / "a")
    _write(journal, tmp_path / "b")
    segs = sorted(os.listdir(tmp_path / "a"))
    assert segs == sorted(os.listdir(tmp_path / "b"))
    for s in segs:
        assert (tmp_path / "a" / s).read_bytes() == \
            (tmp_path / "b" / s).read_bytes()
    assert (tmp_path / "a" / segs[0]).read_bytes()[:4] == b"PJN1"


def test_digest_equal_and_corrupt_bytes_raise_in_both():
    wire = _wire(4)
    assert journal.digest_wire(wire) == jax_journal.digest_wire(wire)
    bad = dict(wire)
    raw = bytearray(bad["log_weight"].tobytes())
    raw[7] ^= 0x10
    bad["log_weight"] = np.frombuffer(bytes(raw), np.float32)
    for mod in (journal, jax_journal):
        digest = mod.digest_wire(wire)
        mod.verify_wire(wire, digest, t=4)
        with pytest.raises(mod.IntegrityError, match="CRC"):
            mod.verify_wire(bad, digest, t=4)
        reshaped = dict(wire, theta=wire["theta"][:10])
        with pytest.raises(mod.IntegrityError, match="manifest"):
            mod.verify_wire(reshaped, digest, t=4)
    # a tensor and its host copy give the same manifest
    assert journal.manifest_of({"x": torch.zeros(3, 2)}) == \
        journal.manifest_of({"x": np.zeros((3, 2), np.float32)})


def _record_offsets(data: bytes):
    """``(header, payload_start, end)`` of every framed record."""
    import json
    import struct
    off, out = 0, []
    while off + 16 <= len(data):
        hlen, plen, _ = struct.unpack_from("<III", data, off + 4)
        start = off + 16
        header = json.loads(data[start:start + hlen])
        out.append((header, start + hlen, start + hlen + plen))
        off = start + hlen + plen
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_crc_bad_record_skipped_and_torn_tail_ignored(tmp_path, writer):
    d = tmp_path / "j"
    _write(jax_journal if writer == "jax" else journal, d)
    seg = d / sorted(os.listdir(d))[0]
    data = bytearray(seg.read_bytes())
    (_, lo, hi), = [(h, lo, hi) for h, lo, hi in _record_offsets(data)
                    if h.get("kind") == "payload" and h.get("t") == 3]
    data[(lo + hi) // 2] ^= 0xFF  # one flipped bit in t=3's payload
    import struct
    torn = b"PJN1" + struct.pack("<III", 10, 100, 0) + b"xx"
    seg.write_bytes(bytes(data) + torn)  # plus a torn tail
    before = REGISTRY.to_dict()
    ours = journal.SpillJournal(str(d)).pending()
    theirs = jax_journal.SpillJournal(str(d)).pending()
    assert ours.keys() == theirs.keys() == {1}
    delta = REGISTRY.delta(before)
    assert delta["resilience_journal_bad_records_total"] >= 1
    assert delta["resilience_journal_torn_total"] >= 1


def test_jax_history_crc_column_verifies_in_the_port(tmp_path):
    db = str(tmp_path / "jax.db")
    h = jpt.History("sqlite:///" + db)
    h.store_initial_data(None, {}, {"y": np.float32(1.0)}, None,
                         ["m0", "m1"])
    rng = np.random.default_rng(0)
    m = np.asarray([0, 1] * 20, np.int32)
    theta = rng.normal(size=(40, 1)).astype(np.float32)
    w = np.full(40, 1 / 40, np.float32)
    d = rng.uniform(size=40).astype(np.float32)
    pop = jpt.Population(m, theta, w, d)
    h.append_population(0, 0.5, pop, 400, ["m0", "m1"], [["mu"], ["mu"]])
    h.close()
    ours = pt.History("sqlite:///" + db, abc_id=1)
    before = REGISTRY.to_dict().get("store_integrity_checks_total", 0)
    got = ours.get_population(0)
    assert REGISTRY.to_dict()["store_integrity_checks_total"] - before == 6
    order = np.argsort(m, kind="stable")
    np.testing.assert_array_equal(got.theta, theta[order])
    np.testing.assert_array_equal(got.distance, d[order])
    df, wm = ours.get_distribution(m=1, t=0)
    assert len(df) == 20
    ours.close()
    # one flipped byte in a stored blob: the port refuses it
    with sqlite3.connect(db) as conn:
        blob = bytearray(conn.execute(
            "SELECT theta FROM model_populations WHERE m=1").fetchone()[0])
        blob[-1] ^= 0x01
        conn.execute("UPDATE model_populations SET theta=? WHERE m=1",
                     (bytes(blob),))
    ours = pt.History("sqlite:///" + db, abc_id=1)
    with pytest.raises(journal.IntegrityError):
        ours.get_population(0)


def test_journal_dir_resolution(tmp_path, monkeypatch):
    monkeypatch.delenv(journal.JOURNAL_DIR_ENV, raising=False)
    monkeypatch.delenv(journal.JOURNAL_ENV, raising=False)
    assert journal.journal_dir_for("/x/a.db", False) == "/x/a.db.journal"
    assert journal.journal_dir_for(":memory:", True) is None
    monkeypatch.setenv(journal.JOURNAL_DIR_ENV, str(tmp_path))
    assert journal.journal_dir_for(":memory:", True) == str(tmp_path)
    monkeypatch.setenv(journal.JOURNAL_ENV, "0")
    assert journal.journal_dir_for("/x/a.db", False) is None
    for mod in (journal, jax_journal):
        monkeypatch.delenv(mod.JOURNAL_ENV, raising=False)
        monkeypatch.delenv(mod.JOURNAL_DIR_ENV, raising=False)
        assert mod.journal_dir_for("/x/a.db", False) == "/x/a.db.journal"


# ---- crash recovery in child processes that import no JAX -----------------

_NO_JAX = """
import sys
for name in ("jax", "jaxlib", "pyabc_tpu"):
    sys.modules[name] = None
"""


def _child(tmp_path, body, env=None, name="child.py"):
    script = tmp_path / name
    script.write_text(_NO_JAX + textwrap.dedent(body))
    full_env = dict(os.environ, PYTHONPATH=_REPO)
    for key in ("PYABC_TPU_FAULTS", "PYABC_TPU_STORE_GENS"):
        full_env.pop(key, None)
    full_env.update(env or {})
    return subprocess.run([sys.executable, str(script)], env=full_env,
                          capture_output=True, text=True, timeout=300)


_FIDELITY_CHILD = """
import sys
import torch
import pyabc_tpu_torch as pt
from pyabc_tpu_torch.models.sir import SIRTauLeap
from pyabc_tpu_torch.random_variables import RV, Distribution

model = SIRTauLeap(n_steps=40, n_obs=8)
prior = Distribution(log_beta=RV("uniform", -2.0, 3.0),
                     log_gamma=RV("uniform", -3.0, 3.0))
g = torch.Generator().manual_seed(11)
obs = model.simulate(g, torch.log(torch.tensor([[0.8, 0.2]])))
observed = {k: v[0].numpy() for k, v in obs.items()}
abc = pt.ABCSMC([model], [prior], pt.PNormDistance(p=2),
                population_size=128,
                sampler=pt.VectorizedSampler(device="cpu"),
                fuse_generations=2, seed=11, fidelity="screen",
                history_mode="eager")
abc.new(DB, observed)
abc.run(max_nr_populations=5)
sys.exit(0)
"""


def _sir_problem():
    from pyabc_tpu_torch.models.sir import SIRTauLeap
    from pyabc_tpu_torch.random_variables import RV, Distribution
    model = SIRTauLeap(n_steps=40, n_obs=8)
    prior = Distribution(log_beta=RV("uniform", -2.0, 3.0),
                         log_gamma=RV("uniform", -3.0, 3.0))
    g = torch.Generator().manual_seed(11)
    obs = model.simulate(g, torch.log(torch.tensor([[0.8, 0.2]])))
    return [model], [prior], pt.PNormDistance(p=2), {
        k: v[0].numpy() for k, v in obs.items()}


def test_calibrate_kill9_recovers_with_screening_self_disabled(tmp_path):
    db = "sqlite:///" + str(tmp_path / "fid_chaos.db")
    proc = _child(tmp_path, f"DB = {db!r}\n" + _FIDELITY_CHILD,
                  env={"PYABC_TPU_FAULTS": "fidelity.calibrate@2:sigkill",
                       "PYABC_TPU_FAULT_SEED": "0"})
    assert proc.returncode == -9, proc.stderr[-2000:]
    models, priors, distance, _ = _sir_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=128,
                    sampler=pt.VectorizedSampler(device="cpu"),
                    fuse_generations=2, seed=12, fidelity="screen",
                    history_mode="eager")
    abc.load(db)
    done = abc.history.max_t + 1
    assert done == 3, f"lost generations: only {done} durable"
    lo, full = abc._fidelity_nan_seed(abc.fidelity.cal_rows)
    assert float(screen_threshold(
        lo, full, torch.tensor(1.0), q=abc.fidelity.false_reject_q,
        margin=abc.fidelity.margin, min_corr=abc.fidelity.min_corr,
        min_pairs=abc.fidelity.min_pairs)) == np.inf
    h = abc.run(max_nr_populations=5 - done)
    counts = h.get_nr_particles_per_population()
    assert sorted(t for t in counts.index if t >= 0) == [0, 1, 2, 3, 4]
    assert all(counts[t] == 128 for t in range(5))
    eps = h.get_all_populations()
    eps = eps[eps.t >= 0].epsilon.to_numpy()
    assert np.all(np.diff(eps) < 0)
    abc.history.close()


_POP = 2000


def _gate(h, posterior_fn, pop):
    t = h.max_t
    p_b = float(h.get_model_probabilities(t).get(1, 0.0))
    df, w = h.get_distribution(m=1, t=t)
    mu = float(np.sum(df["mu"].to_numpy() * w))
    assert abs(p_b - posterior_fn(1.0)) < max(2.5e-3, 2.5 / pop ** 0.5)
    assert abs(mu - 1.0) < max(3e-3, 3.0 / pop ** 0.5)


_SIGKILL_CHILD = """
import sys
import pyabc_tpu_torch as pt
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.resilience import faults

models, priors, distance, observed, _ = make_two_gaussians_problem()
faults.install(faults.FaultPlan.parse("history.materialize@2:sigkill"))
abc = pt.ABCSMC(models, priors, distance, population_size=%(pop)d,
                eps=pt.MedianEpsilon(),
                sampler=pt.VectorizedSampler(device="cpu"),
                stores_sum_stats=False, seed=7, history_mode="lazy",
                ingest_mode="sequential", fuse_generations=3)
abc.new(DB, observed)
abc.run(max_nr_populations=6)
sys.exit(3)
""" % {"pop": _POP}


def test_sigkill_mid_run_recovers_from_journal(tmp_path):
    db = str(tmp_path / "kill.db")
    proc = _child(tmp_path, f"DB = {db!r}\n" + _SIGKILL_CHILD,
                  env={"PYABC_TPU_STORE_GENS": "1"})
    assert proc.returncode == -9, proc.stderr[-3000:]
    j = journal.SpillJournal(db + ".journal")
    assert 2 in j.pending()
    j.close()
    with sqlite3.connect(db) as conn:
        flags = dict(conn.execute(
            "SELECT t, lazy FROM populations WHERE t >= 0"))
    assert flags == {0: 0, 1: 0, 2: 1}

    models, priors, distance, observed, posterior_fn = \
        make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=_POP,
                    eps=pt.MedianEpsilon(),
                    sampler=pt.VectorizedSampler(device="cpu",
                                                 max_batch_size=1 << 15),
                    stores_sum_stats=False, seed=8, history_mode="lazy",
                    ingest_mode="sequential")
    before = REGISTRY.to_dict().get("resilience_journal_replayed_total", 0)
    abc.load(db)
    assert abc.history.max_t == 2
    assert REGISTRY.to_dict()["resilience_journal_replayed_total"] \
        - before == 1
    with sqlite3.connect(db) as conn:
        lazy_left = conn.execute(
            "SELECT COUNT(*) FROM populations WHERE lazy = 1").fetchone()
    assert lazy_left[0] == 0
    j2 = journal.SpillJournal(db + ".journal")
    assert j2.pending() == {}
    j2.close()
    h = abc.run(max_nr_populations=2)
    assert h.max_t == 4
    for tt in range(5):
        pop = h.get_population(t=tt)
        assert pop.theta.shape[0] == _POP
        assert np.isclose(pop.weight.sum(), 1.0, atol=1e-5)
    _gate(h, posterior_fn, _POP)


_PREEMPT_CHILD = """
import sys
import pyabc_tpu_torch as pt
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.resilience import faults
from pyabc_tpu_torch.resilience.checkpoint import Preempted

models, priors, distance, observed, _ = make_two_gaussians_problem()


def make_abc(path):
    abc = pt.ABCSMC(models, priors, distance, population_size=%(pop)d,
                    eps=pt.MedianEpsilon(),
                    sampler=pt.VectorizedSampler(device="cpu",
                                                 max_batch_size=1 << 11,
                                                 max_rounds_per_call=1),
                    stores_sum_stats=False, seed=7,
                    checkpoint_every_rounds=1)
    abc.new(path, observed)
    return abc


probe = faults.install(faults.FaultPlan.parse("preempt@999999999:sigterm"))
make_abc(DB + ".probe").run(max_nr_populations=1)
v0 = probe.visits(faults.SITE_PREEMPT)
faults.install(faults.FaultPlan.parse("preempt@%%d:sigterm" %% (v0 + 1)))
try:
    make_abc(DB).run(max_nr_populations=30)
except Preempted:
    sys.exit(17)
sys.exit(3)
""" % {"pop": _POP}


def test_sigterm_mid_generation_resumes_and_passes_gate(tmp_path):
    db = str(tmp_path / "preempt.db")
    proc = _child(tmp_path, f"DB = {db!r}\n" + _PREEMPT_CHILD)
    assert proc.returncode == 17, proc.stderr[-3000:]
    hist = pt.History(db, abc_id=1)
    assert hist.max_t == 0
    row = hist.load_sub_checkpoint(1)
    assert row is not None
    assert 1 <= row["n_accepted"] < _POP
    assert row["nr_evaluations"] >= row["n_accepted"]
    hist.close()

    ckpt.clear_preempt()
    models, priors, distance, observed, posterior_fn = \
        make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=_POP,
                    eps=pt.MedianEpsilon(),
                    sampler=pt.VectorizedSampler(device="cpu",
                                                 max_batch_size=1 << 15,
                                                 max_rounds_per_call=4),
                    stores_sum_stats=False, seed=8,
                    checkpoint_every_rounds=1)
    abc.load(db)
    h = abc.run(max_nr_populations=5)
    assert h.max_t == 5
    assert h.load_sub_checkpoint(1) is None
    pops = h.get_all_populations()
    assert int(pops[pops.t == 1].samples.iloc[0]) >= row["nr_evaluations"]
    for tt in range(6):
        pop = h.get_population(t=tt)
        assert pop.theta.shape[0] == _POP
        assert np.isclose(pop.weight.sum(), 1.0, atol=1e-5)
    _gate(h, posterior_fn, _POP)


def test_wire_fetch_failure_surfaces_within_one_generation(tmp_path,
                                                           monkeypatch):
    import pyabc_tpu_torch.sampler.base as sampler_base
    import pyabc_tpu_torch.smc as smc
    from pyabc_tpu_torch.wire import WireError

    db = str(tmp_path / "abc.db")
    real_fetch = sampler_base.fetch_to_host
    calls = {"n": 0}

    def dying_fetch(tree, ready=None):
        calls["n"] += 1
        if calls["n"] >= 2:  # the first wire fetch is fine, then it dies
            raise ConnectionResetError("relay died")
        return real_fetch(tree, ready)

    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=256,
                    sampler=pt.VectorizedSampler(device="cpu"), seed=5,
                    ingest_mode="overlap", ingest_depth=2,
                    history_mode="eager")
    abc.new(db, observed)
    monkeypatch.setattr(sampler_base, "fetch_to_host", dying_fetch)
    monkeypatch.setattr(smc, "fetch_to_host", dying_fetch)
    with pytest.raises(WireError, match="relay died"):
        abc.run(max_nr_populations=6)
    monkeypatch.setattr(sampler_base, "fetch_to_host", real_fetch)
    monkeypatch.setattr(smc, "fetch_to_host", real_fetch)
    t_failed = abc.history.max_t
    assert t_failed <= 2
    for t in range(t_failed + 1):
        pop = abc.history.get_population(t=t)
        assert np.isclose(pop.weight.sum(), 1.0, atol=1e-5)
    abc2 = pt.ABCSMC(models, priors, distance, population_size=256,
                     sampler=pt.VectorizedSampler(device="cpu"), seed=6,
                     ingest_mode="sequential")
    abc2.load(db)
    abc2.run(max_nr_populations=2)
    assert abc2.history.max_t >= t_failed + 1


@pytest.mark.parametrize("plan", ["store.hydrate@1:corrupt=4",
                                  "store.hydrate@1+:corrupt=4"])
def test_corrupt_hydration_walks_the_ladder(plan):
    """A bit flipped between the store's fetch and the decode is caught
    by the digest.  Once, the History's ladder re-fetches the device
    copy: the run equals a clean one, with no degradation.  On every
    fetch, the last rung drops lazy mode and redoes the generation
    eagerly: the run completes with full populations and one
    degradation."""
    from pyabc_tpu_torch.resilience import faults

    def run():
        models, priors, distance, observed, _ = make_two_gaussians_problem()
        abc = pt.ABCSMC(models, priors, distance, population_size=300,
                        eps=pt.ConstantEpsilon(0.2), fuse_generations=2,
                        sampler=pt.VectorizedSampler(device="cpu",
                                                     min_batch_size=2048,
                                                     max_batch_size=2048),
                        history_mode="lazy", seed=4)
        abc.new("sqlite://", observed)
        return abc, abc.run(max_nr_populations=3)

    _, clean = run()
    before = REGISTRY.to_dict()
    faults.install(faults.FaultPlan.parse(plan))
    try:
        abc, chaos = run()
    finally:
        faults.uninstall()
    delta = REGISTRY.delta(before)
    assert delta["store_integrity_failures_total"] >= 1
    assert chaos.max_t == 2
    if "+" not in plan:
        assert delta["store_integrity_failures_total"] == 1
        assert delta.get("resilience_degrade_total", 0) == 0
        for t in range(3):
            a, b = clean.get_population(t), chaos.get_population(t)
            np.testing.assert_array_equal(a.theta, b.theta)
            np.testing.assert_array_equal(a.weight, b.weight)
        return
    assert delta["resilience_degrade_total"] == 1
    assert not abc._lazy_active
    assert {r["history_mode"] for r in abc.timeline} == {"eager"}
    for t in range(3):
        pop = chaos.get_population(t)
        assert pop.theta.shape[0] == 300
        assert np.isclose(pop.weight.sum(), 1.0, atol=1e-5)
