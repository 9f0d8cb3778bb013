"""The History blob codec: PTW1 (delta + zlib) in both packages.

Both packages pack every History blob with the PTW1 codec unless
``$PYABC_TPU_WIRE_CODEC`` is ``raw`` (plain ``.npy``), and read both
forms.  For the same arrays the blobs, and so the CRC column, are byte
for byte the same; a database either package wrote reads back in the
other with the same populations, weights and model probabilities, bit
for bit; lazy rows and the spill journal hydrate to the eager bits
under either codec.
"""

import os
import sqlite3

import numpy as np
import pytest

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem
from pyabc_tpu.resilience import journal as jax_journal
from pyabc_tpu.storage.history import _pack as jax_pack
from pyabc_tpu.storage.history import History as JaxHistory
from pyabc_tpu.wire import transfer as jax_transfer
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.resilience import journal
from pyabc_tpu_torch.storage import History
from pyabc_tpu_torch.storage.history import _pack
from pyabc_tpu_torch.wire import transfer

#: the codec settings: the default (PTW1) and raw ``.npy``
CODECS = [None, "raw"]


@pytest.fixture(params=CODECS, ids=["ptw1", "raw"])
def codec(request, monkeypatch):
    if request.param is None:
        monkeypatch.delenv(transfer.WIRE_CODEC_ENV, raising=False)
    else:
        monkeypatch.setenv(transfer.WIRE_CODEC_ENV, request.param)
    return request.param


@pytest.fixture(scope="module")
def jax_db(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ptw1") / "jax.db")
    models, priors, distance, observed, _ = jax_problem()
    abc = jpt.ABCSMC(models, priors, distance, population_size=300,
                     sampler=jpt.VectorizedSampler(), seed=3)
    abc.new(path, observed)
    abc.run(max_nr_populations=3)
    return path


@pytest.mark.parametrize("arr", [
    np.arange(12, dtype=np.float32).reshape(4, 3) * 0.37,
    np.array([3, 1, 4, 1, 5], dtype=np.int64),
    np.array(2.5, dtype=np.float64),
    np.zeros((1, 2), dtype=np.float16),
    np.array([True, False, True]),
])
def test_codec_matches_the_jax_package(arr):
    """Same bytes out of both encoders; each decoder reads both."""
    blob = transfer.encode_array(arr)
    assert blob == jax_transfer.encode_array(arr, codec="delta")
    for out in (transfer.decode_array(blob),
                transfer.decode_array(jax_transfer.encode_array(arr))):
        assert out.dtype == arr.dtype and out.shape == arr.shape
        np.testing.assert_array_equal(out, arr)


def test_jax_history_blobs_are_ptw1(jax_db):
    assert transfer.is_ptw1(jax_pack(np.ones((3, 2), np.float32)))


def test_port_reads_a_jax_database(jax_db):
    jh = JaxHistory(jax_db, abc_id=1)
    ph = History(jax_db, abc_id=1)
    assert ph.max_t == jh.max_t == 2
    for t in range(ph.max_t + 1):
        np.testing.assert_array_equal(
            ph.get_model_probabilities(t).to_numpy(),
            jh.get_model_probabilities(t).to_numpy())
        for m in (0, 1):
            df_p, w_p = ph.get_distribution(m=m, t=t)
            df_j, w_j = jh.get_distribution(m=m, t=t)
            np.testing.assert_array_equal(w_p, w_j)
            np.testing.assert_array_equal(df_p.to_numpy(), df_j.to_numpy())
        pop_p, pop_j = ph.get_population(t), jh.get_population(t)
        np.testing.assert_array_equal(np.asarray(pop_p.distance),
                                      np.asarray(pop_j.distance))
        np.testing.assert_array_equal(np.asarray(pop_p.weight),
                                      np.asarray(pop_j.weight))
    pops_p, pops_j = ph.get_all_populations(), jh.get_all_populations()
    np.testing.assert_array_equal(pops_p.epsilon.to_numpy(),
                                  pops_j.epsilon.to_numpy())
    np.testing.assert_array_equal(pops_p.samples.to_numpy(),
                                  pops_j.samples.to_numpy())


def _population(pkg, seed=0, n=40):
    rng = np.random.default_rng(seed)
    m = np.asarray([0, 1] * (n // 2), np.int32)
    return pkg.Population(
        m, rng.normal(size=(n, 2)).astype(np.float32),
        rng.uniform(0.1, 1.0, n).astype(np.float32),
        rng.uniform(size=n).astype(np.float32),
        {"__flat__": rng.normal(size=(n, 3)).astype(np.float32)})


def _write_population(pkg, db, n=40):
    h = pkg.History("sqlite:///" + db)
    h.store_initial_data(None, {}, {"y": np.float32(1.0)}, None,
                         ["m0", "m1"])
    h.append_population(0, 0.5, _population(pkg, n=n), 400, ["m0", "m1"],
                        [["a", "b"], ["a", "b"]], stat_spec={"s": (3,)})
    h.close()


def _model_rows(db):
    with sqlite3.connect(db) as conn:
        return conn.execute(
            "SELECT m, theta, weight, distance, stats, digest FROM "
            "model_populations ORDER BY m").fetchall()


def test_port_blobs_are_ptw1_by_default_and_npy_under_raw(monkeypatch,
                                                          tmp_path):
    arr = np.arange(12, dtype=np.float32).reshape(6, 2)
    monkeypatch.delenv(transfer.WIRE_CODEC_ENV, raising=False)
    assert transfer.wire_codec() == "delta" and transfer.is_ptw1(_pack(arr))
    _write_population(pt, str(tmp_path / "ptw1.db"))
    for value in ("raw", "OFF", "none", "0"):
        monkeypatch.setenv(transfer.WIRE_CODEC_ENV, value)
        assert transfer.wire_codec() == jax_transfer.wire_codec() == "raw"
        assert _pack(arr)[:6] == b"\x93NUMPY"
    _write_population(pt, str(tmp_path / "raw.db"))
    for row in _model_rows(str(tmp_path / "ptw1.db")):
        assert all(transfer.is_ptw1(b) for b in row[1:5])
    for row in _model_rows(str(tmp_path / "raw.db")):
        assert all(b[:6] == b"\x93NUMPY" for b in row[1:5])
    # the codec refuses an object array: np.save's refusal is the answer
    monkeypatch.delenv(transfer.WIRE_CODEC_ENV)
    with pytest.raises(ValueError):
        _pack(np.array([{"a": 1}], dtype=object))


@pytest.mark.parametrize("n", [40, 100_000])
def test_blob_bytes_and_crcs_equal_the_jax_packages(codec, tmp_path, n):
    """At 100 000 rows a generation's arrays pass
    ``PACK_PARALLEL_MIN_BYTES``: its blobs are packed on threads."""
    from pyabc_tpu_torch.storage.history import PACK_PARALLEL_MIN_BYTES
    assert (n * 6 * 4 >= PACK_PARALLEL_MIN_BYTES) == (n > 40)
    for arr in (np.linspace(0, 1, 64, dtype=np.float32).reshape(32, 2),
                np.array([7], np.int32), np.array(1.5, np.float64)):
        assert _pack(arr) == jax_pack(arr)
    _write_population(pt, str(tmp_path / "port.db"), n)
    _write_population(jpt, str(tmp_path / "jax.db"), n)
    ours, ref = (_model_rows(str(tmp_path / "port.db")),
                 _model_rows(str(tmp_path / "jax.db")))
    assert len(ours) == len(ref) == 2
    assert ours == ref  # every blob and the CRC column, byte for byte


def _arrays(h):
    out = {}
    for t in range(h.max_t + 1):
        pop = h.get_population(t)
        out[t] = {"m": np.asarray(pop.m), "theta": np.asarray(pop.theta),
                  "weight": np.asarray(pop.weight),
                  "distance": np.asarray(pop.distance),
                  "probs": h.get_model_probabilities(t).to_numpy()}
        for m in (0, 1):
            df, w = h.get_distribution(m=m, t=t)
            out[t][f"dist{m}"] = (df.to_numpy(), np.asarray(w))
    return out


def _same_arrays(a, b):
    assert a.keys() == b.keys()
    for t in a:
        for k in a[t]:
            x, y = a[t][k], b[t][k]
            for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
                assert u.dtype == v.dtype, (t, k)
                np.testing.assert_array_equal(u, v)


def _port_run(db, gens=3, **kw):
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=300,
                    sampler=pt.VectorizedSampler(device="cpu"), seed=3,
                    device="cpu", **kw)
    abc.new(db, observed)
    abc.run(max_nr_populations=gens)
    return abc


def test_jax_package_reads_a_port_database(codec, tmp_path):
    db = str(tmp_path / "port.db")
    abc = _port_run("sqlite:///" + db, history_mode="eager")
    abc.history.done()
    with sqlite3.connect(db) as conn:
        blob = conn.execute("SELECT theta FROM model_populations "
                            "LIMIT 1").fetchone()[0]
    assert transfer.is_ptw1(blob) == (codec is None)
    ours, ref = History(db, abc_id=1), JaxHistory(db, abc_id=1)
    assert ours.max_t == ref.max_t == 2
    _same_arrays(_arrays(ours), _arrays(ref))


def test_lazy_rows_and_journal_hydrate_bit_identically(codec, tmp_path):
    db = "sqlite:///" + str(tmp_path / "lazy.db")
    kw = dict(fuse_generations=2, ingest_mode="sequential", gens=5)
    eager = _port_run("sqlite://", history_mode="eager", **kw)
    lazy = _port_run(db, history_mode="lazy", **kw)
    assert {r["history_mode"] for r in lazy.timeline} == {"lazy"}
    want = _arrays(eager.history)
    _same_arrays(want, _arrays(lazy.history))
    lazy.history.done()
    _same_arrays(want, _arrays(History(db, abc_id=lazy.history.id)))
    # the spill journal a lazy History keeps: both packages write the
    # same bytes under the codec, and replay bit-identical payloads
    rng = np.random.default_rng(5)
    wire = {"m": rng.integers(0, 2, 64).astype(np.int32),
            "theta": rng.normal(size=(64, 2)).astype(np.float32),
            "log_weight": rng.normal(size=64).astype(np.float32)}
    for mod, where in ((journal, "port"), (jax_journal, "jax")):
        j = mod.SpillJournal(str(tmp_path / where))
        j.append_payload(1, wire, {"n": 64, "count": 64, "eps": 0.5,
                                   "norm": "stream"})
        j.close()
    segs = sorted(os.listdir(tmp_path / "port"))
    assert segs == sorted(os.listdir(tmp_path / "jax"))
    for seg in segs:
        assert (tmp_path / "port" / seg).read_bytes() == \
            (tmp_path / "jax" / seg).read_bytes()
    replay = journal.SpillJournal(str(tmp_path / "jax")).pending()[1]
    for k, v in wire.items():
        assert replay["host_wire"][k].dtype == v.dtype
        np.testing.assert_array_equal(replay["host_wire"][k], v)
