"""The port's pyABC ORM-schema export and import, held to the JAX
package's (``pyabc_tpu/storage/reference_export.py``) on the same
History: identical reference tables row for row, the import round trip,
and the ``export`` CLI's CSV."""

import io
import sqlite3

import numpy as np
import pytest

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.storage import History

REFERENCE_TABLES = {
    "abc_smc": {"id", "start_time", "end_time", "json_parameters",
                "distance_function", "epsilon_function",
                "population_strategy", "git_hash"},
    "populations": {"id", "abc_smc_id", "t", "population_end_time",
                    "nr_samples", "epsilon"},
    "models": {"id", "population_id", "m", "name", "p_model"},
    "particles": {"id", "model_id", "w"},
    "parameters": {"id", "particle_id", "name", "value"},
    "samples": {"id", "particle_id", "distance"},
    "summary_statistics": {"id", "sample_id", "name", "value"},
}


def _port_run(path: str):
    """Config #2 through the port on the CPU: 3 generations at pop 120
    (the JAX test's run), eager rows."""
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=120,
                    sampler=pt.VectorizedSampler(device="cpu"), seed=7,
                    history_mode="eager")
    abc.new(path, observed)
    abc.run(max_nr_populations=3)
    return abc.history


def _jax_written(path: str):
    """A two-model run written by the JAX package's History (its PTW1
    blobs), from seeded numpy populations: ``{t: Population}``."""
    rng = np.random.default_rng(11)
    h = jpt.History(path)
    h.store_initial_data(None, {"source": "numpy"},
                         {"y": np.array([0.5, 1.5], np.float32)}, None,
                         ["m0", "m1"])
    pops = {}
    for t, eps in ((-1, np.inf), (0, 2.0), (1, 0.75)):
        n = 40
        w = rng.random(n).astype(np.float32)
        pop = jpt.Population(
            m=(rng.random(n) < 0.4).astype(np.int32),
            theta=rng.normal(size=(n, 2)).astype(np.float32),
            weight=w / w.sum(), distance=rng.random(n).astype(np.float32),
            sum_stats={"__flat__": rng.normal(size=(n, 2))
                       .astype(np.float32)})
        h.append_population(t, eps, pop, 100 + t, ["m0", "m1"],
                            ["a", "b"], stat_spec={"y": [2]})
        pops[t] = pop
    h.done()
    return pops


@pytest.fixture(scope="module")
def native_dbs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("refdb")
    port_db = str(tmp / "port_native.db")
    _port_run(port_db)
    jax_db = str(tmp / "jax_native.db")
    _jax_written(jax_db)
    return {"port_run": port_db, "jax_written": jax_db}


def _tables(path: str) -> dict:
    conn = sqlite3.connect(path)
    try:
        out = {}
        for table in REFERENCE_TABLES:
            cols = [c for c in sorted(REFERENCE_TABLES[table])
                    if c != "end_time"]  # the export's own clock
            out[table] = conn.execute(
                f"SELECT {', '.join(cols)} FROM {table} ORDER BY id"
            ).fetchall()
        return out
    finally:
        conn.close()


@pytest.mark.parametrize("source", ["port_run", "jax_written"])
def test_both_exports_give_identical_tables(native_dbs, tmp_path, source):
    db = native_dbs[source]
    id_p = History(db, abc_id=1).to_reference_db(str(tmp_path / "p.db"))
    id_j = jpt.History(db, abc_id=1).to_reference_db(str(tmp_path / "j.db"))
    assert id_p == id_j == 1
    got, ref = _tables(str(tmp_path / "p.db")), _tables(str(tmp_path / "j.db"))
    for table in REFERENCE_TABLES:
        assert got[table] == ref[table], table
        assert got[table], table
    conn = sqlite3.connect(str(tmp_path / "p.db"))
    try:
        for table, cols in REFERENCE_TABLES.items():
            have = {r[1] for r in conn.execute(
                f"PRAGMA table_info({table})")}
            assert have == cols, table
        for _, blob in conn.execute(
                "SELECT name, value FROM summary_statistics LIMIT 5"):
            assert blob[:6] == b"\x93NUMPY"
            np.load(io.BytesIO(blob), allow_pickle=False)
    finally:
        conn.close()


@pytest.mark.parametrize("source", ["port_run", "jax_written"])
def test_import_round_trip(native_dbs, tmp_path, source):
    """export -> ``History.from_reference_db``: θ, distances, model
    probabilities, ε and evaluations exactly; the weights come back as
    the reference stores them (within-model, times ``p_model``): exactly
    for a run's population, whose weights sum to 1 in float64, and to
    float32 rounding for the hand-made one, normalized in float32; the
    port's import equal to the JAX package's."""
    h = History(native_dbs[source], abc_id=1)
    ref_db = str(tmp_path / "ref.db")
    h.to_reference_db(ref_db)
    back = History.from_reference_db(ref_db, db=str(tmp_path / "back.db"))
    back_j = jpt.History.from_reference_db(ref_db,
                                           db=str(tmp_path / "back_j.db"))
    assert back.max_t == h.max_t == back_j.max_t
    native = h.get_all_populations()
    gens = native[native.t >= 0]
    got = back.get_all_populations()
    assert list(got.t) == list(gens.t)
    np.testing.assert_array_equal(got.epsilon, gens.epsilon)
    assert list(got.samples) == list(gens.samples)
    assert back.observed_sum_stat().keys() == h.observed_sum_stat().keys()
    for t in range(h.max_t + 1):
        np.testing.assert_array_equal(
            back.get_model_probabilities(t).to_numpy(),
            h.get_model_probabilities(t).to_numpy())
        for m in h.alive_models(t):
            df, w = h.get_distribution(m=m, t=t)
            df_b, w_b = back.get_distribution(m=m, t=t)
            df_j, w_j = back_j.get_distribution(m=m, t=t)
            np.testing.assert_array_equal(df_b.to_numpy(), df.to_numpy())
            np.testing.assert_array_equal(df_b.to_numpy(), df_j.to_numpy())
            if source == "port_run":
                np.testing.assert_array_equal(w_b, w)
            else:
                np.testing.assert_allclose(w_b, w, rtol=1e-6)
            np.testing.assert_array_equal(w_b, w_j)
        a, b = h.get_population(t), back.get_population(t)
        order_a, order_b = np.argsort(a.m, kind="stable"), \
            np.argsort(b.m, kind="stable")
        np.testing.assert_array_equal(a.distance[order_a],
                                      b.distance[order_b])


def test_export_cli_writes_the_jax_packages_csv(native_dbs, tmp_path):
    from pyabc_tpu.storage import export as jax_export
    from pyabc_tpu_torch.storage import export

    outs = {}
    for name, mod in (("port", export), ("jax", jax_export)):
        out = str(tmp_path / f"{name}.csv")
        mod.main.main(["--db", native_dbs["port_run"], "--out", out],
                      standalone_mode=False)
        with open(out) as f:
            outs[name] = f.read()
    assert outs["port"] == outs["jax"]
    assert outs["port"].splitlines()[0].split(",")[-3:] == ["w", "t", "m"]
    with pytest.raises(ValueError, match="extension"):
        export.df_to_file(export.history_to_df(
            History(native_dbs["port_run"], abc_id=1)), "x.unknown")
