"""Two-way interop with the reference pyABC ORM schema.

The port's copy of ``pyabc_tpu/storage/reference_export.py``, over the
port's own History (``_pack``, ``_unpack``, ``to_bytes``); stdlib sqlite3,
json and numpy only.  The native storage is array-blob sqlite (one row
per model per generation, :mod:`.history`); pyABC's own tooling reads the
row-per-particle ORM schema (abc_smc -> populations -> models ->
particles -> parameters / samples -> summary_statistics).
``to_reference_db`` writes a run into exactly that layout:

- table and column names and foreign keys as pyABC's DDL,
- per-particle ``w`` normalized WITHIN its model, the model row carrying
  ``p_model``, so ``weight = particle.w * model.p_model`` is the global
  weight,
- summary-statistic values as plain ``.npy`` bytes
  (``np.save(allow_pickle=False)``),
- the PRE_TIME population as pyABC's dummy holding the observed summary
  statistics on a single particle.

``from_reference_db`` goes the other way: it ingests a pyABC database
into the native layout.
"""

from __future__ import annotations

import datetime
import io
import json
import sqlite3
from typing import Optional

import numpy as np

_REFERENCE_DDL = """
CREATE TABLE IF NOT EXISTS abc_smc (
    id INTEGER NOT NULL PRIMARY KEY,
    start_time DATETIME,
    end_time DATETIME,
    json_parameters VARCHAR(5000),
    distance_function VARCHAR(5000),
    epsilon_function VARCHAR(5000),
    population_strategy VARCHAR(5000),
    git_hash VARCHAR(120)
);
CREATE TABLE IF NOT EXISTS populations (
    id INTEGER NOT NULL PRIMARY KEY,
    abc_smc_id INTEGER REFERENCES abc_smc (id),
    t INTEGER,
    population_end_time DATETIME,
    nr_samples INTEGER,
    epsilon FLOAT
);
CREATE TABLE IF NOT EXISTS models (
    id INTEGER NOT NULL PRIMARY KEY,
    population_id INTEGER REFERENCES populations (id),
    m INTEGER,
    name VARCHAR(200),
    p_model FLOAT
);
CREATE TABLE IF NOT EXISTS particles (
    id INTEGER NOT NULL PRIMARY KEY,
    model_id INTEGER REFERENCES models (id),
    w FLOAT
);
CREATE TABLE IF NOT EXISTS parameters (
    id INTEGER NOT NULL PRIMARY KEY,
    particle_id INTEGER REFERENCES particles (id),
    name VARCHAR(200),
    value FLOAT
);
CREATE TABLE IF NOT EXISTS samples (
    id INTEGER NOT NULL PRIMARY KEY,
    particle_id INTEGER REFERENCES particles (id),
    distance FLOAT
);
CREATE TABLE IF NOT EXISTS summary_statistics (
    id INTEGER NOT NULL PRIMARY KEY,
    sample_id INTEGER REFERENCES samples (id),
    name VARCHAR(200),
    value BLOB
);
"""


def _np_bytes(value) -> bytes:
    # plain .npy: reference-schema DBs must stay readable by pyABC's
    # numpy_bytes_storage.np_from_bytes
    buf = io.BytesIO()
    np.save(buf, np.asarray(value), allow_pickle=False)
    return buf.getvalue()


def _sql_datetime(stamp) -> Optional[str]:
    """SQLAlchemy's sqlite DATETIME result processor needs the
    space-separated '%Y-%m-%d %H:%M:%S.%f' form — the native history
    stores 'T'-separated isoformat, which pyABC's ORM cannot parse."""
    if stamp is None:
        return None
    return str(stamp).replace("T", " ")


def to_reference_db(history, path: str,
                    batch_stats: bool = True) -> int:
    """Write this run into a fresh reference-schema sqlite DB at ``path``.

    Returns the ``abc_smc.id`` of the exported run.  ``batch_stats=False``
    skips the per-particle summary-statistic rows (the by-far largest
    table) when only parameters/weights/distances are needed.
    """
    from .history import _unpack
    src = history
    dst = sqlite3.connect(path)
    try:
        dst.executescript(_REFERENCE_DDL)
        meta = src._conn.execute(
            "SELECT start_time, json_parameters, distance, epsilon, "
            "population_strategy FROM abc_smc WHERE id=?",
            (src.id,)).fetchone()
        if meta is None:
            raise ValueError(f"no run with id {src.id} in {src.db_file()}")
        start_time, json_parameters, distance, epsilon, pop_strategy = meta
        cur = dst.execute(
            "INSERT INTO abc_smc (start_time, end_time, json_parameters, "
            "distance_function, epsilon_function, population_strategy, "
            "git_hash) VALUES (?,?,?,?,?,?,?)",
            (_sql_datetime(start_time),
             datetime.datetime.now().isoformat(sep=" "),
             json_parameters, distance, epsilon, pop_strategy, None))
        abc_id = cur.lastrowid

        pops = src._conn.execute(
            "SELECT t, epsilon, nr_samples, population_end_time FROM "
            "populations WHERE abc_smc_id=? ORDER BY t",
            (src.id,)).fetchall()
        for t, eps, nr_samples, end_time in pops:
            if t == -1:
                # the reference's PRE_TIME is a dummy population whose one
                # particle carries the OBSERVED summary statistics
                # (history.py:437-470) — not the calibration sample the
                # native schema stores there
                _write_pre_population(src, dst, abc_id)
                continue
            cur = dst.execute(
                "INSERT INTO populations (abc_smc_id, t, "
                "population_end_time, nr_samples, epsilon) "
                "VALUES (?,?,?,?,?)",
                (abc_id, t, _sql_datetime(end_time), nr_samples, eps))
            population_id = cur.lastrowid
            rows = src._conn.execute(
                "SELECT m, name, p_model, theta, weight, distance, "
                "param_names FROM model_populations WHERE abc_smc_id=? "
                "AND t=? ORDER BY m", (src.id, t)).fetchall()
            for m, name, p_model, theta_b, w_b, d_b, names_json in rows:
                cur = dst.execute(
                    "INSERT INTO models (population_id, m, name, p_model) "
                    "VALUES (?,?,?,?)",
                    (population_id, int(m), name, float(p_model)))
                model_id = cur.lastrowid
                # native blobs are .npy or the JAX package's PTW1 codec:
                # the codec-sniffing _unpack reads both
                theta = _unpack(theta_b)
                w = np.asarray(_unpack(w_b), dtype=np.float64)
                d = _unpack(d_b)
                names = json.loads(names_json) if names_json else []
                # within-model normalization (reference convention:
                # global weight = particle.w * model.p_model)
                w_within = w / w.sum() if w.sum() > 0 else w
                keyed = src.get_sum_stats(t, m) if batch_stats else {}
                n = theta.shape[0]
                # bulk-insert with explicit ids: per-row lastrowid
                # round-trips are the reference schema's known cost
                base_pid = _next_id(dst, "particles")
                dst.executemany(
                    "INSERT INTO particles (id, model_id, w) "
                    "VALUES (?,?,?)",
                    ((base_pid + i, model_id, float(w_within[i]))
                     for i in range(n)))
                if names:
                    base_par = _next_id(dst, "parameters")
                    dst.executemany(
                        "INSERT INTO parameters (id, particle_id, name, "
                        "value) VALUES (?,?,?,?)",
                        ((base_par + i * len(names) + j, base_pid + i,
                          names[j], float(theta[i, j]))
                         for i in range(n) for j in range(len(names))))
                base_sid = _next_id(dst, "samples")
                dst.executemany(
                    "INSERT INTO samples (id, particle_id, distance) "
                    "VALUES (?,?,?)",
                    ((base_sid + i, base_pid + i, float(d[i]))
                     for i in range(n)))
                if keyed:
                    keys = [k for k in keyed if k != "__flat__"] \
                        or list(keyed)
                    base_ss = _next_id(dst, "summary_statistics")
                    dst.executemany(
                        "INSERT INTO summary_statistics (id, sample_id, "
                        "name, value) VALUES (?,?,?,?)",
                        ((base_ss + i * len(keys) + j, base_sid + i,
                          keys[j], _np_bytes(keyed[keys[j]][i]))
                         for i in range(n) for j in range(len(keys))))
        dst.commit()
        return abc_id
    finally:
        dst.close()


def _next_id(conn, table: str) -> int:
    row = conn.execute(f"SELECT MAX(id) FROM {table}").fetchone()
    return (row[0] or 0) + 1


def _write_pre_population(src, dst, abc_id: int):
    """Reference-style PRE_TIME dummy: observed sum stats on one particle
    (w=0, distance 0) of a p_model=1 model (reference history.py:437-470;
    the gt-model variant is not reconstructed — the native schema stores
    gt info in json_parameters, which the export copies verbatim)."""
    cur = dst.execute(
        "INSERT INTO populations (abc_smc_id, t, population_end_time, "
        "nr_samples, epsilon) VALUES (?,?,?,?,?)",
        (abc_id, -1, None, 0, float("inf")))
    population_id = cur.lastrowid
    cur = dst.execute(
        "INSERT INTO models (population_id, m, name, p_model) "
        "VALUES (?,?,?,?)", (population_id, 0, None, 1.0))
    model_id = cur.lastrowid
    cur = dst.execute(
        "INSERT INTO particles (model_id, w) VALUES (?,?)", (model_id, 0.0))
    particle_id = cur.lastrowid
    cur = dst.execute(
        "INSERT INTO samples (particle_id, distance) VALUES (?,?)",
        (particle_id, 0.0))
    sample_id = cur.lastrowid
    for key, val in src.observed_sum_stat().items():
        # the native store accepts arbitrary observed types (tagged
        # bytes); the reference schema's .npy blobs only carry numeric
        # arrays — coerce what coerces (DataFrames/Series via to_numpy),
        # skip the rest rather than aborting the whole export
        try:
            import pandas as pd
            if isinstance(val, (pd.DataFrame, pd.Series)):
                val = val.to_numpy()
            arr = np.asarray(val)
            if arr.dtype == object:
                raise ValueError("non-numeric observed value")
            blob = _np_bytes(arr)
        except (ValueError, TypeError):
            continue
        dst.execute(
            "INSERT INTO summary_statistics (sample_id, name, value) "
            "VALUES (?,?,?)", (sample_id, key, blob))


def from_reference_db(path: str, db: str = "sqlite://",
                      abc_id: int = 1):
    """Ingest a reference-pyABC ORM database into a native History.

    Returns a :class:`History` (backed by ``db``) holding the run:
    per-generation populations with global weights (``w * p_model``),
    parameters pivoted into dense theta columns (sorted parameter-name
    order per model), per-particle distances, and keyed summary
    statistics — so existing pyABC runs load, resume, plot, and export
    with this framework.
    """
    from .history import History

    src = sqlite3.connect(path)
    try:
        meta = src.execute(
            "SELECT start_time, json_parameters, distance_function, "
            "epsilon_function, population_strategy FROM abc_smc "
            "WHERE id=?", (abc_id,)).fetchone()
        if meta is None:
            raise ValueError(f"no abc_smc run with id {abc_id} in {path}")
        start_time, json_params, dist_json, eps_json, popstrat_json = meta

        hist = History(db)
        # model names from the generation-0 model rows (the reference
        # stores them per model row, not centrally)
        name_rows = src.execute(
            "SELECT DISTINCT models.m, models.name FROM models "
            "JOIN populations ON models.population_id = populations.id "
            "WHERE populations.abc_smc_id=? AND populations.t >= 0 "
            "AND models.m IS NOT NULL ORDER BY models.m",
            (abc_id,)).fetchall()
        names_by_m = {}
        for m, name in name_rows:
            names_by_m.setdefault(int(m), name)
        model_names = [names_by_m.get(m) or f"model_{m}"
                       for m in range(max(names_by_m, default=-1) + 1)]
        try:
            params_dict = json.loads(json_params) if json_params else {}
            if not isinstance(params_dict, dict):
                raise ValueError
        except ValueError:
            # the reference writes str(options) (python repr, not json)
            params_dict = {"raw_json_parameters": json_params}
        params_dict.setdefault("model_names", model_names)
        params_dict["imported_from"] = path
        cur = hist._conn.execute(
            "INSERT INTO abc_smc (start_time, json_parameters, distance, "
            "epsilon, population_strategy) VALUES (?,?,?,?,?)",
            (start_time, json.dumps(params_dict), dist_json, eps_json,
             popstrat_json))
        hist.id = cur.lastrowid

        # observed data from the PRE_TIME dummy particle
        obs_rows = src.execute(
            "SELECT summary_statistics.name, summary_statistics.value "
            "FROM populations "
            "JOIN models ON models.population_id = populations.id "
            "JOIN particles ON particles.model_id = models.id "
            "JOIN samples ON samples.particle_id = particles.id "
            "JOIN summary_statistics "
            "ON summary_statistics.sample_id = samples.id "
            "WHERE populations.abc_smc_id=? AND populations.t=-1",
            (abc_id,)).fetchall()
        from .bytes_storage import to_bytes
        from .history import _unpack
        for key, blob in obs_rows:
            val = _unpack(blob)
            tag, b = to_bytes(val)
            hist._conn.execute(
                "INSERT OR REPLACE INTO observed_data VALUES (?,?,?,?)",
                (hist.id, key, b, tag))

        pops = src.execute(
            "SELECT id, t, epsilon, nr_samples, population_end_time "
            "FROM populations WHERE abc_smc_id=? AND t>=0 ORDER BY t",
            (abc_id,)).fetchall()
        for pop_id, t, eps, nr_samples, end_time in pops:
            hist._conn.execute(
                "INSERT OR REPLACE INTO populations (abc_smc_id, t, "
                "epsilon, nr_samples, population_end_time) "
                "VALUES (?,?,?,?,?)",
                (hist.id, t, eps, nr_samples,
                 str(end_time) if end_time else None))
            model_rows = src.execute(
                "SELECT id, m, name, p_model FROM models "
                "WHERE population_id=? AND m IS NOT NULL ORDER BY m",
                (pop_id,)).fetchall()
            for model_id, m, name, p_model in model_rows:
                _import_model(src, hist, t, int(m), name, float(p_model),
                              model_id)
        hist._conn.commit()
        return hist
    finally:
        src.close()


def _import_model(src, hist, t: int, m: int, name, p_model: float,
                  model_id: int):
    from .history import _pack, _unpack

    particles = src.execute(
        "SELECT id, w FROM particles WHERE model_id=? ORDER BY id",
        (model_id,)).fetchall()
    if not particles:
        return
    pids = [p[0] for p in particles]
    w_within = np.asarray([p[1] for p in particles], dtype=np.float64)
    # subqueries on model_id, not per-particle IN lists: an explicit
    # placeholder per particle hits sqlite's variable limit (~32k default)
    # far below the 1e6-particle populations this targets
    par_rows = src.execute(
        "SELECT particle_id, name, value FROM parameters WHERE "
        "particle_id IN (SELECT id FROM particles WHERE model_id=?)",
        (model_id,)).fetchall()
    names = sorted({r[1] for r in par_rows})
    col = {nm: j for j, nm in enumerate(names)}
    theta = np.zeros((len(pids), len(names)), dtype=np.float32)
    pid_index = {pid: i for i, pid in enumerate(pids)}
    for pid, nm, val in par_rows:
        theta[pid_index[pid], col[nm]] = val
    samp_rows = src.execute(
        "SELECT id, particle_id, distance FROM samples WHERE "
        "particle_id IN (SELECT id FROM particles WHERE model_id=?) "
        "ORDER BY id", (model_id,)).fetchall()
    # one distance per particle (multi-sample particles: mean, matching
    # the fixed-shape multi-replicate semantics in sampler/rounds.py)
    d_lists: dict = {}
    first_sample: dict = {}
    for sid, pid, dist in samp_rows:
        d_lists.setdefault(pid, []).append(dist)
        first_sample.setdefault(pid, sid)
    d = np.asarray(
        [float(np.mean(d_lists.get(pid, [np.nan]))) for pid in pids],
        dtype=np.float32)
    # summary statistics of each particle's first sample
    first_sids = {first_sample[pid] for pid in pids if pid in first_sample}
    stats_flat = None
    spec = None
    if first_sids:
        ss_rows = src.execute(
            "SELECT sample_id, name, value FROM summary_statistics "
            "WHERE sample_id IN (SELECT s.id FROM samples s JOIN "
            "particles p ON s.particle_id = p.id WHERE p.model_id=?)",
            (model_id,)).fetchall()
        ss_rows = [r for r in ss_rows if r[0] in first_sids]
        if ss_rows:
            by_sid: dict = {}
            for sid, nm, blob in ss_rows:
                arr = np.asarray(_unpack(blob), dtype=np.float32)
                by_sid.setdefault(sid, {})[nm] = np.atleast_1d(arr)
            # column layout from the UNION of keys (shape from each
            # key's first occurrence); a key missing on some particle
            # leaves NaN in its columns rather than shifting later keys
            keys = sorted({nm for v in by_sid.values() for nm in v})
            shapes = {}
            for v in by_sid.values():
                for k, arr in v.items():
                    shapes.setdefault(k, arr.shape)
            spec = {k: list(shapes[k]) for k in keys}
            offsets = {}
            off = 0
            for k in keys:
                offsets[k] = off
                off += int(np.prod(shapes[k]))
            stats_flat = np.full((len(pids), off), np.nan,
                                 dtype=np.float32)
            sid_index = {first_sample[pid]: pid_index[pid]
                         for pid in pids if pid in first_sample}
            for sid, stats in by_sid.items():
                for k, arr in stats.items():
                    size = int(np.prod(shapes[k]))
                    if arr.size != size:
                        raise ValueError(
                            f"inconsistent shape for summary statistic "
                            f"{k!r} across particles (model m={m}, t={t})")
                    stats_flat[sid_index[sid],
                               offsets[k]:offsets[k] + size] = arr.ravel()
    w_global = (w_within * p_model).astype(np.float32)
    hist._conn.execute(
        "INSERT OR REPLACE INTO model_populations (abc_smc_id, t, m, "
        "name, p_model, n_particles, theta, weight, distance, stats, "
        "param_names, stat_spec) VALUES (?,?,?,?,?,?,?,?,?,?,?,?)",
        (hist.id, t, m, name, p_model, len(pids),
         _pack(theta), _pack(w_global), _pack(d),
         _pack(stats_flat) if stats_flat is not None else None,
         json.dumps(names),
         json.dumps(spec) if spec else None))
