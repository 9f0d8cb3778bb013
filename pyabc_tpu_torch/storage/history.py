"""History: durable generation-by-generation storage and resume.

Port of the eager path of ``pyabc_tpu/storage/history.py``: stdlib
sqlite3 with one row per (run, generation, model) holding that model's
particles as array blobs — one INSERT per model per generation at any
population size.  Blobs are plain ``.npy`` (``allow_pickle=False``);
reading a database written by ``pyabc_tpu`` (its PTW1 blob codec) comes
later.  ``db`` may be a path, ``"sqlite:///path"`` or ``"sqlite://"``
(in memory).
"""

from __future__ import annotations

import datetime
import io
import json
import sqlite3
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from ..population import Population
from .bytes_storage import from_bytes, to_bytes

PRE_TIME = -1  # calibration-sample time index

_SCHEMA = """
CREATE TABLE IF NOT EXISTS abc_smc (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    start_time TEXT,
    json_parameters TEXT,
    distance TEXT,
    epsilon TEXT,
    population_strategy TEXT
);
CREATE TABLE IF NOT EXISTS populations (
    abc_smc_id INTEGER,
    t INTEGER,
    epsilon REAL,
    nr_samples INTEGER,
    population_end_time TEXT,
    PRIMARY KEY (abc_smc_id, t)
);
CREATE TABLE IF NOT EXISTS model_populations (
    abc_smc_id INTEGER,
    t INTEGER,
    m INTEGER,
    name TEXT,
    p_model REAL,
    n_particles INTEGER,
    theta BLOB,
    weight BLOB,
    distance BLOB,
    stats BLOB,
    param_names TEXT,
    stat_spec TEXT,
    PRIMARY KEY (abc_smc_id, t, m)
);
CREATE TABLE IF NOT EXISTS observed_data (
    abc_smc_id INTEGER,
    key TEXT,
    value BLOB,
    tag TEXT DEFAULT 'npy',
    PRIMARY KEY (abc_smc_id, key)
);
"""


def _pack(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr), allow_pickle=False)
    return buf.getvalue()


def _unpack(blob: bytes) -> np.ndarray:
    return np.load(io.BytesIO(blob), allow_pickle=False)


class History:
    """SQLite-backed run history."""

    def __init__(self, db: str, abc_id: Optional[int] = None,
                 stores_sum_stats: bool = True):
        self.stores_sum_stats = bool(stores_sum_stats)
        if db.startswith("sqlite:///"):
            db = db[len("sqlite:///"):]
        self.in_memory = db in ("sqlite://", ":memory:", "")
        self.db_path = ":memory:" if self.in_memory else db
        self._conn = sqlite3.connect(self.db_path, timeout=30.0)
        self._conn.executescript(_SCHEMA)
        self._conn.commit()
        self.id = abc_id

    # ---- run registration ------------------------------------------------

    def store_initial_data(self, ground_truth_model: Optional[int],
                           options: dict, observed_sum_stat: Dict,
                           ground_truth_parameter: Optional[dict],
                           model_names: List[str],
                           distance_function_json: str = "{}",
                           eps_function_json: str = "{}",
                           population_strategy_json: str = "{}") -> int:
        """Register a new run; returns its id."""
        cur = self._conn.execute(
            "INSERT INTO abc_smc (start_time, json_parameters, distance,"
            " epsilon, population_strategy) VALUES (?,?,?,?,?)",
            (datetime.datetime.now().isoformat(),
             json.dumps({"ground_truth_model": ground_truth_model,
                         "ground_truth_parameter":
                             {k: float(v) for k, v
                              in dict(ground_truth_parameter).items()}
                             if ground_truth_parameter else None,
                         "model_names": model_names, **(options or {})}),
             distance_function_json, eps_function_json,
             population_strategy_json))
        self.id = cur.lastrowid
        for key, val in observed_sum_stat.items():
            tag, blob = to_bytes(val)
            self._conn.execute(
                "INSERT OR REPLACE INTO observed_data VALUES (?,?,?,?)",
                (self.id, key, blob, tag))
        self._conn.commit()
        return self.id

    def observed_sum_stat(self) -> Dict:
        rows = self._conn.execute(
            "SELECT key, value, tag FROM observed_data WHERE abc_smc_id=?",
            (self.id,)).fetchall()
        return {k: from_bytes(tag, v) for k, v, tag in rows}

    # ---- the per-generation durable write -------------------------------

    def append_population(self, t: int, current_epsilon: float,
                          population: Population, nr_simulations: int,
                          model_names: List[str],
                          param_names: Optional[List] = None,
                          stat_spec: Optional[dict] = None):
        """One INSERT per model; the commit is the durability point."""
        probs = population.get_model_probabilities(
            nr_models=len(model_names))
        self._conn.execute(
            "INSERT OR REPLACE INTO populations (abc_smc_id, t, epsilon,"
            " nr_samples, population_end_time) VALUES (?,?,?,?,?)",
            (self.id, t, float(current_epsilon), int(nr_simulations),
             datetime.datetime.now().isoformat()))
        m_arr = np.asarray(population.m)
        stats = (population.sum_stats.get("__flat__")
                 if self.stores_sum_stats else None)
        per_model = (param_names
                     and isinstance(param_names[0], (list, tuple)))
        for m in range(len(model_names)):
            idx = np.nonzero(m_arr == m)[0]
            if idx.size == 0:
                continue
            names_m = param_names[m] if per_model else param_names
            self._conn.execute(
                "INSERT OR REPLACE INTO model_populations (abc_smc_id, t,"
                " m, name, p_model, n_particles, theta, weight, distance,"
                " stats, param_names, stat_spec)"
                " VALUES (?,?,?,?,?,?,?,?,?,?,?,?)",
                (self.id, t, m, model_names[m], float(probs[m]),
                 int(idx.size), _pack(population.theta[idx]),
                 _pack(population.weight[idx]),
                 _pack(population.distance[idx]),
                 _pack(stats[idx]) if stats is not None else None,
                 json.dumps(list(names_m or [])),
                 json.dumps({k: list(v) for k, v in stat_spec.items()})
                 if stat_spec else None))
        self._conn.commit()

    # ---- queries ---------------------------------------------------------

    @property
    def max_t(self) -> int:
        row = self._conn.execute(
            "SELECT MAX(t) FROM populations WHERE abc_smc_id=? AND t>=0",
            (self.id,)).fetchone()
        return row[0] if row and row[0] is not None else -1

    def get_model_probabilities(self, t: Optional[int] = None):
        """All generations as a t x m DataFrame, or one generation's
        ``{m: p}`` Series."""
        if t is None:
            rows = self._conn.execute(
                "SELECT t, m, p_model FROM model_populations WHERE "
                "abc_smc_id=? AND t>=0 ORDER BY t, m", (self.id,)).fetchall()
            df = pd.DataFrame(rows, columns=["t", "m", "p"])
            return df.pivot(index="t", columns="m", values="p").fillna(0.0)
        rows = self._conn.execute(
            "SELECT m, p_model FROM model_populations WHERE abc_smc_id=? "
            "AND t=? ORDER BY m", (self.id, t)).fetchall()
        return pd.Series({m: p for m, p in rows}, dtype=float)

    def get_distribution(self, m: int = 0, t: Optional[int] = None
                         ) -> Tuple[pd.DataFrame, np.ndarray]:
        """(parameter DataFrame, normalized weights) of model ``m``."""
        t = self.max_t if t is None else t
        row = self._conn.execute(
            "SELECT theta, weight, param_names FROM model_populations "
            "WHERE abc_smc_id=? AND t=? AND m=?", (self.id, t, m)).fetchone()
        if row is None:
            return pd.DataFrame(), np.zeros(0)
        theta, w = _unpack(row[0]), _unpack(row[1])
        names = json.loads(row[2]) or [f"p{i}" for i in range(theta.shape[1])]
        return pd.DataFrame(theta[:, :len(names)], columns=names), w / w.sum()

    def get_all_populations(self) -> pd.DataFrame:
        rows = self._conn.execute(
            "SELECT t, epsilon, nr_samples, population_end_time FROM "
            "populations WHERE abc_smc_id=? ORDER BY t", (self.id,)).fetchall()
        return pd.DataFrame(
            rows, columns=["t", "epsilon", "samples", "population_end_time"])

    def get_population(self, t: Optional[int] = None) -> Population:
        """Reconstruct the dense population of generation ``t``."""
        t = self.max_t if t is None else t
        rows = self._conn.execute(
            "SELECT m, theta, weight, distance, stats FROM model_populations "
            "WHERE abc_smc_id=? AND t=? ORDER BY m", (self.id, t)).fetchall()
        if not rows:
            return Population(m=np.zeros(0, np.int32), theta=np.zeros((0, 0)),
                              weight=np.zeros(0), distance=np.zeros(0))
        thetas = [_unpack(r[1]) for r in rows]
        dim = max(th.shape[1] for th in thetas)
        thetas = [np.pad(th, ((0, 0), (0, dim - th.shape[1])))
                  for th in thetas]
        stats = [_unpack(r[4]) for r in rows if r[4] is not None]
        return Population(
            m=np.concatenate([np.full(th.shape[0], r[0], np.int32)
                              for r, th in zip(rows, thetas)]),
            theta=np.concatenate(thetas),
            weight=np.concatenate([_unpack(r[2]) for r in rows]),
            distance=np.concatenate([_unpack(r[3]) for r in rows]),
            sum_stats=({"__flat__": np.concatenate(stats)}
                       if len(stats) == len(rows) else {}))

    def done(self):
        self._conn.commit()

    def close(self):
        self._conn.close()
