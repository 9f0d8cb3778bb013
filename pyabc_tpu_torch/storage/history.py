"""History: durable generation-by-generation storage and resume.

Port of ``pyabc_tpu/storage/history.py``: stdlib sqlite3 with one row
per (run, generation, model) holding that model's particles as array
blobs — one INSERT per model per generation at any population size.
Blobs are plain ``.npy`` (``allow_pickle=False``); reading a database
written by ``pyabc_tpu`` (its PTW1 blob codec) comes later.  ``db`` may
be a path, ``"sqlite:///path"`` or ``"sqlite://"`` (in memory).

Lazy rows (``ABCSMC(history_mode="lazy")``): the orchestrator attaches a
:class:`~pyabc_tpu_torch.wire.store.DeviceRunStore` and appends each
device-resident generation as a summary row (``lazy = 1``, the posterior
summary packet as JSON, model rows with counts and masses and no blobs).
Every reader of blobs materializes the generation first — fetch,
the eager decode, the eager write, drop from the store — so a read sees
the eager bits.  Generations the store's ring evicted are drained here,
on this object's thread (sqlite connections are thread-affine; deposits
come from ingest workers).  :meth:`done` materializes every resident
generation, so a fresh ``History`` on the same file reads the same bits.
"""

from __future__ import annotations

import datetime
import io
import json
import logging
import sqlite3
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from ..population import Population
from .bytes_storage import from_bytes, to_bytes

PRE_TIME = -1  # calibration-sample time index

logger = logging.getLogger("ABC.History")

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
    lazy INTEGER DEFAULT 0,
    summary TEXT,
    summary_grid BLOB,
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
        self._migrate()
        self._conn.commit()
        self.id = abc_id
        #: the device store lazy generations live in (attach_store)
        self._store = None

    def _migrate(self):
        """Add the lazy-row columns to a database written without them."""
        cols = {r[1] for r in self._conn.execute(
            "PRAGMA table_info(populations)").fetchall()}
        for col, kind in (("lazy", "INTEGER DEFAULT 0"), ("summary", "TEXT"),
                          ("summary_grid", "BLOB")):
            if col not in cols:
                self._conn.execute(
                    f"ALTER TABLE populations ADD COLUMN {col} {kind}")

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
                          stat_spec: Optional[dict] = None,
                          summary_json: Optional[str] = None):
        """One INSERT per model; the commit is the durability point.
        ``summary_json`` keeps a materialized lazy row's packet."""
        probs = population.get_model_probabilities(
            nr_models=len(model_names))
        self._conn.execute(
            "INSERT OR REPLACE INTO populations (abc_smc_id, t, epsilon,"
            " nr_samples, population_end_time, lazy, summary) VALUES"
            " (?,?,?,?,?,0,?)",
            (self.id, t, float(current_epsilon), int(nr_simulations),
             datetime.datetime.now().isoformat(), summary_json))
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

    # ---- lazy rows: device-resident generations ---------------------------

    def attach_store(self, store):
        self._store = store

    def detach_store(self):
        """Later appends take the eager path; the store is no longer
        read."""
        self._store = None

    def append_population_lazy(self, t: int, current_epsilon: float,
                               nr_simulations: int, *, summary: dict,
                               model_names: List[str],
                               param_names: Optional[List] = None,
                               stat_spec: Optional[dict] = None):
        """The summary row of a device-resident generation: the packet
        (``wire.store.summary_from_lanes``) and one blob-less row per
        model with its count and mass."""
        self._drain_spills()
        self._conn.execute(
            "INSERT OR REPLACE INTO populations (abc_smc_id, t, epsilon,"
            " nr_samples, population_end_time, lazy, summary) VALUES"
            " (?,?,?,?,?,1,?)",
            (self.id, int(t), float(current_epsilon), int(nr_simulations),
             datetime.datetime.now().isoformat(), json.dumps(summary)))
        model_w = list(summary.get("model_w", []))
        model_n = list(summary.get("model_n", []))
        per_model = (param_names
                     and isinstance(param_names[0], (list, tuple)))
        for m in range(len(model_names)):
            n_m = int(model_n[m]) if m < len(model_n) else 0
            if n_m <= 0:
                continue
            names_m = param_names[m] if per_model else param_names
            self._conn.execute(
                "INSERT OR REPLACE INTO model_populations (abc_smc_id, t,"
                " m, name, p_model, n_particles, theta, weight, distance,"
                " stats, param_names, stat_spec)"
                " VALUES (?,?,?,?,?,?,NULL,NULL,NULL,NULL,?,?)",
                (self.id, int(t), m, model_names[m],
                 float(model_w[m]) if m < len(model_w) else 0.0, n_m,
                 json.dumps(list(names_m or [])),
                 json.dumps({k: list(v) for k, v in stat_spec.items()})
                 if stat_spec else None))
        self._conn.commit()

    def _lazy_flag(self, t: int) -> Optional[tuple]:
        """``(lazy, epsilon, nr_samples, summary)`` of generation ``t``,
        or None without a row."""
        return self._conn.execute(
            "SELECT lazy, epsilon, nr_samples, summary FROM populations"
            " WHERE abc_smc_id=? AND t=?", (self.id, int(t))).fetchone()

    def model_names(self) -> List[str]:
        row = self._conn.execute(
            "SELECT json_parameters FROM abc_smc WHERE id=?",
            (self.id,)).fetchone()
        return list(json.loads(row[0]).get("model_names") or []) \
            if row and row[0] else []

    def _materialize_pop(self, t: int, pop: Population, row: tuple):
        """Replace generation ``t``'s summary row with the eager write of
        ``pop``; names and spec come from the lazy model rows, the
        packet stays."""
        names = self.model_names()
        rows = self._conn.execute(
            "SELECT m, param_names, stat_spec FROM model_populations"
            " WHERE abc_smc_id=? AND t=? ORDER BY m",
            (self.id, int(t))).fetchall()
        pn = {m: (json.loads(p) if p else []) for m, p, _ in rows}
        spec = next(({k: tuple(v) for k, v in json.loads(sp).items()}
                     for _, _, sp in rows if sp), None)
        self.append_population(
            int(t), row[1], pop, row[2], names,
            [pn.get(m, []) for m in range(len(names))], spec,
            summary_json=row[3])

    def _drain_spills(self):
        """Materialize the entries the store's ring evicted.  An entry
        whose summary row is not appended yet (a worker deposited ahead of
        the harvest) is requeued."""
        from ..wire.store import hydrate_entry
        store = self._store
        if store is None:
            return
        requeue = []
        for entry in store.take_spills():
            row = self._lazy_flag(entry["t"])
            if row is None:
                requeue.append(entry)
            elif row[0]:
                pop = hydrate_entry(entry)
                if pop is not None:
                    self._materialize_pop(entry["t"], pop, row)
        store.requeue_spills(requeue)

    def _materialize(self, t: int) -> bool:
        """Give generation ``t``'s row its blobs.  True when the row
        exists and is durable afterwards; False when it stayed a summary
        (no store, or the generation is not in it)."""
        self._drain_spills()
        row = self._lazy_flag(t)
        if row is None or not row[0]:
            return row is not None
        store = self._store
        if store is None or not store.has(t):
            return False
        pop = store.hydrate(t)
        if pop is None:
            return False
        self._materialize_pop(t, pop, row)
        store.drop(t)
        return True

    def hydrate_population(self, t: int) -> Population:
        """Generation ``t`` in round order, decoded from the store as the
        eager path decoded it (the durable write is done on the way);
        from the blobs, grouped by model, when it is no longer
        resident."""
        self._drain_spills()
        store = self._store
        row = self._lazy_flag(t)
        if store is not None and store.has(t) and row is not None \
                and row[0]:
            pop = store.hydrate(t)
            if pop is not None:
                self._materialize_pop(t, pop, row)
                store.drop(t)
                return pop
        self._materialize(t)
        return self.get_population(t)

    def flush_lazy(self):
        """Materialize every resident generation and empty the store."""
        self._drain_spills()
        store = self._store
        if store is None:
            return
        for t in store.resident_ts():
            self._materialize(t)
        store.clear()

    def purge_stale_lazy(self) -> int:
        """Delete summary rows no store can hydrate any more (a lazy run
        that died before ``done``): ``max_t`` then anchors on the last
        durable generation.  Returns how many generations went."""
        live = set(self._store.resident_ts()) if self._store else set()
        stale = [t for (t,) in self._conn.execute(
            "SELECT t FROM populations WHERE abc_smc_id=? AND lazy=1",
            (self.id,)).fetchall() if t not in live]
        for t in stale:
            for table in ("populations", "model_populations"):
                self._conn.execute(
                    f"DELETE FROM {table} WHERE abc_smc_id=? AND t=?",
                    (self.id, t))
        if stale:
            self._conn.commit()
            logger.warning("purged %d summary-only generation(s) %s of an "
                           "interrupted lazy run", len(stale), stale)
        return len(stale)

    def get_population_summary(self, t: Optional[int] = None
                               ) -> Optional[dict]:
        """Generation ``t``'s summary packet (lazy rows keep it after
        materializing), or None for an eager row."""
        t = self.max_t if t is None else t
        row = self._conn.execute(
            "SELECT summary FROM populations WHERE abc_smc_id=? AND t=?",
            (self.id, int(t))).fetchone()
        return None if row is None or row[0] is None else json.loads(row[0])

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
        self._materialize(t)
        row = self._conn.execute(
            "SELECT theta, weight, param_names FROM model_populations "
            "WHERE abc_smc_id=? AND t=? AND m=?", (self.id, t, m)).fetchone()
        if row is None or row[0] is None:
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
        self._materialize(t)
        rows = self._conn.execute(
            "SELECT m, theta, weight, distance, stats FROM model_populations "
            "WHERE abc_smc_id=? AND t=? ORDER BY m", (self.id, t)).fetchall()
        rows = [r for r in rows if r[1] is not None]
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
        """End of a run: every resident generation gets its blobs."""
        self.flush_lazy()
        self._conn.commit()

    def close(self):
        self._conn.close()
