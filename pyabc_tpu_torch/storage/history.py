"""History: durable generation-by-generation storage and resume.

Port of ``pyabc_tpu/storage/history.py``: stdlib sqlite3 with one row
per (run, generation, model) holding that model's particles as array
blobs — one INSERT per model per generation at any population size.
Blobs are written as plain ``.npy`` (``allow_pickle=False``) and read
as either that or the JAX package's PTW1 codec (``wire.transfer.
decode_array``), so a database that ``pyabc_tpu`` wrote loads here.
``db`` may be a path, ``"sqlite:///path"`` or ``"sqlite://"`` (in
memory).

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

Resilience (``pyabc_tpu/storage/history.py:131-256``, ``:419-520``,
``:726-800``, ``:874-...``): every model row carries a ``digest`` column
(the CRC32 of each blob; ``_unpack_checked`` raises ``IntegrityError``
on a mismatch), and so does the ``sub_checkpoints`` table, the
round-granular ledger a preempted generation resumes from
(:meth:`save_sub_checkpoint`).  The durable writes run under the shared
retry policy (``history.append`` site).  A lazy History arms a
:class:`~pyabc_tpu_torch.resilience.journal.SpillJournal` under
``<db>.journal``; a generation materializes down a ladder (the device
copy, then the journal's copy) and is tombstoned in the journal after the
commit; :meth:`persist_lazy_tail` anchors resident generations on a
crash or a preemption (journal first, then materialize), and
:meth:`recover_lazy` replays what a killed process left in the journal.
"""

from __future__ import annotations

import datetime
import io
import json
import logging
import os
import sqlite3
import time
import zlib
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import pandas as pd

from ..population import Population
from ..wire import transfer
from .bytes_storage import from_bytes, to_bytes

PRE_TIME = -1  # calibration-sample time index

logger = logging.getLogger("ABC.History")

#: preemption-barrier budget: persist_lazy_tail stops materializing after
#: this many seconds (journal-first ordering means whatever was not
#: materialized is still replayable)
PREEMPT_DEADLINE_ENV = "PYABC_TPU_PREEMPT_DEADLINE_S"


def _preempt_deadline_s() -> float:
    try:
        return float(os.environ.get(PREEMPT_DEADLINE_ENV, "30"))
    except ValueError:
        return 30.0

#: keep only the last resident generation's blobs at ``flush_lazy``
LAZY_FINAL_ONLY_ENV = "PYABC_TPU_LAZY_FINAL_ONLY"


def create_sqlite_db_id(dir_: Optional[str] = None,
                        file_: str = "pyabc_test.db") -> str:
    """``sqlite:///<dir>/<file>``, in the system temp directory by
    default (``pyabc_tpu/storage/history.py:59``)."""
    import tempfile
    base = dir_ if dir_ is not None else tempfile.gettempdir()
    return "sqlite:///" + os.path.join(base, file_)


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
    digest TEXT,
    PRIMARY KEY (abc_smc_id, t, m)
);
CREATE TABLE IF NOT EXISTS observed_data (
    abc_smc_id INTEGER,
    key TEXT,
    value BLOB,
    tag TEXT DEFAULT 'npy',
    PRIMARY KEY (abc_smc_id, key)
);
CREATE TABLE IF NOT EXISTS sub_checkpoints (
    abc_smc_id INTEGER,
    t INTEGER,
    rounds INTEGER,
    n_accepted INTEGER,
    nr_evaluations INTEGER,
    eps REAL,
    m BLOB,
    theta BLOB,
    distance BLOB,
    log_weight BLOB,
    stats BLOB,
    created TEXT,
    manifest TEXT,
    digest TEXT,
    PRIMARY KEY (abc_smc_id, t)
);
"""


def _blob_crc(blob: Optional[bytes]) -> Optional[int]:
    if blob is None:
        return None
    return zlib.crc32(blob) & 0xFFFFFFFF


def _pack(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr), allow_pickle=False)
    return buf.getvalue()


def _unpack(blob: bytes) -> np.ndarray:
    """Blob -> array: a PTW1 blob (the JAX package's default) or ``.npy``."""
    if transfer.is_ptw1(blob):
        return transfer.decode_array(blob)
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
        if not self.in_memory:
            # readers proceed while a generation's write is in flight,
            # and the commit is one durable point
            try:
                self._conn.execute("PRAGMA journal_mode=WAL")
            except sqlite3.OperationalError:
                pass
        self._conn.executescript(_SCHEMA)
        self._migrate()
        self._conn.commit()
        self.id = abc_id
        #: the device store lazy generations live in (attach_store)
        self._store = None
        #: the write-ahead SpillJournal, created on first use (lazy runs,
        #: resume recovery), never for plain eager runs
        self._journal = None
        self._journal_armed = False

    def _migrate(self):
        """Add the newer columns to a database written without them."""
        for table, adds in (
                ("populations", (("lazy", "INTEGER DEFAULT 0"),
                                 ("summary", "TEXT"),
                                 ("summary_grid", "BLOB"))),
                ("model_populations", (("digest", "TEXT"),)),
                ("sub_checkpoints", (("manifest", "TEXT"),
                                     ("digest", "TEXT")))):
            cols = {r[1] for r in self._conn.execute(
                f"PRAGMA table_info({table})").fetchall()}
            for col, kind in adds:
                if col not in cols:
                    self._conn.execute(
                        f"ALTER TABLE {table} ADD COLUMN {col} {kind}")

    @property
    def journal(self):
        """The run's spill journal, created on first use (file-backed
        DBs at ``<db>.journal``; in-memory DBs only under an explicit
        ``$PYABC_TPU_JOURNAL_DIR``); None when journaling is off."""
        if not self._journal_armed:
            self._journal_armed = True
            from ..resilience.journal import journal_for_history
            self._journal = journal_for_history(self)
        return self._journal

    def _existing_journal(self):
        """The journal only if it is armed already or its directory
        exists on disk: resume recovery finds a previous process's
        journal without creating directories for runs that never
        journaled."""
        if self._journal_armed:
            return self._journal
        from ..resilience.journal import journal_dir_for
        d = journal_dir_for(self.db_path, self.in_memory)
        if d and os.path.isdir(d):
            return self.journal
        return None

    def _unpack_checked(self, blob, crc, *, t=-2, where="db.read"):
        """``_unpack`` behind the stored-blob CRC: a flipped bit in the
        database raises ``IntegrityError`` instead of decoding into a
        silently wrong posterior."""
        if blob is None:
            return None
        if crc is not None:
            from ..resilience.journal import IntegrityError
            from ..telemetry.metrics import REGISTRY
            _help = "checksummed hydration; see resilience/journal.py"
            REGISTRY.counter("store_integrity_checks_total", _help).inc()
            if _blob_crc(blob) != int(crc):
                REGISTRY.counter("store_integrity_failures_total",
                                 _help).inc()
                from ..telemetry.flight import RECORDER
                RECORDER.note("integrity", t=int(t), where=where,
                              detail="stored blob CRC mismatch")
                raise IntegrityError(
                    f"generation {t}: stored blob failed its CRC "
                    f"({where}) — database bytes are corrupt",
                    t=t, where=where)
        return _unpack(blob)

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
        """One INSERT OR REPLACE per model; the commit is the durability
        point, so the write is idempotent and a transient sqlite failure
        retries through the shared policy (``history.append`` site)."""
        from ..resilience import faults as _faults
        from ..resilience import retry as _retry
        _retry.shared_policy().call(
            self._append_population_once, _faults.SITE_APPEND,
            t, current_epsilon, population, nr_simulations, model_names,
            param_names, stat_spec)

    def _append_population_once(self, t, current_epsilon, population,
                                nr_simulations, model_names,
                                param_names=None, stat_spec=None,
                                summary_json=None, summary_grid=None):
        probs = population.get_model_probabilities(
            nr_models=len(model_names))
        self._conn.execute(
            "INSERT OR REPLACE INTO populations (abc_smc_id, t, epsilon,"
            " nr_samples, population_end_time, lazy, summary, summary_grid)"
            " VALUES (?,?,?,?,?,0,?,?)",
            (self.id, t, float(current_epsilon), int(nr_simulations),
             datetime.datetime.now().isoformat(), summary_json,
             summary_grid))
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
            blobs = {"theta": _pack(population.theta[idx]),
                     "weight": _pack(population.weight[idx]),
                     "distance": _pack(population.distance[idx]),
                     "stats": (_pack(stats[idx]) if stats is not None
                               else None)}
            digest = json.dumps({k: _blob_crc(v) for k, v in blobs.items()
                                 if v is not None})
            self._conn.execute(
                "INSERT OR REPLACE INTO model_populations (abc_smc_id, t,"
                " m, name, p_model, n_particles, theta, weight, distance,"
                " stats, param_names, stat_spec, digest)"
                " VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)",
                (self.id, t, m, model_names[m], float(probs[m]),
                 int(idx.size), blobs["theta"], blobs["weight"],
                 blobs["distance"], blobs["stats"],
                 json.dumps(list(names_m or [])),
                 json.dumps({k: list(v) for k, v in stat_spec.items()})
                 if stat_spec else None, digest))
        # the generation is durable in the same transaction: its
        # mid-generation ledger row is obsolete
        self._conn.execute(
            "DELETE FROM sub_checkpoints WHERE abc_smc_id=? AND t=?",
            (self.id, t))
        self._conn.commit()

    # ---- mid-generation sub-checkpoints (resilience/checkpoint.py) -----

    def save_sub_checkpoint(self, t: int, batch: Optional[Dict],
                            rounds: int, nr_evaluations: int,
                            eps: Optional[float] = None,
                            manifest: Optional[dict] = None):
        """REPLACE the round-granular accepted-particle ledger of
        generation ``t``: the cumulative accepted rows through round
        ``rounds`` (``batch``: host ``m``, ``theta``, ``distance``,
        ``log_weight`` and optionally ``stats``).  One row per
        generation; :meth:`append_population` deletes it once the whole
        generation is durable.  In lazy mode steady-state flushes pass
        ``batch=None`` and the device store's ``manifest``."""
        from ..resilience import faults as _faults
        from ..resilience import retry as _retry

        def _write():
            blobs = {k: (_pack(batch[k]) if batch is not None
                         and batch.get(k) is not None else None)
                     for k in ("m", "theta", "distance", "log_weight",
                               "stats")}
            digest = json.dumps({k: _blob_crc(v) for k, v in blobs.items()
                                 if v is not None})
            self._conn.execute(
                "INSERT OR REPLACE INTO sub_checkpoints (abc_smc_id, t,"
                " rounds, n_accepted, nr_evaluations, eps, m, theta,"
                " distance, log_weight, stats, created, manifest,"
                " digest) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                (self.id, int(t), int(rounds),
                 int(batch["m"].shape[0]) if batch is not None else 0,
                 int(nr_evaluations),
                 float(eps) if eps is not None else None,
                 blobs["m"], blobs["theta"], blobs["distance"],
                 blobs["log_weight"], blobs["stats"],
                 datetime.datetime.now().isoformat(),
                 json.dumps(manifest) if manifest is not None else None,
                 digest))
            self._conn.commit()

        _retry.shared_policy().call(_write, _faults.SITE_APPEND)

    def load_sub_checkpoint(self, t: int) -> Optional[Dict]:
        """The flushed ledger of generation ``t``, or None (also for a
        manifest-only row: nothing to splice).  Returns ``{rounds,
        nr_evaluations, eps, n_accepted, batch}``, the batch ready for
        ``Sample.splice_front``; every blob is CRC-checked."""
        row = self._conn.execute(
            "SELECT rounds, n_accepted, nr_evaluations, eps, m, theta,"
            " distance, log_weight, stats, digest FROM sub_checkpoints"
            " WHERE abc_smc_id=? AND t=?", (self.id, int(t))).fetchone()
        if row is None or row[4] is None:
            return None
        crcs = json.loads(row[9]) if row[9] else {}
        batch = {}
        for i, k in enumerate(("m", "theta", "distance", "log_weight",
                               "stats")):
            if row[4 + i] is not None:
                batch[k] = self._unpack_checked(
                    row[4 + i], crcs.get(k), t=t, where="checkpoint.splice")
        return {"rounds": int(row[0]), "n_accepted": int(row[1]),
                "nr_evaluations": int(row[2]),
                "eps": float(row[3]) if row[3] is not None else None,
                "batch": batch}

    def load_sub_checkpoint_manifest(self, t: int) -> Optional[dict]:
        """The device-store manifest recorded with generation ``t``'s
        ledger row (lazy mode), or None."""
        row = self._conn.execute(
            "SELECT manifest FROM sub_checkpoints WHERE abc_smc_id=?"
            " AND t=?", (self.id, int(t))).fetchone()
        if row is None or row[0] is None:
            return None
        return json.loads(row[0])

    def clear_sub_checkpoint(self, t: int):
        self._conn.execute(
            "DELETE FROM sub_checkpoints WHERE abc_smc_id=? AND t=?",
            (self.id, int(t)))
        self._conn.commit()

    # ---- lazy rows: device-resident generations ---------------------------

    def attach_store(self, store):
        self._store = store
        # arm the durability contract: deposits and evictions write ahead
        # into the journal this History tombstones after its commits
        store.attach_journal(self.journal)

    def detach_store(self):
        """Later appends take the eager path; the store is no longer
        read."""
        self._store = None

    def drop_generation(self, t: int):
        """Delete generation ``t``'s rows (the degrade-to-eager rung
        re-runs the generation; its summary row must not shadow the
        eager re-append)."""
        for table in ("populations", "model_populations"):
            self._conn.execute(
                f"DELETE FROM {table} WHERE abc_smc_id=? AND t=?",
                (self.id, int(t)))
        self._conn.commit()

    def append_population_lazy(self, t: int, current_epsilon: float,
                               nr_simulations: int, *, summary: dict,
                               model_names: List[str],
                               param_names: Optional[List] = None,
                               stat_spec: Optional[dict] = None,
                               summary_grid: Optional[dict] = None):
        """The summary row of a device-resident generation: the packet
        (``wire.store.summary_from_lanes``) and one blob-less row per
        model with its count and mass, under the shared retry policy.
        ``summary_grid`` (``wire.store.maybe_summary_grid``) is stored
        as one ``[2, G]`` blob (centroids, log masses)."""
        from ..resilience import faults as _faults
        from ..resilience import retry as _retry
        _retry.shared_policy().call(
            self._append_population_lazy_once, _faults.SITE_APPEND,
            t, current_epsilon, nr_simulations, summary, model_names,
            param_names, stat_spec, summary_grid)

    def _append_population_lazy_once(self, t, current_epsilon,
                                     nr_simulations, summary, model_names,
                                     param_names, stat_spec, summary_grid):
        self._drain_spills()
        grid_blob = None
        if summary_grid:
            grid_blob = _pack(np.stack(
                [np.asarray(summary_grid["grid_centroid"]),
                 np.asarray(summary_grid["grid_log_mass"])]))
        self._conn.execute(
            "INSERT OR REPLACE INTO populations (abc_smc_id, t, epsilon,"
            " nr_samples, population_end_time, lazy, summary, summary_grid)"
            " VALUES (?,?,?,?,?,1,?,?)",
            (self.id, int(t), float(current_epsilon), int(nr_simulations),
             datetime.datetime.now().isoformat(), json.dumps(summary),
             grid_blob))
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
        self._conn.execute(
            "DELETE FROM sub_checkpoints WHERE abc_smc_id=? AND t=?",
            (self.id, int(t)))
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
        packet stays.  The commit is the durability point: only then
        does the journal forget the generation."""
        names = self.model_names()
        rows = self._conn.execute(
            "SELECT m, param_names, stat_spec FROM model_populations"
            " WHERE abc_smc_id=? AND t=? ORDER BY m",
            (self.id, int(t))).fetchall()
        pn = {m: (json.loads(p) if p else []) for m, p, _ in rows}
        spec = next(({k: tuple(v) for k, v in json.loads(sp).items()}
                     for _, _, sp in rows if sp), None)
        grid = self._conn.execute(
            "SELECT summary_grid FROM populations WHERE abc_smc_id=?"
            " AND t=?", (self.id, int(t))).fetchone()
        self._append_population_once(
            int(t), row[1], pop, row[2], names,
            [pn.get(m, []) for m in range(len(names))], spec,
            summary_json=row[3], summary_grid=grid[0] if grid else None)
        self._journal_done(int(t))

    def _journal_done(self, t: int):
        journal = self._journal if self._journal_armed else None
        if journal is not None and journal.has_payload(t):
            journal.mark_materialized(t)

    def _hydrate_checked(self, t: int, entry: dict):
        """``hydrate_entry`` behind the recovery ladder.  On
        ``IntegrityError``: (1) a corrupt journaled host copy is dropped
        and the decode retried from the still-resident device wire; (2)
        the journal's own copy of the generation is re-read; then the
        error propagates."""
        from ..resilience.journal import IntegrityError
        from ..telemetry.metrics import REGISTRY
        from ..wire.store import hydrate_entry
        _help = "hydration recovery ladder; see resilience/journal.py"
        try:
            return hydrate_entry(entry)
        except IntegrityError as first:
            logger.warning("generation %d failed checksummed hydration "
                           "(%s) — walking the recovery ladder", t, first)
            if entry.get("host_wire") is not None \
                    and entry.get("wire") is not None:
                retry_entry = dict(entry)
                retry_entry.pop("host_wire", None)
                if retry_entry.get("digest"):
                    retry_entry["digest"] = dict(retry_entry["digest"],
                                                 crc=None)
                try:
                    pop = hydrate_entry(retry_entry)
                    REGISTRY.counter("store_integrity_recovered_total",
                                     _help).inc()
                    return pop
                except IntegrityError:
                    pass
            journal = self._journal if self._journal_armed else None
            if journal is not None and journal.has_payload(t):
                try:
                    jentry = journal.pending().get(int(t))
                    if jentry is not None:
                        pop = hydrate_entry(jentry)
                        REGISTRY.counter("store_integrity_recovered_total",
                                         _help).inc()
                        return pop
                except IntegrityError:
                    pass
            raise

    def _drain_spills(self):
        """Materialize the entries the store's ring evicted, each under
        its own retry (``history.materialize`` site): a failure requeues
        THAT entry and the drain moves on.  An entry whose summary row is
        not appended yet (a worker deposited ahead of the harvest) is
        requeued too."""
        store = self._store
        if store is None:
            return
        from ..resilience import faults as _faults
        from ..resilience import retry as _retry
        from ..resilience.journal import IntegrityError
        requeue = []
        for entry in store.take_spills():
            t = entry["t"]
            row = self._lazy_flag(t)
            if row is None:
                requeue.append(entry)
                continue
            if not row[0]:
                self._journal_done(t)
                continue  # stale spill: the row is durable already
            try:
                _retry.shared_policy().call(
                    self._materialize_spill_once, _faults.SITE_MATERIALIZE,
                    entry, row)
            except (_retry.RetryExhausted, IntegrityError) as err:
                logger.warning(
                    "spill drain: generation %d not materialized (%s) — "
                    "requeued for the next drain", t, err)
                from ..telemetry.flight import RECORDER
                RECORDER.note("spill_requeue", t=int(t),
                              detail=type(err).__name__)
                requeue.append(entry)
        store.requeue_spills(requeue)

    def _materialize_spill_once(self, entry: dict, row: tuple):
        pop = self._hydrate_checked(entry["t"], entry)
        if pop is not None:
            self._materialize_pop(entry["t"], pop, row)

    def _store_hydrate(self, store, t: int):
        """``store.hydrate`` with the recovery ladder behind it; an
        unrecoverable mismatch propagates."""
        from ..resilience.journal import IntegrityError
        try:
            return store.hydrate(t)
        except IntegrityError:
            entry = store.entry(t)
            if entry is None:
                raise
            return self._hydrate_checked(t, entry)

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
        pop = self._store_hydrate(store, int(t))
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
            pop = self._store_hydrate(store, int(t))
            if pop is not None:
                self._materialize_pop(t, pop, row)
                store.drop(t)
                return pop
        self._materialize(t)
        return self.get_population(t)

    def flush_lazy(self, final_only: Optional[bool] = None,
                   newest_first: bool = False,
                   deadline: Optional[float] = None):
        """Materialize every resident generation and empty the store.
        With ``final_only`` (None: ``$PYABC_TPU_LAZY_FINAL_ONLY``) every
        resident generation but the last is dropped first and keeps its
        summary row only.  ``deadline`` (absolute ``time.monotonic``)
        bounds the flush: past it the remaining generations stay resident
        and journaled instead of being dropped.  A complete flush compacts
        the journal."""
        if final_only is None:
            final_only = os.environ.get(LAZY_FINAL_ONLY_ENV, "0").lower() \
                in ("1", "true", "on")
        self._drain_spills()
        store = self._store
        if store is None:
            return
        ts = store.resident_ts()
        if final_only and ts:
            for t in ts[:-1]:
                store.drop(t)
            ts = ts[-1:]
        if newest_first:
            ts = list(reversed(ts))
        for i, t in enumerate(ts):
            if deadline is not None and time.monotonic() >= deadline:
                logger.warning(
                    "lazy flush: deadline hit with %d generation(s) left "
                    "un-materialized — their journal/device copies "
                    "survive for recovery", len(ts) - i)
                return
            self._materialize(t)
        store.clear()
        journal = self._journal if self._journal_armed else None
        if journal is not None:
            journal.compact()

    def persist_lazy_tail(self, deadline_s: Optional[float] = None):
        """Exit-path durability anchor, in two bounded phases: journal
        the bytes of every un-journaled resident generation, newest
        first (``DeviceRunStore.journal_tail``), then materialize
        best-effort, newest first.  The barrier is bounded by
        ``deadline_s`` (default ``$PYABC_TPU_PREEMPT_DEADLINE_S`` = 30
        s)."""
        if deadline_s is None:
            deadline_s = _preempt_deadline_s()
        deadline = (time.monotonic() + float(deadline_s)
                    if deadline_s and deadline_s > 0 else None)
        store = self._store
        if store is not None:
            if store.journal is None and self.journal is not None:
                store.attach_journal(self.journal)
            store.journal_tail(deadline)
        self.flush_lazy(newest_first=True, deadline=deadline)

    def recover_lazy(self) -> dict:
        """Startup recovery (``ABCSMC.load``): replay the previous
        process's un-materialized journal payloads into durable blobs —
        generations a crash stranded on the card are restored, not
        discarded — then purge whatever is still summary-only.  Returns
        ``{"recovered": n, "purged": m}``."""
        from ..telemetry.metrics import REGISTRY
        recovered = 0
        journal = self._existing_journal()
        if journal is not None:
            for t, entry in sorted(journal.pending().items()):
                row = self._lazy_flag(t)
                if row is None or not row[0]:
                    # nothing to fill: no summary row committed, or the
                    # generation is durable already
                    journal.mark_materialized(t)
                    continue
                try:
                    pop = self._hydrate_checked(t, entry)
                except Exception:
                    logger.exception("journal replay: generation %d "
                                     "undecodable — left for purge", t)
                    continue
                if pop is None:
                    continue
                self._materialize_pop(t, pop, row)
                recovered += 1
                REGISTRY.counter(
                    "resilience_journal_replayed_total",
                    "journal payloads replayed into durable blobs").inc()
            journal.compact()
        if recovered:
            logger.warning("recovered %d generation(s) from the spill "
                           "journal left by an interrupted lazy run",
                           recovered)
        purged = self.purge_stale_lazy()
        return {"recovered": recovered, "purged": purged}

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

    @property
    def n_populations(self) -> int:
        return self.max_t + 1

    def alive_models(self, t: Optional[int] = None) -> List[int]:
        """Models with a positive probability in generation ``t``."""
        t = self.max_t if t is None else t
        rows = self._conn.execute(
            "SELECT m FROM model_populations WHERE abc_smc_id=? AND t=? "
            "AND p_model>0 ORDER BY m", (self.id, t)).fetchall()
        return [r[0] for r in rows]

    def db_file(self) -> str:
        return self.db_path

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
            "SELECT theta, weight, param_names, digest FROM "
            "model_populations WHERE abc_smc_id=? AND t=? AND m=?",
            (self.id, t, m)).fetchone()
        if row is None or row[0] is None:
            return pd.DataFrame(), np.zeros(0)
        crcs = json.loads(row[3]) if row[3] else {}
        theta = self._unpack_checked(row[0], crcs.get("theta"), t=t)
        w = self._unpack_checked(row[1], crcs.get("weight"), t=t)
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
            "SELECT m, theta, weight, distance, stats, digest FROM "
            "model_populations WHERE abc_smc_id=? AND t=? ORDER BY m",
            (self.id, t)).fetchall()
        rows = [r for r in rows if r[1] is not None]
        if not rows:
            return Population(m=np.zeros(0, np.int32), theta=np.zeros((0, 0)),
                              weight=np.zeros(0), distance=np.zeros(0))

        def unpack(r, i, key):
            crcs = json.loads(r[5]) if r[5] else {}
            return self._unpack_checked(r[i], crcs.get(key), t=t)

        thetas = [unpack(r, 1, "theta") for r in rows]
        dim = max(th.shape[1] for th in thetas)
        thetas = [np.pad(th, ((0, 0), (0, dim - th.shape[1])))
                  for th in thetas]
        stats = [unpack(r, 4, "stats") for r in rows if r[4] is not None]
        return Population(
            m=np.concatenate([np.full(th.shape[0], r[0], np.int32)
                              for r, th in zip(rows, thetas)]),
            theta=np.concatenate(thetas),
            weight=np.concatenate([unpack(r, 2, "weight") for r in rows]),
            distance=np.concatenate([unpack(r, 3, "distance")
                                     for r in rows]),
            sum_stats=({"__flat__": np.concatenate(stats)}
                       if len(stats) == len(rows) else {}))

    def get_sum_stats(self, t: Optional[int] = None, m: int = 0
                      ) -> Dict[str, np.ndarray]:
        """Model ``m``'s per-particle summary statistics of generation
        ``t`` by key, ``{key: [N, *shape]}`` (keys in sorted order over
        the flat block, as the stored spec lays them out)."""
        t = self.max_t if t is None else t
        self._materialize(t)
        row = self._conn.execute(
            "SELECT stats, stat_spec, digest FROM model_populations "
            "WHERE abc_smc_id=? AND t=? AND m=?", (self.id, t, m)).fetchone()
        if row is None or row[0] is None:
            return {}
        crcs = json.loads(row[2]) if row[2] else {}
        flat = self._unpack_checked(row[0], crcs.get("stats"), t=t)
        if not row[1]:
            return {"__flat__": flat}
        spec = json.loads(row[1])
        out, off = {}, 0
        for k in sorted(spec):
            shape = tuple(spec[k])
            size = int(np.prod(shape, dtype=int))
            out[k] = flat[:, off:off + size].reshape((flat.shape[0],) + shape)
            off += size
        return out

    def get_nr_particles_per_population(self) -> pd.Series:
        rows = self._conn.execute(
            "SELECT t, SUM(n_particles) FROM model_populations WHERE "
            "abc_smc_id=? GROUP BY t ORDER BY t", (self.id,)).fetchall()
        return pd.Series({t: n for t, n in rows})

    def _blob(self, blob, digest, key: str, t: int):
        """One stored blob of a model row behind its CRC."""
        crcs = json.loads(digest) if digest else {}
        return self._unpack_checked(blob, crcs.get(key), t=t)

    def get_weighted_distances(self, t: Optional[int] = None
                               ) -> pd.DataFrame:
        """Generation ``t``'s distances with their normalized weights
        (columns ``distance``, ``w``), models in row order."""
        t = self.max_t if t is None else t
        self._materialize(t)
        rows = self._conn.execute(
            "SELECT distance, weight, digest FROM model_populations WHERE "
            "abc_smc_id=? AND t=?", (self.id, t)).fetchall()
        rows = [r for r in rows if r[0] is not None]
        ds = (np.concatenate([self._blob(r[0], r[2], "distance", t)
                              for r in rows]) if rows else np.zeros(0))
        ws = (np.concatenate([self._blob(r[1], r[2], "weight", t)
                              for r in rows]) if rows else np.zeros(0))
        return pd.DataFrame({"distance": ds,
                             "w": ws / max(ws.sum(), 1e-300)})

    def _raw_weighted_sum_stats(self, t: int, m: int
                                ) -> Tuple[np.ndarray, List[Dict]]:
        """Model ``m``'s un-normalized weights and one summary-statistic
        dict per particle."""
        self._materialize(t)
        row = self._conn.execute(
            "SELECT weight, digest FROM model_populations WHERE "
            "abc_smc_id=? AND t=? AND m=?", (self.id, t, m)).fetchone()
        if row is None or row[0] is None:
            return np.zeros(0), []
        w = self._blob(row[0], row[1], "weight", t)
        keyed = self.get_sum_stats(t, m)
        return w, [{k: v[i] for k, v in keyed.items()}
                   for i in range(w.shape[0])]

    def get_weighted_sum_stats(self, t: Optional[int] = None
                               ) -> Tuple[np.ndarray, List[Dict]]:
        """(normalized weights, one summary-statistic dict per particle)
        over all models of generation ``t``."""
        t = self.max_t if t is None else t
        rows = self._conn.execute(
            "SELECT m FROM model_populations WHERE abc_smc_id=? "
            "AND t=? ORDER BY m", (self.id, t)).fetchall()
        weights, dicts = [], []
        for (m,) in rows:
            w, d = self._raw_weighted_sum_stats(t, m)
            weights.append(w)
            dicts.extend(d)
        if not weights:
            return np.zeros(0), []
        w = np.concatenate(weights)
        return w / max(w.sum(), 1e-300), dicts

    def get_weighted_sum_stats_for_model(self, m: int = 0,
                                         t: Optional[int] = None
                                         ) -> Tuple[np.ndarray, List[Dict]]:
        """(normalized weights, summary-statistic dicts) of model ``m``."""
        t = self.max_t if t is None else t
        w, dicts = self._raw_weighted_sum_stats(t, m)
        if w.size == 0:
            return w, dicts
        return w / max(w.sum(), 1e-300), dicts

    def get_population_strategy(self) -> dict:
        row = self._conn.execute(
            "SELECT population_strategy FROM abc_smc WHERE id=?",
            (self.id,)).fetchone()
        return json.loads(row[0]) if row and row[0] else {}

    def all_runs(self) -> pd.DataFrame:
        rows = self._conn.execute(
            "SELECT id, start_time FROM abc_smc").fetchall()
        return pd.DataFrame(rows, columns=["id", "start_time"])

    @property
    def db_size(self) -> float:
        """The database file's size in MB; -1 in memory."""
        if self.in_memory:
            return -1.0
        try:
            return os.path.getsize(self.db_path) / 1e6
        except OSError:
            return -1.0

    @property
    def total_nr_simulations(self) -> int:
        row = self._conn.execute(
            "SELECT SUM(nr_samples) FROM populations WHERE abc_smc_id=?",
            (self.id,)).fetchone()
        return int(row[0] or 0)

    def get_ground_truth_parameter(self) -> dict:
        row = self._conn.execute(
            "SELECT json_parameters FROM abc_smc WHERE id=?",
            (self.id,)).fetchone()
        params = json.loads(row[0]) if row and row[0] else {}
        return params.get("ground_truth_parameter") or {}

    def nr_of_models_alive(self, t: Optional[int] = None) -> int:
        return len(self.alive_models(t))

    def get_population_extended(self, m: Optional[int] = None,
                                t: Union[int, str, None] = "last"
                                ) -> pd.DataFrame:
        """Long-form particle table: columns ``t``, ``m``, ``w``,
        ``distance`` and the parameters.  ``t="last"`` is the last
        generation; ``None`` or ``"all"`` every stored one, the
        calibration sample (``t = -1``) included."""
        if t == "last":
            ts = [self.max_t]
        elif t is None or t == "all":
            ts = [r[0] for r in self._conn.execute(
                "SELECT DISTINCT t FROM model_populations WHERE "
                "abc_smc_id=? ORDER BY t", (self.id,)).fetchall()]
        else:
            ts = [int(t)]
        frames = []
        for ti in ts:
            query = ("SELECT m, theta, weight, distance, param_names, "
                     "digest FROM model_populations WHERE abc_smc_id=? "
                     "AND t=?")
            args = [self.id, ti]
            if m is not None:
                query += " AND m=?"
                args.append(m)
            self._materialize(ti)
            rows = self._conn.execute(query + " ORDER BY m",
                                      args).fetchall()
            for mi, tb, wb, db_, names_json, digest in rows:
                if tb is None:
                    continue
                theta = self._blob(tb, digest, "theta", ti)
                names = (json.loads(names_json)
                         or [f"p{i}" for i in range(theta.shape[1])])
                df = pd.DataFrame(theta[:, :len(names)], columns=names)
                df.insert(0, "distance",
                          self._blob(db_, digest, "distance", ti))
                df.insert(0, "w", self._blob(wb, digest, "weight", ti))
                df.insert(0, "m", mi)
                df.insert(0, "t", ti)
                frames.append(df)
        if not frames:
            return pd.DataFrame(columns=["t", "m", "w", "distance"])
        return pd.concat(frames, ignore_index=True)

    @classmethod
    def from_reference_db(cls, path: str, db: str = "sqlite://",
                          abc_id: int = 1) -> "History":
        """A run of a pyABC ORM-schema database as a History backed by
        ``db`` (:mod:`.reference_export`)."""
        from .reference_export import from_reference_db
        return from_reference_db(path, db=db, abc_id=abc_id)

    def to_reference_db(self, path: str, batch_stats: bool = True) -> int:
        """Write this run into a fresh pyABC ORM-schema database at
        ``path`` (:mod:`.reference_export`); returns its ``abc_smc.id``."""
        from .reference_export import to_reference_db
        return to_reference_db(self, path, batch_stats=batch_stats)

    def done(self):
        """End of a run: every resident generation gets its blobs (and
        the journal compacts to empty)."""
        self.flush_lazy()
        self._conn.commit()

    def close(self):
        if self._journal is not None:
            self._journal.close()
        self._conn.close()
