"""Job-state DB for the SGE mapper.

Parity: pyabc/sge/db.py:13-144 — an sqlite file inside the job tmp dir
tracks per-task start/completion; the master polls it with timeout-based
re-waits (db.py:42).
"""

from __future__ import annotations

import os
import sqlite3
import time


class JobDB:
    def __init__(self, tmp_dir: str):
        self.path = os.path.join(tmp_dir, "jobs.db")

    def _conn(self):
        return sqlite3.connect(self.path, timeout=30)

    def create(self, n_tasks: int):
        with self._conn() as c:
            c.execute("CREATE TABLE IF NOT EXISTS tasks "
                      "(id INTEGER PRIMARY KEY, started REAL, finished REAL,"
                      " ok INTEGER)")
            c.executemany("INSERT INTO tasks VALUES (?, NULL, NULL, NULL)",
                          [(k,) for k in range(1, n_tasks + 1)])

    def start(self, task_id: int):
        with self._conn() as c:
            c.execute("UPDATE tasks SET started=? WHERE id=?",
                      (time.time(), task_id))

    def finish(self, task_id: int, ok: bool):
        with self._conn() as c:
            c.execute("UPDATE tasks SET finished=?, ok=? WHERE id=?",
                      (time.time(), int(ok), task_id))

    def n_unfinished(self) -> int:
        with self._conn() as c:
            row = c.execute("SELECT COUNT(*) FROM tasks WHERE finished IS "
                            "NULL").fetchone()
            return int(row[0])

    def wait_for_completion(self, poll_interval: float = 0.2,
                            timeout: float = 24 * 3600):
        t0 = time.time()
        while self.n_unfinished():
            if time.time() - t0 > timeout:
                raise TimeoutError("SGE jobs did not finish in time")
            time.sleep(poll_interval)
