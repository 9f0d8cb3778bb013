"""Per-task entry point for SGE array jobs.

Parity: pyabc/sge/execute_load.py — unpickle function + argument, run it
inside the execution context, pickle the result, update the job DB.
Invoked as ``python -m pyabc_tpu_torch.sge.execute_load <tmp_dir> <task_id>``.
"""

from __future__ import annotations

import json
import os
import pickle
import sys


def _restore_sys_path(tmp_dir: str):
    """Extend sys.path with the submitting process's entries so functions
    pickled by reference (e.g. from a pytest-inserted test dir) resolve."""
    path_file = os.path.join(tmp_dir, "sys_path.json")
    if os.path.exists(path_file):
        with open(path_file) as f:
            for p in json.load(f):
                if p not in sys.path:
                    sys.path.append(p)


def main(tmp_dir: str, task_id: int):
    from .db import JobDB

    db = JobDB(tmp_dir)
    db.start(task_id)
    ok = False
    try:
        _restore_sys_path(tmp_dir)
        with open(os.path.join(tmp_dir, "function.pickle"), "rb") as f:
            bundle = pickle.load(f)
        function = bundle["function"]
        context_cls = bundle["context"]
        with open(os.path.join(tmp_dir, "jobs", f"{task_id}.job"),
                  "rb") as f:
            arg = pickle.load(f)
        with context_cls(tmp_dir, task_id):
            result = function(arg)
        ok = True
    except Exception as e:  # result file carries the exception
        result = e
    with open(os.path.join(tmp_dir, "results", f"{task_id}.result"),
              "wb") as f:
        pickle.dump(result, f)
    db.finish(task_id, ok)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
