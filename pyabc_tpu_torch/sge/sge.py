"""SGE batch mapper: qsub array jobs with file-pickle transport.

Parity: pyabc/sge/sge.py:24-383 — ``SGE.map(fn, args)`` pickles the
function and each argument to a shared tmp directory, renders a ``qsub``
array-job script (one task per argument, ``_render_batch_file`` analog),
submits it, polls a job-state DB until all tasks finish, and unpickles the
results.  Failed task directories are preserved as ``*_with_exception``
(reference sge.py:330-335).

When no ``qsub`` binary exists, ``SGE`` degrades to a
local subprocess pool executing the same rendered job script per task — the
transport, DB polling and error handling are identical, so the cluster path
is exercised end-to-end minus the scheduler binary.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Sequence

import cloudpickle

from .config import get_config
from .db import JobDB
from .execution_contexts import DefaultContext

_BATCH_TEMPLATE = """#!/bin/bash
#$ -N {job_name}
#$ -t 1-{n_tasks}
#$ -q {queue}
#$ -l h_rt={time_h}:00:00
#$ -l h_vmem={memory}
#$ -cwd
#$ -S /bin/bash
#$ -e {tmp_dir}/stderr
#$ -o {tmp_dir}/stdout
{python} -m pyabc_tpu_torch.sge.execute_load "{tmp_dir}" $SGE_TASK_ID
"""


class SGE:
    """Array-job mapper (reference sge.py:24-120 constructor options)."""

    def __init__(self, tmp_directory: str = None, memory: str = "3G",
                 time_h: int = 100, python_executable_path: str = None,
                 sge_error_file: str = None, sge_output_file: str = None,
                 parallel_environment: str = None, name: str = "pyabc_tpu_torch",
                 queue: str = None, priority: int = None, num_threads: int = 1,
                 execution_context=DefaultContext, chunk_size: int = 1):
        cfg = get_config()
        self.tmp_directory = tmp_directory or cfg.get("DIRECTORIES", {}).get(
            "TMP", tempfile.gettempdir())
        self.memory = memory
        self.time_h = int(time_h)
        self.python = python_executable_path or sys.executable
        self.name = name
        self.queue = queue or cfg.get("SGE", {}).get("QUEUE", "p.openmp")
        self.priority = priority
        self.num_threads = num_threads
        self.execution_context = execution_context
        self.chunk_size = chunk_size

    @staticmethod
    def sge_available() -> bool:
        """reference sge.py:14-21 (`qsub` on PATH)."""
        return shutil.which("qsub") is not None

    def _render_batch_file(self, n_tasks: int, tmp_dir: str) -> str:
        """reference sge.py:343-382."""
        return _BATCH_TEMPLATE.format(
            job_name=self.name, n_tasks=n_tasks, queue=self.queue,
            time_h=self.time_h, memory=self.memory, tmp_dir=tmp_dir,
            python=self.python)

    def map(self, function: Callable, array: Sequence) -> List:
        """Pickle -> submit -> poll -> collect (reference sge.py:232-341)."""
        array = list(array)
        if not array:
            return []
        tmp_dir = tempfile.mkdtemp(prefix=f"{self.name}_",
                                   dir=self.tmp_directory)
        os.makedirs(os.path.join(tmp_dir, "jobs"))
        os.makedirs(os.path.join(tmp_dir, "results"))
        os.makedirs(os.path.join(tmp_dir, "stdout"))
        os.makedirs(os.path.join(tmp_dir, "stderr"))
        # cloudpickle serializes functions defined in importable modules by
        # reference; the worker subprocess must see the same sys.path (e.g.
        # a pytest-inserted test dir) to resolve them on unpickle.  Persist
        # it to a side file read BEFORE function.pickle is opened.
        with open(os.path.join(tmp_dir, "sys_path.json"), "w") as f:
            # '' means the submitter's CWD — resolve it so workers running
            # elsewhere can still import modules from it
            json.dump([p or os.path.abspath(os.getcwd()) for p in sys.path],
                      f)
        with open(os.path.join(tmp_dir, "function.pickle"), "wb") as f:
            cloudpickle.dump(
                {"function": function,
                 "context": self.execution_context}, f)
        for k, arg in enumerate(array, start=1):
            with open(os.path.join(tmp_dir, "jobs", f"{k}.job"), "wb") as f:
                cloudpickle.dump(arg, f)
        db = JobDB(tmp_dir)
        db.create(len(array))

        batch_file = os.path.join(tmp_dir, "job.sh")
        with open(batch_file, "w") as f:
            f.write(self._render_batch_file(len(array), tmp_dir))

        if self.sge_available():
            subprocess.run(["qsub", batch_file], check=True,
                           capture_output=True)
        else:
            self._run_locally(tmp_dir, len(array))

        db.wait_for_completion()

        results = []
        for k in range(1, len(array) + 1):
            path = os.path.join(tmp_dir, "results", f"{k}.result")
            if not os.path.exists(path):
                results.append(Exception(f"task {k} produced no result"))
                continue
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        if any(isinstance(r, Exception) for r in results):
            # preserve evidence (reference sge.py:330-335)
            shutil.move(tmp_dir, tmp_dir + "_with_exception")
        else:
            shutil.rmtree(tmp_dir, ignore_errors=True)
        return results

    def _run_locally(self, tmp_dir: str, n_tasks: int):
        """Local fallback: same per-task entry point, subprocess pool."""
        import multiprocessing as mp
        n_workers = min(mp.cpu_count(), n_tasks)
        procs: list = []
        task = 1
        while task <= n_tasks or procs:
            while len(procs) < n_workers and task <= n_tasks:
                procs.append(subprocess.Popen(
                    [self.python, "-m", "pyabc_tpu_torch.sge.execute_load",
                     tmp_dir, str(task)]))
                task += 1
            procs = [p for p in procs if p.poll() is None]
            time.sleep(0.05)
