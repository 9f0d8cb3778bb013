"""Execution contexts wrapping each cluster task.

Parity: pyabc/sge/execution_contexts.py:1-92 — ``DefaultContext`` (no-op),
``ProfilingContext`` (cProfile dump per job), ``NamedPrinter`` (tagged
stdout).
"""

from __future__ import annotations

import cProfile
import os


class DefaultContext:
    def __init__(self, tmp_dir: str = ".", task_id: int = 0):
        self.tmp_dir = tmp_dir
        self.task_id = task_id

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class ProfilingContext(DefaultContext):
    """Wrap the job in cProfile, dump ``<task>.pstats`` (reference :57-92)."""

    def __enter__(self):
        self.profiler = cProfile.Profile()
        self.profiler.enable()
        return self

    def __exit__(self, *exc):
        self.profiler.disable()
        self.profiler.dump_stats(
            os.path.join(self.tmp_dir, f"{self.task_id}.pstats"))
        return False


class NamedPrinter(DefaultContext):
    """Tag stdout lines with the task id (reference :13-44)."""

    def __enter__(self):
        import builtins
        self._orig_print = builtins.print
        task = self.task_id

        def tagged_print(*args, **kwargs):
            self._orig_print(f"[task {task}]", *args, **kwargs)

        builtins.print = tagged_print
        return self

    def __exit__(self, *exc):
        import builtins
        builtins.print = self._orig_print
        return False
