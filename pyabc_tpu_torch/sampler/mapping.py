"""Map-based and executor-based samplers.

Port of ``pyabc_tpu/sampler/mapping.py``: :class:`MappingSampler` over
any ``map``-like callable (STAT scheduling in waves) and
:class:`ConcurrentFutureSampler` over a ``concurrent.futures.Executor``
(the DYN scheduler of :mod:`.eps_mixin`).  Each task runs the same round
function as :class:`~.vectorized.VectorizedSampler` — proposal, simulate,
distance, accept, with the proposal density evaluated in the round (the
KDE kernel on the card) — at the task's batch size, on the run's device
(:func:`~.eps_mixin.task_runner`); only the scheduling is farmed out.
Simulators torch cannot express plug in underneath as models
(:mod:`..external`).  For a model that runs on the card,
``VectorizedSampler`` is the fast path.
"""

from __future__ import annotations

import logging
from concurrent.futures import Executor, ThreadPoolExecutor, as_completed
from typing import Optional

import numpy as np

from ..convert import to_torch
from ..device import resolve_device
from .base import Sample, Sampler
from .eps_mixin import EPSMixin, task_runner

logger = logging.getLogger("ABC.Sampler")


class MappingSampler(Sampler):
    """STAT scheduling over any map-like callable: each map task runs a
    round of one candidate; tasks go out in waves of ``wave_size``
    (default ``max(n, 16)``) until n are accepted, and are accounted in
    task order.  ``task_counts`` gets the tasks run per call."""

    def __init__(self, map_=map, mapper_pickles: bool = False,
                 wave_size: Optional[int] = None, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.map_ = map_
        self.mapper_pickles = mapper_pickles
        self.wave_size = wave_size
        self.task_counts = []

    def sample_until_n_accepted(self, n, round_fn, generator, params,
                                max_eval=np.inf, all_accepted=False,
                                **kwargs) -> Sample:
        sample = Sample(record_rejected=self.record_rejected,
                        max_records=self.max_records)
        wave = self.wave_size or max(n, 16)
        eval_one = task_runner(round_fn, generator,
                               to_torch(params, self.device), 1,
                               all_accepted)
        task = 0
        while sample.n_accepted < n:
            tasks = list(range(task, task + wave))
            task += wave
            for _, rr, host in self.map_(eval_one, tasks):
                sample.append_round(rr, host)
            if sample.nr_evaluations >= max_eval and sample.n_accepted < n:
                logger.warning("max_eval reached in MappingSampler")
                break
        self.task_counts.append(len(eval_one.started))
        self.nr_evaluations_ = sample.nr_evaluations
        return sample


class ConcurrentFutureSampler(EPSMixin, Sampler):
    """DYN scheduling over a ``concurrent.futures.Executor``: the
    :class:`~.eps_mixin.EPSMixin` loop keeps ``client_max_jobs`` batches
    of ``batch_size`` in flight, harvests them as they complete in
    submission order, and cancels the rest once n are accepted.  Without
    an executor it makes a thread pool of ``client_max_jobs`` workers."""

    def __init__(self, cfuture_executor: Optional[Executor] = None,
                 client_max_jobs: int = 8, batch_size: int = 1,
                 device=None):
        Sampler.__init__(self)
        self.device = resolve_device(device)
        self.executor = cfuture_executor
        self._owns_executor = cfuture_executor is None
        self.client_max_jobs = int(client_max_jobs)
        self.batch_size = int(batch_size)
        self.task_counts = []

    def _submit(self, fn, task_id):
        if self.executor is None:
            self.executor = ThreadPoolExecutor(
                max_workers=self.client_max_jobs)
            self._owns_executor = True
        return self.executor.submit(fn, task_id)

    def _wait_any(self, futures):
        return next(as_completed(futures))

    def _recover(self):
        """Rebuild a broken executor this sampler owns; the lost batches
        are resubmitted."""
        if not self._owns_executor:
            return False
        logger.warning("executor broke — rebuilding and resubmitting")
        try:
            self.executor.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass
        self.executor = None  # _submit makes a new one
        return True

    def stop(self):
        # only an executor this sampler made: a caller's executor may
        # carry the caller's other work
        if self.executor is not None and self._owns_executor:
            self.executor.shutdown(wait=False, cancel_futures=True)
            self.executor = None
