"""EPSMixin: the DYN eval-parallel scheduler shared by futures samplers.

Port of ``pyabc_tpu/sampler/eps_mixin.py``: submit batches while
``running < min(client_max_jobs, client_cores())``, harvest completed
futures, account results in SUBMISSION order (a fast straggler cannot
jump the queue and bias the population toward short-running
simulations), cancel stragglers once n are accepted.

Each task runs one round of ``batch_size`` candidates on the run's device
(:func:`task_runner`): its own ``torch.Generator``, seeded from one draw
of the caller's generator plus the task id (the JAX package's
``fold_in(key, seed)``), so a run repeats bit for bit whatever the
threads' timing; the round and the fetch of its accepted rows run in the
task, the fetch after an event recorded on the round's stream.  A task's
error is classified by :mod:`..resilience.retry`: a transient one (an
out-of-memory, a broken executor) resubmits the same task, a sticky CUDA
error ends the run, anything else writes the batch off as a model
failure.  Shared by :class:`~.mapping.ConcurrentFutureSampler` and
:class:`~.dask_sampler.DaskDistributedSampler`.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..convert import to_torch
from ..device import device_of
from ..resilience import retry as _retry
from .base import Sample, fetch_to_host, round_rows

logger = logging.getLogger("ABC.Sampler")


def task_runner(round_fn, generator: torch.Generator, params: dict, B: int,
                all_accepted: bool = False):
    """``run(task_id) -> (task_id, RoundResult, host rows)``: one round of
    ``B`` candidates from a generator of its own on ``generator``'s
    device, seeded ``base + task_id`` with ``base`` one draw of
    ``generator`` (one host read per call of this function).
    ``run.started`` lists the task ids in the order their rounds began."""
    dev = device_of(generator)
    base = int(torch.randint(0, 1 << 62, (1,), generator=generator,
                             device=dev).item())
    kwargs = {"all_accepted": True} if all_accepted else {}

    def run(task_id: int):
        run.started.append(task_id)
        gen = torch.Generator(device=dev)
        gen.manual_seed(base + int(task_id))
        rr = round_fn(gen, params, B, **kwargs)
        return task_id, rr, fetch_to_host(round_rows(rr))

    run.started = []
    return run


class EPSMixin:
    """Scheduling core over an abstract futures client.

    Concrete samplers provide:

    - ``_submit(fn, task_id) -> future`` — the future must expose
      ``result()``, ``done()`` and ``cancel()``
    - ``client_cores() -> int`` — parallelism of the backing cluster
    - optionally ``_wait_any(futures) -> future`` — blocking wait for any
      completed future (default: poll ``done()``)

    plus attributes ``client_max_jobs``, ``batch_size`` and ``device``.
    ``task_counts`` gets, per call, the number of tasks whose round ran
    (stragglers included: a task that had started when the call ended is
    waited for, so a generation's device work stays inside its call).
    """

    client_max_jobs: int = 8
    batch_size: int = 1

    #: abort after this many consecutive failed batches with no progress:
    #: a persistently crashing model, not sporadic failures
    max_consecutive_failures: int = 64

    #: resubmissions of the SAME batch after a transient failure before
    #: it is written off as a model failure
    max_transient_retries: int = 3

    def _submit(self, fn, task_id):
        raise NotImplementedError

    def client_cores(self) -> int:
        return self.client_max_jobs

    def _wait_any(self, futures):
        """Any completed future (default: poll)."""
        while True:
            for fut in futures:
                if fut.done():
                    return fut
            time.sleep(0.001)

    def _cancel(self, fut):
        try:
            fut.cancel()
        except Exception:  # cancellation is best-effort on every backend
            pass

    def _recover(self):
        """Rebuild a broken backend (all in-flight work lost): True if
        sampling may go on (the lost tasks are resubmitted), False to
        re-raise."""
        return False

    def sample_until_n_accepted(self, n, round_fn, generator, params,
                                max_eval=np.inf, all_accepted=False,
                                **kwargs) -> Sample:
        sample = Sample(record_rejected=self.record_rejected,
                        max_records=self.max_records)
        B = self.batch_size
        eval_batch = task_runner(round_fn, generator,
                                 to_torch(params, self.device), B,
                                 all_accepted)
        max_jobs = max(int(min(self.client_max_jobs, self.client_cores())),
                       1)
        next_task = 0
        in_flight = {}
        results = {}
        harvested = 0  # next submission id to account
        #: the simulation budget charges unique batches, not attempts: a
        #: retried batch counts once, a written-off one in failed_evals
        failed_evals = 0
        task_retries = {}
        consecutive_failures = 0
        bar = None
        if self.show_progress:
            from ..utils.progress import ProgressBar
            bar = ProgressBar(n, desc="sampling")
        try:
            while True:
                # submission-order accounting
                while harvested in results:
                    done_task = results.pop(harvested)
                    if done_task is not None:  # None: a failed batch
                        sample.append_round(*done_task)
                    harvested += 1
                if bar is not None:
                    bar.update(min(sample.n_accepted, n))
                if sample.n_accepted >= n or (
                        sample.nr_evaluations + failed_evals >= max_eval
                        and sample.n_accepted < n):
                    break
                while len(in_flight) < max_jobs:
                    fut = self._submit(eval_batch, next_task)
                    in_flight[fut] = next_task
                    next_task += 1
                done = self._wait_any(list(in_flight))
                try:
                    task_id, rr, host = done.result()
                    consecutive_failures = 0
                except Exception as err:  # model error or dead worker
                    if _retry.is_sticky_cuda_error(err):
                        raise  # the context is gone: nothing can go on
                    task_id = in_flight.pop(done)
                    consecutive_failures += 1
                    if consecutive_failures > self.max_consecutive_failures:
                        raise RuntimeError(
                            f"{consecutive_failures} consecutive batch "
                            "failures — model or cluster is persistently "
                            "broken") from err
                    if self._is_broken_backend(err):
                        # every in-flight task died with the backend:
                        # resubmit them all (the dying one included: its
                        # simulations never ran) after recovery
                        if not self._recover():
                            raise
                        lost = sorted(set(in_flight.values()) | {task_id})
                        in_flight = {}
                        for s in lost:
                            in_flight[self._submit(eval_batch, s)] = s
                        logger.warning(
                            "backend died under batch %d (%s: %s) — "
                            "rebuilt, %d batches resubmitted", task_id,
                            type(err).__name__, err, len(lost))
                        continue
                    retries = task_retries.get(task_id, 0)
                    if (_retry.is_transient(err)
                            and retries < self.max_transient_retries):
                        task_retries[task_id] = retries + 1
                        in_flight[self._submit(eval_batch, task_id)] = \
                            task_id
                        logger.warning(
                            "batch %d failed transiently (%s: %s) — "
                            "resubmitted (attempt %d/%d)", task_id,
                            type(err).__name__, err, retries + 1,
                            self.max_transient_retries)
                        continue
                    failed_evals += B
                    logger.warning(
                        "batch %d failed (%s: %s) — discarded, continuing "
                        "with fresh work", task_id, type(err).__name__, err)
                    results[task_id] = None
                    continue
                del in_flight[done]
                results[task_id] = (rr, host)
        finally:
            if bar is not None:
                bar.finish()
            for fut in in_flight:
                self._cancel(fut)
            for fut in in_flight:
                if not fut.cancelled():
                    try:
                        fut.result()
                    except Exception:  # a straggler's result is dropped
                        pass
            self.task_counts.append(len(eval_batch.started))
        self.nr_evaluations_ = sample.nr_evaluations + failed_evals
        return sample

    @staticmethod
    def _is_broken_backend(err: Exception) -> bool:
        """Whether the error means the whole backend died (vs one batch)."""
        from concurrent.futures import BrokenExecutor
        return isinstance(err, BrokenExecutor)
