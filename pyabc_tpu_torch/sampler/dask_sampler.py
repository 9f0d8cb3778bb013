"""Dask-distributed sampler: :class:`~.eps_mixin.EPSMixin` over a
``distributed.Client``.

Port of ``pyabc_tpu/sampler/dask_sampler.py``: DYN scheduling over dask
futures with ``batch_size`` candidates per task, a local cluster
(``Client(processes=False)``) when no client is given, and pickling that
drops the client handle.  ``distributed`` is optional: it is imported
only when a sampler is made without a client, and then its absence
raises ``ImportError``.  A caller may pass any object with ``submit``,
``ncores`` and ``close``.  Each task's round runs on the run's device in
the client's worker (:func:`~.eps_mixin.task_runner`).
"""

from __future__ import annotations

from ..device import resolve_device
from .base import Sampler
from .eps_mixin import EPSMixin


class DaskDistributedSampler(EPSMixin, Sampler):
    """DYN sampler over dask futures.

    ``dask_client``: a configured ``distributed.Client`` (None: a local
    in-process cluster); ``client_max_jobs``: futures in flight, capped by
    the cluster's cores; ``batch_size``: candidates per task.
    """

    def __init__(self, dask_client=None,
                 client_max_jobs: int = int(2**31 - 1),
                 batch_size: int = 1, device=None):
        Sampler.__init__(self)
        self.device = resolve_device(device)
        if dask_client is None:
            try:
                from distributed import Client
            except ImportError as e:
                raise ImportError(
                    "DaskDistributedSampler needs the 'distributed' "
                    "package, or pass a pre-configured client-compatible "
                    "object") from e
            dask_client = Client(processes=False)
        self.my_client = dask_client
        self.client_max_jobs = int(min(client_max_jobs, 2**31 - 1))
        self.batch_size = int(batch_size)
        self.task_counts = []

    def __getstate__(self):
        # the client holds sockets; it is resolved again after unpickling
        d = dict(self.__dict__)
        del d["my_client"]
        return d

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.my_client = None  # resolved again by _client()

    def _client(self):
        """The live client; after unpickling, ``distributed.get_client``
        or a new local cluster."""
        if self.my_client is None:
            from distributed import Client, get_client
            try:
                self.my_client = get_client()
            except ValueError:
                self.my_client = Client(processes=False)
        return self.my_client

    def client_cores(self) -> int:
        """The workers' cores in all."""
        try:
            return int(sum(self._client().ncores().values()))
        except Exception:
            return self.client_max_jobs

    def _submit(self, fn, task_id):
        # pure=False: every task draws from its own stream, so dask must
        # not deduplicate results by key
        try:
            return self._client().submit(fn, task_id, pure=False)
        except TypeError:  # a client without a `pure` keyword
            return self._client().submit(fn, task_id)

    def _wait_any(self, futures):
        # by the futures' type: a client-compatible object may hand back
        # concurrent.futures.Future objects that distributed.wait ignores
        try:
            from distributed import Future as DaskFuture, wait
            if isinstance(futures[0], DaskFuture):
                done, _ = wait(futures, return_when="FIRST_COMPLETED")
                return next(iter(done))
        except ImportError:
            pass
        return super()._wait_any(futures)

    def stop(self):
        try:
            if self.my_client is not None:
                self.my_client.close()
        except Exception:
            pass
