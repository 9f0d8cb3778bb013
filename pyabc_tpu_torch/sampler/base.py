"""Sampler contract and the Sample accumulator.

Port of ``RoundResult``, ``Sample`` and ``Sampler`` from
``pyabc_tpu/sampler/base.py``.  A round function

    round_fn(generator, params, B, ...) -> RoundResult   (B candidates)

runs one fixed-size batch of candidates on the run's device; the sampler
repeats rounds until ``n`` are accepted.  Rounds are ordered, so keeping
the accepted rows in (round, lane) order and truncating to the first
``n`` is the reference's de-biasing protocol.  ``nr_evaluations`` counts
rounds × B.

The record stream: with ``record_rejected`` set (an adaptive distance
or a temperature scheme asks for it), every valid candidate — accepted
or not — is recorded, up to ``max_records`` per generation, earliest
first.  The records stay on the device: the adaptive distance's scale
refit and the temperature's acceptance-rate solve are device reductions.
With ``record_proposal_density`` set, each ingested record batch gets
its generating proposal's density (the rounds defer it; K1 on the card);
the orchestrator sets the new proposal's density on the ``Sample``
(``transition_log_pdf`` on host arrays, ``transition_log_pdf_device`` on
tensors), and the temperature schemes read the ratio of the two.

:func:`fetch_to_host` is the single device-to-host chokepoint of the
population wire (``pyabc_tpu/sampler/base.py:87``): it waits on the
producer's CUDA event (booked to the ledger's ``compute_s``), copies on a
stream of its own into pinned host memory (``d2h_s``), and books the
bytes, under the shared retry policy.  :meth:`Sampler._dispatch` is the
device-dispatch chokepoint, under the sampler's own policy.  With ``defer_wire_fetch`` the sampler leaves a generation's
accepted rows on the device as the ``Sample``'s pending wire, for the
orchestrator to hand to a streaming-ingest worker or the device store.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..population import Population
from ..resilience import faults as _faults
from ..resilience import retry as _retry
from ..telemetry import spans
from ..wire import transfer

_copy_streams = threading.local()


def _tensors(tree, out: list) -> list:
    if isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif torch.is_tensor(tree):
        out.append(tree)
    return out


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree) if torch.is_tensor(tree) else tree


def mark_ready(tree) -> Optional["torch.cuda.Event"]:
    """A CUDA event recorded now on the current stream of the device the
    tree's tensors live on: it completes when every kernel queued so far
    (the wire's producer) has run.  None without a CUDA tensor."""
    cuda = [t for t in _tensors(tree, []) if t.is_cuda]
    if not cuda:
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(cuda[0].device))
    return event


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """This thread's copy stream on ``device``."""
    streams = getattr(_copy_streams, "by_device", None)
    if streams is None:
        streams = _copy_streams.by_device = {}
    if device.index not in streams:
        streams[device.index] = torch.cuda.Stream(device=device)
    return streams[device.index]


def fetch_to_host(tree, ready: Optional["torch.cuda.Event"] = None):
    """A nested dict / list / tuple of tensors as host numpy arrays
    (other leaves pass through), booked to the wire ledger.

    On the card: wait for ``ready`` (the producer's event, recorded now
    on the current stream when not given) — ``compute_s`` — then copy
    every tensor ``non_blocking`` into pinned host memory on this
    thread's own stream after ``wait_event(ready)``, with
    ``record_stream`` so the caching allocator keeps the source until the
    copy ran, and synchronize that stream — ``d2h_s``.  A worker thread
    copying this way overlaps the caller's next kernels on the default
    stream instead of queueing behind them.  On the CPU the arrays are
    copied (the caller may reuse the tensors) and no ``compute_s`` is
    booked: the producer already ran, so there is no wait to charge, and
    the autotuner, which reads the overlap ratio only when ``compute_s``
    > 0, sizes a CPU run's batches independently of thread timing.

    The d2h retry chokepoint (``pyabc_tpu/sampler/base.py:158``): every
    attempt runs under the shared retry policy at the ``wire.fetch``
    site, on sampler loops and ingest workers alike; a failed attempt
    books no bytes (the ledger commits only on success)."""
    cuda = [t for t in _tensors(tree, []) if t.is_cuda]
    if cuda and ready is None:
        ready = mark_ready(tree)

    def _fetch():
        if cuda:
            t0 = time.perf_counter()
            ready.synchronize()
            transfer.record_compute(time.perf_counter() - t0)
        with spans.span("wire.fetch") as sp, \
                transfer.timed_d2h() as timer:
            if cuda:
                stream = _copy_stream(cuda[0].device)

                def copy(t):
                    if not t.is_cuda:
                        return t.detach().clone()
                    t.record_stream(stream)
                    host = torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True)
                    host.copy_(t, non_blocking=True)
                    return host

                with torch.cuda.stream(stream):
                    stream.wait_event(ready)
                    pinned = _map(tree, copy)
                stream.synchronize()
                out = _map(pinned, lambda t: t.numpy())
            else:
                out = _map(tree, lambda t: t.detach().numpy().copy())
        out = timer.commit(out)
        sp.set(nbytes=transfer.tree_nbytes(out))
        return out

    return _retry.shared_policy().call(_fetch, _faults.SITE_FETCH)


class RoundResult:
    """One batch of B candidates (tensors on the run's device)."""

    def __init__(self, m, theta, distance, accepted, log_weight, stats,
                 valid=None, log_proposal=None):
        self.m = m                    # int64[B]
        self.theta = theta            # float32[B, D]
        self.distance = distance      # float32[B]
        self.accepted = accepted      # bool[B]
        self.log_weight = log_weight  # float32[B]
        self.stats = stats            # float32[B, S]
        #: candidates that count as records (inside the prior support)
        self.valid = valid if valid is not None else accepted
        #: log density of the proposal that generated each candidate: the
        #: prior at t = 0, NaN where the round deferred the density
        self.log_proposal = (log_proposal if log_proposal is not None
                             else torch.zeros_like(log_weight))


class SamplingError(Exception):
    pass


_ROW_KEYS = ("m", "theta", "distance", "log_weight", "stats")
#: the record columns (``rec_<key>`` in the device loop's harvest)
RECORD_KEYS = ("stats", "distance", "accepted", "m", "theta",
               "log_proposal")


def round_rows(rr: RoundResult) -> dict:
    """The columns of a round that :meth:`Sample.append_round` reads on
    the host."""
    return {k: getattr(rr, k) for k in _ROW_KEYS + ("accepted",)}


class Sample:
    """Host-side accumulator over rounds: accepted rows as numpy batches,
    records as device tensors."""

    def __init__(self, record_rejected: bool = False,
                 max_records: int = 1 << 21):
        self.record_rejected = record_rejected
        self.max_records = int(max_records)
        self._acc: List[dict] = []
        self._rec: List[dict] = []
        self._n_recorded = 0
        self.nr_evaluations = 0
        #: ALL acceptances observed, incl. beyond the requested n (for an
        #: acceptance rate unbiased by the batch rounding)
        self.raw_accepted = 0
        #: the accepted rows as device tensors (``m``, ``theta``,
        #: ``distance``, ``log_weight``, ``stats``), when the sampler kept
        #: them: the orchestrator re-evaluates distances from these stats
        #: without an upload
        self.device_population: Optional[dict] = None
        #: the sampler's round is captured as a CUDA graph
        #: (``sampler/device_loop.py``: the first round of a rung runs
        #: eagerly, every later one replays); False for eager rounds
        self.round_graph = False
        #: rounds of this sample that were graph replays
        self.round_replays = 0
        #: the clocks of the sampler's count reads
        #: (``telemetry.phases.RoundClock.row``: ``count_wait_s``,
        #: ``round_host_s``, ``loop_s``, and with the tracer on the
        #: rounds' ``phase_device_s``, ``phase_rounds`` and the captured
        #: finalize's ``finalize_device_s``); empty where the sampler
        #: reads no count
        self.round_clock: dict = {}
        #: log density of the newly fitted proposal at ``(m, theta)``:
        #: host arrays in and out, and the same on device tensors (set by
        #: the orchestrator for the temperature schemes)
        self.transition_log_pdf: Optional[Callable] = None
        self.transition_log_pdf_device: Optional[Callable] = None
        #: the blobs of the accepted rows packed while the card computed
        #: their weights (``Sampler.prepacker``'s handle), or None
        self.prepacked = None
        #: the accepted rows left on the device (``defer_wire_fetch``),
        #: the event their producer completes, and their row count
        self.pending_wire: Optional[dict] = None
        self.pending_ready = None
        self._pending_rows = 0

    def append_round(self, rr: RoundResult, host: Optional[dict] = None):
        """Ingest one round's accepted rows (one host transfer, unless a
        host sampler's task already fetched ``host = fetch_to_host(
        round_rows(rr))``) and, when recording, its valid rows."""
        if host is None:
            host = fetch_to_host(round_rows(rr))
        acc = host["accepted"]
        self.nr_evaluations += int(acc.shape[0])
        self.raw_accepted += int(acc.sum())
        idx = np.nonzero(acc)[0]
        if idx.size:
            self._acc.append({k: host[k][idx] for k in _ROW_KEYS})
        if self.record_rejected:
            valid = torch.nonzero(rr.valid).flatten()
            self.append_record_batch(
                {"rec_" + k: getattr(rr, k)[valid] for k in RECORD_KEYS}
                | {"rec_count": int(valid.numel())})

    def append_device_batch(self, out: dict, n_evals: int, count: int,
                            device_view: Optional[dict] = None):
        """Ingest a generation's compacted accepted buffers: ``out`` holds
        the first ``min(count, n)`` rows as host numpy, ``device_view``
        the same rows on the device."""
        self.nr_evaluations += int(n_evals)
        self.raw_accepted += int(count)
        if out["m"].shape[0]:
            self._acc.append(out)
        if device_view is not None:
            self.device_population = device_view

    def append_pending_wire(self, wire: dict, n_evals: int, count: int,
                            device_view: dict, ready=None):
        """Defer the accepted rows' fetch: ``wire`` (the first
        ``min(count, n)`` rows on the device) stays there for an ingest
        worker or the device store; the accounting is
        :meth:`append_device_batch`'s, and :attr:`n_accepted` counts the
        rows."""
        self.nr_evaluations += int(n_evals)
        self.raw_accepted += int(count)
        self.device_population = device_view
        self.pending_wire = wire
        self.pending_ready = ready
        self._pending_rows = int(wire["m"].shape[0])

    def take_pending_wire(self) -> Optional[dict]:
        """Hand the deferred wire to its new owner; the rows still count
        in :attr:`n_accepted`."""
        wire, self.pending_wire = self.pending_wire, None
        return wire

    def resolve_pending(self):
        """Fetch a deferred wire no one took and ingest it."""
        if self.pending_wire is None:
            return
        out = fetch_to_host(self.take_pending_wire(), self.pending_ready)
        self._pending_rows = 0
        if out["m"].shape[0]:
            self._acc.append(out)

    def splice_front(self, batch: dict, nr_evaluations: int):
        """Prepend rows restored from a mid-generation sub-checkpoint
        (resilience/checkpoint.py): the preempted process flushed them
        in round order BEFORE any row of this sample was drawn, so front
        insertion keeps the round-order truncation.  Evaluations add
        exactly (the flushed rounds ran once, in the killed process), and
        the raw log-weights normalize together in
        :meth:`get_accepted_population`.  The device view covers only
        this process's rows, so it is dropped: device consumers rebuild
        from the host population."""
        self.resolve_pending()
        self._acc.insert(0, batch)
        self.nr_evaluations += int(nr_evaluations)
        self.raw_accepted += int(batch["m"].shape[0])
        self.device_population = None

    def append_record_batch(self, rec: dict):
        """Ingest one record harvest (``rec_<key>`` tensors whose first
        ``rec_count`` rows are filled, in (round, lane) order).  Keeps the
        earliest rows up to ``max_records`` across calls; the kept rows
        are sliced to the exact count (views, no copy).  With a
        ``record_density_fn(m, theta)`` in ``rec`` (rounds that deferred
        the proposal density), the kept rows' ``log_proposal`` is that
        density: one evaluation per batch, bounded by the record budget
        rather than by rounds × batch."""
        if not self.record_rejected:
            return
        rc = min(int(rec["rec_count"]), self.max_records - self._n_recorded)
        if rc <= 0:
            return
        batch = {k: rec["rec_" + k][:rc] for k in RECORD_KEYS}
        density_fn = rec.get("record_density_fn")
        if density_fn is not None:
            batch["log_proposal"] = density_fn(batch["m"], batch["theta"])
        self._rec.append(batch)
        self._n_recorded += rc

    @property
    def n_record_batches(self) -> int:
        """Record batches ingested (one per sampler call that kept
        records)."""
        return len(self._rec)

    @property
    def n_recorded(self) -> int:
        return self._n_recorded

    @property
    def n_accepted(self) -> int:
        return sum(a["m"].shape[0] for a in self._acc) + self._pending_rows

    @property
    def acceptance_rate(self) -> float:
        """Raw acceptances (incl. beyond n) / evaluations."""
        return self.raw_accepted / max(self.nr_evaluations, 1)

    def get_accepted_population(self, n: int) -> Population:
        """First n accepted particles in round order, weights normalized
        in log space (float64) and stored as float32."""
        self.resolve_pending()
        if self.n_accepted < n:
            raise SamplingError(
                f"expected {n} accepted particles, have {self.n_accepted}")
        # the stats are absent when the sampler kept them on the device
        cols = {k: np.concatenate([a[k] for a in self._acc])[:n]
                for k in _ROW_KEYS if all(k in a for a in self._acc)}
        logw = cols["log_weight"]
        logw = logw - logw.max() if logw.size else logw
        w = np.exp(np.asarray(logw, dtype=np.float64))
        s = w.sum()
        if not np.isfinite(s) or s <= 0:
            raise SamplingError("all accepted particles have zero weight")
        return Population(
            m=cols["m"].astype(np.int32), theta=cols["theta"],
            weight=(w / s).astype(np.float32), distance=cols["distance"],
            sum_stats={"__flat__": cols["stats"]} if "stats" in cols else {})

    def get_all_stats(self):
        """Every recorded candidate's stats ``[R, S]`` (rejected ones
        included) on the device; without records, the accepted stats."""
        if self._rec:
            return torch.cat([r["stats"] for r in self._rec])
        if self._acc and all("stats" in a for a in self._acc):
            return np.concatenate([a["stats"] for a in self._acc])
        return np.zeros((0, 0), np.float32)

    def get_records(self, keys=RECORD_KEYS) -> Optional[dict]:
        """The record columns ``keys`` concatenated over calls (device
        tensors), or None without records."""
        if not self._rec:
            return None
        return {k: torch.cat([r[k] for r in self._rec]) for k in keys}

    def get_records_arrays(self, keys=None) -> Optional[dict]:
        """The record columns ``keys`` (default all) as host numpy arrays
        of the exact record count, or None without records: one fetch of
        every requested column (``egress("summary")``).  The ``[R, S]``
        stats block is the big one; ask only for what is read."""
        recs = self.get_records(tuple(keys) if keys is not None
                                else RECORD_KEYS)
        if recs is None:
            return None
        with transfer.egress("summary"):
            return fetch_to_host(recs)

    def get_records_columns(self) -> Optional[Dict[str, np.ndarray]]:
        """Host record columns for the temperature schemes: ``distance``
        (the kernel value), ``transition_pd_prev`` (density of the
        generating proposal), ``transition_pd`` (density of the new
        proposal, through :attr:`transition_log_pdf`) and ``accepted``.
        Both densities are shifted by one constant before ``exp``: the
        schemes read only their ratio."""
        # the schemes never read the [R, S] stats block
        recs = self.get_records(("m", "theta", "distance", "accepted",
                                 "log_proposal"))
        if recs is None:
            return None
        log_prev = recs["log_proposal"].cpu().numpy().astype(np.float64)
        if self.transition_log_pdf is None:
            log_new = log_prev
        else:
            log_new = np.asarray(self.transition_log_pdf(
                recs["m"].cpu().numpy(), recs["theta"].cpu().numpy()),
                dtype=np.float64)
        finite = np.concatenate([log_prev[np.isfinite(log_prev)],
                                 log_new[np.isfinite(log_new)]])
        shift = finite.max() if finite.size else 0.0
        return {
            "distance": recs["distance"].cpu().numpy().astype(np.float64),
            "transition_pd_prev": np.exp(log_prev - shift),
            "transition_pd": np.exp(log_new - shift),
            "accepted": recs["accepted"].cpu().numpy().astype(bool),
        }

    def get_records_device(self) -> Optional[dict]:
        """Device record columns for the temperature schemes: ``log_dens``
        (the kernel value) and ``log_ratio`` (log new-proposal density −
        log generating density, through :attr:`transition_log_pdf_device`).
        Reads nothing back to the host; None without records or without
        the device density."""
        if not self._rec or self.transition_log_pdf_device is None:
            return None
        recs = self.get_records(("m", "theta", "distance", "log_proposal"))
        log_new = self.transition_log_pdf_device(recs["m"], recs["theta"])
        return {"log_dens": recs["distance"],
                "log_ratio": log_new - recs["log_proposal"]}

    def get_all_records(self) -> List[dict]:
        """The reference's list-of-dicts view of
        :meth:`get_records_columns`: one dict per record, O(R) Python —
        nothing in this package calls it, and above 1e5 records it warns
        and points at the column view."""
        cols = self.get_records_columns()
        if cols is None:
            return []
        n = cols["distance"].shape[0]
        if n > 100_000:
            warnings.warn(
                f"Sample.get_all_records materializes {n} per-record "
                "dicts (O(R) Python); use get_records_columns() for "
                "vectorized access at this scale", RuntimeWarning,
                stacklevel=2)
        return [{k: v[i].item() for k, v in cols.items()}
                for i in range(n)]


class Sampler:
    """Abstract sampler."""

    def __init__(self):
        self.nr_evaluations_ = 0
        #: record every valid candidate (set by configure_sampler of a
        #: distance that adapts to them)
        self.record_rejected = False
        #: records must carry their generating proposal's density (set
        #: with record_rejected by a temperature that reads the records)
        self.record_proposal_density = False
        #: cap on recorded candidates per generation (the orchestrator
        #: sets it from ABCSMC.max_nr_recorded_particles)
        self.max_records = 1 << 21
        #: copy the accepted stats to the host; the orchestrator clears it
        #: when nothing reads them there (no History blob, no refit over
        #: accepted stats) and they stay on the device
        self.fetch_stats = True
        #: bounded-backoff retry policy every device dispatch of a
        #: sampler loop routes through (:meth:`_dispatch`)
        self._retry = _retry.RetryPolicy.from_env()
        #: mid-generation sub-checkpoint sink, set by the sequential run
        #: path for one generation (resilience/checkpoint.py); None = off
        self.checkpointer = None
        #: ``rows -> handle``: set by the sequential run path for one
        #: generation whose eager History write takes blobs packed ahead
        #: (``History.prepack``); a sampler that fetches the accepted
        #: rows eagerly calls it with the host columns the finalize does
        #: not change, before the finalize, and keeps the handle on the
        #: ``Sample`` (:attr:`Sample.prepacked`); None = off
        self.prepacker = None
        #: render a per-generation bar over the accepted count (set from
        #: ``ABCSMC(show_progress=)``)
        self.show_progress = False

    def _dispatch(self, fn, *args, rng=None, restore=None):
        """THE device-dispatch chokepoint of a sampler loop: transient
        failures retry with backoff, injected faults have one site
        (``device.dispatch``), and ``rng``/``restore`` make a retry the
        same dispatch (resilience/retry.py)."""
        return self._retry.call(fn, _faults.SITE_DISPATCH, *args, rng=rng,
                                restore=restore)

    def sample_until_n_accepted(self, n: int, round_fn, generator, params,
                                max_eval: float = np.inf,
                                all_accepted: bool = False,
                                defer_wire_fetch: bool = False) -> Sample:
        raise NotImplementedError

    def stop(self):
        """Teardown hook: release what the sampler holds (the reference's
        interface; a no-op here)."""
