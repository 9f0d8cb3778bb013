"""Device-resident population store: keep accepted generations on the
card, ship summaries.

Port of ``pyabc_tpu/wire/store.py``.  In ``history_mode="lazy"`` the
engines deposit each generation's wire — the tensors that would have been
fetched — into a :class:`DeviceRunStore`, a ring of
``$PYABC_TPU_STORE_GENS`` (default 12) generations keyed by ``t``, and the
host receives only a posterior summary packet of O(KB) (weighted moments,
ESS, per-model mass and count, distance extremes), booked under
``egress("summary")``.

A full population leaves the card only on request: :func:`hydrate_entry`
fetches the wire under ``egress("history")`` and replays the decode the
eager path used, so the result is the same bits.  Two decodes exist, as
in the JAX package, because the engines normalize differently:

- ``norm="sample"`` — a sequential generation's deferred wire, through
  ``Sample.get_accepted_population`` (float32 max-shift, float64 exp);
- ``norm="stream"`` — a device engine's generation, through
  ``wire.ingest.split_gen_wire`` and ``batch_to_population`` (float64
  max-shift).

Entries the ring pushes out land on a spill queue that the History
drains on its own thread (sqlite connections are thread-affine, and
deposits come from ingest workers): the store never touches the
database.

Durability contract (``resilience/journal.py``): with a
:class:`~pyabc_tpu_torch.resilience.journal.SpillJournal` attached,
``deposit`` write-aheads an O(100 B) manifest record before
acknowledging, and the moment a generation becomes *at risk* — evicted
from the ring, or still resident during a preemption flush
(:meth:`DeviceRunStore.journal_tail`) — its wire bytes are fetched once
(a fetch that is complete before the record is framed and fsynced) and
journaled BEFORE anything consumes them.  Every deposit also records a
content digest (shape/dtype manifest at deposit, bytes CRC completed at
first host contact) that :func:`entry_host_wire` verifies on every
decode; a mismatch raises ``IntegrityError`` for the History's recovery
ladder.  The ``store.deposit``, ``store.spill`` and ``store.hydrate``
fault sites sit at those three points.

Opt-in ``$PYABC_TPU_SUMMARY_GRID``: a sequential generation's lazy row
also keeps its 1-D posterior compressed to the device grid
(:func:`maybe_summary_grid`).
"""

from __future__ import annotations

import logging
import math
import os
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from . import transfer

logger = logging.getLogger("ABC.Wire")

#: ring capacity (resident generations)
STORE_GENS_ENV = "PYABC_TPU_STORE_GENS"
#: the default ``history_mode`` of ``ABCSMC`` (lazy | eager)
HISTORY_MODE_ENV = "PYABC_TPU_HISTORY_MODE"
#: "1" keeps a grid-compressed 1-D posterior with each sequential lazy row
SUMMARY_GRID_ENV = "PYABC_TPU_SUMMARY_GRID"

#: wire lanes of the summary packet, computed on the device
SUMMARY_LANE_KEYS = ("sm_ess", "sm_mean", "sm_var", "sm_mw", "sm_mn",
                     "sm_dmin", "sm_dmean")
#: control lanes of a one-dispatch wire (never population data): a
#: deposit strips them
CONTROL_LANE_KEYS = ("live",)


def default_max_gens() -> int:
    """Ring capacity from ``$PYABC_TPU_STORE_GENS`` (default 12)."""
    try:
        return max(int(os.environ.get(STORE_GENS_ENV, "12")), 1)
    except ValueError:
        return 12


# ---------------------------------------------------------------- summary

def summary_wire_lanes(m, theta, distance, log_weight, valid, M: int
                       ) -> dict:
    """The summary packet's device half over one generation's accepted
    rows (``valid`` marks the rows below the count): the weights
    normalized as the fused carry does (float32 max-shift over valid
    finite rows)."""
    neg_inf = torch.full_like(log_weight, -math.inf)
    lw_max = torch.where(valid & torch.isfinite(log_weight), log_weight,
                         neg_inf).max()
    lw_max = torch.where(torch.isfinite(lw_max), lw_max,
                         torch.zeros_like(lw_max))
    zero = torch.zeros_like(log_weight)
    w_un = torch.where(valid, torch.exp(log_weight - lw_max), zero)
    w = w_un / torch.clamp(w_un.sum(), min=1e-38)
    mean = (w[:, None] * theta).sum(0)
    var = (w[:, None] * torch.square(theta - mean[None, :])).sum(0)
    ess = 1.0 / torch.clamp((w * w).sum(), min=1e-38)
    one_hot = m[:, None] == torch.arange(M, device=m.device)[None, :]
    mw = torch.where(one_hot, w[:, None], zero[:, None]).sum(0)
    mn = (one_hot & valid[:, None]).sum(0).to(torch.int32)
    dmin = torch.where(valid, distance,
                       torch.full_like(distance, math.inf)).min()
    dmean = torch.where(valid, w * distance, zero).sum()
    return {"sm_ess": ess, "sm_mean": mean, "sm_var": var, "sm_mw": mw,
            "sm_mn": mn, "sm_dmin": dmin, "sm_dmean": dmean}


def summary_from_lanes(host: dict) -> dict:
    """Fetched ``sm_*`` lanes as the JSON-able summary packet; model
    masses renormalized in float64 (one model stores exactly 1.0)."""
    mw = np.asarray(host["sm_mw"], dtype=np.float64).reshape(-1)
    total = mw.sum()
    if np.isfinite(total) and total > 0:
        mw = mw / total
    return {
        "ess": float(np.asarray(host["sm_ess"])),
        "mean": np.asarray(host["sm_mean"],
                           dtype=np.float64).reshape(-1).tolist(),
        "var": np.asarray(host["sm_var"],
                          dtype=np.float64).reshape(-1).tolist(),
        "model_w": mw.tolist(),
        "model_n": np.asarray(host["sm_mn"],
                              dtype=np.int64).reshape(-1).tolist(),
        "dist_min": float(np.asarray(host["sm_dmin"])),
        "dist_mean": float(np.asarray(host["sm_dmean"])),
    }


def summarize_device_population(dp: dict, M: int) -> dict:
    """The summary packet of a sequential generation's accepted rows on
    the device (``Sample.device_population``, all rows valid), fetched
    under ``egress("summary")``."""
    from ..sampler.base import fetch_to_host
    m = dp["m"]
    valid = torch.ones(m.shape[0], dtype=torch.bool, device=m.device)
    lanes = summary_wire_lanes(m, dp["theta"], dp["distance"],
                               dp["log_weight"], valid, M)
    with transfer.egress("summary"):
        host = fetch_to_host(lanes)
    return summary_from_lanes(host)


def summary_grid_enabled() -> bool:
    return os.environ.get(SUMMARY_GRID_ENV, "0").lower() in (
        "1", "true", "on", "yes")


def maybe_summary_grid(dp: dict) -> Optional[dict]:
    """The population's 1-D posterior on the device grid
    (``sampler/fused.py:_compress_support_device``) when
    ``$PYABC_TPU_SUMMARY_GRID`` is on: ``{"grid_centroid",
    "grid_log_mass"}`` host arrays of the grid's cells, or None (off, or
    the parameter space is not 1-D).  ``dp`` is a sequential
    generation's accepted rows (``Sample.device_population``: every row
    valid)."""
    if not summary_grid_enabled():
        return None
    theta = dp["theta"]
    if theta.ndim != 2 or theta.shape[1] != 1:
        return None
    from ..sampler.base import fetch_to_host
    from ..sampler.fused import _compress_support_device

    valid = torch.ones(theta.shape[0], dtype=torch.bool,
                       device=theta.device)
    log_w = dp["log_weight"]
    lw = torch.where(torch.isfinite(log_w), log_w,
                     torch.full_like(log_w, -math.inf))
    lw_max = lw.max()
    lw_max = torch.where(torch.isfinite(lw_max), lw_max,
                         torch.zeros_like(lw_max))
    w_un = torch.exp(log_w - lw_max)
    w = w_un / torch.clamp(w_un.sum(), min=1e-38)
    sup, log_mass, _ = _compress_support_device(
        theta, w, valid, torch.ones((1, 1), dtype=theta.dtype,
                                    device=theta.device))
    with transfer.egress("summary"):
        host = fetch_to_host({"grid_centroid": sup[:, 0],
                              "grid_log_mass": log_mass})
    return {k: np.asarray(v) for k, v in host.items()}


# ---------------------------------------------------------------- decode

def _population_wire(entry: dict) -> dict:
    """The entry's decodable lanes (the summary ``sm_*`` and telemetry
    ``tl_*`` lanes carry no population bytes)."""
    return {k: v for k, v in entry["wire"].items()
            if not k.startswith(("sm_", "tl_"))}


def entry_host_wire(entry: dict) -> dict:
    """Generation bytes on the host, fetched at most once per entry:
    the journaled copy when the spill path already paid the d2h, else a
    fetch under ``egress("history")`` that completes the entry's content
    digest (CRC at first host contact).  The result passes the
    ``store.hydrate`` fault site and is digest-verified — corruption
    between fetch and decode raises ``IntegrityError``."""
    from ..resilience import faults as _faults
    from ..resilience.journal import crc_of, verify_wire
    from ..sampler.base import fetch_to_host

    out = entry.get("host_wire")
    fresh = False
    if out is None:
        with transfer.egress("history"):
            out = fetch_to_host(_population_wire(entry), entry.get("ready"))
        digest = entry.get("digest")
        if digest is not None and digest.get("crc") is None:
            entry["digest"] = digest = dict(digest, crc=crc_of(out))
            fresh = True
    seen = _faults.fault_point(_faults.SITE_STORE_HYDRATE, data=out)
    digest = entry.get("digest")
    if fresh and seen is out:
        # the CRC was just taken of these very arrays: a second pass
        # over them checks nothing (the JAX package takes it anyway);
        # the manifest is still checked, and bytes a fault plan swapped
        # in get the full check
        digest = dict(digest, crc=None)
    verify_wire(seen, digest, t=entry.get("t", -2), where="store.hydrate")
    return seen


def hydrate_entry(entry: dict):
    """One deposited generation on the host, decoded as the eager path
    decodes it (the entry's ``norm``): a round-order
    :class:`~pyabc_tpu_torch.population.Population`, or None when its
    weights are degenerate.  The bytes come from
    :func:`entry_host_wire`."""
    from ..sampler.base import Sample
    from .ingest import SCALAR_KEYS, batch_to_population, split_gen_wire

    out = entry_host_wire(entry)
    if entry["norm"] == "sample":
        batch = {k: v for k, v in out.items() if k not in SCALAR_KEYS}
        smp = Sample()
        if batch["m"].shape[0]:
            smp._acc.append(batch)
        return smp.get_accepted_population(entry["n"])
    batch, _, _, _ = split_gen_wire(out, entry["n"])
    return batch_to_population(batch)


# ------------------------------------------------------------------ store

class DeviceRunStore:
    """Bounded ring of device-resident generations.

    ``deposit`` is thread-safe (ingest workers call it); what the ring
    pushes out lands on the spill queue, which the History drains on its
    thread.  ``hydrate`` decodes an entry without removing it; the owner
    ``drop``s it once durable, or ``drop_from`` a pipelined rewind's
    frontier."""

    def __init__(self, max_gens: Optional[int] = None):
        self.max_gens = int(max_gens) if max_gens else default_max_gens()
        self._entries: "OrderedDict[int, dict]" = OrderedDict()
        self._spills: list = []
        self._lock = threading.RLock()
        self.deposits = 0
        self.evictions = 0
        self.hydrations = 0
        #: optional write-ahead SpillJournal (resilience/journal.py);
        #: journal calls happen outside the store lock
        self.journal = None

    def attach_journal(self, journal):
        """Arm the durability contract: deposits write-ahead manifest
        records, evictions and preemption flushes journal the bytes
        before they become the generation's only copy."""
        self.journal = journal

    def deposit(self, t: int, wire: dict, *, n: int, count: int,
                eps: Optional[float] = None, norm: str = "stream",
                ready=None):
        """Park generation ``t``'s wire (``ready``: its producer's CUDA
        event).  A repeat deposit of ``t`` replaces the entry.  With a
        journal the deposit is acknowledged only after its manifest
        record is durable, and an entry the ring evicts has its bytes
        journaled before it joins the spill queue."""
        from ..resilience import faults as _faults
        from ..resilience.journal import manifest_of

        _faults.fault_point(_faults.SITE_STORE_DEPOSIT)
        wire = {k: v for k, v in wire.items() if k not in CONTROL_LANE_KEYS}
        entry = {"t": int(t), "wire": wire, "n": int(n), "count": int(count),
                 "eps": None if eps is None else float(eps),
                 "norm": str(norm), "ready": ready,
                 "nbytes": transfer.tree_nbytes(wire)}
        entry["digest"] = {"crc": None,
                           "manifest": manifest_of(_population_wire(entry))}
        journal = self.journal
        if journal is not None:
            journal.append_manifest({
                "t": entry["t"], "n": entry["n"], "count": entry["count"],
                "eps": entry["eps"], "norm": entry["norm"],
                "nbytes": entry["nbytes"], "digest": entry["digest"]})
        evicted = []
        with self._lock:
            self._entries.pop(int(t), None)
            self._entries[int(t)] = entry
            self.deposits += 1
            while len(self._entries) > self.max_gens:
                t_old, old = self._entries.popitem(last=False)
                evicted.append(old)
                self.evictions += 1
                logger.info("device store: evicting gen %d to the spill "
                            "queue (%d resident)", t_old,
                            len(self._entries))
        for old in evicted:
            # outside the lock: the spill fetch and the fsync'd journal
            # write must not serialize concurrent deposits
            self._journal_spill(old)
            with self._lock:
                self._spills.append(old)

    def _journal_spill(self, entry: dict) -> bool:
        """Write an at-risk entry's bytes ahead (``store.spill`` site,
        retried).  On success the entry carries ``host_wire`` and a
        completed digest; on exhausted retries it stays a device-only
        spill and the run continues."""
        journal = self.journal
        if journal is None or entry.get("host_wire") is not None:
            return entry.get("host_wire") is not None
        from ..resilience import faults as _faults
        from ..resilience.retry import RetryExhausted, shared_policy
        try:
            shared_policy().call(self._spill_once, _faults.SITE_STORE_SPILL,
                                 entry, journal)
            return True
        except RetryExhausted:
            logger.exception(
                "device store: could not journal spilled gen %d — it "
                "remains device-only until materialization", entry["t"])
            from ..telemetry.flight import RECORDER
            RECORDER.note("spill_unjournaled", t=entry["t"])
            return False

    @staticmethod
    def _spill_once(entry: dict, journal):
        from ..parallel.mesh import host_shard_slice, world
        from ..sampler.base import fetch_to_host

        rank, size = world()
        if size > 1:
            # pod posture (``pyabc_tpu/wire/store.py:440-454``): journal
            # only this rank's rows, with no cross-rank traffic.  The
            # port's wire is replicated, so the shard is a slice of the
            # whole; recovery reassembles the generation rank-major from
            # the sibling journals (``resilience/journal.py``
            # pod_pending), and the entry keeps its deposit-time GLOBAL
            # manifest so a later hydration of the whole wire verifies
            wire = _population_wire(entry)
            rows = int(wire["m"].shape[0])
            cut = host_shard_slice(None, rows)
            shard_wire = {k: (v[cut] if v.dim() >= 1
                              and v.shape[0] == rows else v)
                          for k, v in wire.items()}
            with transfer.egress("history"):
                shard = fetch_to_host(shard_wire, entry.get("ready"))
            journal.append_payload(
                entry["t"], shard,
                {"n": entry["n"], "count": entry["count"],
                 "eps": entry["eps"], "norm": entry["norm"],
                 "shard": [rank, size],
                 "global_manifest": entry["digest"]["manifest"]})
            entry["host_shard"] = shard
            return
        # the fetch has completed (its copy stream synchronized) before
        # the bytes are framed and fsynced
        with transfer.egress("history"):
            host_wire = fetch_to_host(_population_wire(entry),
                                      entry.get("ready"))
        entry["digest"] = journal.append_payload(
            entry["t"], host_wire,
            {"n": entry["n"], "count": entry["count"],
             "eps": entry["eps"], "norm": entry["norm"]})
        entry["host_wire"] = host_wire

    def journal_tail(self, deadline: Optional[float] = None) -> int:
        """Preemption barrier, phase 1: journal the bytes of every
        un-journaled generation (resident ring + spill queue), NEWEST
        first.  ``deadline`` is an absolute ``time.monotonic`` stop;
        returns how many generations were journaled."""
        import time as _time
        if self.journal is None:
            return 0
        with self._lock:
            candidates = sorted(
                list(self._entries.values()) + list(self._spills),
                key=lambda e: e["t"], reverse=True)
        done = 0
        for entry in candidates:
            if deadline is not None and _time.monotonic() >= deadline:
                logger.warning(
                    "preemption barrier: deadline hit after journaling "
                    "%d/%d generations", done, len(candidates))
                break
            if self.journal.has_payload(entry["t"]):
                continue
            if self._journal_spill(entry):
                done += 1
        return done

    def entry(self, t: int) -> Optional[dict]:
        """The live entry of generation ``t`` (shared, not a copy): the
        History's recovery ladder re-decodes from it."""
        with self._lock:
            return self._entries.get(int(t))

    def has(self, t: int) -> bool:
        with self._lock:
            return int(t) in self._entries

    def resident_ts(self) -> list:
        with self._lock:
            return sorted(self._entries)

    def entry_meta(self, t: int) -> Optional[dict]:
        with self._lock:
            e = self._entries.get(int(t))
            if e is None:
                return None
            return {k: e[k] for k in ("t", "n", "count", "eps", "norm",
                                      "nbytes")}

    def hydrate(self, t: int):
        """Generation ``t`` decoded on the host (None when not resident);
        the entry stays."""
        with self._lock:
            entry = self._entries.get(int(t))
        if entry is None:
            return None
        pop = hydrate_entry(entry)
        with self._lock:
            self.hydrations += 1
        return pop

    def take_spills(self) -> list:
        """Hand the evicted entries to the caller; clears the queue."""
        with self._lock:
            spills, self._spills = self._spills, []
            return spills

    def requeue_spills(self, entries: list):
        """Put back spills a drain could not materialize yet (their
        summary rows are not appended): at the front, they are older."""
        if entries:
            with self._lock:
                self._spills = list(entries) + self._spills

    def drop(self, t: int) -> bool:
        with self._lock:
            return self._entries.pop(int(t), None) is not None

    def drop_from(self, t: int) -> int:
        """Drop every entry with generation >= ``t``, resident or
        spilled; returns how many."""
        with self._lock:
            stale = [k for k in self._entries if k >= int(t)]
            for k in stale:
                del self._entries[k]
            n_spill = len(self._spills)
            self._spills = [e for e in self._spills if e["t"] < int(t)]
            return len(stale) + n_spill - len(self._spills)

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._spills = []

    def manifest(self) -> dict:
        """JSON-able snapshot: what is resident and what awaits a
        drain."""
        with self._lock:
            out = {
                "max_gens": self.max_gens, "deposits": self.deposits,
                "evictions": self.evictions,
                "resident": [self.entry_meta(t) for t in self._entries],
                "spill_pending": [e["t"] for e in self._spills]}
        if self.journal is not None:
            out["journaled"] = [
                t for t in sorted({*[m["t"] for m in out["resident"]],
                                   *out["spill_pending"]})
                if self.journal.has_payload(t)]
        return out
