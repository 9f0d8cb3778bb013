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

Not ported (ROADMAP): the spill journal, the deposit digest and its CRC
check at hydration, the fault sites, and the opt-in
``$PYABC_TPU_SUMMARY_GRID`` packet.
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


# ---------------------------------------------------------------- decode

def _population_wire(entry: dict) -> dict:
    """The entry's lanes other than the summary's."""
    return {k: v for k, v in entry["wire"].items()
            if not k.startswith("sm_")}


def hydrate_entry(entry: dict):
    """One deposited generation on the host, decoded as the eager path
    decodes it (the entry's ``norm``): a round-order
    :class:`~pyabc_tpu_torch.population.Population`, or None when its
    weights are degenerate.  The fetch is booked to
    ``egress("history")``."""
    from ..sampler.base import Sample, fetch_to_host
    from .ingest import SCALAR_KEYS, batch_to_population, split_gen_wire

    with transfer.egress("history"):
        out = fetch_to_host(_population_wire(entry), entry.get("ready"))
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

    def deposit(self, t: int, wire: dict, *, n: int, count: int,
                eps: Optional[float] = None, norm: str = "stream",
                ready=None):
        """Park generation ``t``'s wire (``ready``: its producer's CUDA
        event).  A repeat deposit of ``t`` replaces the entry."""
        wire = {k: v for k, v in wire.items() if k not in CONTROL_LANE_KEYS}
        entry = {"t": int(t), "wire": wire, "n": int(n), "count": int(count),
                 "eps": None if eps is None else float(eps),
                 "norm": str(norm), "ready": ready,
                 "nbytes": transfer.tree_nbytes(wire)}
        with self._lock:
            self._entries.pop(int(t), None)
            self._entries[int(t)] = entry
            self.deposits += 1
            while len(self._entries) > self.max_gens:
                t_old, old = self._entries.popitem(last=False)
                self._spills.append(old)
                self.evictions += 1
                logger.info("device store: evicting gen %d to the spill "
                            "queue (%d resident)", t_old,
                            len(self._entries))

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
            return {
                "max_gens": self.max_gens, "deposits": self.deposits,
                "evictions": self.evictions,
                "resident": [self.entry_meta(t) for t in self._entries],
                "spill_pending": [e["t"] for e in self._spills]}
