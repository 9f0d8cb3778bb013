"""Wire decode and population assembly shared by every ingest site: fused
blocks, one-dispatch runs, the pipelined engine and a sequential
generation's deferred wire.

Port of ``pyabc_tpu/wire/ingest.py``.  The port has no narrow wire codec:
a generation's wire is its float32 tensors (the model index int64) and
the decode is the host copy.  :func:`batch_to_population` normalizes the
log weights with the JAX package's float64 max-shift, so a population
assembled here and one hydrated from the device store with
``norm="stream"`` (``wire.store.hydrate_entry``) are the same bits.
"""

from __future__ import annotations

import numpy as np

from ..population import Population

#: per-generation scalar lanes of a wire (not population rows)
SCALAR_KEYS = ("count", "rounds", "eps")


def slice_block_wire(wires: dict, k: int) -> dict:
    """Generation ``k`` of a wire stacked over a block (leading axis)."""
    return {key: v[k] for key, v in wires.items()}


def split_gen_wire(out: dict, n: int):
    """One fetched generation's ``(batch, count, rounds, eps)``: the
    population lanes (``eps`` None without an eps lane).  ``n`` is the
    population size the rows were cut to on the device."""
    batch = {key: v for key, v in out.items()
             if key not in SCALAR_KEYS and not key.startswith("sm_")}
    count = int(np.asarray(out["count"]))
    rounds = int(np.asarray(out["rounds"]))
    eps = (float(np.asarray(out["eps"], dtype=np.float64))
           if "eps" in out else None)
    return batch, count, rounds, eps


def split_block_wire(wires: dict, K: int, n: int):
    """A fetched K-generation wire as ``(gens, counts, rounds, eps)``:
    each generation's batch and the K-long scalar lanes (``eps`` None
    without an eps lane)."""
    parts = [split_gen_wire(slice_block_wire(wires, k), n)
             for k in range(K)]
    eps = (None if parts[0][3] is None
           else np.asarray([p[3] for p in parts], np.float64))
    return ([p[0] for p in parts], np.asarray([p[1] for p in parts]),
            np.asarray([p[2] for p in parts]), eps)


def split_single_wire(out: dict, n: int):
    """A sequential generation's fetched deferred wire (its rows, no
    scalar lanes) in :func:`split_block_wire`'s layout with K = 1."""
    rows = int(out["m"].shape[0])
    return [out], np.asarray([rows]), None, None


def _fetch_gen(gen_wire: dict, n: int, ready):
    from ..sampler.base import fetch_to_host
    return split_gen_wire(fetch_to_host(gen_wire, ready), n)


class GenStream:
    """Per-generation fetch of one K-generation block wire on a
    :class:`~.streaming.StreamingIngest` engine.

    At most one ticket is in flight per stream: :meth:`result` resolves
    generation ``k`` and submits ``k + 1``, so the next generation's copy
    drains on the worker while the caller appends this one, and a block
    holds at most one of the engine's depth slots.  The wire's CUDA event
    is recorded once, when the stream is made right after the block: each
    generation's fetch waits on the block's own kernels, never on later
    work the caller queues.

    ``fetch(k, gen_wire, n, ready) -> (payload, count, rounds, eps)``
    replaces the default fetch-and-split (the lazy History deposits the
    generation in the device store and fetches only its summary lanes).
    """

    def __init__(self, engine, wires: dict, K: int, n: int, label: str,
                 fetch=None):
        from ..sampler.base import mark_ready
        self._engine = engine
        self._wires = wires
        self._K = K
        self._n = n
        self._label = label
        self._fetch = fetch if fetch is not None else (
            lambda k, gw, n_rows, ready: _fetch_gen(gw, n_rows, ready))
        self._ready = mark_ready(wires)
        self._next = 0
        self._ticket = None
        self._submit()

    def _submit(self):
        if self._next >= self._K:
            self._ticket = None
            self._wires = None  # release the block's tensors
            return
        k = self._next
        gw = slice_block_wire(self._wires, k)
        self._ticket = self._engine.submit(
            lambda f=self._fetch, k=k, gw=gw, n=self._n, r=self._ready:
            f(k, gw, n, r), label=f"{self._label}+{k}")
        self._next += 1

    def result(self):
        """The next generation's ``(payload, count, rounds, eps)``; queues
        the one after it."""
        out = self._ticket.result()
        self._submit()
        return out

    def abandon(self):
        """Drop the stream: the in-flight ticket is abandoned and the
        generations not yet submitted are never fetched."""
        if self._ticket is not None:
            self._ticket.abandon()
            self._ticket = None
        self._wires = None


def batch_to_population(batch: dict):
    """A host batch as a :class:`Population` with weights normalized by
    a float64 max-shift; None when every weight is zero."""
    lw = np.asarray(batch["log_weight"], dtype=np.float64)
    lw = lw - lw.max()
    w = np.exp(lw)
    w_sum = w.sum()
    if not (np.isfinite(w_sum) and w_sum > 0):
        return None
    return Population(
        m=np.asarray(batch["m"]).astype(np.int32), theta=batch["theta"],
        weight=(w / w_sum).astype(np.float32), distance=batch["distance"],
        sum_stats=({"__flat__": batch["stats"]} if "stats" in batch
                   else {}))
