"""Host<->device transfer and overlap accounting: the wire's ledger.

Port of the ledger half of ``pyabc_tpu/wire/transfer.py``.  Process-wide
counters in the telemetry registry (``telemetry.metrics.REGISTRY``, the
JAX package's ``wire_*`` names, under its lock) that the single
device-to-host chokepoint (``sampler.base.fetch_to_host``) and the
streaming-ingest engine increment, so that wire bytes and the time the host spends waiting on
them are machine-visible per generation (``ABCSMC.generation_transfer``)
and feed the batch autotuner's margin.

Ledger keys (cumulative since process start):

- ``d2h_bytes`` / ``d2h_calls`` / ``h2d_bytes`` — raw wire volume.
- ``compute_s`` — seconds a fetch waited for the PRODUCING computation
  before any byte moved.  On the card this is the host's wait on a
  ``torch.cuda.Event`` recorded on the producing stream right after the
  producer's kernels were queued (``sampler.base.mark_ready``); on the
  CPU the producer has finished when the fetch starts and it is 0.
  The JAX package books the same wait from ``block_until_ready``; its
  dispatch returns at once, so its wait covers the whole device program,
  while a port block is a Python loop that reads each round's loop
  condition and has nearly finished by the time its wire is fetched.
- ``d2h_s`` / ``fetch_s`` — the copy alone: after the event, from the
  start of the ``non_blocking`` copies into pinned host buffers on the
  fetch's own stream to that stream's synchronize (one counter, two
  names, as in the JAX package).
- ``decode_s`` — host-side decode seconds (the port has no narrow wire
  codec: nothing books here yet; kept so both ledgers have one layout).
- ``overlap_s`` — fetch seconds a background ingest worker spent while
  the caller thread was not blocked on them (``wire.streaming``).
- ``rewinds`` — speculative generations the pipelined engine discarded
  (``ABCSMC._run_pipelined``'s ``rewind_to_frontier``).
- ``collective_s`` — host seconds in cross-process collectives
  (``parallel.mesh.all_gather_rows``: a sharded round's rows); 0 in a
  one-process run.

``snapshot()``/``delta()`` also report the derived ``d2h_mb_per_s``.
Every fetched byte is attributed to one ``EGRESS_SUBSYSTEMS`` bucket, the
calling thread's :func:`egress` label (``population`` by default).

The PTW1 blob codec (:func:`encode_array` / :func:`decode_array`) is
here too: History packs every blob with it (the same bytes as the JAX
package's) unless ``$PYABC_TPU_WIRE_CODEC`` says ``raw``
(:func:`wire_codec`), and reads both forms.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from contextlib import contextmanager
from typing import Optional

import numpy as np

from ..telemetry.metrics import REGISTRY

#: ledger keys, in the order snapshots report them; ``d2h_s`` and
#: ``fetch_s`` read the same counter
_KEYS = ("d2h_bytes", "d2h_s", "d2h_calls", "h2d_bytes", "compute_s",
         "fetch_s", "decode_s", "overlap_s", "rewinds", "collective_s")
_INT_KEYS = frozenset({"d2h_bytes", "d2h_calls", "h2d_bytes", "rewinds"})
#: the registry counter behind each key (the JAX package's names)
_METRIC = {
    "d2h_bytes": "wire_d2h_bytes_total",
    "d2h_s": "wire_fetch_seconds_total",
    "d2h_calls": "wire_d2h_calls_total",
    "h2d_bytes": "wire_h2d_bytes_total",
    "compute_s": "wire_compute_seconds_total",
    "fetch_s": "wire_fetch_seconds_total",
    "decode_s": "wire_decode_seconds_total",
    "overlap_s": "wire_overlap_seconds_total",
    "rewinds": "wire_rewinds_total",
    "collective_s": "wire_collective_seconds_total",
}

#: d2h egress subsystems: every fetched byte is booked to one of them
EGRESS_SUBSYSTEMS = ("population", "history", "checkpoint", "summary",
                     "control", "telemetry", "other")

_HELP = "wire ledger; see wire/transfer.py"
#: the registry lock — held by ``snapshot()`` reads and counter writes
_lock = REGISTRY._lock
_egress_tls = threading.local()


def _c(name: str):
    # create-or-return each call: survives REGISTRY.reset() in tests
    return REGISTRY.counter(name, _HELP)


def current_egress() -> str:
    """The subsystem the calling thread's next d2h bytes are booked to."""
    return getattr(_egress_tls, "label", "population")


@contextmanager
def egress(subsystem: str):
    """Book d2h bytes this thread records inside the block to
    ``subsystem`` (an unknown name books to ``other``)."""
    if subsystem not in EGRESS_SUBSYSTEMS:
        subsystem = "other"
    prev = current_egress()
    _egress_tls.label = subsystem
    try:
        yield
    finally:
        _egress_tls.label = prev


def egress_breakdown() -> dict:
    """Cumulative d2h bytes per subsystem; sums to ``d2h_bytes``."""
    with _lock:
        return {name: int(_c(f"wire_egress_{name}_bytes_total").value)
                for name in EGRESS_SUBSYSTEMS}


def record_d2h(nbytes: int, seconds: float):
    with _lock:
        _c("wire_d2h_bytes_total").inc(int(nbytes))
        _c("wire_fetch_seconds_total").inc(float(seconds))
        _c("wire_d2h_calls_total").inc()
        _c(f"wire_egress_{current_egress()}_bytes_total").inc(int(nbytes))


def record_h2d(nbytes: int):
    _c("wire_h2d_bytes_total").inc(int(nbytes))


def record_compute(seconds: float):
    """Charge a fetch's wait on its producer."""
    _c("wire_compute_seconds_total").inc(float(seconds))


def record_decode(seconds: float):
    _c("wire_decode_seconds_total").inc(float(seconds))


def record_overlap(seconds: float):
    """Credit fetch seconds a background worker spent while the caller
    thread was not waiting on them."""
    _c("wire_overlap_seconds_total").inc(float(seconds))


def record_rewind(count: int = 1):
    """Count speculative generations a pipeline rewind discarded."""
    _c("wire_rewinds_total").inc(int(count))


def record_collective(seconds: float):
    """Charge a host-side cross-process synchronization
    (``pyabc_tpu/wire/transfer.py:181``).  Under gloo the seconds are
    the whole exchange; under NCCL the host's share of the call (the
    gather itself runs on the card's stream).  The fleet rollup reads it
    as ``collective_s_per_gen``."""
    _c("wire_collective_seconds_total").inc(float(seconds))


def _read(key: str):
    v = _c(_METRIC[key]).value
    return int(v) if key in _INT_KEYS else float(v)


def _derived(d: dict) -> dict:
    d["d2h_mb_per_s"] = (d["d2h_bytes"] / 1e6 / d["fetch_s"]
                         if d["fetch_s"] > 1e-9 else 0.0)
    return d


def snapshot() -> dict:
    with _lock:
        return _derived({k: _read(k) for k in _KEYS})


def delta(before: dict, after: dict = None) -> dict:
    """Counter difference ``after - before`` (``after`` defaults to now),
    with ``d2h_mb_per_s`` over the window."""
    after = after if after is not None else snapshot()
    return _derived({k: after[k] - before.get(k, 0) for k in _KEYS})


def tree_nbytes(tree) -> int:
    """Bytes of the arrays in a nested dict / list / tuple."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    return int(getattr(tree, "nbytes", 0))


class timed_d2h:
    """Times one device-to-host transaction; ``commit(tree)`` books the
    tree's bytes and the seconds.  The caller waits for the producer
    before entering, so the seconds are the copy alone."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False

    def commit(self, tree):
        record_d2h(tree_nbytes(tree), self.seconds)
        return tree


# ---- the PTW1 blob codec ----------------------------------------------
#
# ``PTW1`` + a little-endian u32 header length + a JSON header (dtype,
# shape, codec) + a zlib payload.  Codec "delta" stores a wrapping
# same-width unsigned delta along axis 0 (exactly invertible), "plain"
# the raw bytes.

WIRE_CODEC_ENV = "PYABC_TPU_WIRE_CODEC"
_CODEC_MAGIC = b"PTW1"
_UINT_FOR_SIZE = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def wire_codec() -> str:
    """The storage codec from ``$PYABC_TPU_WIRE_CODEC``, read per call:
    ``delta`` (the default) or ``raw`` (plain ``.npy`` History blobs)."""
    v = os.environ.get(WIRE_CODEC_ENV, "delta").lower()
    return "raw" if v in ("raw", "off", "none", "0") else "delta"


def encode_array(arr: np.ndarray, codec: Optional[str] = None) -> bytes:
    """One array as a self-describing PTW1 blob.  ``codec`` (default
    :func:`wire_codec`) ``"delta"`` deltas along axis 0 before
    compression; any other codec, and arrays the delta cannot help (0-d,
    single-row, exotic itemsizes), are stored plain."""
    shape = np.asarray(arr).shape  # before ascontiguousarray: it
    arr = np.ascontiguousarray(arr)  # promotes 0-d to (1,)
    if arr.dtype.hasobject:
        raise ValueError("object arrays cannot ride the wire codec")
    codec = codec or wire_codec()
    u_dtype = _UINT_FOR_SIZE.get(arr.dtype.itemsize)
    if codec == "delta" and u_dtype is not None and arr.ndim >= 1 \
            and arr.shape[0] >= 2:
        u = arr.view(u_dtype)
        d = np.empty_like(u)
        d[0] = u[0]
        np.subtract(u[1:], u[:-1], out=d[1:])  # wraps mod 2^width
        used, payload = "delta", d.tobytes()
    else:
        used, payload = "plain", arr.tobytes()
    header = json.dumps({"dtype": arr.dtype.str, "shape": list(shape),
                         "codec": used}).encode("ascii")
    return (_CODEC_MAGIC + struct.pack("<I", len(header)) + header
            + zlib.compress(payload, 1))


def is_ptw1(blob: bytes) -> bool:
    return bytes(blob[:4]) == _CODEC_MAGIC


def decode_array(blob: bytes) -> np.ndarray:
    """Exact inverse of :func:`encode_array` (bit-identical)."""
    if not is_ptw1(blob):
        raise ValueError("not a PTW1 codec blob")
    (hlen,) = struct.unpack("<I", blob[4:8])
    meta = json.loads(bytes(blob[8:8 + hlen]).decode("ascii"))
    raw = zlib.decompress(bytes(blob[8 + hlen:]))
    dtype = np.dtype(meta["dtype"])
    shape = tuple(meta["shape"])
    if meta["codec"] == "delta":
        d = np.frombuffer(raw, dtype=_UINT_FOR_SIZE[dtype.itemsize]
                          ).reshape(shape)
        # a cumsum in the same unsigned width wraps mod 2^width: the
        # exact inverse of the wrapping delta
        return np.cumsum(d, axis=0, dtype=d.dtype).view(dtype)
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
