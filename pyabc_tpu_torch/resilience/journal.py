"""Write-ahead spill journal + content digests for the lazy History.

Port of ``pyabc_tpu/resilience/journal.py``, its pod functions
included (``_pod_suffix``, :func:`pod_sibling_dirs`,
:func:`merge_shard_wires`, :func:`pod_pending`: each rank of a
``torch.distributed`` pod journals its own rows into an ``h<rank>``
directory, and recovery reassembles whole generations from them).
In ``history_mode="lazy"`` accepted populations stay on the card
(``wire/store.py``) and the sqlite History keeps blob-less ``lazy=1``
summary rows until something asks for real bytes.  Between a deposit and
its materialization the generation's only copy lives in device memory
(the ring) or the spill queue, both of which die with the process.  This
module is the durability contract's mechanical half:

- :class:`SpillJournal` — an append-only, fsync'd, CRC-framed journal
  under ``<db>.journal/``.  Deposits write an O(100 B) **manifest
  record** before the store acknowledges; the moment a generation
  becomes *at risk* (evicted from the ring, or resident during a
  preemption flush) its wire bytes go in as a **payload record** BEFORE
  anything else happens to them.  ``storage/history.py`` appends a
  tombstone after the sqlite commit, and segments whose payloads are all
  materialized are deleted on :meth:`compact`.

- content digests (:func:`digest_wire` / :func:`verify_wire`) — a
  per-generation bytes CRC plus a shape/dtype manifest, recorded at
  deposit (shapes/dtypes) and completed at the wire's first host contact
  (CRC), then checked at every later decode.  A mismatch raises the
  typed :class:`IntegrityError` that ``storage/history.py`` resolves
  down its recovery ladder instead of fitting a posterior to corrupt
  bytes.

Record framing (little-endian), byte for byte the JAX package's, so a
journal either package writes is read by the other::

    b"PJN1" | u32 header_len | u32 payload_len | u32 crc32(hdr+payload)
           | header JSON | payload

Payload arrays ride the PTW1 container (``wire/transfer.py:
encode_array``), one length-prefixed frame per key.  A torn tail
(partial record at EOF after a crash) ends the segment scan; a CRC-bad
record with intact framing is skipped and counted
(``resilience_journal_bad_records_total``).
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import zlib
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger("ABC.Resilience")

_HELP = "spill journal; see resilience/journal.py"

#: hard off-switch for the journal (lazy mode then keeps its pre-journal
#: semantics: an unmaterialized generation dies with the process)
JOURNAL_ENV = "PYABC_TPU_JOURNAL"
#: override the default ``<db>.journal`` directory (also arms journaling
#: for in-memory DBs, which is what the chaos tests use)
JOURNAL_DIR_ENV = "PYABC_TPU_JOURNAL_DIR"
#: skip the per-append fsync (benchmarking only; the journal is then
#: crash-*consistent* but no longer crash-*durable*)
JOURNAL_FSYNC_ENV = "PYABC_TPU_JOURNAL_FSYNC"

_MAGIC = b"PJN1"
_HDR = struct.Struct("<III")  # header_len, payload_len, crc32

#: roll the active segment past this size so compaction can reclaim
#: materialized payloads without rewriting live ones
SEGMENT_BYTES = 64 * 1024 * 1024


class IntegrityError(RuntimeError):
    """Checksummed hydration failed: the bytes decoded for a generation
    do not match the digest recorded when they were deposited/packed.
    Carries the generation (``t``, -2 = unknown) and the boundary that
    caught it (``where``).  Deliberately NOT transient for
    ``resilience/retry.py`` — re-reading the same corrupt bytes cannot
    help; recovery is the History's ladder (journal re-read -> DB
    fallback -> degrade to eager mode)."""

    def __init__(self, msg: str, t: int = -2, where: str = ""):
        super().__init__(msg)
        self.t = int(t)
        self.where = where


def _counter(name: str):
    from ..telemetry.metrics import REGISTRY
    return REGISTRY.counter(name, _HELP)


def _gauge(name: str):
    from ..telemetry.metrics import REGISTRY
    return REGISTRY.gauge(name, _HELP)


# ---------------------------------------------------------------- digests

def _dtype_str(dtype) -> str:
    """The numpy dtype string of a numpy or torch dtype."""
    if isinstance(dtype, np.dtype) or not hasattr(dtype, "is_floating_point"):
        return np.dtype(dtype).str
    import torch
    return torch.empty((), dtype=dtype).numpy().dtype.str


def manifest_of(wire: Dict) -> Dict[str, list]:
    """Shape/dtype manifest of a (device or host) wire dict — computable
    at deposit time without touching a byte; a tensor and its host copy
    give the same manifest."""
    return {k: [_dtype_str(v.dtype), [int(x) for x in v.shape]]
            for k, v in sorted(wire.items())}


def crc_of(wire: Dict[str, np.ndarray]) -> int:
    """Packed-bytes CRC over a HOST wire dict: crc32 chained over the
    sorted keys and their raw buffers, so any flipped bit (or swapped
    column) changes the digest."""
    crc = 0
    for k in sorted(wire):
        crc = zlib.crc32(k.encode("utf-8"), crc)
        crc = zlib.crc32(np.ascontiguousarray(wire[k]).tobytes(), crc)
    return crc & 0xFFFFFFFF


def digest_wire(host_wire: Dict[str, np.ndarray]) -> dict:
    """Full content digest of a host wire: CRC + shape/dtype manifest."""
    return {"crc": crc_of(host_wire), "manifest": manifest_of(host_wire)}


def verify_wire(host_wire: Dict[str, np.ndarray],
                digest: Optional[dict], *, t: int = -2,
                where: str = "hydrate") -> None:
    """Check a decoded host wire against its recorded digest; raises
    :class:`IntegrityError` on any mismatch.  A digest whose ``crc`` is
    still None (the wire never left the device before) only has its
    manifest checked.  Every call books one
    ``store_integrity_checks_total``; failures additionally book
    ``store_integrity_failures_total`` and a flight-recorder event."""
    if not digest:
        return
    _counter("store_integrity_checks_total").inc()
    mismatch = None
    want_man = digest.get("manifest")
    if want_man is not None:
        got = json.dumps(manifest_of(host_wire), sort_keys=True)
        want = json.dumps({k: [v[0], list(v[1])]
                           for k, v in want_man.items()}, sort_keys=True)
        if got != want:
            mismatch = f"shape/dtype manifest mismatch ({where})"
    want_crc = digest.get("crc")
    if mismatch is None and want_crc is not None:
        if crc_of(host_wire) != int(want_crc):
            mismatch = f"packed-bytes CRC mismatch ({where})"
    if mismatch is None:
        return
    _counter("store_integrity_failures_total").inc()
    from ..telemetry.flight import RECORDER
    RECORDER.note("integrity", t=int(t), where=where, detail=mismatch)
    raise IntegrityError(
        f"generation {t}: {mismatch} — refusing to hand corrupt bytes "
        f"to the posterior", t=t, where=where)


# ---------------------------------------------------------------- journal

def journal_enabled() -> bool:
    return os.environ.get(JOURNAL_ENV, "1").lower() not in (
        "0", "off", "false", "no")


def _fsync_enabled() -> bool:
    return os.environ.get(JOURNAL_FSYNC_ENV, "1").lower() not in (
        "0", "off", "false", "no")


def _pod_suffix() -> str:
    """Per-rank namespace under a ``torch.distributed`` world of more
    than one rank (``pyabc_tpu/resilience/journal.py:179``): pod ranks
    may share a filesystem, so each journals into its own
    ``h<rank>`` subdirectory — shard-local bytes, no cross-rank
    clobbering, and the sibling layout :func:`pod_sibling_dirs`
    reassembles whole generations from."""
    from ..parallel.mesh import world
    rank, size = world()
    return f"h{rank:03d}" if size > 1 else ""


def journal_dir_for(db_path: str, in_memory: bool) -> Optional[str]:
    """Resolve the journal directory for a History: the env override
    wins, else ``<db>.journal`` next to a file-backed DB; None (journal
    off) for in-memory DBs without an override or when disabled.  Under
    a multi-rank pod every rank gets its own ``h<rank>`` subdirectory of
    the resolved location."""
    if not journal_enabled():
        return None
    override = os.environ.get(JOURNAL_DIR_ENV, "").strip()
    base = override or (None if in_memory else db_path + ".journal")
    if base is None:
        return None
    suffix = _pod_suffix()
    return os.path.join(base, suffix) if suffix else base


def purge_for_db(db_path: str):
    """Remove the spill-journal directory of a retired file-backed DB
    (``<db>.journal``): once a finished run's DB is deleted, its journal
    (only useful for resuming that run) must not outlive it.  No-op when
    journaling is off or redirected elsewhere by ``PYABC_TPU_JOURNAL_DIR``
    (a shared override directory may hold other runs' segments)."""
    if os.environ.get(JOURNAL_DIR_ENV, "").strip():
        return
    base = db_path + ".journal"
    if os.path.isdir(base):
        import shutil
        shutil.rmtree(base, ignore_errors=True)


def pod_sibling_dirs(directory: str) -> list:
    """All per-rank journal directories of the pod run ``directory``
    belongs to, rank-major (``h000``, ``h001``, ...); ``[directory]``
    when it is not pod-namespaced.  Only meaningful on a filesystem the
    ranks share — ranks with private disks see their own shard."""
    head, tail = os.path.split(os.path.normpath(directory))
    if not (len(tail) == 4 and tail[0] == "h" and tail[1:].isdigit()):
        return [directory]
    try:
        sibs = sorted(n for n in os.listdir(head)
                      if len(n) == 4 and n[0] == "h" and n[1:].isdigit()
                      and os.path.isdir(os.path.join(head, n)))
    except OSError:
        return [directory]
    return [os.path.join(head, n) for n in sibs] or [directory]


def merge_shard_wires(shards: list, global_manifest: Optional[dict]
                      ) -> Dict[str, np.ndarray]:
    """One generation's whole host wire from per-rank shard payloads
    (rank-major order).  Row lanes are concatenated, replicated lanes
    (scalars, summary lanes) taken from the first shard; the
    deposit-time GLOBAL manifest decides which is which: a key whose
    recorded leading dim differs from the shard's is row-sharded.  The
    caller verifies the merged wire against that manifest."""
    first = shards[0]
    out: Dict[str, np.ndarray] = {}
    for k in sorted(first):
        want = (global_manifest or {}).get(k)
        v0 = np.asarray(first[k])
        sharded = (want is not None and len(want[1]) >= 1
                   and v0.ndim >= 1
                   and int(want[1][0]) != int(v0.shape[0]))
        if sharded:
            out[k] = np.concatenate(
                [np.asarray(s[k]) for s in shards], axis=0)
        else:
            out[k] = v0
    return out


def pod_pending(journal) -> Dict[int, dict]:
    """``journal.pending()``, pod-aware: when the journal lives in a
    per-rank ``h<rank>`` namespace, scan every sibling rank's journal
    and reassemble whole generations from their shard payloads
    (rank-major row concat, :func:`merge_shard_wires`).  A generation
    missing a shard is logged and left out (its summary row is then
    purged, as any unrecoverable loss).  Merged entries carry a
    manifest-only digest, the deposit-time GLOBAL manifest: each shard's
    CRC was checked by its own ``pending()`` scan."""
    dirs = pod_sibling_dirs(journal.dir)
    if len(dirs) <= 1:
        return journal.pending()
    mine = os.path.normpath(journal.dir)
    per = []
    for d in dirs:
        j = journal if os.path.normpath(d) == mine else SpillJournal(d)
        per.append(j.pending())
    out: Dict[int, dict] = {}
    for t in sorted(set().union(*map(set, per))):
        recs = [p[t] for p in per if t in p]
        shards = sorted((r for r in recs if r.get("shard")),
                        key=lambda r: int(r["shard"][0]))
        if not shards:
            out[t] = recs[0]  # un-sharded payload (a one-rank write)
            continue
        want = int(shards[0]["shard"][1])
        if len(shards) < want:
            _counter("resilience_journal_bad_records_total").inc()
            logger.warning(
                "pod journal replay: generation %d has %d/%d shard "
                "payload(s) — left for purge", t, len(shards), want)
            continue
        gm = shards[0].get("global_manifest")
        out[t] = {
            "t": t, "n": shards[0]["n"], "count": shards[0]["count"],
            "eps": shards[0]["eps"], "norm": shards[0]["norm"],
            "host_wire": merge_shard_wires(
                [r["host_wire"] for r in shards], gm),
            "digest": {"crc": None, "manifest": gm} if gm else None,
        }
    return out


def _pack_payload(host_wire: Dict[str, np.ndarray], keys) -> bytes:
    from ..wire import transfer as _transfer
    frames = []
    for k in keys:
        blob = _transfer.encode_array(np.asarray(host_wire[k]))
        frames.append(struct.pack("<I", len(blob)))
        frames.append(blob)
    return b"".join(frames)


def _unpack_payload(payload: bytes, keys) -> Dict[str, np.ndarray]:
    from ..wire import transfer as _transfer
    out, off = {}, 0
    for k in keys:
        (n,) = struct.unpack_from("<I", payload, off)
        off += 4
        out[k] = _transfer.decode_array(payload[off:off + n])
        off += n
    if off != len(payload):
        raise ValueError("journal payload has trailing bytes")
    return out


class SpillJournal:
    """Append-only CRC-framed write-ahead journal for lazy generations.

    Thread-safe: deposits come from ingest workers while the History
    tombstones on the sqlite thread.  All appends go through one fault
    site (``journal.write``) so the chaos harness can raise, delay,
    kill, or bit-flip exactly here.
    """

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.RLock()
        self._fh = None
        self._seg = 0
        #: generations tombstoned (materialized) — union of what is on
        #: disk and what this process marked
        self._mat = set()
        #: generation -> segment index of its newest payload record
        self._payload_seg: Dict[int, int] = {}
        self._bootstrap()

    # -- segment bookkeeping ------------------------------------------------

    def _seg_path(self, i: int) -> str:
        return os.path.join(self.dir, f"seg-{i:06d}.wal")

    def _segments(self) -> list:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        segs = []
        for n in names:
            if n.startswith("seg-") and n.endswith(".wal"):
                try:
                    segs.append(int(n[4:-4]))
                except ValueError:
                    continue
        return sorted(segs)

    def _bootstrap(self):
        """Continue after the highest existing segment; index payloads
        and tombstones so ``pending``/``compact`` need no rescan."""
        segs = self._segments()
        for i in segs:
            for rec, payload in self._scan(self._seg_path(i)):
                if rec.get("kind") == "mat":
                    self._mat.add(int(rec["t"]))
                elif rec.get("kind") == "payload":
                    self._payload_seg[int(rec["t"])] = i
        self._seg = (segs[-1] + 1) if segs else 0
        self._open_segment()
        self._update_gauge()

    def _open_segment(self):
        if self._fh is not None:
            self._fh.close()
        self._fh = open(self._seg_path(self._seg), "ab")

    def _update_gauge(self):
        _gauge("resilience_journal_mb").set(self.size_bytes() / 1e6)

    def size_bytes(self) -> int:
        total = 0
        for i in self._segments():
            try:
                total += os.path.getsize(self._seg_path(i))
            except OSError:
                pass
        return total

    # -- appends ------------------------------------------------------------

    def _append(self, header: dict, payload: bytes = b""):
        """Frame + CRC + write + (fsync'd) ack — THE durability point,
        behind the shared retry policy (a transient disk hiccup must
        not fail a deposit).  Note ``journal.write`` gets TWO fault
        visits per append: the retry boundary's attempt-start hook and
        the data hook carrying the framed bytes (the one ``corrupt=N``
        plans bit-flip — exactly what lands on disk)."""
        from . import faults as _faults
        from .retry import shared_policy
        shared_policy().call(self._append_once, _faults.SITE_JOURNAL,
                             header, payload)

    def _append_once(self, header: dict, payload: bytes):
        from . import faults as _faults
        hdr = json.dumps(header, sort_keys=True).encode("utf-8")
        crc = zlib.crc32(hdr + payload) & 0xFFFFFFFF
        frame = (_MAGIC + _HDR.pack(len(hdr), len(payload), crc)
                 + hdr + payload)
        frame = _faults.fault_point(_faults.SITE_JOURNAL, data=frame)
        with self._lock:
            self._fh.write(frame)
            self._fh.flush()
            if _fsync_enabled():
                os.fsync(self._fh.fileno())
            _counter("resilience_journal_writes_total").inc()
            _counter("resilience_journal_bytes_total").inc(len(frame))
            if self._fh.tell() > SEGMENT_BYTES:
                self._seg += 1
                self._open_segment()
            self._update_gauge()

    def append_manifest(self, meta: dict):
        """Deposit-time manifest record (O(100 B)): generation ``t``
        existed with this shape — a later recovery can say WHAT a hard
        kill lost even when the bytes never made it off the device."""
        self._append({"kind": "manifest", **meta})

    def append_payload(self, t: int, host_wire: Dict[str, np.ndarray],
                       meta: dict) -> dict:
        """Write generation ``t``'s packed wire bytes ahead of whatever
        put them at risk.  Returns the content digest recorded with the
        record (callers carry it into the store entry)."""
        keys = sorted(host_wire)
        digest = digest_wire(host_wire)
        payload = _pack_payload(host_wire, keys)
        self._append({"kind": "payload", "t": int(t), "keys": keys,
                      "digest": digest, **meta}, payload)
        with self._lock:
            self._payload_seg[int(t)] = self._seg
            self._mat.discard(int(t))
        return digest

    def has_payload(self, t: int) -> bool:
        with self._lock:
            return int(t) in self._payload_seg \
                and int(t) not in self._mat

    def mark_materialized(self, t: int):
        """Tombstone generation ``t`` — call AFTER the sqlite commit
        that made its blobs durable (write-ahead on the way in,
        truncate-behind on the way out)."""
        with self._lock:
            if int(t) in self._mat:
                return
            self._mat.add(int(t))
        self._append({"kind": "mat", "t": int(t)})

    # -- scans / recovery ---------------------------------------------------

    def _scan(self, path: str):
        """Yield ``(header, payload)`` per intact record.  Stops at a
        torn tail; skips (and counts) CRC-bad records whose framing is
        still intact."""
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return
        off, n = 0, len(data)
        while off + 4 + _HDR.size <= n:
            if data[off:off + 4] != _MAGIC:
                _counter("resilience_journal_torn_total").inc()
                logger.warning("journal %s: bad magic at offset %d — "
                               "ending segment scan", path, off)
                return
            hlen, plen, crc = _HDR.unpack_from(data, off + 4)
            start = off + 4 + _HDR.size
            end = start + hlen + plen
            if end > n:
                _counter("resilience_journal_torn_total").inc()
                logger.warning(
                    "journal %s: torn tail at offset %d (crash mid-"
                    "append) — %d trailing bytes ignored", path, off,
                    n - off)
                return
            blob = data[start:end]
            if zlib.crc32(blob) & 0xFFFFFFFF != crc:
                _counter("resilience_journal_bad_records_total").inc()
                logger.warning("journal %s: CRC-bad record at offset "
                               "%d — skipped", path, off)
                off = end
                continue
            try:
                header = json.loads(blob[:hlen].decode("utf-8"))
            except ValueError:
                _counter("resilience_journal_bad_records_total").inc()
                off = end
                continue
            yield header, blob[hlen:]
            off = end

    def pending(self) -> Dict[int, dict]:
        """Un-materialized payload records as store-entry-shaped dicts:
        ``{t: {t, n, count, eps, norm, host_wire, digest}}``.  Each
        payload is CRC-framed on disk AND digest-checked here, so a
        replayed generation is exactly what was journaled."""
        with self._lock:
            mat = set(self._mat)
        out: Dict[int, dict] = {}
        for i in self._segments():
            for rec, payload in self._scan(self._seg_path(i)):
                kind = rec.get("kind")
                if kind == "mat":
                    mat.add(int(rec["t"]))
                    out.pop(int(rec["t"]), None)
                    continue
                if kind != "payload":
                    continue
                t = int(rec["t"])
                try:
                    wire = _unpack_payload(payload, rec["keys"])
                    verify_wire(wire, rec.get("digest"), t=t,
                                where="journal.replay")
                except Exception as err:
                    # one bad payload (incl. a digest mismatch the
                    # frame CRC somehow missed) costs one generation's
                    # replay, not the whole recovery
                    _counter(
                        "resilience_journal_bad_records_total").inc()
                    logger.warning("journal payload for t=%d "
                                   "undecodable (%s) — skipped", t, err)
                    continue
                out[t] = {
                    "t": t, "n": int(rec.get("n", 0)),
                    "count": int(rec.get("count", 0)),
                    "eps": rec.get("eps"),
                    "norm": rec.get("norm", "sample"),
                    "host_wire": wire,
                    "digest": rec.get("digest"),
                }
                if rec.get("shard") is not None:
                    # a pod shard payload holds one rank's rows;
                    # pod_pending() reassembles the generation
                    out[t]["shard"] = [int(rec["shard"][0]),
                                       int(rec["shard"][1])]
                    out[t]["global_manifest"] = rec.get(
                        "global_manifest")
        for t in mat:
            out.pop(t, None)
        return out

    def compact(self):
        """Delete segments whose payload records are all materialized.
        The active segment rolls first when it qualifies, so a clean
        run end leaves an empty directory."""
        with self._lock:
            live = {t for t, _ in self._payload_seg.items()
                    if t not in self._mat}
            segs = self._segments()
            removed = 0
            for i in segs:
                seg_live = any(
                    seg == i and t in live
                    for t, seg in self._payload_seg.items())
                if seg_live:
                    continue
                if i == self._seg:
                    if self._fh.tell() == 0:
                        continue  # already empty, keep as active
                    self._seg += 1
                    self._open_segment()
                try:
                    os.remove(self._seg_path(i))
                    removed += 1
                except OSError:
                    continue
                for t in [t for t, seg in self._payload_seg.items()
                          if seg == i]:
                    del self._payload_seg[t]
            if removed:
                _counter("resilience_journal_truncations_total").inc(
                    removed)
            self._update_gauge()

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def journal_for_history(history) -> Optional["SpillJournal"]:
    """Build (or decline to build) the journal for a History: file-backed
    DBs journal next to the DB, in-memory DBs only under an explicit
    ``PYABC_TPU_JOURNAL_DIR``."""
    directory = journal_dir_for(history.db_path, history.in_memory)
    if directory is None:
        return None
    try:
        return SpillJournal(directory)
    except OSError:
        logger.exception("spill journal unavailable at %s — lazy mode "
                         "continues without write-ahead durability",
                         directory)
        return None
