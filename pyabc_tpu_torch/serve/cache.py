"""Content-addressed study cache: digest → posterior summary, tiered.

Port of ``pyabc_tpu/serve/cache.py`` (host code, copied).

Duplicate submissions are the cheapest studies to serve: the digest
(:func:`pyabc_tpu_torch.serve.spec.study_digest`) covers everything that can
move the posterior, so a digest hit IS the result — no queue slot, no
dispatch, no device time.  The worker keys entries by
``<digest>.<engine>`` (the two serving engines are statistically but
not bitwise equivalent, so entries never alias across them); these
classes are agnostic to the key's composition.

Two tiers (docs/serving.md "Data plane"):

- **tier-1** (:class:`StudyCache`) — a bounded in-memory LRU private
  to one worker, with per-worker directory persistence (one JSON file
  per key) so a restarted worker re-serves its own history.  The
  spill write is atomic (write-then-rename, the queue's crash-safety
  contract) and CRC-framed, so a SIGKILL mid-spill can never leave a
  torn file that poisons restart warmth — a bad frame reads as a
  miss and is unlinked.
- **tier-2** (:class:`SharedResultStore`) — a shared content-
  addressed store on the serve mount, published on study completion,
  so *any* worker serves *any* tenant's duplicate warm, not just the
  worker that first ran it.  Publishes are write-then-hardlink with
  single-writer-wins semantics on digest collision (two workers
  finishing the same digest concurrently: the first publish is the
  entry, the loser discards its copy — the engines are deterministic
  per digest, so either copy is correct; first-wins just makes the
  choice stable).  Reads are CRC-verified and fall back to dispatch
  on corruption (the corrupt file is unlinked so the next completion
  republishes).

:class:`TieredStudyCache` composes them: get walks t1 → t2
(promoting a t2 hit into t1), put inserts into t1 and publishes to
t2.  Hit/miss/eviction counters land in the ``serve_*`` telemetry
namespace (fleet snapshots, ``abc-top``, ``/api/serve``, Prometheus
``pyabc_tpu_serve_*``), with per-tier hit counters feeding the
``serve_cache_hit_ratio_t1``/``_t2`` gauges.

Capacity knob: ``PYABC_TPU_SERVE_CACHE_SIZE`` (tier-1 entries,
default 64).  Tier-2 is unbounded by count (entries are small summary
JSONs; retention is the operator's mount policy).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import zlib
from collections import OrderedDict
from typing import Optional, Tuple

from ..telemetry.metrics import REGISTRY

#: cache capacity env knob (tier-1 entries)
CACHE_SIZE_ENV = "PYABC_TPU_SERVE_CACHE_SIZE"

_DEFAULT_CAPACITY = 64


def cache_capacity() -> int:
    try:
        return max(int(os.environ.get(CACHE_SIZE_ENV,
                                      str(_DEFAULT_CAPACITY))), 1)
    except ValueError:
        return _DEFAULT_CAPACITY


# ---------------------------------------------------------------------------
# CRC framing, shared by both tiers' on-disk entries
# ---------------------------------------------------------------------------

def _frame(summary: dict) -> str:
    """Serialize a summary with a CRC32 over its canonical JSON — the
    frame a reader can verify without trusting the filesystem."""
    body = json.dumps(summary, sort_keys=True)
    return json.dumps({"crc": zlib.crc32(body.encode("utf-8")),
                       "summary": json.loads(body)})


def _unframe(text: str) -> Optional[dict]:
    """Decode a framed entry; ``None`` on a torn/corrupt/legacy file
    (any byte flip moves the CRC)."""
    try:
        payload = json.loads(text)
        body = json.dumps(payload["summary"], sort_keys=True)
        if zlib.crc32(body.encode("utf-8")) != int(payload["crc"]):
            return None
        return payload["summary"]
    except (ValueError, KeyError, TypeError):
        return None


def _write_frame(root: str, summary: dict) -> str:
    """Write a framed entry to a fresh tmp file under ``root`` and
    return its path — the caller renames (tier-1 spill) or hardlinks
    (tier-2 publish) it into place."""
    fd, tmp = tempfile.mkstemp(dir=root, suffix=".tmp")
    with os.fdopen(fd, "w", encoding="utf-8") as f:
        f.write(_frame(summary))
    return tmp


class StudyCache:
    """Tier-1: bounded LRU of study results keyed by content digest.

    ``get`` counts a hit or a miss (instance ledger + the ``serve_*``
    registry counters); ``put`` inserts and optionally persists.  A
    memory miss falls through to the persistence directory before
    counting as a miss — a warm DISK is still a served duplicate.
    Spill files are CRC-framed and written atomically (module
    docstring): a torn or bit-flipped spill reads as a miss and is
    unlinked, never served.
    """

    #: lock-discipline contract, enforced by `abc-lint`
    _GUARDED_BY = {"_entries": "_lock", "_hits": "_lock",
                   "_misses": "_lock", "_evictions": "_lock"}

    def __init__(self, capacity: Optional[int] = None,
                 root: Optional[str] = None):
        self.capacity = (cache_capacity() if capacity is None
                         else max(int(capacity), 1))
        self.root = root
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        if root:
            os.makedirs(os.path.join(root), exist_ok=True)

    # ---- persistence -----------------------------------------------------

    def _path(self, digest: str) -> Optional[str]:
        return None if not self.root else os.path.join(
            self.root, f"{digest}.json")

    def _load_persisted(self, digest: str) -> Optional[dict]:
        path = self._path(digest)
        if path is None or not os.path.exists(path):
            return None
        try:
            with open(path, encoding="utf-8") as f:
                summary = _unframe(f.read())
        except UnicodeDecodeError:
            summary = None  # bit rot past valid utf-8: corrupt
        except OSError:
            return None
        if summary is None:
            # torn/corrupt spill: poison for restart warmth — unlink
            # so the next put rewrites a clean frame
            REGISTRY.counter(
                "serve_cache_spill_corrupt_total",
                "tier-1 spill files that failed CRC verification").inc()
            try:
                os.unlink(path)
            except OSError:
                pass
        return summary

    def _persist(self, digest: str, summary: dict):
        path = self._path(digest)
        if path is None:
            return
        try:
            tmp = _write_frame(self.root, summary)
            os.replace(tmp, path)  # atomic on POSIX
        except OSError:
            pass  # persistence is an optimization, never a failure

    # ---- core ------------------------------------------------------------

    def get(self, digest: str) -> Optional[dict]:
        with self._lock:
            entry = self._entries.get(digest)
            if entry is not None:
                self._entries.move_to_end(digest)
                self._hits += 1
                REGISTRY.counter(
                    "serve_cache_hits_total",
                    "duplicate studies served from the content-"
                    "addressed cache").inc()
                return dict(entry)
        persisted = self._load_persisted(digest)
        with self._lock:
            if persisted is not None:
                self._insert_locked(digest, persisted)
                self._hits += 1
                REGISTRY.counter(
                    "serve_cache_hits_total",
                    "duplicate studies served from the content-"
                    "addressed cache").inc()
                return dict(persisted)
            self._misses += 1
            REGISTRY.counter(
                "serve_cache_misses_total",
                "study digests not found in the cache").inc()
            return None

    def put(self, digest: str, summary: dict) -> str:
        """Insert; returns the tier the entry landed in (``"t1"`` —
        the lifecycle trace's ``published(tier)`` field)."""
        with self._lock:
            self._insert_locked(digest, dict(summary))
        self._persist(digest, summary)
        return "t1"

    def _insert_locked(self, digest: str, summary: dict):
        self._entries[digest] = summary
        self._entries.move_to_end(digest)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self._evictions += 1
            REGISTRY.counter(
                "serve_cache_evictions_total",
                "study results dropped by the cache LRU").inc()

    def stats(self) -> dict:
        with self._lock:
            looked = self._hits + self._misses
            return {
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "size": len(self._entries),
                "capacity": self.capacity,
                "hit_ratio": (self._hits / looked) if looked else 0.0,
            }


class SharedResultStore:
    """Tier-2: shared content-addressed result store on the serve
    mount (module docstring).  One CRC-framed JSON file per cache key;
    publish is atomic with single-writer-wins on collision; reads
    verify the frame and treat corruption as a miss (unlinking the bad
    file so a future completion republishes)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.json")

    def publish(self, key: str, summary: dict) -> bool:
        """Publish a completed study's summary; returns ``True`` if
        this call created the entry, ``False`` on a digest collision
        (an equal-digest study finished first — first writer wins and
        this copy is discarded) or a filesystem error (publishing is
        an optimization, never a failure)."""
        path = self._path(key)
        if os.path.exists(path):
            REGISTRY.counter(
                "serve_cache_t2_collisions_total",
                "tier-2 publishes dropped because an equal-digest "
                "entry already existed (first writer won)").inc()
            return False
        tmp = None
        try:
            tmp = _write_frame(self.root, summary)
            # hardlink publish: link(2) fails with EEXIST instead of
            # overwriting, so two racing publishers resolve to exactly
            # one winner with no torn intermediate state
            try:
                os.link(tmp, path)
            except FileExistsError:
                REGISTRY.counter(
                    "serve_cache_t2_collisions_total",
                    "tier-2 publishes dropped because an equal-digest "
                    "entry already existed (first writer won)").inc()
                return False
            except OSError:
                # mount without hardlinks: fall back to rename (still
                # atomic; the racing window collapses to last-wins,
                # which is equally correct — both copies verify)
                os.replace(tmp, path)
                tmp = None
            REGISTRY.counter(
                "serve_cache_t2_published_total",
                "study results published into the shared tier-2 "
                "store").inc()
            return True
        except OSError:
            return False
        finally:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    def get(self, key: str) -> Optional[dict]:
        path = self._path(key)
        try:
            with open(path, encoding="utf-8") as f:
                summary = _unframe(f.read())
        except UnicodeDecodeError:
            summary = None  # bit rot past valid utf-8: corrupt
        except OSError:
            return None
        if summary is None:
            # CRC mismatch: serve nothing from a corrupt entry — fall
            # back to dispatch and make room for a clean republish
            REGISTRY.counter(
                "serve_cache_t2_corrupt_total",
                "tier-2 entries that failed CRC verification").inc()
            try:
                os.unlink(path)
            except OSError:
                pass
        return summary

    def verify_all(self) -> Tuple[int, int]:
        """Walk the store and CRC-check every entry — the chaos
        soak's integrity probe.  Returns ``(ok, corrupt)``; corrupt
        entries are left in place (``get`` unlinks on demand)."""
        ok = corrupt = 0
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return (0, 0)
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.root, name),
                          encoding="utf-8") as f:
                    good = _unframe(f.read()) is not None
            except UnicodeDecodeError:
                good = False
            except OSError:
                continue
            if good:
                ok += 1
            else:
                corrupt += 1
        return (ok, corrupt)

    def size(self) -> int:
        try:
            return sum(1 for n in os.listdir(self.root)
                       if n.endswith(".json"))
        except OSError:
            return 0


class TieredStudyCache:
    """The worker's cache surface: tier-1 LRU in front of the shared
    tier-2 store.  ``lookup`` reports WHICH tier hit so the worker can
    label ``served_from`` (``cache`` = tier-1, ``cache_t2`` = shared
    store); a t2 hit is promoted into t1 so the next duplicate on
    this worker is a t1 hit."""

    def __init__(self, capacity: Optional[int] = None,
                 root: Optional[str] = None,
                 shared_root: Optional[str] = None):
        self.t1 = StudyCache(capacity=capacity, root=root)
        self.t2 = (SharedResultStore(shared_root)
                   if shared_root else None)
        self._t2_hits = 0

    def lookup(self, key: str) -> Tuple[Optional[dict], Optional[str]]:
        summary = self.t1.get(key)
        if summary is not None:
            return summary, "t1"
        if self.t2 is not None:
            summary = self.t2.get(key)
            if summary is not None:
                self._t2_hits += 1
                REGISTRY.counter(
                    "serve_cache_t2_hits_total",
                    "duplicate studies served from the shared tier-2 "
                    "store").inc()
                self.t1.put(key, summary)  # promote: next hit is t1
                return summary, "t2"
        return None, None

    def get(self, key: str) -> Optional[dict]:
        return self.lookup(key)[0]

    def put(self, key: str, summary: dict) -> str:
        """Insert into t1 and publish to the shared tier; returns the
        deepest tier reached (``"t2"`` when this call created the
        shared entry, else ``"t1"``) for trace attribution."""
        self.t1.put(key, summary)
        if self.t2 is not None and self.t2.publish(key, summary):
            return "t2"
        return "t1"

    def stats(self) -> dict:
        s = self.t1.stats()
        lookups = s["hits"] + s["misses"]
        t1_hits = s["hits"]
        hits = t1_hits + self._t2_hits
        # a t2 hit was counted as a t1 miss by the inner cache; at the
        # tier surface it is a hit — misses here mean "dispatched"
        misses = max(s["misses"] - self._t2_hits, 0)
        return {
            **s,
            "hits": hits,
            "misses": misses,
            "t1_hits": t1_hits,
            "t2_hits": self._t2_hits,
            "t2_size": self.t2.size() if self.t2 is not None else 0,
            "hit_ratio": (hits / lookups) if lookups else 0.0,
            "hit_ratio_t1": (t1_hits / lookups) if lookups else 0.0,
            "hit_ratio_t2": (self._t2_hits / lookups) if lookups
            else 0.0,
        }
