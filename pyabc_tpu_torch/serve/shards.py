"""Partitioned queue layout: the serving data plane's shard map.

Port of ``pyabc_tpu/serve/shards.py`` (host code, copied).

A single flat ``pending/`` directory makes every ``claim()`` an
O(depth) scan and every claim rename a contention point on one
directory inode — fine for one warm worker, hostile at fleet scale.
The data plane therefore shards ``pending/`` into
``P = PYABC_TPU_SERVE_PARTITIONS`` subdirectories::

    queue/pending/p0000/<id>.json
    queue/pending/p0001/<id>.json
    ...

keyed by ``hash(study_digest) % P`` — the SAME content address the
result cache uses, so equal-digest duplicates always land in the same
partition and a claim scan is O(depth / P).  Workers walk partitions
in a worker-rotated order (:func:`rotation`): different workers start
their scan at different partitions, so under load the fleet spreads
its claim renames across P directory inodes instead of stampeding
one.

The partition of a digest is a pure function of the digest and P
(:func:`partition_of`): every submitter, worker and scheduler on the
mount computes the same placement with no coordination.  Changing P
re-keys future submissions only — ``claim()`` walks every ``p*``
directory that exists (plus flat stragglers in ``pending/`` itself),
so a mixed-P fleet drains correctly, just without the contention win
until the old partitions empty.  :func:`migrate_layout` upgrades a
pre-partition flat queue in place: each flat ticket is moved into its
digest's partition with a single rename (the same atomicity as claim
— a crashed migration loses nothing and a second run converges).

Knob: ``PYABC_TPU_SERVE_PARTITIONS`` (default 8), documented in
``docs/serving.md``.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional

#: number of pending/ partitions (the data-plane shard count)
PARTITIONS_ENV = "PYABC_TPU_SERVE_PARTITIONS"

_DEFAULT_PARTITIONS = 8


def partitions_default() -> int:
    """``$PYABC_TPU_SERVE_PARTITIONS`` or 8; floored at 1."""
    try:
        return max(int(os.environ.get(PARTITIONS_ENV,
                                      str(_DEFAULT_PARTITIONS))), 1)
    except ValueError:
        return _DEFAULT_PARTITIONS


def partition_of(digest: str, partitions: int) -> int:
    """Stable partition index for a study digest: a pure function of
    the content address, identical on every host (no ``hash()`` — the
    builtin is salted per process)."""
    if partitions <= 1:
        return 0
    try:
        return int(digest[:16], 16) % partitions
    except ValueError:
        h = hashlib.sha256(digest.encode("utf-8")).hexdigest()
        return int(h[:16], 16) % partitions


def partition_name(index: int) -> str:
    return f"p{index:04d}"


def rotation(partitions: int, worker_id: str, salt: int = 0) -> List[int]:
    """Partition indices in this worker's scan order: a full cycle
    starting at a stable per-worker offset (advanced by ``salt`` per
    claim so one worker does not camp on a single partition while its
    neighbours back up)."""
    if partitions <= 1:
        return [0]
    h = hashlib.sha256(worker_id.encode("utf-8")).hexdigest()
    start = (int(h[:16], 16) + salt) % partitions
    return [(start + i) % partitions for i in range(partitions)]


def partition_dirs(pending_dir: str) -> List[str]:
    """Every partition directory that EXISTS under ``pending/``, sorted
    — the union of this process's configured layout and whatever other
    P a past config created, so a mixed-P fleet still drains all of
    them."""
    try:
        names = sorted(n for n in os.listdir(pending_dir)
                       if n.startswith("p") and n[1:].isdigit()
                       and os.path.isdir(os.path.join(pending_dir, n)))
    except OSError:
        return []
    return [os.path.join(pending_dir, n) for n in names]


def migrate_layout(pending_dir: str,
                   partitions: Optional[int] = None) -> int:
    """One-shot flat→sharded upgrade: move every ticket sitting
    directly in ``pending/`` into its digest's partition directory.
    Each move is one :func:`os.rename` — atomic, so a crash mid-
    migration loses zero tickets and a concurrent migrator (or a
    worker claiming the flat file directly) just wins the race.
    Unreadable (torn) files are left in place for their writer to
    finish; the claim path scans flat stragglers as a fallback, so
    nothing strands either way.  Returns the number of tickets moved;
    idempotent — a second call is a no-op."""
    partitions = (partitions_default() if partitions is None
                  else max(int(partitions), 1))
    moved = 0
    try:
        names = sorted(os.listdir(pending_dir))
    except OSError:
        return 0
    for name in names:
        if not name.endswith(".json"):
            continue
        src = os.path.join(pending_dir, name)
        if not os.path.isfile(src):
            continue
        try:
            with open(src, encoding="utf-8") as f:
                digest = str(json.load(f).get("digest", ""))
        except (OSError, ValueError):
            continue  # torn concurrent write: its writer will finish
        pdir = os.path.join(pending_dir,
                            partition_name(partition_of(digest,
                                                        partitions)))
        os.makedirs(pdir, exist_ok=True)
        try:
            os.rename(src, os.path.join(pdir, name))
            moved += 1
        except OSError:
            continue  # claimed or migrated concurrently
    return moved
