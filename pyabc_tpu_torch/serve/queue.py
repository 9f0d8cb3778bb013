"""Admission queue over the ``parallel/`` mount contract.

Port of ``pyabc_tpu/serve/queue.py`` (host code, copied; the
heartbeat and host identity come from the port's ``parallel/health.py``
and ``telemetry/aggregate.py``).

The reference pyABC farms studies through a redis broker
(``abc-redis-manager`` + workers); the TPU-native serving tier keeps
the same manager/worker split but rides the existing run-dir mount
contract (``parallel/health.py``): the queue IS a directory any
shared filesystem all hosts mount, studies are single JSON files, and
state transitions are filesystem-atomic writes — no broker process,
no connection state.

Layout under the serve root (``$PYABC_TPU_SERVE_DIR``, defaulting to
``$PYABC_TPU_RUN_DIR/serve``)::

    queue/pending/p0000/<id>.json      submitted, unclaimed (sharded:
    queue/pending/p0001/<id>.json      partition = hash(digest) % P,
    ...                                see serve/shards.py)
    queue/claimed/<worker>/<id>.json   claimed by one worker (rename)
    queue/done/<id>.json               served (result in the cache)
    queue/failed/<id>.json             exhausted its attempts

``pending/`` is sharded into ``P = PYABC_TPU_SERVE_PARTITIONS``
per-partition directories keyed by the study digest
(``serve/shards.py``), so claim scans and rename contention are
O(depth/P); ``claim()`` walks partitions in a worker-rotated order
and takes the best aged-priority candidate from the first non-empty
partition — strict priority order holds *within* a partition,
cross-partition order is approximate but starvation-free (aging still
accrues wherever a ticket sits, and the rotation revisits every
partition).  A pre-partition flat queue is upgraded in place on first
touch (:func:`~pyabc_tpu_torch.serve.shards.migrate_layout`), and flat
stragglers are still scanned last, so no layout mix loses tickets.

Crash-safety semantics, precisely:

- ``submit`` and ``claim`` are each ONE atomic rename — a ticket is
  never lost and never claimed twice.
- ``complete`` / ``fail`` / ``requeue`` must mutate the payload, so
  they are write-destination-then-unlink-source.  A crash between the
  two steps leaves a *stale source copy* alongside the authoritative
  destination.  Ticket ids make the duplicate detectable:
  :meth:`~StudyQueue.requeue_worker` (the drain/janitor sweep) reaps a
  claimed copy whose id already reached ``done``/``failed`` instead of
  requeueing it, and a double requeue converges because the pending
  destination is keyed by id.  Duplication is therefore at most
  transient, never silent.
- every claim carries a **lease**: the claimed file's mtime, stamped
  immediately before the claim rename (so the stamp travels with the
  rename — a ticket is never claimed without a live lease) and renewed
  by the worker's heartbeat thread (:meth:`~StudyQueue.renew_leases`).
  A lease older than ``PYABC_TPU_SERVE_LEASE_S`` has *lapsed* and the
  scheduler (``sched/scheduler.py``) may requeue it; lease age is
  measured on the queue filesystem's own clock (:meth:`~StudyQueue
  .fs_now`), so a live-but-slow study is never stolen by clock skew
  and a dead worker's claims lapse deterministically.
- ``done``/``failed`` tickets are tombstones: the pickled spec (the
  payload's bulk) is stripped on arrival, and
  :meth:`~StudyQueue.sweep` (called from every ``Scheduler.tick()``,
  with the worker idle loop as a fallback on scheduler-less
  deployments) reaps tombstones older than
  ``PYABC_TPU_SERVE_RETAIN_S`` so a long-lived serve root stays
  bounded even on a fleet that never idles.

Admission enforces *backpressure* (``PYABC_TPU_SERVE_MAX_DEPTH``
pending studies total → :class:`QueueFull`) and *per-tenant quotas*
(``PYABC_TPU_SERVE_TENANT_QUOTA`` pending per tenant →
:class:`TenantQuotaExceeded`) so one tenant cannot starve the fleet.
Both checks are list-then-write and therefore **best-effort** across
concurrent submitters: racing submissions can each pass the check and
overshoot the bound by at most the number of in-flight racers.  The
limits are operator guard rails, not hard capacity guarantees.
Claiming orders by *aged priority*: ``priority + age_s /
PYABC_TPU_SERVE_AGING_S`` — a low-priority study waiting long enough
eventually outranks fresh high-priority traffic, so nothing starves.
A SIGTERM-draining worker :meth:`~StudyQueue.requeue`\\ s its claimed
studies back to pending (``requeues`` is incremented — the poison-pill
ledger).

Trust model: the spec payload is a pickle, and unpickling executes
code.  By default submitters are *code-trusted* — anyone who can write
``queue/pending/`` can run arbitrary code on every worker, exactly
like the reference pyABC's cloudpickle-over-redis sampler — so the
serve root must NOT be writable by untrusted tenants; route untrusted
traffic through a front-end that constructs the specs itself.  Where
the mount is shared more widely, set ``PYABC_TPU_SERVE_HMAC_KEY`` on
submitters and workers: payloads are then HMAC-SHA256-signed at
submit and verified *before* unpickling, so only key-holders can make
a worker deserialize anything.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import pickle
import tempfile
import time
import uuid
from dataclasses import dataclass, field
from typing import List, Optional

from ..telemetry.metrics import REGISTRY
from . import shards
from .spec import StudySpec, study_digest
from .tracing import TraceLog

#: serve root (queue + cache persistence); default <run dir>/serve
SERVE_DIR_ENV = "PYABC_TPU_SERVE_DIR"

#: global backpressure: max pending studies before submit rejects
MAX_DEPTH_ENV = "PYABC_TPU_SERVE_MAX_DEPTH"

#: per-tenant admission quota (pending studies per tenant)
TENANT_QUOTA_ENV = "PYABC_TPU_SERVE_TENANT_QUOTA"

#: priority aging: seconds of queue age worth +1 effective priority
AGING_S_ENV = "PYABC_TPU_SERVE_AGING_S"

#: optional shared secret: when set, spec payloads are HMAC-signed at
#: submit and verified BEFORE unpickling (see the module trust model)
HMAC_KEY_ENV = "PYABC_TPU_SERVE_HMAC_KEY"

#: done/failed tombstone retention in seconds (0 disables the sweep)
RETAIN_S_ENV = "PYABC_TPU_SERVE_RETAIN_S"

#: claim lease TTL: a claimed study whose lease stamp has not been
#: renewed for this long is reappable by the scheduler (sched/)
LEASE_S_ENV = "PYABC_TPU_SERVE_LEASE_S"

#: poison-ticket budget: a study bounced back to pending this many
#: times is quarantined into ``failed/`` instead of requeued again
MAX_BOUNCES_ENV = "PYABC_TPU_SERVE_MAX_BOUNCES"

_DEFAULT_MAX_DEPTH = 256
_DEFAULT_TENANT_QUOTA = 32
_DEFAULT_AGING_S = 30.0
_DEFAULT_RETAIN_S = 3600.0
_DEFAULT_LEASE_S = 60.0
_DEFAULT_MAX_BOUNCES = 3


class QueueFull(RuntimeError):
    """Global backpressure: the pending queue is at max depth."""


class TenantQuotaExceeded(QueueFull):
    """This tenant's pending share is at its admission quota."""


class SpecAuthError(RuntimeError):
    """A signing key is configured and the ticket's spec payload has a
    missing or invalid HMAC — the worker refuses to unpickle it."""


def _hmac_key() -> Optional[bytes]:
    key = os.environ.get(HMAC_KEY_ENV)
    return key.encode("utf-8") if key else None


def _sign_spec(key: bytes, spec_b64: str) -> str:
    return hmac.new(key, spec_b64.encode("ascii"),
                    hashlib.sha256).hexdigest()


def serve_root(root: Optional[str] = None) -> str:
    """Resolve the serve directory: explicit arg >
    ``$PYABC_TPU_SERVE_DIR`` > ``$PYABC_TPU_RUN_DIR/serve`` >
    ``./abc-serve``."""
    if root:
        return root
    env = os.environ.get(SERVE_DIR_ENV)
    if env:
        return env
    from ..parallel import health
    run_dir = os.environ.get(health.RUN_DIR_ENV)
    if run_dir:
        return os.path.join(run_dir, "serve")
    return os.path.abspath("abc-serve")


def default_worker_id() -> str:
    # host_id() (not the raw hostname) so a worker's claimed/<worker>
    # directory and its hb_<host>_<pid>.json heartbeat key the SAME
    # fleet identity — the scheduler (sched/scheduler.py) joins the two
    # to decide which claims belong to a dead worker
    from ..telemetry.aggregate import host_id
    return f"{host_id()}_{os.getpid()}"


def lease_s_default() -> float:
    """The claim lease TTL: ``$PYABC_TPU_SERVE_LEASE_S`` or 60 s."""
    return _env_float(LEASE_S_ENV, _DEFAULT_LEASE_S)


def max_bounces_default() -> int:
    """The poison-ticket budget: ``$PYABC_TPU_SERVE_MAX_BOUNCES`` or 3."""
    return _env_int(MAX_BOUNCES_ENV, _DEFAULT_MAX_BOUNCES)


def _env_int(name: str, default: int) -> int:
    try:
        return max(int(os.environ.get(name, str(default))), 1)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return max(float(os.environ.get(name, str(default))), 1e-3)
    except ValueError:
        return default


@dataclass
class Ticket:
    """One study's queue entry: admission metadata in the clear, the
    spec itself pickled (the redis sampler's cloudpickle analog) so a
    different worker process can reconstruct the callables."""

    id: str
    digest: str
    tenant: str
    priority: int
    submitted_unix: float
    requeues: int = 0
    path: Optional[str] = None
    #: holder of the claim this ticket was listed from (claimed state
    #: only — the claimed/<worker>/ directory name)
    worker: Optional[str] = None
    #: wall-clock instant this process claimed the ticket (stamped by
    #: :meth:`StudyQueue.claim`; ``None`` for listings) — the worker's
    #: trace fold uses it for the synthetic ``claimed`` event
    claimed_unix: Optional[float] = None
    _payload: Optional[dict] = field(default=None, repr=False)

    @property
    def trace_id(self) -> Optional[str]:
        """The study's lifecycle trace id, stamped at submit and
        carried in the payload for the ticket's whole life (``None``
        when tracing was off at submit)."""
        return (self._payload or {}).get("trace_id")

    @property
    def batch_key(self) -> Optional[str]:
        """The spec's study-axis grouping key
        (:func:`~pyabc_tpu_torch.serve.multiplex.batch_key`), stamped at
        submit so a keyed claim can filter candidates WITHOUT
        unpickling specs.  ``None`` on pre-stamp tickets — they never
        match a keyed claim, only plain ones."""
        return (self._payload or {}).get("batch_key")

    def load_spec(self) -> StudySpec:
        """Reconstruct the spec.  Unpickling EXECUTES code: with no
        ``PYABC_TPU_SERVE_HMAC_KEY`` configured, submitters are
        code-trusted (module trust model); with a key, the payload's
        signature is verified first and a bad one raises
        :class:`SpecAuthError` — the worker's poison-ticket path."""
        spec_b64 = self._payload["spec_b64"]
        key = _hmac_key()
        if key is not None:
            tag = str(self._payload.get("spec_hmac", ""))
            if not hmac.compare_digest(_sign_spec(key, spec_b64), tag):
                raise SpecAuthError(
                    f"ticket {self.id}: spec HMAC missing or invalid")
        return pickle.loads(base64.b64decode(spec_b64))

    def effective_priority(self, aging_s: float,
                           now: Optional[float] = None) -> float:
        age = (time.time() if now is None else now) - self.submitted_unix
        return self.priority + max(age, 0.0) / aging_s


def _ticket_from_file(path: str) -> Optional[Ticket]:
    try:
        with open(path, encoding="utf-8") as f:
            payload = json.load(f)
        return Ticket(
            id=payload["id"], digest=payload["digest"],
            tenant=payload.get("tenant", "default"),
            priority=int(payload.get("priority", 0)),
            submitted_unix=float(payload.get("submitted_unix", 0.0)),
            requeues=int(payload.get("requeues", 0)),
            path=path, _payload=payload)
    except (OSError, ValueError, KeyError):
        return None  # torn read during a concurrent rename: skip


class StudyQueue:
    """Directory-backed admission queue (see module docstring)."""

    def __init__(self, root: Optional[str] = None,
                 max_depth: Optional[int] = None,
                 tenant_quota: Optional[int] = None,
                 aging_s: Optional[float] = None,
                 lease_s: Optional[float] = None,
                 partitions: Optional[int] = None,
                 admission=None):
        self.root = os.path.join(serve_root(root), "queue")
        self.max_depth = (_env_int(MAX_DEPTH_ENV, _DEFAULT_MAX_DEPTH)
                          if max_depth is None else int(max_depth))
        self.tenant_quota = (
            _env_int(TENANT_QUOTA_ENV, _DEFAULT_TENANT_QUOTA)
            if tenant_quota is None else int(tenant_quota))
        self.aging_s = (_env_float(AGING_S_ENV, _DEFAULT_AGING_S)
                        if aging_s is None else float(aging_s))
        self.lease_s = (lease_s_default() if lease_s is None
                        else float(lease_s))
        self.partitions = (shards.partitions_default()
                           if partitions is None
                           else max(int(partitions), 1))
        for state in ("pending", "claimed", "done", "failed"):
            os.makedirs(os.path.join(self.root, state), exist_ok=True)
        for i in range(self.partitions):
            os.makedirs(self._partition_dir(i), exist_ok=True)
        self.migrate_layout()
        if admission is None:
            # lazy import: admission subclasses this module's QueueFull
            from .admission import AdmissionController
            admission = AdmissionController(os.path.dirname(self.root))
        self.admission = admission
        # the lifecycle event log rides the same serve root and the
        # same partitioning as the queue (serve/tracing.py)
        self.trace = TraceLog(os.path.dirname(self.root),
                              partitions=self.partitions)
        self._claim_salt = 0

    # ---- introspection ---------------------------------------------------

    def _dir(self, state: str) -> str:
        return os.path.join(self.root, state)

    def _partition_dir(self, index: int) -> str:
        return os.path.join(self._dir("pending"),
                            shards.partition_name(index))

    def _pending_dirs(self) -> List[str]:
        """Every pending location a ticket can live in: each existing
        partition directory (whatever P wrote it), then the flat
        ``pending/`` root itself for pre-partition stragglers."""
        return shards.partition_dirs(self._dir("pending")) + [
            self._dir("pending")]

    def migrate_layout(self) -> int:
        """Upgrade a pre-partition flat queue in place (one atomic
        rename per ticket — see :func:`serve.shards.migrate_layout`);
        a no-op on an already-sharded or empty queue."""
        return shards.migrate_layout(self._dir("pending"),
                                     self.partitions)

    def _list_dir(self, dirpath: str) -> List[Ticket]:
        try:
            names = sorted(os.listdir(dirpath))
        except OSError:
            return []
        out = []
        for name in names:
            if not name.endswith(".json"):
                continue
            path = os.path.join(dirpath, name)
            if not os.path.isfile(path):
                continue
            t = _ticket_from_file(path)
            if t is not None:
                out.append(t)
        return out

    def _list(self, state: str) -> List[Ticket]:
        if state == "pending":
            out = []
            for d in self._pending_dirs():
                out.extend(self._list_dir(d))
            return out
        out = []
        base = self._dir(state)
        walk = ([(base, None, sorted(os.listdir(base)))] if state
                != "claimed" else list(os.walk(base)))
        for dirpath, _dirs, names in walk:
            for name in sorted(names):
                if not name.endswith(".json"):
                    continue
                t = _ticket_from_file(os.path.join(dirpath, name))
                if t is not None:
                    if state == "claimed":
                        t.worker = os.path.basename(dirpath)
                    out.append(t)
        return out

    def pending(self) -> List[Ticket]:
        return self._list("pending")

    def claimed(self) -> List[Ticket]:
        return self._list("claimed")

    def fs_now(self) -> float:
        """Reference "now" from the SAME filesystem the queue lives on
        (touch a probe file and stat its mtime, the ``parallel/health``
        clock trick): lease age is then mtime-vs-mtime on one clock —
        worker↔scheduler wall-clock skew can neither steal a live lease
        nor keep a dead one alive.  Falls back to local time on a
        read-only mount."""
        probe = os.path.join(self.root, ".now_probe")
        try:
            if os.path.exists(probe):
                os.utime(probe, None)
            else:
                with open(probe, "w"):
                    pass
            return os.stat(probe).st_mtime
        except OSError:
            return time.time()

    # ---- leases ----------------------------------------------------------

    def lease_age_s(self, ticket: Ticket,
                    now: Optional[float] = None) -> float:
        """Seconds since this claimed ticket's lease stamp (its file
        mtime) was last renewed; ``inf`` if the file vanished (claim
        settled concurrently — the caller should re-list)."""
        if not ticket.path:
            return float("inf")
        try:
            mtime = os.stat(ticket.path).st_mtime
        except OSError:
            return float("inf")
        return (self.fs_now() if now is None else now) - mtime

    def renew_leases(self, worker_id: str) -> int:
        """Re-stamp every lease this worker holds (utime on its claimed
        files).  Called from the worker's heartbeat thread
        (``parallel/health.py``) so lease liveness and heartbeat
        liveness are the same signal: a live-but-slow study keeps its
        lease for as long as the worker keeps beating, and a dead
        worker's leases stop advancing the moment its heartbeat does."""
        wdir = os.path.join(self._dir("claimed"), worker_id)
        if not os.path.isdir(wdir):
            return 0
        n = 0
        for name in os.listdir(wdir):
            if not name.endswith(".json"):
                continue
            try:
                os.utime(os.path.join(wdir, name), None)
                n += 1
            except OSError:
                continue  # settled concurrently by the main thread
        return n

    def lapsed(self, lease_s: Optional[float] = None) -> List[Ticket]:
        """Claimed tickets whose lease is older than ``lease_s``
        (default: this queue's TTL) — the scheduler's reap candidates.
        Measured on the queue filesystem's clock (:meth:`fs_now`)."""
        lease_s = self.lease_s if lease_s is None else float(lease_s)
        now = self.fs_now()
        return [t for t in self.claimed()
                if self.lease_age_s(t, now=now) > lease_s]

    def _dir_depth(self, dirpath: str) -> int:
        try:
            return sum(1 for n in os.listdir(dirpath)
                       if n.endswith(".json")
                       and os.path.isfile(os.path.join(dirpath, n)))
        except OSError:
            return 0

    def depth(self) -> int:
        return sum(self._dir_depth(d) for d in self._pending_dirs())

    def partition_depth(self, index: int) -> int:
        return self._dir_depth(self._partition_dir(index))

    def partition_depths(self) -> List[int]:
        """Pending count per configured partition (index-aligned).
        Flat stragglers and foreign-P partitions are not included —
        :meth:`depth` is the total."""
        return [self.partition_depth(i) for i in range(self.partitions)]

    def stats(self) -> dict:
        per_tenant: dict = {}
        pending = self.pending()
        for t in pending:
            per_tenant[t.tenant] = per_tenant.get(t.tenant, 0) + 1
        return {
            "pending": len(pending),
            "claimed": len(self.claimed()),
            "done": len([n for n in os.listdir(self._dir("done"))
                         if n.endswith(".json")]),
            "failed": len([n for n in os.listdir(self._dir("failed"))
                           if n.endswith(".json")]),
            "max_depth": self.max_depth,
            "tenant_quota": self.tenant_quota,
            "aging_s": self.aging_s,
            "lease_s": self.lease_s,
            "partitions": self.partitions,
            "partition_depths": self.partition_depths(),
            "pending_by_tenant": per_tenant,
        }

    # ---- producer side ---------------------------------------------------

    def submit(self, spec: StudySpec) -> Ticket:
        """Admit one study; raises :class:`QueueFull` /
        :class:`TenantQuotaExceeded` instead of queueing unboundedly —
        backpressure the submitter can see and retry against.  The
        depth/quota checks are best-effort under concurrent submitters
        (module docstring): racers can overshoot the bound by at most
        the number of in-flight submissions."""
        trace_id = self.trace.new_id()  # None while tracing is off
        tenant = spec.tenant or "default"
        pending = self.pending()
        if len(pending) >= self.max_depth:
            REGISTRY.counter(
                "serve_queue_rejected_total",
                "study submissions rejected by admission control").inc()
            self.trace.emit(trace_id, "rejected", partition=0,
                            tenant=tenant, reason="depth")
            raise QueueFull(
                f"queue at max depth {self.max_depth}")
        mine = sum(1 for t in pending if t.tenant == tenant)
        if mine >= self.tenant_quota:
            REGISTRY.counter(
                "serve_queue_rejected_total",
                "study submissions rejected by admission control").inc()
            self.trace.emit(trace_id, "rejected", partition=0,
                            tenant=tenant, reason="tenant_quota")
            raise TenantQuotaExceeded(
                f"tenant {tenant!r} at quota {self.tenant_quota}")
        digest = study_digest(spec)
        partition = shards.partition_of(digest, self.partitions)
        if self.admission is not None and self.admission.enabled():
            # SLO load-shedding (serve/admission.py): distinct from the
            # depth/quota rejections above — raises ServeOverloaded
            # with a computed retry_after_s
            try:
                self.admission.check(self.partition_depth(partition),
                                     partition=partition)
            except QueueFull as exc:  # ServeOverloaded subclasses it
                self.trace.emit(
                    trace_id, "shed", digest=digest, tenant=tenant,
                    reason=getattr(exc, "reason", "overload"),
                    retry_after_s=getattr(exc, "retry_after_s", None))
                raise
        sid = f"{time.time_ns():019d}-{digest[:12]}-{uuid.uuid4().hex[:8]}"
        from .multiplex import batch_key as _batch_key
        payload = {
            "id": sid,
            "digest": digest,
            "tenant": tenant,
            "priority": int(spec.priority),
            "submitted_unix": time.time(),
            "requeues": 0,
            # the study-axis grouping key, in the clear: keyed claims
            # (the continuous-batching refill) filter on it without
            # unpickling the spec
            "batch_key": _batch_key(spec),
            "spec_b64": base64.b64encode(
                pickle.dumps(spec)).decode("ascii"),
        }
        if trace_id is not None:
            payload["trace_id"] = trace_id
        key = _hmac_key()
        if key is not None:
            payload["spec_hmac"] = _sign_spec(key, payload["spec_b64"])
        self.trace.emit(trace_id, "submitted", digest=digest,
                        ticket=sid, tenant=tenant,
                        priority=int(spec.priority))
        pdir = self._partition_dir(partition)
        os.makedirs(pdir, exist_ok=True)
        path = os.path.join(pdir, f"{sid}.json")
        self._write_atomic(path, payload)
        self.trace.emit(trace_id, "queued", digest=digest, ticket=sid,
                        partition=partition)
        REGISTRY.counter(
            "serve_queue_submitted_total",
            "studies admitted into the serve queue").inc()
        return Ticket(id=sid, digest=digest, tenant=tenant,
                      priority=int(spec.priority),
                      submitted_unix=payload["submitted_unix"],
                      path=path, _payload=payload)

    def _write_atomic(self, path: str, payload: dict):
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   suffix=".tmp")
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    # ---- worker side -----------------------------------------------------

    def claim(self, worker_id: Optional[str] = None,
              batch_key: Optional[str] = None) -> Optional[Ticket]:
        """Claim the highest aged-priority pending study (atomic
        rename; a lost race just moves on to the next candidate).

        ``batch_key`` keys the claim: only tickets stamped with that
        study-axis grouping key are candidates — the continuous-
        batching refill path, which must not steal work it cannot seat
        in the open batch.  The scan order (partition rotation), the
        aged-priority order WITHIN the key, the lease stamp and the
        ``claimed`` event are all identical to a plain claim; tickets
        without a stamp (pre-stamp submitters) are skipped by keyed
        claims and left for plain ones.

        The lease stamp travels WITH the rename: the pending file's
        mtime is refreshed *first*, then the rename moves it — so there
        is no instant at which a claimed ticket exists without a live
        lease.  A worker dying between the two steps leaves a pending
        file with a fresh mtime (harmless); dying right after the
        rename leaves a claimed file whose lease is already counting
        down toward the scheduler's reap — the claim/crash invisibility
        window is zero, no janitor sweep needed.

        A pending file whose id already reached ``done``/``failed`` is
        a requeued duplicate of a settled study (a partitioned worker
        completed it after the scheduler bounced it): it is reaped
        here, never served twice.

        The scan is sharded (``serve/shards.py``): partitions are
        walked in this worker's rotated order and the claim goes to
        the best aged-priority candidate in the FIRST non-empty
        partition — O(depth/P) per claim, strict priority order
        within a partition, approximate across partitions (the
        rotation advances each call so no partition is camped on, and
        aging accrues wherever a ticket waits).  Foreign-P partition
        directories and flat pre-partition stragglers are scanned
        last, so a mixed layout still drains."""
        worker_id = worker_id or default_worker_id()
        wdir = os.path.join(self._dir("claimed"), worker_id)
        os.makedirs(wdir, exist_ok=True)
        now = time.time()
        order = shards.rotation(self.partitions, worker_id,
                                self._claim_salt)
        self._claim_salt += 1
        scan = [self._partition_dir(i) for i in order]
        seen = set(scan)
        scan.extend(d for d in self._pending_dirs() if d not in seen)
        for dirpath in scan:
            tickets = self._list_dir(dirpath)
            if batch_key is not None:
                tickets = [t for t in tickets
                           if t.batch_key == batch_key]
            candidates = sorted(
                tickets,
                key=lambda t: (-t.effective_priority(self.aging_s, now),
                               t.submitted_unix, t.id))
            for t in candidates:
                if any(os.path.exists(os.path.join(
                        self._dir(state), f"{t.id}.json"))
                        for state in ("done", "failed")):
                    try:
                        os.unlink(t.path)
                    except OSError:
                        pass
                    continue
                dest = os.path.join(wdir, os.path.basename(t.path))
                try:
                    os.utime(t.path, None)  # lease stamp, THEN rename
                    os.rename(t.path, dest)
                except OSError:
                    continue  # another worker won this one
                t.path = dest
                t.worker = worker_id
                t.claimed_unix = time.time()
                self.trace.emit(t.trace_id, "claimed",
                                digest=t.digest, ticket=t.id,
                                worker=worker_id, bounce=t.requeues)
                return t
        return None

    def _move(self, ticket: Ticket, state: str, extra: dict) -> str:
        """Write-destination-then-unlink-source (NOT one rename — the
        payload mutates).  A crash between the steps leaves a stale
        source copy that ``requeue_worker`` reaps by id; see the
        module docstring's crash-safety semantics."""
        payload = dict(ticket._payload or {})
        payload.update(extra)
        if state in ("done", "failed"):
            # tombstones: the result lives in the cache, so the
            # pickled spec (the payload's bulk) is dropped — done/
            # failed stay small and sweepable
            payload.pop("spec_b64", None)
            payload.pop("spec_hmac", None)
        dest = os.path.join(self._dir(state), f"{ticket.id}.json")
        self._write_atomic(dest, payload)
        if ticket.path and os.path.exists(ticket.path):
            try:
                os.unlink(ticket.path)
            except OSError:
                pass
        ticket.path = dest
        ticket._payload = payload
        if state in ("done", "failed"):
            self.trace.emit(payload.get("trace_id"), "tombstoned",
                            digest=ticket.digest, ticket=ticket.id,
                            state=state)
        return dest

    def complete(self, ticket: Ticket, wall_s: float = 0.0,
                 engine: str = "solo",
                 trace: Optional[dict] = None):
        """Settle a served study into ``done/``.  ``trace`` is the
        worker's folded critical-path block (phases + trace id) —
        written into the tombstone so per-study latency attribution
        is readable without assembling the event log."""
        extra = {
            "completed_unix": time.time(),
            "wall_s": float(wall_s),
            "engine": engine,
        }
        if trace is not None:
            extra["trace"] = trace
        self._move(ticket, "done", extra)

    def fail(self, ticket: Ticket, error: str,
             trace: Optional[dict] = None):
        extra = {
            "failed_unix": time.time(),
            "error": str(error)[:2000],
        }
        if trace is not None:
            extra["trace"] = trace
        self._move(ticket, "failed", extra)

    def requeue(self, ticket: Ticket, worker: Optional[str] = None,
                error: Optional[str] = None) -> bool:
        """Return a claimed study to pending (SIGTERM drain, crashed
        attempt, lapsed lease) with its original submission time — its
        accumulated age, and therefore its aged priority, survives the
        bounce.  Each bounce leaves a breadcrumb (``last_worker``,
        ``last_error``, an appended ``bounce_history`` entry) so a
        ticket that ends up quarantined is diagnosable from its
        tombstone alone.

        If the ticket's id already reached ``done``/``failed`` the
        claimed file is a stale copy from a crash between
        :meth:`_move`'s write and unlink: it is reaped, not requeued
        (returns ``False``) — the study is never served twice.  A
        crash inside requeue itself converges the same way: the
        pending destination is keyed by id, so a second requeue
        overwrites rather than duplicates."""
        for state in ("done", "failed"):
            if os.path.exists(os.path.join(self._dir(state),
                                           f"{ticket.id}.json")):
                if ticket.path and os.path.exists(ticket.path):
                    try:
                        os.unlink(ticket.path)
                    except OSError:
                        pass
                return False
        worker = worker if worker is not None else ticket.worker
        payload = dict(ticket._payload or {})
        payload["requeues"] = int(payload.get("requeues", 0)) + 1
        payload["last_worker"] = worker
        payload["last_error"] = (None if error is None
                                 else str(error)[:2000])
        history = list(payload.get("bounce_history", []))
        history.append({"worker": worker,
                        "error": payload["last_error"],
                        "requeued_unix": time.time()})
        payload["bounce_history"] = history[-32:]  # bounded breadcrumb
        # partition-aware: the bounce returns to the SAME partition the
        # digest keys to (pure function — every requeuer converges on
        # one destination path, so a double requeue still overwrites)
        pdir = self._partition_dir(
            shards.partition_of(ticket.digest, self.partitions))
        os.makedirs(pdir, exist_ok=True)
        dest = os.path.join(pdir, f"{ticket.id}.json")
        self._write_atomic(dest, payload)
        if ticket.path and os.path.exists(ticket.path):
            try:
                os.unlink(ticket.path)
            except OSError:
                pass
        ticket.path = dest
        ticket._payload = payload
        ticket.requeues = payload["requeues"]
        self.trace.emit(ticket.trace_id, "requeued",
                        digest=ticket.digest, ticket=ticket.id,
                        worker=worker, bounce=ticket.requeues,
                        error=payload["last_error"])
        REGISTRY.counter(
            "serve_queue_requeues_total",
            "claimed studies returned to pending (drain/crash)").inc()
        return True

    def requeue_worker(self, worker_id: str,
                       error: Optional[str] = None) -> int:
        """Requeue EVERY study a worker still holds — the drain path's
        bulk form, also the scheduler's recovery for a dead worker.
        Stale claims whose id already completed are reaped instead of
        requeued (see :meth:`requeue`); the count excludes them."""
        wdir = os.path.join(self._dir("claimed"), worker_id)
        if not os.path.isdir(wdir):
            return 0
        n = 0
        for name in sorted(os.listdir(wdir)):
            if not name.endswith(".json"):
                continue
            t = _ticket_from_file(os.path.join(wdir, name))
            if t is None:
                continue
            t.worker = worker_id
            if self.requeue(t, worker=worker_id, error=error):
                n += 1
        return n

    def quarantine(self, ticket: Ticket, error: str,
                   flight_path: Optional[str] = None):
        """Retire a poison ticket into ``failed/`` with its full bounce
        history and (when the scheduler captured one) the path of the
        flight-recorder dump — the post-mortem surface for a study that
        kept killing workers.  The tombstone keeps ``last_worker`` /
        ``bounce_history`` from :meth:`requeue`, so *which* workers it
        took down and with what errors is readable from one file."""
        extra = {
            "failed_unix": time.time(),
            "error": str(error)[:2000],
            "quarantined": True,
        }
        if flight_path:
            extra["flight_path"] = flight_path
        self._move(ticket, "failed", extra)
        REGISTRY.counter(
            "serve_queue_quarantined_total",
            "poison tickets retired after exhausting their bounce "
            "budget").inc()

    # ---- housekeeping ----------------------------------------------------

    def sweep(self, retain_s: Optional[float] = None,
              now: Optional[float] = None) -> int:
        """Reap ``done``/``failed`` tombstones older than the
        retention window (``PYABC_TPU_SERVE_RETAIN_S``, default 1 h;
        ``0`` disables) so a long-lived serve root stays bounded and
        :meth:`stats` stays cheap.  Called from every scheduler tick
        (a busy fleet never idles, so the worker's idle-loop call —
        kept as a fallback for scheduler-less deployments — cannot be
        the only GC); safe to run from any process on the mount."""
        if retain_s is None:
            try:
                retain_s = float(os.environ.get(
                    RETAIN_S_ENV, str(_DEFAULT_RETAIN_S)))
            except ValueError:
                retain_s = _DEFAULT_RETAIN_S
        if retain_s <= 0:
            return 0
        now = time.time() if now is None else now
        n = 0
        for state in ("done", "failed"):
            base = self._dir(state)
            for name in os.listdir(base):
                if not name.endswith(".json"):
                    continue
                path = os.path.join(base, name)
                try:
                    if now - os.path.getmtime(path) > retain_s:
                        os.unlink(path)
                        n += 1
                except OSError:
                    continue  # another sweeper won the race
        if n:
            REGISTRY.counter(
                "serve_queue_swept_total",
                "expired done/failed tombstones reaped").inc(n)
        return n
