"""Worker health, heartbeats and clean-stop over a shared run directory.

Port of ``pyabc_tpu/parallel/health.py``.  Each process heartbeats into
a run directory that every host mounts (``$PYABC_TPU_RUN_DIR``): a
:class:`Heartbeat` thread writes ``hb_<host>_<pid>.json`` every interval,
:func:`worker_status` / :func:`healthy` read the files back (liveness
from the file's mtime against a probe file on the same filesystem,
cross-checked against this process's monotonic clock), and
:func:`reset_workers` removes stale ones.  :func:`request_stop` drops the
``STOP`` sentinel that the orchestrator polls between generations
(:func:`stop_requested`); with several ``torch.distributed`` ranks every
rank's vote is gathered so all stop at the same generation.

The file formats are the JAX package's: a heartbeat or a sentinel
written by one package reads in the other.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from ..telemetry.aggregate import SCHEMA_VERSION, host_id

RUN_DIR_ENV = "PYABC_TPU_RUN_DIR"
STOP_SENTINEL = "STOP"
#: a heartbeat older than this is considered dead (default; override
#: per-deployment with $PYABC_TPU_STALE_S — slow shared filesystems
#: and long GC pauses want a larger window)
STALE_AFTER_S = 30.0
STALE_ENV = "PYABC_TPU_STALE_S"
_HB_PREFIX = "hb_"
_PROBE_NAME = ".now_probe"

#: first-seen bookkeeping for the monotonic staleness cross-check:
#: hb path -> (mtime, monotonic clock when that mtime was first seen)
_MONO_SEEN: Dict[str, tuple] = {}
_MONO_LOCK = threading.Lock()


def stale_after_default() -> float:
    """The staleness window: ``$PYABC_TPU_STALE_S`` or 30 s."""
    try:
        val = float(os.environ.get(STALE_ENV, STALE_AFTER_S))
    except ValueError:
        return STALE_AFTER_S
    return val if val >= 0 else STALE_AFTER_S


def run_dir() -> Optional[str]:
    """The shared run directory advertised to this process, if any."""
    return os.environ.get(RUN_DIR_ENV)


class Heartbeat:
    """Background thread writing ``hb_<host>_<pid>.json`` every interval.

    Start it on a worker's bring-up; :func:`worker_status` reads the
    files.
    """

    def __init__(self, directory: str, interval_s: float = 5.0,
                 process_index: Optional[int] = None,
                 metrics_fn: Optional[callable] = None,
                 on_beat: Optional[callable] = None):
        self.directory = directory
        self.interval_s = interval_s
        self.process_index = process_index
        #: zero-arg callable invoked after every successful beat — the
        #: serve worker renews its queue claim leases here
        #: (``StudyQueue.renew_leases``), so lease liveness rides the
        #: same thread, cadence and failure mode as the heartbeat
        #: itself; exceptions are swallowed (a lease-renewal hiccup
        #: must never kill the liveness signal)
        self.on_beat = on_beat
        #: zero-arg callable returning a flat scalar dict embedded in
        #: every heartbeat, so ``info`` shows per-host throughput, not
        #: just liveness; defaults to the telemetry summary
        if metrics_fn is None:
            from ..telemetry.metrics import heartbeat_summary
            metrics_fn = heartbeat_summary
        self.metrics_fn = metrics_fn
        # host_id() (not the raw hostname) so heartbeats, telemetry
        # snapshots and span files all key the same fleet identity —
        # overridable via $PYABC_TPU_HOST_ID (containers, tests)
        self.path = os.path.join(
            directory, f"{_HB_PREFIX}{host_id()}_{os.getpid()}.json")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self):
        # chaos hook: `heartbeat.write@...` fault plans exercise the
        # loop's OSError tolerance (resilience/faults.py)
        from ..resilience.faults import SITE_HEARTBEAT, fault_point
        fault_point(SITE_HEARTBEAT)
        os.makedirs(self.directory, exist_ok=True)
        payload = {
            # same schema version as the telemetry snapshots: the fleet
            # aggregator and worker_status readers consume both
            # record kinds without format sniffing
            "schema_version": SCHEMA_VERSION,
            "host": host_id(),
            "pid": os.getpid(),
            "process_index": self.process_index,
            "ts": time.time(),
            # wall minus monotonic: lets any reader translate this
            # host's monotonic stamps to its wall clock
            "monotonic_offset_s": time.time() - time.monotonic(),
        }
        try:
            payload["metrics"] = self.metrics_fn()
        except Exception:  # metrics must never kill the liveness signal
            payload["metrics"] = {}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)  # atomic on POSIX
        if self.on_beat is not None:
            try:
                self.on_beat()
            except Exception:
                pass  # renewal failure must not stop the heartbeat

    def start(self) -> "Heartbeat":
        def loop():
            while not self._stop.is_set():
                try:
                    self.beat()
                except OSError:  # shared FS hiccup — retry next interval
                    pass
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(
            target=loop, name="abc-heartbeat", daemon=True)
        self._thread.start()
        return self

    def stop(self, remove: bool = True):
        """Stop beating. ``remove=True`` (clean exit) deregisters the
        worker; ``remove=False`` (crash path) leaves the last heartbeat in
        place so ``info`` reports the worker as STALE instead of silently
        absent — the worker-death-detection contract
        (multicorebase.py:78-105)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s)
        if remove:
            try:
                os.remove(self.path)
            except OSError:
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop(remove=exc_type is None)


def worker_status(directory: str,
                  stale_after_s: Optional[float] = None) -> List[Dict]:
    """All workers that ever heartbeat into ``directory``, newest first.

    Each entry carries ``alive`` (heartbeat within ``stale_after_s``,
    defaulting to ``$PYABC_TPU_STALE_S`` / 30 s) — the reference's
    ``healthy()`` analog.

    Liveness is cross-checked against this process's MONOTONIC clock:
    once a heartbeat has been observed, a worker is only declared dead
    after ``stale_after_s`` of monotonic time passes without its mtime
    advancing — a wall-clock step (NTP correction, VM migration) on
    either side cannot mark a live, beating worker dead.  The wall-age
    test still applies on the FIRST observation (a manager starting up
    must classify pre-existing stale files correctly) and remains as an
    OR thereafter, so genuine staleness is never masked.
    """
    if stale_after_s is None:
        stale_after_s = stale_after_default()
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    # reference "now" from the SAME filesystem the heartbeats land on
    # (touch a probe and stat it) so worker-vs-manager clock skew cannot
    # misclassify liveness; the probe file is reused (utime, no re-create
    # churn) and removed by reset_workers; fall back to local time on a
    # read-only mount
    probe = os.path.join(directory, _PROBE_NAME)
    try:
        if os.path.exists(probe):
            os.utime(probe, None)
        else:
            with open(probe, "w"):
                pass
        now = os.stat(probe).st_mtime
    except OSError:
        now = time.time()
    for name in names:
        if not (name.startswith(_HB_PREFIX) and name.endswith(".json")):
            continue
        path = os.path.join(directory, name)
        try:
            with open(path) as f:
                entry = json.load(f)
            # liveness from the file's mtime — one clock (the fileserver's)
            # on both sides, immune to worker↔manager wall-clock skew;
            # the embedded ts is informational only
            mtime = os.stat(path).st_mtime
        except (OSError, ValueError):
            continue
        with _MONO_LOCK:
            seen = _MONO_SEEN.get(path)
            if seen is None or seen[0] != mtime:
                _MONO_SEEN[path] = (mtime, time.monotonic())
                first = seen is None
                mono_age = 0.0
            else:
                first = False
                mono_age = time.monotonic() - seen[1]
        wall_age = now - mtime
        if first:
            entry["alive"] = wall_age <= stale_after_s
        else:
            entry["alive"] = (wall_age <= stale_after_s
                              or mono_age <= stale_after_s)
        entry["last_seen"] = mtime
        out.append(entry)
    out.sort(key=lambda e: -e["last_seen"])
    return out


def healthy(directory: str,
            stale_after_s: Optional[float] = None) -> bool:
    """True iff every registered worker heartbeat recently."""
    status = worker_status(directory, stale_after_s)
    return bool(status) and all(e["alive"] for e in status)


def reset_workers(directory: str,
                  stale_after_s: Optional[float] = None) -> int:
    """Remove stale heartbeat files (reference ``reset-workers``,
    redis_eps/cli.py:279-280). Returns the number removed."""
    removed = 0
    for entry in worker_status(directory, stale_after_s):
        if not entry["alive"]:
            path = os.path.join(
                directory,
                f"{_HB_PREFIX}{entry['host']}_{entry['pid']}.json")
            try:
                os.remove(path)
                removed += 1
            except OSError:
                pass
            with _MONO_LOCK:
                _MONO_SEEN.pop(path, None)
    if not worker_status(directory, stale_after_s):
        # nothing registered anymore: remove the clock probe too so a
        # fully-reset run dir is empty again
        try:
            os.remove(os.path.join(directory, _PROBE_NAME))
        except OSError:
            pass
    return removed


def request_stop(directory: str):
    """Ask every host's ABCSMC to exit after the current generation
    (reference ``stop``, redis_eps/cli.py:276-277)."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, STOP_SENTINEL), "w") as f:
        f.write(str(time.time()))


def clear_stop(directory: str):
    try:
        os.remove(os.path.join(directory, STOP_SENTINEL))
    except OSError:
        pass


def stop_requested(directory: Optional[str] = None) -> bool:
    """Polled by the orchestrator between generations.

    With more than one ``torch.distributed`` rank, every rank enters one
    collective (a MAX over the ranks' local sentinel checks), so all
    ranks take the same stop decision at the same generation boundary,
    ranks started without a run directory included (their vote is
    False)."""
    directory = directory if directory is not None else run_dir()
    local = bool(directory) and os.path.exists(
        os.path.join(directory, STOP_SENTINEL))
    import torch.distributed as dist
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        import torch
        dev = ("cuda" if dist.get_backend() == "nccl" else "cpu")
        vote = torch.tensor([int(local)], device=dev)
        dist.all_reduce(vote, op=dist.ReduceOp.MAX)
        return bool(vote.item())
    return local
