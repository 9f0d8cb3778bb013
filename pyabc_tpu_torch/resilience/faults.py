"""Deterministic, seeded fault injection for the device hot loop.

Port of ``pyabc_tpu/resilience/faults.py``: the same plan grammar, the
same seeded firing, the same actions.  A :class:`FaultPlan` (built in
code or from the ``PYABC_TPU_FAULTS`` environment variable) raises,
delays, bit-flips, or delivers a real ``SIGTERM``/``SIGKILL`` at an
exact visit of a named site — reproducibly, under a fixed seed.

Fault sites (the constants below):

- ``device.dispatch`` — every device dispatch under a retry policy
  (``Sampler._dispatch``, the fused / one-dispatch / pipelined block
  dispatches in smc.py)
- ``wire.fetch``      — the d2h chokepoint (``sampler.base
  .fetch_to_host``), including background ingest workers (wire/)
- ``history.append``  — the per-generation durable write
  (``storage.history.History.append_population``)
- ``preempt``         — polled once per sampler call; the ``sigterm``
  action here simulates a preemption notice mid-generation
  (resilience/checkpoint.py)
- ``store.deposit``   — ``wire.store.DeviceRunStore.deposit``, the
  lazy path's acknowledge point
- ``store.spill``     — ring eviction fetching an at-risk generation
  to the host + write-ahead journal
- ``store.hydrate``   — ``wire.store.entry_host_wire`` decoding a
  generation back into a Population (data hook: the fetched host wire)
- ``history.materialize`` — ``storage.history`` turning a lazy row
  into durable blobs (spill drain)
- ``journal.write``   — every ``resilience.journal.SpillJournal``
  append (data hook: the framed record bytes)
- ``run.drain``       — each generation the one-dispatch drain harvests
- ``fidelity.calibrate`` — block-carry seeding of the multi-fidelity
  calibration rings (``ABCSMC._seed_block_carry``)

The JAX package's ``heartbeat.write`` and ``serve.window`` sites belong
to layers the port does not have yet.

Plan grammar (semicolon-separated directives)::

    site@N:action     fire at exactly the N-th visit of the site
    site@N+:action    fire at every visit >= N
    site~P:action     fire with probability P per visit (seeded RNG)

    action := raise=ExcName | delay=SECONDS | sigterm | sigkill
            | corrupt=N

e.g. ``PYABC_TPU_FAULTS="wire.fetch@3:raise=ConnectionResetError;``
``preempt@5:sigterm"``.  Exception names resolve against builtins plus
a small registry (``OperationalError``, ``WireError``).  ``sigkill`` delivers an uncatchable ``SIGKILL``
to the process (subprocess chaos tests only).  ``corrupt=N`` flips N
bits (deterministically, from the plan seed) in the data passing through
the site — only sites that hand bytes to :func:`fault_point` via
``data=`` can corrupt; elsewhere it degrades to a no-op visit.

Disabled cost: :func:`fault_point` is one module-global load and a
``None`` check.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

SITE_DISPATCH = "device.dispatch"
SITE_FETCH = "wire.fetch"
SITE_APPEND = "history.append"
SITE_PREEMPT = "preempt"
SITE_STORE_DEPOSIT = "store.deposit"
SITE_STORE_SPILL = "store.spill"
SITE_STORE_HYDRATE = "store.hydrate"
SITE_MATERIALIZE = "history.materialize"
SITE_JOURNAL = "journal.write"
SITE_DRAIN = "run.drain"
SITE_FIDELITY_CALIBRATE = "fidelity.calibrate"

#: every named fault site, for validation and docs
SITES = (SITE_DISPATCH, SITE_FETCH, SITE_APPEND, SITE_PREEMPT,
         SITE_STORE_DEPOSIT, SITE_STORE_SPILL, SITE_STORE_HYDRATE,
         SITE_MATERIALIZE, SITE_JOURNAL, SITE_DRAIN,
         SITE_FIDELITY_CALIBRATE)

FAULTS_ENV = "PYABC_TPU_FAULTS"
FAULT_SEED_ENV = "PYABC_TPU_FAULT_SEED"

_HELP = "resilience fault injection; see resilience/faults.py"


def _counter(name: str):
    # create-or-return each call: survives REGISTRY.reset() in tests
    from ..telemetry.metrics import REGISTRY
    return REGISTRY.counter(name, _HELP)


def _resolve_exception(name: str) -> type:
    """Exception class for a plan directive: builtins first, then the
    in-repo registry of failure types chaos tests care about."""
    import builtins
    exc = getattr(builtins, name, None)
    if isinstance(exc, type) and issubclass(exc, BaseException):
        return exc
    if name == "OperationalError":
        import sqlite3
        return sqlite3.OperationalError
    if name == "WireError":
        from ..wire.streaming import WireError
        return WireError
    raise ValueError(f"unknown exception name in fault plan: {name!r}")


class FaultSpec:
    """One parsed directive of a :class:`FaultPlan`."""

    __slots__ = ("site", "mode", "arg", "action", "action_arg")

    def __init__(self, site: str, mode: str, arg: float, action: str,
                 action_arg=None):
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r} (valid: {', '.join(SITES)})")
        if mode not in ("at", "from", "prob"):
            raise ValueError(f"unknown trigger mode {mode!r}")
        if action not in ("raise", "delay", "sigterm", "sigkill",
                          "corrupt"):
            raise ValueError(f"unknown fault action {action!r}")
        self.site = site
        self.mode = mode
        self.arg = arg
        self.action = action
        self.action_arg = action_arg

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        text = text.strip()
        head, sep, action = text.partition(":")
        if not sep:
            raise ValueError(
                f"fault directive {text!r} is missing ':action'")
        if "@" in head:
            site, _, trig = head.partition("@")
            if trig.endswith("+"):
                mode, arg = "from", int(trig[:-1])
            else:
                mode, arg = "at", int(trig)
            if arg < 1:
                raise ValueError(
                    f"visit index must be >= 1 in {text!r}")
        elif "~" in head:
            site, _, trig = head.partition("~")
            mode, arg = "prob", float(trig)
            if not 0.0 <= arg <= 1.0:
                raise ValueError(
                    f"probability must be in [0, 1] in {text!r}")
        else:
            raise ValueError(
                f"fault directive {text!r} needs '@N', '@N+' or '~P'")
        kind, _, val = action.partition("=")
        kind = kind.strip()
        if kind == "raise":
            return cls(site.strip(), mode, arg, "raise",
                       _resolve_exception(val.strip()))
        if kind == "delay":
            return cls(site.strip(), mode, arg, "delay", float(val))
        if kind in ("sigterm", "sigkill"):
            if val.strip():
                raise ValueError(
                    f"{kind} takes no argument in {text!r}")
            return cls(site.strip(), mode, arg, kind)
        if kind == "corrupt":
            nbits = int(val) if val.strip() else 1
            if nbits < 1:
                raise ValueError(
                    f"corrupt=N needs N >= 1 in {text!r}")
            return cls(site.strip(), mode, arg, "corrupt", nbits)
        raise ValueError(f"unknown fault action in {text!r}")

    def fires(self, visit: int, rng: random.Random) -> bool:
        if self.mode == "at":
            return visit == int(self.arg)
        if self.mode == "from":
            return visit >= int(self.arg)
        return rng.random() < self.arg

    def __repr__(self):  # pragma: no cover - debugging aid
        trig = {"at": f"@{int(self.arg)}", "from": f"@{int(self.arg)}+",
                "prob": f"~{self.arg}"}[self.mode]
        return f"FaultSpec({self.site}{trig}:{self.action})"


class FaultPlan:
    """A deterministic set of :class:`FaultSpec` directives.

    Visit counters are per-site and process-global for the plan's
    lifetime; probabilistic triggers draw from a per-spec ``Random``
    seeded from ``(seed, spec index)``, so the same plan + seed fires
    at the same visits on every run — chaos tests are reproducible.
    """

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        self._visits: Dict[str, int] = {}
        self._rngs = [random.Random((self.seed + 1) * 1000003 + i)
                      for i in range(len(self.specs))]
        self._lock = threading.Lock()
        #: (site, action) -> times fired, for test assertions
        self.fired: Dict[Tuple[str, str], int] = {}

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        specs = [FaultSpec.parse(part)
                 for part in text.split(";") if part.strip()]
        if not specs:
            raise ValueError(f"empty fault plan: {text!r}")
        return cls(specs, seed=seed)

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        text = os.environ.get(FAULTS_ENV, "").strip()
        if not text:
            return None
        seed = int(os.environ.get(FAULT_SEED_ENV, "0"))
        return cls.parse(text, seed=seed)

    def visits(self, site: str) -> int:
        with self._lock:
            return self._visits.get(site, 0)

    def visit(self, site: str, data=None):
        """Count one visit of ``site``, run any triggered actions, and
        return ``data`` (bit-flipped if a ``corrupt`` spec fired).

        The trigger decision happens under the plan lock (deterministic
        counters even with background ingest threads); the action runs
        outside it — a raise must not leave the lock held, and a delay
        must not serialize unrelated sites.
        """
        actions = []
        with self._lock:
            visit = self._visits.get(site, 0) + 1
            self._visits[site] = visit
            for i, spec in enumerate(self.specs):
                if spec.site == site and spec.fires(visit, self._rngs[i]):
                    actions.append(spec)
                    key = (site, spec.action)
                    self.fired[key] = self.fired.get(key, 0) + 1
        for spec in actions:
            _counter("resilience_faults_injected_total").inc()
            from ..telemetry.flight import RECORDER
            RECORDER.note("fault", site=site, action=spec.action,
                          visit=visit)
            if spec.action == "delay":
                time.sleep(spec.action_arg)
            elif spec.action == "sigterm":
                # a REAL signal, not a flag: the installed handler
                # (resilience/checkpoint.py) must prove it turns an
                # asynchronous SIGTERM into a flush + clean Preempted
                import signal
                os.kill(os.getpid(), signal.SIGTERM)
            elif spec.action == "sigkill":
                # uncatchable by design: the process dies HERE, and the
                # durability contract is whatever already hit the disk
                import signal
                os.kill(os.getpid(), signal.SIGKILL)
                time.sleep(60)  # pragma: no cover - death is imminent
            elif spec.action == "corrupt":
                corrupted = _corrupt(
                    data, spec.action_arg,
                    seed=(self.seed + 1) * 9176 + visit)
                if corrupted is not None:
                    data = corrupted
            else:
                message = f"injected fault at {site} (visit {visit})"
                import sqlite3
                if spec.action_arg is sqlite3.OperationalError:
                    # the realistic TRANSIENT sqlite failure — carries
                    # the marker retry.is_transient classifies on, so
                    # the injection tests the retry path, not the
                    # fatal-error path
                    message = "database is locked; " + message
                raise spec.action_arg(message)
        return data


#: the installed plan; ``None`` = injection disabled (the hot-path
#: fast case: fault_point is one load + None check)
_PLAN: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    global _PLAN
    _PLAN = plan
    return plan


def uninstall():
    global _PLAN
    _PLAN = None


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def install_from_env() -> Optional[FaultPlan]:
    """Install the ``PYABC_TPU_FAULTS`` plan, if the variable is set.
    Called once at package import so subprocess chaos tests need no
    code — just the environment variable."""
    plan = FaultPlan.from_env()
    if plan is not None:
        install(plan)
    return plan


def _corrupt(data, nbits: int, seed: int):
    """Flip ``nbits`` bits in ``data`` (bytes/bytearray, a numpy array,
    or a dict of numpy arrays) deterministically from ``seed``.
    Returns the corrupted copy, or ``None`` when the site passed no
    corruptible data (the visit still counts; nothing else happens)."""
    import numpy as np
    rng = random.Random(seed)

    def _flip_bytes(buf: bytes) -> bytes:
        if not buf:
            return buf
        out = bytearray(buf)
        for _ in range(nbits):
            i = rng.randrange(len(out))
            out[i] ^= 1 << rng.randrange(8)
        return bytes(out)

    def _flip_array(arr: "np.ndarray") -> "np.ndarray":
        raw = _flip_bytes(arr.tobytes())
        return (np.frombuffer(raw, dtype=arr.dtype)
                .reshape(arr.shape).copy())  # writable, like the original

    if isinstance(data, (bytes, bytearray)):
        return _flip_bytes(bytes(data))
    if isinstance(data, np.ndarray):
        return _flip_array(data)
    if isinstance(data, dict) and data:
        keys = [k for k in sorted(data)
                if isinstance(data[k], np.ndarray) and data[k].size]
        if not keys:
            return None
        out = dict(data)
        k = keys[rng.randrange(len(keys))]
        out[k] = _flip_array(np.asarray(out[k]))
        return out
    return None


def fault_point(site: str, data=None):
    """The hook every instrumented chokepoint calls.  No-op (one global
    load + ``None`` check) unless a plan is installed.  Sites that move
    bytes pass them via ``data`` and MUST use the return value — that
    is how ``corrupt=N`` plans inject bit rot."""
    plan = _PLAN
    if plan is None:
        return data
    return plan.visit(site, data)
