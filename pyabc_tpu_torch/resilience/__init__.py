"""Fault injection, retry, checkpointing, and the crash-consistent spill
journal of the PyTorch port.

Port of ``pyabc_tpu/resilience`` without its pod half:

- :mod:`.faults` — deterministic, seeded fault injection at the hot
  loop's named sites (``PYABC_TPU_FAULTS``), so chaos tests are
  reproducible;
- :mod:`.retry` — bounded exponential-backoff retry around every device
  dispatch, the d2h chokepoint and the History writes, with
  transient-vs-fatal classification (CUDA errors included) and graceful
  degradation (batch-rung drop, fused / one-dispatch / pipelined ->
  sequential fallback);
- :mod:`.checkpoint` — mid-generation sub-checkpointing: a round-granular
  accepted-particle ledger flushed to the History, so a SIGTERM
  mid-generation loses at most one flush interval;
- :mod:`.journal` — the lazy History's durability contract: an
  append-only fsync'd CRC-framed write-ahead journal for device-resident
  generations, per-generation content digests verified on every
  hydration, and crash recovery that replays what a kill stranded.
"""

from . import checkpoint, faults, journal, retry  # noqa: F401
from .checkpoint import GenCheckpointer, Preempted
from .faults import (FAULTS_ENV, SITE_APPEND, SITE_DISPATCH, SITE_DRAIN,
                     SITE_FETCH, SITE_FIDELITY_CALIBRATE, SITE_HEARTBEAT,
                     SITE_JOURNAL, SITE_MATERIALIZE, SITE_PREEMPT,
                     SITE_STORE_DEPOSIT,
                     SITE_STORE_HYDRATE, SITE_STORE_SPILL, SITES, FaultPlan,
                     FaultSpec, active_plan, fault_point, install,
                     install_from_env, uninstall)
from .journal import (IntegrityError, SpillJournal, digest_wire,
                      journal_for_history, verify_wire)
from .retry import (RetryExhausted, RetryPolicy, is_transient,
                    retry_counters, shared_policy)

# env-driven chaos needs no code: subprocess tests just set
# PYABC_TPU_FAULTS (+ PYABC_TPU_FAULT_SEED) and import the package
install_from_env()

__all__ = [
    "FaultPlan", "FaultSpec", "active_plan", "fault_point", "install",
    "install_from_env", "uninstall", "FAULTS_ENV", "SITES",
    "SITE_DISPATCH", "SITE_FETCH", "SITE_APPEND", "SITE_HEARTBEAT",
    "SITE_PREEMPT",
    "SITE_STORE_DEPOSIT", "SITE_STORE_SPILL", "SITE_STORE_HYDRATE",
    "SITE_MATERIALIZE", "SITE_JOURNAL", "SITE_DRAIN",
    "SITE_FIDELITY_CALIBRATE",
    "RetryPolicy", "RetryExhausted", "is_transient", "shared_policy",
    "retry_counters",
    "GenCheckpointer", "Preempted",
    "SpillJournal", "IntegrityError", "digest_wire", "verify_wire",
    "journal_for_history",
]
