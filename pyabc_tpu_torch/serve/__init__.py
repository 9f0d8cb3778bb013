"""Studies as a service: many tenants' small studies on one warm card.

Port of ``pyabc_tpu/serve`` (the JAX package's ``__all__``):

- :mod:`.spec` — the study spec and its content-address digests;
- :mod:`.queue` — the admission queue over the run-dir mount, with
  tenant quotas, backpressure, priority aging, leases and keyed claims;
- :mod:`.shards` — the partitioned ``pending/`` layout;
- :mod:`.tracing` — the per-study lifecycle event log;
- :mod:`.cache` — the two-tier content-addressed result cache;
- :mod:`.admission` — SLO load shedding;
- :mod:`.multiplex` — the study axis: many small studies as lanes of
  one windowed batch whose importance weights run through K1;
- :mod:`.worker` — the persistent warm worker (``python -m
  pyabc_tpu_torch.serve.worker``), keeping built engines warm across
  studies through :meth:`ABCSMC.renew`.
"""

from .admission import AdmissionController, ServeOverloaded
from .cache import SharedResultStore, StudyCache, TieredStudyCache
from .multiplex import (ShapeHysteresis, StudyBatch, lane_eligible,
                        multiplex_eligible)
from .queue import (QueueFull, SpecAuthError, StudyQueue,
                    TenantQuotaExceeded)
from .spec import StudySpec, problem_key, study_digest
from .worker import ServeWorker

__all__ = [
    "AdmissionController",
    "QueueFull",
    "ServeOverloaded",
    "ServeWorker",
    "ShapeHysteresis",
    "SharedResultStore",
    "SpecAuthError",
    "StudyBatch",
    "StudyCache",
    "StudyQueue",
    "StudySpec",
    "TenantQuotaExceeded",
    "TieredStudyCache",
    "lane_eligible",
    "multiplex_eligible",
    "problem_key",
    "study_digest",
]
