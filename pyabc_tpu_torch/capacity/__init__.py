"""Device-memory capacity planning: plan, then run, instead of running
out of memory.

:mod:`.model` predicts the peak bytes of a run shape before anything is
allocated, so the orchestrator can take the (batch, K, max_T, at-rest
precision) point that fits the budget — or raise a
:class:`CapacityError` carrying the full ledger when nothing does.
"""

from .model import (  # noqa: F401
    HBM_BUDGET_ENV,
    HBM_HEADROOM_ENV,
    ROUND_HEADROOM,
    CapacityError,
    CapacityPlan,
    detect_hbm_bytes,
    ledger,
    parse_bytes,
    plan,
    predict_peak_bytes,
    resolved_budget_bytes,
)
