"""K1's least time, frozen.

Copy of ``bound_seconds`` in ``pyabc_tpu_torch/ops/kde_cuda.py``
(lines 287-299) with ``EXP2_FMA_COST`` (line 67), at the clock and SM
count of the published part: an H100 SXM's maximum SM clock of
1980 MHz and its 132 SMs.  A pair of support and query rows costs an
exp and ``d + 4`` FP32 operations; the exps are shared between the 16
MUFU lanes and the FMA pipe (``EXP2_FMA_COST`` FP32 operations each) of
each SM, in the share that evens the two pipes.
"""

from __future__ import annotations

#: FP32-rate instructions of one exp on the FMA pipe (kde_cuda.py:67)
EXP2_FMA_COST = 11
#: the H100 SXM's published maximum SM clock, Hz
SM_CLOCK_HZ = 1.98e9
#: SMs of the H100 SXM
SMS = 132


def bound_seconds(m: int, n: int, d: int, sm_clock_hz: float = SM_CLOCK_HZ,
                  sms: int = SMS) -> float:
    """Least seconds for ``m * n`` query-support pairs at dimension d."""
    c = EXP2_FMA_COST
    phi = max(0.0, (4.0 - d) / (8.0 + c))
    per_pair = max((1.0 - phi) / 16.0, (d + 4.0 + phi * c) / 128.0)
    return float(m) * float(n) * per_pair / (sms * sm_clock_hz)
