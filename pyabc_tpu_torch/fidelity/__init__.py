"""Multi-fidelity early-reject cascade.

Port of ``pyabc_tpu/fidelity/``.  Staged acceptance inside a device
engine's rejection round: every candidate first runs its model's cheap
:meth:`~pyabc_tpu_torch.model.Model.low_fidelity` variant, the resulting
distance is screened against a per-generation calibrated threshold
(:mod:`.calibrate`), and only survivors are simulated again at full
fidelity for the real accept test (:mod:`.screen` owns the slot math).
Opt-in via ``ABCSMC(fidelity="screen")``; configuration in
:mod:`.config`.
"""

from .calibrate import (pearson_corr, pearson_corr_np, screen_calibration,
                        screen_threshold, screen_threshold_np)
from .config import FidelityConfig
from .screen import compact_survivors, scatter_back, screen_mask

__all__ = [
    "FidelityConfig",
    "compact_survivors",
    "pearson_corr",
    "pearson_corr_np",
    "scatter_back",
    "screen_calibration",
    "screen_mask",
    "screen_threshold",
    "screen_threshold_np",
]
