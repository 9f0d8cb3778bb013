"""Fidelity-cascade configuration: one frozen dataclass, env-tunable.

Port of ``pyabc_tpu/fidelity/config.py`` (copied: plain Python).  The
multi-fidelity early-reject cascade is opt-in per run via
``ABCSMC(fidelity=...)``.  The resolved :class:`FidelityConfig` is what
the orchestrator threads into the block builders, and its
:meth:`FidelityConfig.digest_key` keys every engine the orchestrator
caches — a screened engine can never alias an unscreened one.

Environment knobs:

- ``PYABC_TPU_FIDELITY`` — operational kill switch: ``off`` disables
  screening even for runs that requested it (the run degrades to the
  exact unscreened program; results stay valid, just slower).  It
  never turns screening ON — enabling is an explicit, digest-bearing
  per-run decision.
- ``PYABC_TPU_FIDELITY_FULL_FRACTION`` — survivors re-simulated at
  full fidelity per round, as a fraction of the round batch.
- ``PYABC_TPU_FIDELITY_Q`` — calibration false-reject quantile.
- ``PYABC_TPU_FIDELITY_MARGIN`` — multiplicative slack on the
  calibrated threshold.
- ``PYABC_TPU_FIDELITY_MIN_CORR`` — self-disable floor on the
  low/full distance correlation.
- ``PYABC_TPU_FIDELITY_CAL_ROWS`` — calibration ring-buffer rows
  riding the device carry.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

ENV_FIDELITY = "PYABC_TPU_FIDELITY"
ENV_FULL_FRACTION = "PYABC_TPU_FIDELITY_FULL_FRACTION"
ENV_Q = "PYABC_TPU_FIDELITY_Q"
ENV_MARGIN = "PYABC_TPU_FIDELITY_MARGIN"
ENV_MIN_CORR = "PYABC_TPU_FIDELITY_MIN_CORR"
ENV_CAL_ROWS = "PYABC_TPU_FIDELITY_CAL_ROWS"


@dataclasses.dataclass(frozen=True)
class FidelityConfig:
    """Resolved screening configuration (mode ``"screen"`` only — an
    ``"off"`` run is represented as ``None`` everywhere downstream, so
    the unscreened code path is never run).

    Defaults are deliberately conservative: ``false_reject_q = 0.02``
    with ``margin = 1.25``, and ``min_corr = 0.2`` self-disables
    screening before a weakly-correlated low-fidelity surrogate can bias
    anything.
    """

    #: fraction of the round batch re-simulated at full fidelity —
    #: the static survivor-slot count is ``ceil(B * full_fraction)``
    full_fraction: float = 0.5
    #: calibration quantile: the screen threshold is set so at most
    #: this fraction of the previous generation's ACCEPTABLE paired
    #: samples would have been screened out
    false_reject_q: float = 0.02
    #: multiplicative slack on the calibrated threshold (> 1 loosens
    #: the screen, trading sims for safety)
    margin: float = 1.25
    #: Pearson-correlation floor between paired low/full distances;
    #: below it the generation self-disables (threshold = +inf)
    min_corr: float = 0.2
    #: calibration ring rows carried on device (NaN = empty slot)
    cal_rows: int = 1024
    #: minimum acceptable pairs before the calibrator trusts its
    #: quantile; fewer self-disables the generation
    min_pairs: int = 32

    def __post_init__(self):
        if not 0.0 < self.full_fraction <= 1.0:
            raise ValueError("full_fraction must be in (0, 1]")
        if not 0.0 < self.false_reject_q < 1.0:
            raise ValueError("false_reject_q must be in (0, 1)")
        if self.margin < 1.0:
            raise ValueError("margin must be >= 1 (a sub-1 margin "
                             "would tighten the calibrated bound)")
        if self.cal_rows < self.min_pairs:
            raise ValueError("cal_rows must hold at least min_pairs")

    # -- digest / cache identity ------------------------------------------

    def digest_key(self) -> tuple:
        """Hashable identity for the engine cache — every field that
        changes the engine or the screening statistics participates."""
        return ("screen", self.full_fraction, self.false_reject_q,
                self.margin, self.min_corr, self.cal_rows,
                self.min_pairs)

    def n_full(self, B: int) -> int:
        """Static full-fidelity slot count for a round batch ``B``."""
        return self.static_n_full(B, self.full_fraction)

    @staticmethod
    def static_n_full(B: int, full_fraction: float) -> int:
        """Slot-count formula, usable where only the fraction travels
        (the staged round receives ``full_fraction``)."""
        import math
        return max(1, min(B, int(math.ceil(B * full_fraction))))

    # -- construction ------------------------------------------------------

    @classmethod
    def from_env(cls) -> "FidelityConfig":
        """Defaults with any of the ``ENV_*`` knob overrides applied."""
        def _f(name, default):
            raw = os.environ.get(name)
            return default if raw is None else float(raw)

        def _i(name, default):
            raw = os.environ.get(name)
            return default if raw is None else int(raw)

        return cls(
            full_fraction=_f(ENV_FULL_FRACTION, cls.full_fraction),
            false_reject_q=_f(ENV_Q, cls.false_reject_q),
            margin=_f(ENV_MARGIN, cls.margin),
            min_corr=_f(ENV_MIN_CORR, cls.min_corr),
            cal_rows=_i(ENV_CAL_ROWS, cls.cal_rows),
        )

    @classmethod
    def resolve(cls, value: Union[None, bool, str, "FidelityConfig"]
                ) -> Optional["FidelityConfig"]:
        """Canonicalize the ``ABCSMC(fidelity=...)`` argument.

        ``None``/``False``/``"off"`` -> ``None`` (unscreened);
        ``True``/``"screen"`` -> env-tuned defaults; a ready
        :class:`FidelityConfig` passes through.  The
        ``PYABC_TPU_FIDELITY=off`` kill switch wins over everything.
        """
        if os.environ.get(ENV_FIDELITY, "").strip().lower() == "off":
            return None
        if value is None or value is False:
            return None
        if isinstance(value, FidelityConfig):
            return value
        if value is True:
            return cls.from_env()
        if isinstance(value, str):
            mode = value.strip().lower()
            if mode in ("", "off", "none"):
                return None
            if mode == "screen":
                return cls.from_env()
            raise ValueError(f"unknown fidelity mode {value!r} "
                             f"(expected 'off' or 'screen')")
        raise TypeError(f"fidelity must be None, bool, str or "
                        f"FidelityConfig, got {type(value).__name__}")

    def mode_str(self) -> str:
        """The digest-facing mode string (``StudySpec.fidelity``)."""
        return "screen"
