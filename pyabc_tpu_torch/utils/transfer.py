"""Deprecated alias of :mod:`pyabc_tpu_torch.wire.transfer`, the
transfer ledger, kept for import parity with ``pyabc_tpu.utils.transfer``;
importing it warns."""

import warnings

from ..wire.transfer import (  # noqa: F401
    _lock,
    delta,
    record_compute,
    record_d2h,
    record_decode,
    record_h2d,
    record_overlap,
    record_rewind,
    snapshot,
    timed_d2h,
    tree_nbytes,
)

warnings.warn(
    "pyabc_tpu_torch.utils.transfer is deprecated; import "
    "pyabc_tpu_torch.wire.transfer instead",
    DeprecationWarning,
    stacklevel=2,
)
