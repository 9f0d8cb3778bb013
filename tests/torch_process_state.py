"""The process-wide state a port test can leave behind, put back in one
place.

A run with sub-checkpoints installs its package's SIGTERM handler for
the process, and each package's handler chains to the one it found: an
in-process SIGTERM over the port's handler sets the JAX package's
preemption flag too, and a set flag stops every later run of that
package in the worker at once.  :func:`process_state` snapshots the
SIGTERM and SIGINT handlers and both packages' handler bookkeeping, and
clears both packages' preemption flags and fault plans, before the body
and again after it; clearing before as well guards the body against a
flag that an earlier test left set.  A test file that arms or delivers
a preemption takes it as an autouse fixture::

    from torch_process_state import clean_process_state  # noqa: F401
"""

import contextlib
import signal

import pytest

from pyabc_tpu.resilience import checkpoint as jax_ckpt
from pyabc_tpu.resilience import faults as jax_faults
from pyabc_tpu_torch.resilience import checkpoint as ckpt
from pyabc_tpu_torch.resilience import faults

_SIGNALS = (signal.SIGTERM, signal.SIGINT)
_PACKAGES = ((ckpt, faults), (jax_ckpt, jax_faults))


def _clear():
    for checkpoint, plans in _PACKAGES:
        plans.uninstall()
        checkpoint.clear_preempt()


@contextlib.contextmanager
def process_state():
    handlers = [signal.getsignal(s) for s in _SIGNALS]
    installed = [(c._INSTALLED, c._PREV_HANDLER) for c, _ in _PACKAGES]
    _clear()
    try:
        yield
    finally:
        _clear()
        for s, handler in zip(_SIGNALS, handlers):
            signal.signal(s, handler)
        for (c, _), (flag, prev) in zip(_PACKAGES, installed):
            c._INSTALLED, c._PREV_HANDLER = flag, prev


@pytest.fixture(autouse=True)
def clean_process_state():
    with process_state():
        yield
