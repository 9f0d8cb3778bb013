"""The process-wide state a port test leaves behind
(``tests/torch_process_state.py``).

A port run arms the port's SIGTERM handler over the JAX package's, and
the port's chains to it: an in-process SIGTERM then sets both packages'
preemption flags.  A port test that delivers one must clear both, or
every later JAX run in the worker stops at once.  The order below is
one that a worker of the suite can run: the JAX package's resume test
arms its handler, the port's resume-splice test delivers a SIGTERM,
and the JAX wire test runs after it.
"""

import os
import signal
import subprocess
import sys

from pyabc_tpu.resilience import checkpoint as jax_ckpt
from pyabc_tpu_torch.resilience import checkpoint as ckpt

from torch_process_state import process_state

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ORDER = (
    "tests/test_resilience.py::test_stale_splice_discarded_on_eps_mismatch",
    "tests/test_torch_history_prepack.py::"
    "test_a_resume_splice_takes_the_one_shot_pack",
    "tests/test_wire.py::test_stats_off_wire_cuts_bytes",
)


def test_a_port_sigterm_does_not_stop_the_jax_runs_after_it(tmp_path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:xdist",
         "-p", "no:randomly", "-p", "no:cacheprovider",
         f"--basetemp={tmp_path / 'run'}", *ORDER],
        cwd=_REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert "3 passed" in out.stdout, out.stdout[-4000:]


def test_a_sigterm_over_both_handlers_leaves_neither_flag_set():
    found = (signal.getsignal(signal.SIGTERM),
             signal.getsignal(signal.SIGINT))
    installed = [(c._INSTALLED, c._PREV_HANDLER) for c in (ckpt, jax_ckpt)]
    with process_state():
        # the JAX package's first, so that the port's chains to it
        for c in (jax_ckpt, ckpt):
            c._INSTALLED = False
            assert c.install_signal_handlers()
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        signal.raise_signal(signal.SIGTERM)
        assert ckpt.preempt_requested() and jax_ckpt.preempt_requested()
    assert not ckpt.preempt_requested()
    assert not jax_ckpt.preempt_requested()
    assert (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT)) == found
    assert [(c._INSTALLED, c._PREV_HANDLER)
            for c in (ckpt, jax_ckpt)] == installed
