"""The port's resilience and telemetry layers on the card (marked
``cuda``: they skip without one).  This file imports no JAX: the card
machine has none, so run it with ``--noconftest``.

- a real ``torch.cuda.OutOfMemoryError`` is transient: a retry policy
  uses up its attempts and raises ``RetryExhausted`` with the OOM chained;
- a device-side assert (an out-of-bounds gather on the card) in a child
  process is fatal: one attempt, the CUDA error named, non-zero exit;
- a dispatch that fails after its rounds drew on the card's generator
  retries the same draws;
- the telemetry lanes and the generator's state save/restore read
  nothing back to the host (``torch.cuda.set_sync_debug_mode("error")``).
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from pyabc_tpu_torch.resilience import faults, retry
from pyabc_tpu_torch.telemetry import lanes

pytestmark = pytest.mark.cuda

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (see the module docstring)")
    return torch.device("cuda")


def test_real_oom_is_transient_and_exhausts(dev):
    total = torch.cuda.get_device_properties(0).total_memory
    policy = retry.RetryPolicy(max_attempts=3, base_delay_s=0.0)

    def too_big():
        return torch.empty(2 * total, dtype=torch.uint8, device=dev)

    with pytest.raises(retry.RetryExhausted) as info:
        policy.call(too_big, faults.SITE_DISPATCH)
    assert isinstance(info.value.__cause__, torch.cuda.OutOfMemoryError)
    assert retry.is_transient(info.value.__cause__)
    assert policy.last_attempts == 3
    torch.ones(4, device=dev).sum().item()  # the context still works


def test_device_side_assert_is_fatal_with_one_attempt(dev):
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {_REPO!r})
        import torch
        from pyabc_tpu_torch.resilience import faults, retry
        policy = retry.RetryPolicy(max_attempts=3, base_delay_s=0.0)
        x = torch.zeros(16, device="cuda")
        idx = torch.arange(16, device="cuda") + 100

        def dispatch():
            return float(x[idx].sum())

        try:
            policy.call(dispatch, faults.SITE_DISPATCH)
        except Exception as err:
            print("ATTEMPTS", policy.last_attempts,
                  retry.is_transient(err), retry.is_sticky_cuda_error(err))
            raise
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "ATTEMPTS 1 False True" in proc.stdout
    assert "device-side assert" in proc.stderr


def test_retry_after_draws_repeats_them_on_the_card(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    seen, calls = [], {"n": 0}

    def dispatch():
        calls["n"] += 1
        draws = torch.rand(1 << 20, generator=gen, device=dev)
        seen.append(draws)
        if calls["n"] == 1:
            raise ConnectionResetError("after the draws")
        return draws

    out = retry.RetryPolicy(base_delay_s=0.0).call(
        dispatch, faults.SITE_DISPATCH, rng=gen)
    assert calls["n"] == 2
    assert torch.equal(out, seen[0])


def test_lanes_and_generator_state_read_nothing_back(dev):
    cost = lanes.phase_cost_model(B=1 << 19, n_target=10 ** 6, d=1, s=1,
                                  M=2, eps_mode="quantile",
                                  support_rows=1 << 14, adaptive=False)
    rounds = torch.tensor(9, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tl = lanes.phase_wire_lanes(rounds, 1 << 19, cost)
        gen.set_state(gen.get_state())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(tl["tl_sims"]) == 9 << 19
    assert tl["tl_phase"].shape == (len(lanes.PHASES),)
