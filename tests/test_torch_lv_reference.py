"""The port's Lotka-Volterra simulator against the benchmark's plain
float64 reference (``benchmark/reference/lotka_volterra.py``, loaded by
path), fed the same standard-normal increments.

The tolerance: a trajectory goes through about ``ROUNDINGS`` float32
roundings of relative size ``U`` each (ten a step, 300 steps).  Their
error, relative to the populations' scale ``1 + |reference|`` (relative
above one animal, absolute below), is at most ``ROUNDINGS * U`` when
they add up in one direction and about ``sqrt(ROUNDINGS) * U`` when they
add up as a random walk.  So the median over every kept state must lie
within ``MEDIAN_TOL`` and the 99th percentile within ``P99_TOL``.  The
largest error is not bounded: a trajectory that passes close to
extinction and recovers multiplies whatever rounding it carries (one
row in 65 536 prior draws reads 2.9e-3).  A bfloat16 run of the same
update (8 bits of mantissa) misses both limits by hundreds of times, a
float16 run overflows (the prey grow past 65 504).

Marked ``cuda``, the comparison at the timed batch of 2^19 rows; the
file imports neither JAX nor the JAX package, so on the machine with the
card it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_lv_reference.py
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from pyabc_tpu_torch.models.lotka_volterra import (
    LV_TRUTH, LotkaVolterraSDE, make_lotka_volterra_problem)

ROOT = Path(__file__).resolve().parents[1]

#: float32 roundings along one trajectory, and the size of each
ROUNDINGS = 10 * 300
U = 2.0 ** -24
MEDIAN_TOL = math.sqrt(ROUNDINGS) * U
P99_TOL = ROUNDINGS * U


def _reference():
    path = ROOT / "benchmark" / "reference" / "lotka_volterra.py"
    spec = importlib.util.spec_from_file_location("lv_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _reference()


def _draws(n: int, kind: str, seed: int, device="cpu"):
    """``theta[n, 4]`` (float32) from the prior's box or near
    ``LV_TRUTH``, and the increments ``[300, n, 2]``."""
    g = torch.Generator(device=device).manual_seed(seed)
    if kind == "prior":
        lo = torch.tensor([-1.0, -3.0, -2.0, -1.0], device=device)
        theta = lo + 2.0 * torch.rand(n, 4, generator=g, device=device)
    else:
        theta = (torch.log(torch.tensor(LV_TRUTH, device=device))
                 + 0.1 * torch.randn(n, 4, generator=g, device=device))
    noise = torch.randn(300, n, 2, generator=g, device=device)
    return theta.float(), noise


def _errors(got: dict, want: dict) -> torch.Tensor:
    """Every kept state's error on the populations' scale, float64."""
    assert set(got) == set(want) == {"prey", "predator"}
    return torch.cat([((got[k].double() - want[k]).abs()
                       / (1.0 + want[k].abs())).flatten() for k in want])


def _within(e: torch.Tensor) -> bool:
    if not bool(torch.isfinite(e).all()):
        return False
    q = torch.quantile(e.cpu(), torch.tensor([0.5, 0.99], dtype=e.dtype))
    return float(q[0]) <= MEDIAN_TOL and float(q[1]) <= P99_TOL


def test_the_observation_steps_agree():
    assert LotkaVolterraSDE().obs_idx.tolist() == ref.obs_steps()


@pytest.mark.parametrize("n", [64, 512, 4096])
@pytest.mark.parametrize("kind", ["prior", "near_truth"])
def test_integrate_matches_the_reference(n, kind):
    theta, noise = _draws(n, kind, seed=n + len(kind))
    want = ref.integrate(theta, noise)
    got = LotkaVolterraSDE().integrate(theta, noise)
    assert got["prey"].dtype == torch.float32
    assert got["prey"].shape == got["predator"].shape == (n, 10)
    assert _within(_errors(got, want))
    assert min(float(v.min()) for v in got.values()) >= 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_a_lower_precision_run_fails_the_tolerance(dtype):
    theta, noise = _draws(4096, "prior", seed=1)
    want = ref.integrate(theta, noise)
    low = LotkaVolterraSDE().integrate(theta.to(dtype), noise.to(dtype))
    e = _errors(low, want)
    assert not _within(e)
    if dtype is torch.bfloat16:
        # finite, and the typical state already misses: the median
        assert float(torch.median(e)) > 100 * MEDIAN_TOL


def test_the_observed_data_are_the_references_under_seed_7():
    """The factory's data: ``LV_TRUTH`` under a CPU generator seeded
    with 7, whose first draw is the whole ``[300, 1, 2]`` block."""
    observed = make_lotka_volterra_problem()[3]
    g = torch.Generator().manual_seed(7)
    noise = torch.randn((300, 1, 2), generator=g)
    theta = torch.log(torch.tensor([LV_TRUTH], dtype=torch.float32))
    want = ref.integrate(theta, noise)
    got = {k: torch.as_tensor(np.asarray(observed[k]))[None]
           for k in ("prey", "predator")}
    # one trajectory near the truth: within the one-direction bound
    assert float(_errors(got, want).max()) <= P99_TOL


@pytest.mark.cuda
def test_integrate_at_the_timed_batch_on_the_card():
    """2^19 rows, half prior draws and half near the truth, one noise
    block drawn on the card: the port in float32 within the tolerance of
    the float64 reference; the port in bfloat16 not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (see the module docstring)")
    dev = torch.device("cuda")
    half = 1 << 18
    th_p, noise_p = _draws(half, "prior", seed=2 ** 31 + 19, device=dev)
    th_t, noise_t = _draws(half, "near_truth", seed=2 ** 31 + 20, device=dev)
    theta = torch.cat([th_p, th_t])
    noise = torch.cat([noise_p, noise_t], dim=1)
    del noise_p, noise_t
    model = LotkaVolterraSDE()
    want = ref.integrate(theta, noise)
    got = model.integrate(theta, noise)
    torch.cuda.synchronize()
    e = _errors(got, want)
    q = torch.quantile(e.cpu(), torch.tensor([0.5, 0.99, 0.999],
                                             dtype=e.dtype))
    print(f"lv integrate 2^19 on {torch.cuda.get_device_name(0)}: "
          f"median {float(q[0]):.3e}, p99 {float(q[1]):.3e}, "
          f"p99.9 {float(q[2]):.3e}, max {float(e.max()):.3e}")
    assert _within(e)
    low = model.integrate(theta.bfloat16(), noise.bfloat16())
    e_low = _errors(low, want)
    print(f"lv integrate 2^19 bfloat16: median "
          f"{float(torch.median(e_low)):.3e}")
    assert not _within(e_low)
