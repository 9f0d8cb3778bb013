#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``pyabc_tpu_torch``) on one card.

    python3 chip_smoke.py                 # every phase, one CUDA device
    python3 chip_smoke.py --phases card,build,kernels

Phases, each printed as one JSON line and each fatal on failure:

1. ``card``    — the card's name, power limit and maximum SM clock.
2. ``build``   — compile every CUDA kernel of the port from its source.
3. ``kernels`` — each kernel against its plain PyTorch version on the card
   at the shapes the main path gives it (tolerance ``1e-4 + 1e-5·|ref|``),
   with its time, the plain time, a one-call library yardstick where one
   exists, and the least time the card could take (``bound_ms``).
4. ``pop16384`` / ``pop1e6`` — the main path: two-Gaussian model selection
   (BASELINE config #2) through ``ABCSMC.run`` with ``MedianEpsilon`` and
   ``VectorizedSampler``, held to the analytic model posterior and mean
   (the JAX package's ``tools/verify_northstar_posterior.py`` gate), with
   the kernel's launch count read around each run.

``--phases profile`` (not in the default run) profiles the slowest
generation of the pop-1e6 run with ``torch.profiler``: device time by
kernel and the device's idle share.

The ``kernels`` summary line and the ``nvidia-smi`` name/power-limit
line come just before the last line, which is ``{"ok": true, "device":
{...}}``.  The script imports nothing of JAX or of the JAX package, exits
non-zero without a result when no CUDA device is present, and builds the
kernels itself.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ALL_PHASES = ("card", "build", "kernels", "pop16384", "pop1e6")
#: opt-in phases (``--phases``): not part of the default smoke
EXTRA_PHASES = ("profile",)
TOL_ABS = 1e-4
TOL_REL = 1e-5
#: largest [M, N] float32 block the library yardstick may materialize
LIBRARY_MAX_BYTES = 8e9


def emit(obj: dict):
    print(json.dumps(obj), flush=True)


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[0]


def time_cuda(torch, fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` calls, each timed with
    CUDA events after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------- phases


def phase_card(torch, state):
    name_limit = smi("name,power.limit")
    clock = smi("clocks.max.sm")
    state["smi"] = name_limit
    state["sm_clock_hz"] = float(clock.split()[0]) * 1e6
    emit({"phase": "card", "ok": True, "nvidia_smi": name_limit,
          "clocks_max_sm": clock, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})


def phase_build(torch, state):
    from pyabc_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    regs = {name: [ln for ln in info["ptxas"].splitlines()
                   if "registers" in ln]
            for name, info in built.items()}
    emit({"phase": "build", "ok": True,
          "seconds": time.perf_counter() - t0,
          "built": sorted(built), "ptxas": regs})


def _kde_case(torch, gen, dev, label, m, n, d, pad_frac=0.0,
              grid=False, pad_last_tile=False):
    """Inputs of one K1 comparison, made on the card from ``gen``."""
    f32 = torch.float32
    if grid:
        # grid-compressed 1-D support (transition _compress_support):
        # cell centroids over the posterior's range, Gaussian cell mass,
        # empty cells at -1e30; bandwidth = 64 cells
        centers = torch.linspace(-1.0, 3.0, n, device=dev, dtype=f32)
        support = centers[:, None].contiguous()
        mass = torch.exp(-0.5 * ((centers - 1.0) / 0.4) ** 2)
        mass = mass * (torch.rand(n, generator=gen, device=dev) > 0.1)
        log_w = torch.where(mass > 0, torch.log(mass / mass.sum()),
                            torch.full_like(mass, -1e30))
        h = 64 * 4.0 / n
        x = 1.0 + 0.4 * torch.randn(m, 1, generator=gen, device=dev)
        chol = torch.full((1, 1), h, device=dev, dtype=f32)
    else:
        support = torch.randn(n, d, generator=gen, device=dev)
        x = torch.randn(m, d, generator=gen, device=dev)
        log_w = torch.log_softmax(
            0.3 * torch.randn(n, generator=gen, device=dev), 0)
        # Silverman bandwidth of a unit-variance population of n points
        h = (4.0 / (n * (d + 2.0))) ** (1.0 / (d + 4.0))
        chol = torch.eye(d, device=dev, dtype=f32) * h
        n_pad = int(round(pad_frac * n))
        if n_pad:
            # pad_params: zero support rows carrying log_w = -1e30
            support[n - n_pad:] = 0.0
            log_w[n - n_pad:] = -1e30
        if pad_last_tile:
            log_w[(n // 256 - 1) * 256:] = -1e30
    log_norm = float(-0.5 * d * math.log(2 * math.pi)
                     - torch.log(torch.diagonal(chol)).sum().item())
    return {"label": label, "x": x, "support": support, "log_w": log_w,
            "chol": chol, "log_norm": log_norm, "m": m, "n": n, "d": d}


def phase_kernels(torch, state):
    from pyabc_tpu_torch.ops import kde as kde_plain
    from pyabc_tpu_torch.ops import kde_cuda

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)
    cases = [
        ("a pop16384 finalize", 16384, 16384, 1, {"pad_frac": 0.2}),
        ("b pop1e6 grid 2^13", 1_000_000, 8192, 1, {"grid": True}),
        ("b pop1e6 grid 2^14", 1_000_000, 16384, 1, {"grid": True}),
        ("b pop1e6 grid 2^16", 1_000_000, 65536, 1, {"grid": True}),
        ("c 65536^2 d=2", 65536, 65536, 2, {}),
        ("c 65536^2 d=5", 65536, 65536, 5, {}),
        ("d ragged d=3", 1000, 1537, 3, {"pad_last_tile": True}),
    ]
    rows = []
    ok_all = True
    for label, m, n, d, kw in cases:
        c = _kde_case(torch, gen, dev, label, m, n, d, **kw)
        args = (c["x"], c["support"], c["log_w"], c["chol"], c["log_norm"])
        got = kde_cuda.weighted_kde_logpdf_cuda(*args)
        ref = kde_plain.weighted_kde_logpdf(*args)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        finite = bool(torch.isfinite(got).all() and torch.isfinite(ref).all())
        ok = finite and bool((err <= TOL_ABS + TOL_REL * ref.abs()).all())
        ms = time_cuda(torch, lambda: kde_cuda.weighted_kde_logpdf_cuda(
            *args), reps=10, warmup=2)
        plain_ms = time_cuda(torch, lambda: kde_plain.weighted_kde_logpdf(
            *args), reps=3)
        library_ms = None
        if 4.0 * m * n <= LIBRARY_MAX_BYTES:
            z_x, z_s = kde_plain.whiten(*args[:4])
            b_s = c["log_w"] - 0.5 * (z_s * z_s).sum(1)
            a_x = 0.5 * (z_x * z_x).sum(1)
            library_ms = time_cuda(torch, lambda: torch.logsumexp(
                z_x @ z_s.T + b_s, 1) - a_x + c["log_norm"], reps=5)
            del z_x, z_s
        bound_ms = 1e3 * kde_cuda.bound_seconds(m, n, d,
                                                state["sm_clock_hz"])
        row = {"phase": "kernels", "kernel": "kde_logpdf", "shape": label,
               "M": m, "N": n, "d": d, "ok": ok,
               "max_abs_err": float(err.max()), "kernel_ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": "operations",
               "pairs_per_s": m * n / (ms * 1e-3)}
        emit(row)
        rows.append(row)
        ok_all = ok_all and ok
        del c, args, got, ref, err
        torch.cuda.empty_cache()
    state["kernel_rows"] = rows
    if not ok_all:
        raise RuntimeError("K1 disagrees with its plain version")


def run_main_path(torch, pop: int, gens: int, seed: int = 0) -> dict:
    """Config #2 through the port's entry points on the card, held to the
    analytic posterior as the JAX package's ``run_gate`` holds it."""
    import numpy as np

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import make_two_gaussians_problem
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda

    models, priors, distance, observed, posterior_fn = \
        make_two_gaussians_problem()
    abc = pt.ABCSMC(
        models, priors, distance, population_size=pop,
        eps=pt.MedianEpsilon(),
        sampler=pt.VectorizedSampler(max_batch_size=1 << 19,
                                     max_rounds_per_call=16, device="cuda"),
        stores_sum_stats=False, seed=seed, device="cuda")
    abc.new("sqlite://", observed)
    weighted_kde_logpdf_cuda.launches = 0
    t0 = time.perf_counter()
    abc.run(max_nr_populations=gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = weighted_kde_logpdf_cuda.launches
    t = abc.history.max_t
    p_b = float(abc.history.get_model_probabilities(t).get(1, 0.0))
    p_true = float(posterior_fn(1.0))
    df, w = abc.history.get_distribution(m=1, t=t)
    mu = float(np.sum(df["mu"].to_numpy() * w)) if len(df) else math.nan
    tol_p = max(2.5e-3, 2.5 / pop ** 0.5)
    tol_mu = max(3e-3, 3.0 / pop ** 0.5)
    rows = abc.timeline
    launches_ok = all(r["kde_launches"] >= 2 for r in rows if r["t"] >= 1)
    gate_ok = abs(p_b - p_true) < tol_p and abs(mu - 1.0) < tol_mu
    gens_run = t + 1
    return {
        "pop": pop, "gens_asked": gens, "gens_run": gens_run,
        "ok": bool(gate_ok and launches_ok and gens_run == gens
                   and math.isfinite(p_b) and math.isfinite(mu)),
        "gate_ok": bool(gate_ok), "launches_ok": bool(launches_ok),
        "p_model_b": p_b, "p_analytic": p_true, "tol_p": tol_p,
        "mu_b": mu, "tol_mu": tol_mu, "kde_launches": launches,
        "wall_s": wall,
        "final_eps": float(abc.history.get_all_populations().epsilon.iloc[-1]),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "generations": [
            {"t": r["t"], "wall_s": r["wall_s"], "sample_s": r["sample_s"],
             "eps": r["eps"], "evaluations": r["evaluations"],
             "acceptance_rate": r["acceptance_rate"], "batch": r["batch"],
             "accepted_per_s": r["n"] / r["wall_s"],
             "kde_launches": r["kde_launches"],
             "kde_support": r["kde_support"]} for r in rows],
    }


def _phase_pop(torch, state, name: str, pop: int, gens: int):
    torch.cuda.reset_peak_memory_stats()
    row = run_main_path(torch, pop, gens)
    if pop >= 1 << 18:
        # every model keeps >= 2^14 particles at this size, so from t = 1
        # on each KDE must run against the grid-compressed support
        row["compressed_ok"] = all(
            s["compressed"] for g in row["generations"] if g["t"] >= 1
            for s in g["kde_support"])
        row["ok"] = row["ok"] and row["compressed_ok"]
    state.setdefault("launches", {})[name] = row["kde_launches"]
    emit({"phase": name, **row})
    if not row["ok"]:
        raise RuntimeError(f"main path at pop {pop} failed its gate")


def phase_pop16384(torch, state):
    _phase_pop(torch, state, "pop16384", 16384, 11)


def phase_pop1e6(torch, state):
    _phase_pop(torch, state, "pop1e6", 1_000_000, 11)


def phase_profile(torch, state):
    """Device time by kernel and the device's idle share over the slowest
    generation of the pop-1e6 run: generations 0-9 run unprofiled, then
    generation 10 runs as a resumed ``run()`` under ``torch.profiler``."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import make_two_gaussians_problem

    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(
        models, priors, distance, population_size=1_000_000,
        eps=pt.MedianEpsilon(),
        sampler=pt.VectorizedSampler(max_batch_size=1 << 19,
                                     max_rounds_per_call=16, device="cuda"),
        stores_sum_stats=False, seed=0, device="cuda")
    abc.new("sqlite://", observed)
    abc.run(max_nr_populations=10)
    torch.cuda.synchronize()
    # device activity only: host-side op events would double the
    # attribution (an ATen op carries its kernel's time) and take minutes
    # to post-process at ~1e5 kernels
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        abc.run(max_nr_populations=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    gen = abc.timeline[-1]

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_s = sum(dev_us(e) for e in kernels) * 1e-6
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    emit({"phase": "profile", "ok": busy_s > 0, "t": gen["t"],
          "wall_s": wall, "evaluations": gen["evaluations"],
          "rounds": int(np.ceil(gen["evaluations"] / gen["batch"])),
          "batch": gen["batch"], "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / wall,
          "kde_launches": gen["kde_launches"],
          "top_device": [{"name": e.key[:80], "calls": e.count,
                          "device_s": dev_us(e) * 1e-6} for e in top]})
    if busy_s <= 0:
        raise RuntimeError("the profiler saw no device time")


def kernels_line(state) -> dict:
    """The per-kernel summary: times at the pop-16384 finalize shape,
    the largest error over every compared shape, launches on the main
    path."""
    rows = state.get("kernel_rows", [])
    main = rows[0] if rows else {}
    launches = state.get("launches", {})
    return {"kernels": [{
        "name": "kde_logpdf", "route": "cuda",
        "source": "pyabc_tpu_torch/csrc/kde_logpdf.cu",
        "replaces": "pyabc_tpu/ops/kde_pallas.py:77",
        "launches": sum(launches.values()),
        "launches_by_phase": launches,
        "max_abs_err": max((r["max_abs_err"] for r in rows), default=None),
        "ms": main.get("kernel_ms"), "plain_ms": main.get("plain_ms"),
        "bound_ms": main.get("bound_ms"), "bound_by": "operations",
        "library_ms": main.get("library_ms"),
        "shape": main.get("shape")}]}


PHASES = {"card": phase_card, "build": phase_build,
          "kernels": phase_kernels, "pop16384": phase_pop16384,
          "pop1e6": phase_pop1e6, "profile": phase_profile}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of "
                    + ",".join(ALL_PHASES + EXTRA_PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = [p for p in phases if p not in PHASES]
    if unknown:
        print(f"unknown phases {unknown}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "pyabc_tpu_torch").is_dir():
        print("chip_smoke: pyabc_tpu_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    state = {}
    if "card" not in phases:
        phases.insert(0, "card")
    for name in phases:
        t0 = time.perf_counter()
        try:
            PHASES[name](torch, state)
        except Exception as exc:  # report the phase, then fail the run
            emit({"phase": name, "ok": False,
                  "error": f"{type(exc).__name__}: {exc}",
                  "seconds": time.perf_counter() - t0})
            raise
    if "kernels" in phases:
        emit(kernels_line(state))
    print(state["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
