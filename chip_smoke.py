#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``pyabc_tpu_torch``) on one card.

    python3 chip_smoke.py                 # every phase, one CUDA device
    python3 chip_smoke.py --phases card,build,kernels

Phases, each printed as one JSON line and each fatal on failure:

1. ``card``    — the card's name, power limit and maximum SM clock.
2. ``build``   — create the CUDA context and compile every CUDA kernel of
   the port from its source.
3. ``kernels`` — each kernel against its plain PyTorch version on the card
   at the shapes the main path gives it (tolerance ``1e-4 + 1e-5·|ref|``),
   with the kernels' own time (``kernel_only_ms``: back-to-back launches
   of a prepared call), the whole wrapper call (``call_ms``), the plain
   time, a one-call library yardstick computed over query chunks of at
   most 8 GB (``library_ms``, ``library_chunks``), the least time the card
   could take (``bound_ms``), and the partial kernel's registers and
   spills as ``nvcc -Xptxas -v`` reports them.
4. ``pop16384`` / ``pop1e6`` — the main path: two-Gaussian model selection
   (BASELINE config #2) through ``ABCSMC.run`` with ``MedianEpsilon`` and
   ``VectorizedSampler``, held to the analytic model posterior and mean
   (the JAX package's ``tools/verify_northstar_posterior.py`` gate), with
   the kernel's launch count read around each run.
5. ``lv1e5`` / ``sir1e5`` — BASELINE configs #3 (Lotka-Volterra SDE) and
   #4 (SIR tau-leap) at full width, pop 1e5, 8 generations, with the
   adaptive p-norm refit over the record stream each generation
   (``AdaptivePNormDistance``, ``MedianEpsilon``, batch 2^19,
   ``stores_sum_stats=False``).  Each holds every generation's ε finite
   and positive, K1 launched in every generation t >= 1, a weight fit per
   generation from at least ``pop`` rows, the posterior mean within 4
   posterior standard deviations of the generating parameters, and each
   posterior standard deviation at most 0.75 of the prior's.
6. ``petab1e5`` / ``sbml1e5`` — BASELINE config #5: exact stochastic ABC
   (``StochasticAcceptor``, ``Temperature``, the llh kernel) over ODE
   models, pop 1e5, batch 2^18.  ``petab1e5`` is the JAX package's
   ``petab_ode_pop100k`` bench row through ``ODEPetabImporter`` (one rate,
   RK4 at dt = 0.1, ``Temperature(aggregate_fun=max)``, 6 generations);
   ``sbml1e5`` imports the SBML decay model with two experimental
   conditions through ``PetabProblem`` and ``SBMLPetabImporter`` (RK4 at
   200 steps, ``Temperature()``, up to 8 generations).  Each holds the
   last temperature at 1, the temperatures non-increasing, K1's launches
   in every generation t >= 1 at the count the code gives (the finalize,
   one per record batch, and the new proposal's density when a scheme
   read the records), and the last population against the exact
   posterior, by quadrature of the model's own llh on the CPU: |mean −
   μ_q| ≤ max(1e-3, 4·σ_q/√ESS), |std/σ_q − 1| ≤ 0.05 + 4/√(2·ESS).
   ``petab1e5`` runs all 6 generations; its quadrature must read 0.685 /
   0.0523.
7. ``fused16384`` / ``fused1e6`` / ``fusedlv1e5`` / ``fusedpetab1e5`` —
   the same workloads through the fused engine, ``fuse_generations=4``:
   generation 0 seeds the device carry sequentially, then blocks of 4
   generations run with no host adaptation between them, and a tail too
   short for a block runs sequentially.  ``fused16384`` and ``fused1e6``
   hold ``run_gate``'s tolerances, and their paths must follow the
   engine's rule (a block from generation 1; a block only where 4
   generations remain; after a block short of 4 — an undershoot — the
   sequential engine redoes the next generation); ``fused16384`` runs at
   least two blocks, ``fused1e6`` hands the engine
   probe the ``pop1e6`` phase's steady seconds per generation, reports
   the engine it chose and both engines' seconds per generation, and its
   first block must run fused.  ``fusedlv1e5`` holds ``lv1e5``'s posterior
   and ε gates and needs the in-block refit's weights for generation 1 +
   K on the host; ``fusedpetab1e5`` runs ``petab1e5``'s model with
   ``Temperature(schemes=[AcceptanceRateScheme()])`` and the pdf norm from
   the kernel's analytic maximum (the eligible form of the triple) and
   holds ``petab1e5``'s temperature and quadrature gates.  Every fused
   phase also requires K1 launched in each fused generation as often as
   the code gives (one per model, twice that with the temperature solve)
   and one History row per generation; its rows carry ``path``,
   ``engine``, ``host_reads`` and ``grids_resolved``, and its blocks their
   wall, rounds and host reads.

8. ``onedispatch1e6`` / ``onedispatchpetab1e5`` — the one-dispatch engine
   (``run_mode="onedispatch"``: after generation 0 the rest of the run is
   one dispatch, the stop chain evaluated on the card after each
   generation), each run beside its fused twin (``run_mode="auto"``, the
   same seed) in the same phase.  ``onedispatch1e6`` is the JAX package's
   ``bench_onedispatch`` row: config #2 at pop 1e6, ``ConstantEpsilon(0.2)``,
   K = 4, batch 2^19 pinned, 16 rounds per call, 9 generations; it holds
   the paths to sequential then 8 × onedispatch, one dispatch, n accepted
   in every generation, every population and weight bit-identical to the
   fused twin's (generations 1–4 and 5–8 in two blocks), K1 launched
   ``kde_launches_per_gen(2, False)`` times per generation and ``rounds +
   1`` host reads per generation (the round-loop reads and one control
   read), and reports both runs' wall, the host time per generation and
   ``control_roundtrip_s`` per generation.  ``onedispatchpetab1e5`` is
   ``fusedpetab1e5`` with ``run_mode="onedispatch"``: the device stop
   chain must end the run on "temperature reached 1" at the fused twin's
   generation, with identical temperatures and populations, and hold
   ``petab1e5``'s quadrature gate.

9. ``pipelined1e6`` / ``pipelinedsir1e6`` — the pipelined engine with
   lazy History rows, as ``ABCSMC``'s defaults run a device-eligible
   configuration at pop >= 2^17 (``ingest_mode="auto"``,
   ``history_mode="lazy"``).  ``pipelined1e6`` is ``run_gate``'s
   configuration exactly (config #2, pop 1e6, ``MedianEpsilon``, batch up
   to 2^19, 16 rounds per call, ``stores_sum_stats=False``, seed 0, 11
   generations): ``run_gate``'s tolerances read through hydration, one
   History row per generation, the block rows still lazy when the run
   ends and none after ``done``, paths ``pipelined`` or ``sequential``
   (the first generation and each redo after an undershoot), K1 launched
   in every generation t >= 1, and the ledger's ``rewinds``, ``overlap_s``
   and egress reported.  In the same phase the JAX package's north-star
   bench row (``ConstantEpsilon(0.2)``, 9 generations) runs four times:
   at ``ingest_depth=2`` lazy, at depth 0 lazy, at depth 2 eager, and as
   bench.py's sequential-eager control; the first three must be
   bit-identical generation by generation, ``overlap_s`` > 0 at depth 2
   and = 0 at depth 0, and the summary egress per generation is reported
   against the eager run's population egress.  ``pipelinedsir1e6`` is
   BASELINE config #4 at its own size: ``sir1e5``'s configuration at pop
   1e6 with the defaults; ``sir1e5``'s posterior, ε and launch gates, an
   in-block weight pre-seed for each block that follows a block, and the
   peak memory of every generation.

Every phase before these pins ``history_mode="eager"``, and every run at
pop 1e6 among them ``ingest_mode="sequential"``, so that each measures
the engine it did before the pipeline and the lazy rows became the
defaults; ``onedispatch1e6`` adds a third one-dispatch run with lazy rows
whose hydrated populations must equal the eager runs' bit for bit.

The ``kernels`` phase runs last: its row (g) takes config #5's record
shape [records × support] from the ``petab1e5`` run's timeline, rows (h),
(i) and (j) the capped shapes of ``fused1e6``, ``fusedlv1e5`` and
``pipelinedsir1e6`` (stated default shapes without those runs).

Opt-in phases (``--phases``, not in the default run): ``profile``
profiles the slowest generation of the pop-1e6 run with
``torch.profiler``: device time by kernel and the device's idle share.
``simprof`` does the same for the last generation of ``lv1e5`` and
``sir1e5``, then runs one more generation with the simulator timed
between device syncs (its share of ``sample_s``), and profiles one
simulator call at the batch size (device time, kernel launches, the
unprofiled call's wall); for ``petab1e5`` and ``sbml1e5`` it profiles
one simulator call at batch 2^18.
Timeline rows carry each generation's peak device memory
(``peak_mem_gb``); a phase reports the largest.  ``k1perm`` times K1 at
the pop-1e6 finalize shape on the sorted grid support and on the same
rows permuted: with no branch on the data the two take the same time.
``repeat`` counts, over 50 calls at four sizes, how often a 1-D float
``torch.cumsum`` and ``ops.choice.ordered_cumsum`` give another result
than their first call, then runs ``fused16384``'s configuration over
seeds 0-19 and reports each run's last ESS, p(B) − analytic and paths.

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

ALL_PHASES = ("card", "build", "pop16384", "pop1e6", "lv1e5", "sir1e5",
              "petab1e5", "sbml1e5", "fused16384", "fused1e6", "fusedlv1e5",
              "fusedpetab1e5", "onedispatch1e6", "onedispatchpetab1e5",
              "pipelined1e6", "pipelinedsir1e6", "kernels")
#: opt-in phases (``--phases``): not part of the default smoke
EXTRA_PHASES = ("profile", "simprof", "k1perm", "repeat")
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
    # the process's CUDA context is made here, not inside the first
    # main-path phase's timed run
    torch.ones(1, device="cuda").sum().item()
    t0 = time.perf_counter()
    built = _build.build_all()
    report = {name: _build.ptxas_report(info["ptxas"])
              for name, info in built.items()}
    state["ptxas"] = report.get("kde_logpdf")
    emit({"phase": "build", "ok": True,
          "seconds": time.perf_counter() - t0,
          "built": sorted(built), "ptxas": report})


def _partial_regs(state, d: int):
    """Registers and spill bytes of the partial kernel's template for d."""
    name = (f"kde_partial_kernel<{d},1>" if d <= 8
            else "kde_partial_kernel<32,0>")
    for row in state.get("ptxas") or []:
        if row["function"] == name:
            return {"function": name, "registers": row["registers"],
                    "stack": row["stack"],
                    "spill_stores": row["spill_stores"],
                    "spill_loads": row["spill_loads"]}
    return None


def time_loop(torch, fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn()`` over ``reps`` back-to-back calls
    between two CUDA events: the device's time when the host keeps it
    fed, without the host's per-call work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def library_logsumexp_ms(torch, kde_plain, c, reps: int = 3) -> dict:
    """One-call yardstick: ``torch.logsumexp(z_x @ z_s.T + b_s, 1)`` on
    pre-whitened inputs, over query chunks whose ``[chunk, N]`` block
    stays within ``LIBRARY_MAX_BYTES``; the chunks' times are summed."""
    args = (c["x"], c["support"], c["log_w"], c["chol"])
    z_x, z_s = kde_plain.whiten(*args)
    b_s = c["log_w"] - 0.5 * (z_s * z_s).sum(1)
    a_x = 0.5 * (z_x * z_x).sum(1)
    rows = max(1, int(LIBRARY_MAX_BYTES // (4 * c["n"])))

    def run():
        for q0 in range(0, c["m"], rows):
            torch.logsumexp(z_x[q0:q0 + rows] @ z_s.T + b_s, 1) \
                - a_x[q0:q0 + rows] + c["log_norm"]

    ms = time_cuda(torch, run, reps=reps)
    return {"library_ms": ms, "library_chunks": -(-c["m"] // rows)}


def _kde_case(torch, gen, dev, label, m, n, d, pad_frac=0.0,
              grid=False, pad_last_tile=False, uniform=False):
    """Inputs of one K1 comparison, made on the card from ``gen``."""
    f32 = torch.float32
    if uniform:
        # the fused engine's capped support: n rows resampled from the
        # population, each at log weight -log n, Silverman bandwidth
        support = torch.randn(n, d, generator=gen, device=dev)
        x = torch.randn(m, d, generator=gen, device=dev)
        log_w = torch.full((n,), -math.log(n), device=dev)
        h = (4.0 / (n * (d + 2.0))) ** (1.0 / (d + 4.0))
        chol = torch.eye(d, device=dev, dtype=f32) * h
    elif grid:
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


KDE_CASES = [
    ("a pop16384 finalize", 16384, 16384, 1, {"pad_frac": 0.2}),
    ("b pop1e6 grid 2^13", 1_000_000, 8192, 1, {"grid": True}),
    ("b pop1e6 grid 2^14", 1_000_000, 16384, 1, {"grid": True}),
    ("b pop1e6 grid 2^16", 1_000_000, 65536, 1, {"grid": True}),
    ("c 65536^2 d=2", 65536, 65536, 2, {}),
    ("c 65536^2 d=5", 65536, 65536, 5, {}),
    ("d ragged d=3", 1000, 1537, 3, {"pad_last_tile": True}),
    # the adaptive workloads' finalize: one model, so the support is the
    # whole previous population of 1e5 rows (ABCSMC._pad_bucket caps the
    # power-of-two bucket at the population: no pad rows)
    ("e lv1e5 finalize d=4", 100_000, 100_000, 4, {}),
    ("f sir1e5 finalize d=2", 100_000, 100_000, 2, {}),
]
#: row (g) without a petab1e5 run: two rounds of 2^18 candidates against
#: the smallest grid-compressed support
RECORD_SHAPE_DEFAULT = (1 << 19, 8192)


def record_case(state) -> tuple:
    """Row (g): config #5's record density, [records × support] at d = 1
    over the grid-compressed support, from the petab1e5 run's generation
    with the most records."""
    m, n = state.get("petab_record_shape", RECORD_SHAPE_DEFAULT)
    source = "petab1e5" if "petab_record_shape" in state else "default"
    return (f"g petab1e5 records ({source})", m, n, 1, {"grid": True})


def fused_cases(state) -> list:
    """Rows (h), (i) and (j): a device block's proposal density above the
    support cap — every query against 2^14 uniform-weight rows — at the
    fused1e6 (d = 1), fusedlv1e5 (d = 4) and pipelinedsir1e6 (d = 2)
    phases' shapes, or at these stated defaults without those runs."""
    out = []
    for label, key, default in (
            ("h fused1e6 capped", "fused_main_shape",
             (1_000_000, 1 << 14, 1)),
            ("i fusedlv1e5 capped", "fused_lv_shape", (100_000, 1 << 14, 4)),
            ("j pipelinedsir1e6 capped", "pipelined_sir_shape",
             (1_000_000, 1 << 14, 2))):
        m, n, d = state.get(key, default)
        source = "run" if key in state else "default"
        out.append((f"{label} ({source})", m, n, d, {"uniform": True}))
    return out


def phase_kernels(torch, state):
    from pyabc_tpu_torch.ops import kde as kde_plain
    from pyabc_tpu_torch.ops import kde_cuda

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)
    rows = []
    ok_all = True
    for label, m, n, d, kw in (KDE_CASES + [record_case(state)]
                               + fused_cases(state)):
        c = _kde_case(torch, gen, dev, label, m, n, d, **kw)
        args = (c["x"], c["support"], c["log_w"], c["chol"], c["log_norm"])
        got = kde_cuda.weighted_kde_logpdf_cuda(*args)
        ref = kde_plain.weighted_kde_logpdf(*args)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        finite = bool(torch.isfinite(got).all() and torch.isfinite(ref).all())
        ok = finite and bool((err <= TOL_ABS + TOL_REL * ref.abs()).all())
        call_ms = time_cuda(torch, lambda: kde_cuda.weighted_kde_logpdf_cuda(
            *args), reps=10, warmup=2)
        call = kde_cuda.KdeCall(*args)
        kernel_only_ms = time_loop(torch, call.run, reps=20)
        plain_ms = time_cuda(torch, lambda: kde_plain.weighted_kde_logpdf(
            *args), reps=3)
        lib = library_logsumexp_ms(torch, kde_plain, c)
        bound_ms = 1e3 * kde_cuda.bound_seconds(m, n, d,
                                                state["sm_clock_hz"])
        chunk, splits = kde_cuda.split_plan(m, n, d)
        row = {"phase": "kernels", "kernel": "kde_logpdf", "shape": label,
               "M": m, "N": n, "d": d, "ok": ok,
               "max_abs_err": float(err.max()),
               "kernel_only_ms": kernel_only_ms, "call_ms": call_ms,
               "plain_ms": plain_ms, **lib,
               "bound_ms": bound_ms, "bound_by": "operations",
               "bound_share": bound_ms / kernel_only_ms,
               "pairs_per_s": m * n / (kernel_only_ms * 1e-3),
               "chunk": chunk, "splits": splits,
               "partial_kernel": _partial_regs(state, d)}
        emit(row)
        rows.append(row)
        ok_all = ok_all and ok
        del c, args, got, ref, err, call
        torch.cuda.empty_cache()
    state["kernel_rows"] = rows
    if not ok_all:
        raise RuntimeError("K1 disagrees with its plain version")


def phase_k1perm(torch, state):
    """K1 at the main path's pop-1e6 finalize shape, on the sorted grid
    support and on the same support rows (and log weights) permuted by one
    fixed random permutation.  The sum is the same up to order; the time
    difference is what the sorted rows' rising maxima cost."""
    from pyabc_tpu_torch.ops import kde as kde_plain
    from pyabc_tpu_torch.ops import kde_cuda

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)
    c = _kde_case(torch, gen, dev, "b pop1e6 grid 2^13", 1_000_000, 8192, 1,
                  grid=True)
    perm = torch.randperm(c["n"], generator=gen, device=dev)
    sorted_args = (c["x"], c["support"], c["log_w"], c["chol"],
                   c["log_norm"])
    perm_args = (c["x"], c["support"][perm].contiguous(),
                 c["log_w"][perm].contiguous(), c["chol"], c["log_norm"])
    ref = kde_plain.weighted_kde_logpdf(*sorted_args)
    errs = {}
    for key, args in (("sorted", sorted_args), ("permuted", perm_args)):
        got = kde_cuda.weighted_kde_logpdf_cuda(*args)
        errs[key] = float((got - ref).abs().max())
        ok = bool(torch.all((got - ref).abs()
                            <= TOL_ABS + TOL_REL * ref.abs()))
        if not ok:
            raise RuntimeError(f"K1 on the {key} support disagrees")
    times = {"sorted": [], "permuted": []}
    for key in ("sorted", "permuted", "permuted", "sorted"):
        args = sorted_args if key == "sorted" else perm_args
        times[key].append(time_cuda(
            torch, lambda: kde_cuda.weighted_kde_logpdf_cuda(*args),
            reps=10, warmup=2))
    sorted_ms = statistics.mean(times["sorted"])
    permuted_ms = statistics.mean(times["permuted"])
    emit({"phase": "k1perm", "ok": True, "shape": c["label"],
          "M": c["m"], "N": c["n"], "max_abs_err": errs,
          "sorted_ms": sorted_ms, "permuted_ms": permuted_ms,
          "sorted_ms_runs": times["sorted"],
          "permuted_ms_runs": times["permuted"],
          "sorted_over_permuted": sorted_ms / permuted_ms})


def run_main_path(torch, pop: int, gens: int, seed: int = 0, fuse: int = 1,
                  seq_probe_s=None) -> dict:
    """Config #2 through the port's entry points on the card, held to the
    analytic posterior as the JAX package's ``run_gate`` holds it;
    ``fuse`` K > 1 runs fused blocks, ``seq_probe_s`` hands the engine
    probe a sequential baseline (seconds per generation).  The classic
    loop and eager rows are pinned (the pipelined1e6 phase runs the
    defaults)."""
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
        stores_sum_stats=False, fuse_generations=fuse, seed=seed,
        ingest_mode="sequential", history_mode="eager", device="cuda")
    abc.new("sqlite://", observed)
    if seq_probe_s is not None:
        abc._note_sequential_gen_s(seq_probe_s)
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
        "peak_mem_gb": max(r["peak_mem_gb"] for r in rows),
        "generations": [
            {**generation_row(r), "accepted_per_s": r["n"] / r["wall_s"]}
            for r in rows],
        **(fused_report(abc, rows) if fuse > 1 else {}),
    }


def generation_row(r: dict) -> dict:
    """One timeline row for the smoke's output: a fused generation's wall
    is its block's wall over the block's generations, its sample_s the
    block's device loop (before the host copies); a sequential
    generation's host_s is its wall less its sampling."""
    keys = ("t", "path", "engine", "wall_s", "sample_s", "eps",
            "evaluations", "acceptance_rate", "ess", "batch",
            "kde_launches", "kde_support", "peak_mem_gb", "compute_s",
            "d2h_s", "overlap_s", "history_mode")
    out = {k: r[k] for k in keys}
    if r["path"] in ("fused", "onedispatch", "pipelined"):
        out.update({k: r[k] for k in ("rounds", "host_reads",
                                       "grids_resolved")})
    else:
        out["host_s"] = r["wall_s"] - r["sample_s"]
    return out


def fused_report(abc, rows) -> dict:
    """The fused blocks of a run (``ABCSMC.blocks``: every block run,
    those that wrote nothing included) and the gates every fused phase
    shares: K1 launched in each fused generation the number of times the
    code gives (one per model for the proposal density, one more per
    model for the temperature solve) — K times that per block, whose
    generations all run — one History row per generation, and paths that
    follow the engine's rule."""
    from pyabc_tpu_torch.sampler.fused import kde_launches_per_gen

    per_gen = kde_launches_per_gen(abc.M, abc._block_mode()["stoch"])
    K = abc.fuse_generations
    fused = [r for r in rows if r["path"] == "fused"]
    pops = abc.history.get_all_populations()
    ts = [r["t"] for r in rows]
    n = abc.population_strategy(0)
    paths = [r["path"] for r in rows]
    checks = {
        "fused_ran": bool(fused),
        "fused_launches": (all(r["kde_launches"] == per_gen for r in fused)
                           and all(b["kde_launches"] == K * per_gen
                                   for b in abc.blocks)),
        "history_rows": (ts == list(range(len(rows)))
                         and list(pops.t) == [-1] + ts
                         and all(len(abc.history.get_population(t)) == n
                                 for t in ts)),
        "paths": paths_follow_the_rule(paths, abc.blocks, K,
                                       abc._engine_choice,
                                       abc.max_nr_populations),
    }
    seq = [r["wall_s"] - r["sample_s"] for r in rows
           if r["path"] == "sequential" and r["t"] >= 1]
    return {"fuse_generations": K, "paths": paths,
            "kde_launches_per_fused_gen": per_gen, "fused_checks": checks,
            "blocks": [{**b, "s_per_gen": (b["wall_s"] / b["written"]
                                           if b["written"] else None)}
                       for b in abc.blocks],
            "engine": abc._engine_choice, "seq_probe_s": abc._seq_probe_s,
            "seq_host_s_per_gen": (statistics.median(seq) if seq else None)}


def paths_follow_the_rule(paths, blocks, K, engine, t_max) -> bool:
    """The engine's rule, read off the paths and the blocks: generation
    0 seeds the carry sequentially and a block starts at 1; a block
    starts only where K generations remain and keeps at most K; after a
    block short of K (an undershoot: it may keep none) the sequential
    engine redoes the next generation; any other sequential generation
    t >= 1 is one where no block fits before ``t_max`` (or the probe
    retired the fused engine)."""
    gens = len(paths)
    redo = {b["t"] + b["written"] for b in blocks
            if b["written"] < K and b["stop"] is None}
    ok = (paths[:2] == ["sequential", "fused"]
          and bool(blocks) and blocks[0]["t"] == 1)
    kept = set()
    for b in blocks:
        ok = ok and b["t"] + K <= t_max and b["written"] <= K
        kept.update(range(b["t"], b["t"] + b["written"]))
    ok = ok and kept == {t for t in range(gens) if paths[t] == "fused"}
    for t in range(1, gens):
        if paths[t] == "sequential" and t not in redo \
                and engine != "sequential":
            ok = ok and t + K > t_max
    return bool(ok)


def _phase_pop(torch, state, name: str, pop: int, gens: int):
    row = run_main_path(torch, pop, gens)
    if pop >= 1 << 18:
        # every model keeps >= 2^14 particles at this size, so from t = 1
        # on each KDE must run against the grid-compressed support
        row["compressed_ok"] = all(
            s["compressed"] for g in row["generations"] if g["t"] >= 1
            for s in g["kde_support"])
        row["ok"] = row["ok"] and row["compressed_ok"]
    state.setdefault("launches", {})[name] = row["kde_launches"]
    # the engine probe's baseline for fused1e6: the steady seconds per
    # generation (median from t = 3, bench.py's warmup-3 protocol)
    state[f"{name}_seq_s"] = statistics.median(
        g["wall_s"] for g in row["generations"] if g["t"] >= 3)
    emit({"phase": name, **row})
    if not row["ok"]:
        raise RuntimeError(f"main path at pop {pop} failed its gate")


def phase_pop16384(torch, state):
    _phase_pop(torch, state, "pop16384", 16384, 11)


def phase_pop1e6(torch, state):
    _phase_pop(torch, state, "pop1e6", 1_000_000, 11)


#: generations per fused block in the fused phases (bench.py's
#: fused_northstar row)
FUSE_K = 4


def _record_fused_shape(state, key, row, pop, d):
    """K1's [queries × support] in the phase's first fused generation:
    the shape of the ``kernels`` row (h) or (i)."""
    g = next((g for g in row["generations"] if g["path"] == "fused"), None)
    if g is not None:
        state[key] = (pop, g["kde_support"][0]["rows"], d)


def _phase_fused_main(torch, state, name: str, pop: int):
    """Config #2 as the sequential phase runs it, with fused blocks of
    FUSE_K generations; at pop 1e6 the engine probe gets the pop1e6
    phase's steady seconds per generation as its baseline."""
    seq_s = state.get("pop1e6_seq_s") if pop > 1 << 17 else None
    row = run_main_path(torch, pop, 11, fuse=FUSE_K, seq_probe_s=seq_s)
    checks = dict(row["fused_checks"])
    if pop > 1 << 17:
        # the probe may retire fusion after the first block
        checks["first_block_fused"] = bool(
            row["blocks"] and row["blocks"][0]["t"] == 1
            and row["blocks"][0]["written"] >= 1)
        first = row["blocks"][0] if row["blocks"] else {}
        row["engine_probe"] = {
            "engine": row["engine"],
            "fused_s_per_gen": first.get("s_per_gen"),
            "sequential_s_per_gen": seq_s}
    else:
        checks["two_blocks"] = sum(b["written"] > 0
                                   for b in row["blocks"]) >= 2
    row["checks"] = checks
    row["ok"] = bool(row["ok"] and all(checks.values()))
    state.setdefault("launches", {})[name] = row["kde_launches"]
    _record_fused_shape(state, "fused_main_shape", row, pop, 1)
    emit({"phase": name, **row})
    if not row["ok"]:
        raise RuntimeError(f"{name} failed its checks: {checks}")


def phase_fused16384(torch, state):
    _phase_fused_main(torch, state, "fused16384", 16384)


def phase_fused1e6(torch, state):
    _phase_fused_main(torch, state, "fused1e6", 1_000_000)


def phase_fusedlv1e5(torch, state):
    row = run_adaptive(torch, "lv1e5", fuse=FUSE_K)
    state.setdefault("launches", {})["fusedlv1e5"] = row["kde_launches"]
    _record_fused_shape(state, "fused_lv_shape", row, ADAPTIVE_POP, 4)
    emit({"phase": "fusedlv1e5", **row})
    if not row["ok"]:
        raise RuntimeError(f"fusedlv1e5 failed its checks: {row['checks']}")


def phase_fusedpetab1e5(torch, state):
    row, _ = run_stochastic(torch, "petab1e5", fuse=FUSE_K)
    state.setdefault("launches", {})["fusedpetab1e5"] = row["kde_launches"]
    emit({"phase": "fusedpetab1e5", **row})
    if not row["ok"]:
        raise RuntimeError(
            f"fusedpetab1e5 failed its checks: {row['checks']}")


def onedispatch_report(abc, rows, wall: float) -> dict:
    """The gates every one-dispatch phase shares: one dispatch, the paths
    sequential then one-dispatch to the end of the run, K1 launched in
    each one-dispatch generation as often as the code gives, the host
    reads of each generation (its rounds, one ``grids_resolved`` where a
    grid is, one control read), one History row of n per generation; and
    the host time per generation (wall − device loop, the loop ending in
    the control read) and ``control_roundtrip_s`` per generation."""
    from pyabc_tpu_torch.sampler.fused import kde_launches_per_gen

    per_gen = kde_launches_per_gen(abc.M, abc._block_mode()["stoch"])
    od = [r for r in rows if r["path"] == "onedispatch"]
    ts = [r["t"] for r in rows]
    n = abc.population_strategy(0)
    paths = [r["path"] for r in rows]
    checks = {
        "dispatches": abc.run_dispatches == 1,
        "od_paths": paths == ["sequential"] + ["onedispatch"] * (len(rows)
                                                                  - 1),
        "od_launches": bool(od) and all(r["kde_launches"] == per_gen
                                        for r in od),
        "host_reads": all(r["host_reads"] == r["rounds"] + 1
                          + (r["grids_resolved"] is not None) for r in od),
        "history_rows": (ts == list(range(len(rows)))
                         and list(abc.history.get_all_populations().t)
                         == [-1] + ts
                         and all(len(abc.history.get_population(t)) == n
                                 for t in ts)),
    }
    return {"paths": paths, "run_dispatches": abc.run_dispatches,
            "kde_launches_per_od_gen": per_gen, "onedispatch_checks": checks,
            "run_wall_s": wall,
            "host_s_per_gen": (statistics.median(
                r["wall_s"] - r["sample_s"] for r in od) if od else None),
            "control_roundtrip_s": abc.control_roundtrip_s,
            "control_roundtrip_s_per_gen": (abc.control_roundtrip_s / len(od)
                                            if od else None)}


def population_difference(h_a, h_b):
    """None when every generation's model index, parameters, distances
    and weights are equal bit for bit in the two histories, else where
    they first differ."""
    import numpy as np

    if h_a.max_t != h_b.max_t:
        return f"generations {h_a.max_t + 1} vs {h_b.max_t + 1}"
    for t in range(h_a.max_t + 1):
        a, b = h_a.get_population(t), h_b.get_population(t)
        for key in ("m", "theta", "distance", "weight"):
            x, y = np.asarray(getattr(a, key)), np.asarray(getattr(b, key))
            if not np.array_equal(x, y):
                return f"t={t} {key}: {int((x != y).sum())} values"
    return None


#: bench.py's bench_onedispatch row: config #2 at pop 1e6,
#: ConstantEpsilon(0.2), K = 4, batch 2^19 pinned, 9 generations
ONEDISPATCH_POP = 1_000_000
ONEDISPATCH_GENS = 9


def onedispatch_main_run(torch, run_mode: str,
                         history_mode: str = "eager") -> tuple:
    """``(abc, wall_s, K1 launches)`` of the ``bench_onedispatch``
    configuration through ``ABCSMC.run`` on the card (the fused twin on
    the classic loop: pop 1e6 would pipeline it)."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import make_two_gaussians_problem
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda

    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(
        models, priors, distance, population_size=ONEDISPATCH_POP,
        eps=pt.ConstantEpsilon(0.2),
        sampler=pt.VectorizedSampler(min_batch_size=1 << 19,
                                     max_batch_size=1 << 19,
                                     max_rounds_per_call=16, device="cuda"),
        stores_sum_stats=False, fuse_generations=FUSE_K, run_mode=run_mode,
        ingest_mode="sequential", history_mode=history_mode, seed=0,
        device="cuda")
    abc.new("sqlite://", observed)
    weighted_kde_logpdf_cuda.launches = 0
    t0 = time.perf_counter()
    abc.run(max_nr_populations=ONEDISPATCH_GENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return abc, wall, weighted_kde_logpdf_cuda.launches


def phase_onedispatch1e6(torch, state):
    # fused, one-dispatch, one-dispatch, fused: the process's first run
    # of this shape pays one-off costs, and each engine runs twice; then
    # one-dispatch with lazy rows
    runs = [onedispatch_main_run(torch, mode)
            for mode in ("auto", "onedispatch", "onedispatch", "auto")]
    lazy_run = onedispatch_main_run(torch, "onedispatch", "lazy")
    (a_f, wall_f, launches_f), (a_o, wall_o, launches_o) = runs[:2]
    rows = a_o.timeline
    report = onedispatch_report(a_o, rows, wall_o)
    checks = dict(report["onedispatch_checks"])
    checks["gens"] = len(rows) == ONEDISPATCH_GENS
    checks["fused_twin_paths"] = all(
        [r["path"] for r in a.timeline] == ["sequential"] + ["fused"] * 8
        for a, _, _ in (runs[0], runs[3]))
    # every run's populations equal the first fused run's, bit for bit
    differences = [population_difference(a.history, a_f.history)
                   for a, _, _ in runs[1:]]
    checks["bit_identical"] = not any(differences)
    # the lazy run's rows hydrate to the eager runs' bits
    lazy_difference = population_difference(lazy_run[0].history,
                                            a_o.history)
    checks["lazy_bit_identical"] = lazy_difference is None
    checks["lazy_rows"] = (
        {r["history_mode"] for r in lazy_run[0].timeline} == {"lazy"}
        and all(lazy_run[0].history.get_population_summary(r["t"])
                for r in lazy_run[0].timeline if r["path"] == "onedispatch"))
    fused_rows = [r for r in a_f.timeline if r["path"] == "fused"]
    row = {"pop": ONEDISPATCH_POP, "gens": ONEDISPATCH_GENS,
           "ok": all(checks.values()), "checks": checks,
           "kde_launches": launches_o, "fused_kde_launches": launches_f,
           "differences_from_first_fused_run": differences,
           "lazy_difference_from_od_run": lazy_difference,
           "od_wall_s_runs": [runs[1][1], runs[2][1]],
           "od_lazy_wall_s": lazy_run[1],
           "od_lazy_kde_launches": lazy_run[2],
           "fused_wall_s_runs": [runs[0][1], runs[3][1]],
           "wall_s": wall_o, "fused_wall_s": wall_f,
           "fused_host_s_per_gen": (statistics.median(
               r["wall_s"] - r["sample_s"] for r in fused_rows)
               if fused_rows else None),
           "fused_blocks": [{k: b[k] for k in ("t", "written", "rounds",
                                               "host_reads", "wall_s")}
                            for b in a_f.blocks],
           "peak_mem_gb": max(r["peak_mem_gb"] for r in rows),
           "generations": [
               {**generation_row(r), "accepted_per_s": r["n"] / r["wall_s"]}
               for r in rows],
           **report}
    launches = state.setdefault("launches", {})
    launches["onedispatch1e6"] = launches_o
    launches["onedispatch1e6_fused"] = launches_f
    launches["onedispatch1e6_lazy"] = lazy_run[2]
    emit({"phase": "onedispatch1e6", **row})
    if not row["ok"]:
        raise RuntimeError(f"onedispatch1e6 failed its checks: {checks}")


def phase_onedispatchpetab1e5(torch, state):
    row_o, a_o = run_stochastic(torch, "petab1e5", fuse=FUSE_K,
                                run_mode="onedispatch")
    launches = state.setdefault("launches", {})
    launches["onedispatchpetab1e5"] = row_o["kde_launches"]
    row_f, a_f = run_stochastic(torch, "petab1e5", fuse=FUSE_K)
    launches["onedispatchpetab1e5_fused"] = row_f["kde_launches"]
    checks = dict(row_o["checks"])
    checks["fused_twin_ok"] = row_f["ok"]
    checks["stop_at_fused_t"] = (
        row_o["stop_reason"] == row_f["stop_reason"] == STOP_TEMPERATURE
        and row_o["gens_run"] == row_f["gens_run"])
    checks["temperatures"] = ([g["temperature"] for g in row_o["generations"]]
                              == [g["temperature"]
                                  for g in row_f["generations"]])
    difference = population_difference(a_o.history, a_f.history)
    checks["bit_identical"] = difference is None
    row = {**row_o, "ok": all(checks.values()), "checks": checks,
           "difference_from_fused_run": difference,
           "fused_wall_s": row_f["wall_s"],
           "fused_kde_launches": row_f["kde_launches"],
           "fused_paths": row_f["paths"]}
    emit({"phase": "onedispatchpetab1e5", **row})
    if not row["ok"]:
        raise RuntimeError(
            f"onedispatchpetab1e5 failed its checks: {checks}")


#: the run_gate configuration and the north-star bench row of the JAX
#: package (``tools/verify_northstar_posterior.py:run_gate``,
#: ``bench.py:272-315``), both at pop 1e6 with ABCSMC's defaults
PIPELINED_POP = 1_000_000
NORTHSTAR_GENS = 9


def _config2_abc(eps, **kw):
    """Config #2 at pop 1e6 on the card as the JAX package's run_gate and
    north-star row build it; ``kw`` overrides constructor defaults."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import make_two_gaussians_problem

    models, priors, distance, observed, posterior_fn = \
        make_two_gaussians_problem()
    abc = pt.ABCSMC(
        models, priors, distance, population_size=PIPELINED_POP, eps=eps,
        sampler=pt.VectorizedSampler(max_batch_size=1 << 19,
                                     max_rounds_per_call=16, device="cuda"),
        stores_sum_stats=False, seed=0, device="cuda", **kw)
    abc.new("sqlite://", observed)
    return abc, posterior_fn


def _timed_run(torch, abc, gens: int) -> dict:
    """``abc.run`` between K1 launch counts set to 0 and read after, with
    the wire ledger's and the egress buckets' deltas, and the rows each
    generation had (lazy or durable) when ``done`` began."""
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda
    from pyabc_tpu_torch.wire import transfer

    h = abc.history
    at_done = {}
    flush = h.flush_lazy

    def flush_recording():
        at_done.update(h._conn.execute(
            "SELECT t, lazy FROM populations WHERE abc_smc_id=? AND t>=0",
            (h.id,)).fetchall())
        flush()

    h.flush_lazy = flush_recording
    tr0, eg0 = transfer.snapshot(), transfer.egress_breakdown()
    weighted_kde_logpdf_cuda.launches = 0
    t0 = time.perf_counter()
    abc.run(max_nr_populations=gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = weighted_kde_logpdf_cuda.launches
    del h.flush_lazy
    eg1 = transfer.egress_breakdown()
    return {"wall_s": wall, "kde_launches": launches,
            "ledger": transfer.delta(tr0),
            "egress_bytes": {k: eg1[k] - eg0[k] for k in eg1},
            "lazy_at_done": at_done}


def phase_pipelined1e6(torch, state):
    import numpy as np

    import pyabc_tpu_torch as pt

    # run_gate exactly: MedianEpsilon, 11 generations, the defaults
    abc, posterior_fn = _config2_abc(pt.MedianEpsilon())
    gate = _timed_run(torch, abc, 11)
    rows = abc.timeline
    n = PIPELINED_POP
    h = abc.history
    t = h.max_t
    p_b = float(h.get_model_probabilities(t).get(1, 0.0))
    df, w = h.get_distribution(m=1, t=t)
    mu = float(np.sum(df["mu"].to_numpy() * w)) if len(df) else math.nan
    tol_p = max(2.5e-3, 2.5 / n ** 0.5)
    tol_mu = max(3e-3, 3.0 / n ** 0.5)
    paths = [r["path"] for r in rows]
    ts = [r["t"] for r in rows]
    lazy_at_done = gate["lazy_at_done"]
    checks = {
        "p_model_b": abs(p_b - posterior_fn(1.0)) < tol_p,
        "mu_b": abs(mu - 1.0) < tol_mu,
        "gens": ts == list(range(11)),
        "history_rows": (list(h.get_all_populations().t) == [-1] + ts
                         and all(len(h.get_population(tt)) == n
                                 for tt in ts)),
        # block rows were summaries until done() hydrated them; nothing
        # stays lazy after it
        "lazy_until_hydrated": (
            any(lazy_at_done.values())
            and all(paths[tt] == "pipelined"
                    for tt, lazy in lazy_at_done.items() if lazy)
            and all(h.get_population_summary(r["t"]) is not None
                    for r in rows if r["path"] == "pipelined")
            and not any(lazy for (lazy,) in h._conn.execute(
                "SELECT lazy FROM populations WHERE abc_smc_id=?",
                (h.id,)).fetchall())),
        "paths": (paths[0] == "sequential" and "pipelined" in paths
                  and set(paths) <= {"sequential", "pipelined"}),
        "launches": all(r["kde_launches"] >= 2 for r in rows if r["t"] >= 1),
        "defaults": abc.ingest_mode == "auto" and abc.history_mode == "lazy",
    }
    state.setdefault("launches", {})["pipelined1e6"] = gate["kde_launches"]

    # the north-star row, four ways: depth 2 lazy, depth 0 lazy, depth 2
    # eager, and bench.py's sequential-eager control
    twins = {}
    for label, kw in (("depth2_lazy", {}), ("depth0_lazy",
                                            {"ingest_depth": 0}),
                      ("depth2_eager", {"history_mode": "eager"}),
                      ("sequential_eager", {"ingest_mode": "sequential",
                                            "history_mode": "eager"})):
        a, _ = _config2_abc(pt.ConstantEpsilon(0.2), **kw)
        twins[label] = (a, _timed_run(torch, a, NORTHSTAR_GENS))
        state["launches"][f"northstar_{label}"] = \
            twins[label][1]["kde_launches"]
    base = twins["depth2_lazy"][0].history
    differences = {label: population_difference(twins[label][0].history,
                                                 base)
                   for label in ("depth0_lazy", "depth2_eager")}
    checks["twins_bit_identical"] = not any(differences.values())
    overlap = {label: r["ledger"]["overlap_s"]
               for label, (_, r) in twins.items()}
    checks["overlap_depth2"] = overlap["depth2_lazy"] > 0
    checks["overlap_depth0"] = overlap["depth0_lazy"] == 0
    twin_paths = {label: [r["path"] for r in a.timeline]
                  for label, (a, _) in twins.items()}
    checks["twin_paths"] = all(
        p[0] == "sequential" and "pipelined" in p
        for label, p in twin_paths.items() if label != "sequential_eager")

    def per_gen_kb(label, bucket):
        return twins[label][1]["egress_bytes"][bucket] / NORTHSTAR_GENS / 1e3

    checks = {k: bool(v) for k, v in checks.items()}
    row = {
        "pop": n, "gens": 11, "ok": all(checks.values()), "checks": checks,
        "p_model_b": p_b, "p_analytic": float(posterior_fn(1.0)),
        "tol_p": tol_p, "mu_b": mu, "tol_mu": tol_mu, "paths": paths,
        "wall_s": gate["wall_s"], "kde_launches": gate["kde_launches"],
        "ledger": gate["ledger"], "egress_bytes": gate["egress_bytes"],
        "lazy_at_done": sorted(tt for tt, lazy in lazy_at_done.items()
                               if lazy),
        "store": abc._store.manifest(),
        "peak_mem_gb": max(r["peak_mem_gb"] for r in rows),
        "generations": [generation_row(r) for r in rows],
        "northstar": {
            label: {"wall_s": r["wall_s"], "kde_launches": r["kde_launches"],
                    "paths": twin_paths[label], "ledger": r["ledger"],
                    "egress_bytes": r["egress_bytes"],
                    "s_per_gen_t_ge_1": statistics.mean(
                        g["wall_s"] for g in a.timeline if g["t"] >= 1)}
            for label, (a, r) in twins.items()},
        "northstar_differences": differences,
        "summary_kb_per_gen_lazy": per_gen_kb("depth2_lazy", "summary"),
        "history_kb_per_gen_lazy": per_gen_kb("depth2_lazy", "history"),
        "population_kb_per_gen_eager": per_gen_kb("depth2_eager",
                                                  "population"),
    }
    emit({"phase": "pipelined1e6", **row})
    if not row["ok"]:
        raise RuntimeError(f"pipelined1e6 failed its checks: {checks}")


def phase_pipelinedsir1e6(torch, state):
    """BASELINE config #4 at its own size: sir1e5's configuration at pop
    1e6 through the constructor's defaults (the pipeline, lazy rows)."""
    row = run_adaptive(torch, "sir1e5", pop=PIPELINED_POP, defaults=True)
    state.setdefault("launches", {})["pipelinedsir1e6"] = row["kde_launches"]
    g = next((g for g in row["generations"] if g["path"] == "pipelined"),
             None)
    if g is not None:
        state["pipelined_sir_shape"] = (PIPELINED_POP,
                                        g["kde_support"][0]["rows"], 2)
    row["peak_mem_gb_by_gen"] = [g["peak_mem_gb"]
                                 for g in row["generations"]]
    emit({"phase": "pipelinedsir1e6", **row})
    if not row["ok"]:
        raise RuntimeError(
            f"pipelinedsir1e6 failed its checks: {row['checks']}")


#: BASELINE configs #3 and #4 as the JAX package's pop-1e5 bench rows run
#: them: (problem factory, generating parameters, generations)
ADAPTIVE = {"lv1e5": ("make_lotka_volterra_problem", "LV_TRUTH", 8),
            "sir1e5": ("make_sir_problem", "SIR_TRUTH", 8)}
ADAPTIVE_POP = 100_000


def adaptive_abc(name: str, fuse: int = 1, pop: int = ADAPTIVE_POP,
                 defaults: bool = False):
    """``(abc, distance, priors, truth)`` of one adaptive workload on the
    card: full-width model, ``AdaptivePNormDistance(p=2)`` with the
    median-absolute-deviation scale, ``MedianEpsilon``, batch 2^19;
    ``fuse`` K > 1 runs fused blocks.  Eager rows are pinned unless
    ``defaults`` (the pipelinedsir1e6 phase)."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch import models as pt_models

    make, truth, _ = ADAPTIVE[name]
    models, priors, distance, observed = getattr(pt_models, make)()
    abc = pt.ABCSMC(
        models, priors, distance, population_size=pop,
        eps=pt.MedianEpsilon(),
        sampler=pt.VectorizedSampler(min_batch_size=1 << 19,
                                     max_batch_size=1 << 19, device="cuda"),
        stores_sum_stats=False, fuse_generations=fuse, seed=0,
        device="cuda", **({} if defaults else {"history_mode": "eager"}))
    abc.new("sqlite://", observed)
    return abc, distance, priors, getattr(pt_models, truth)


def run_adaptive(torch, name: str, fuse: int = 1, pop: int = ADAPTIVE_POP,
                 defaults: bool = False) -> dict:
    """One adaptive workload through ``ABCSMC.run`` on the card, with its
    per-generation timeline and the gates of the module docstring;
    ``defaults`` runs the constructor's defaults (pipelined at pop 1e6)."""
    import numpy as np

    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda

    gens = ADAPTIVE[name][2]
    abc, distance, priors, truth = adaptive_abc(name, fuse, pop, defaults)
    weighted_kde_logpdf_cuda.launches = 0
    t0 = time.perf_counter()
    abc.run(max_nr_populations=gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = weighted_kde_logpdf_cuda.launches
    rows = abc.timeline
    names = priors[0].get_parameter_names()
    df, w = abc.history.get_distribution(m=0, t=abc.history.max_t)
    x = df[names].to_numpy(np.float64)
    w = np.asarray(w, np.float64) / np.sum(w)
    mean = (w[:, None] * x).sum(0)
    std = np.sqrt((w[:, None] * (x - mean) ** 2).sum(0))
    log_truth = np.log(np.asarray(truth))
    prior_std = np.array([priors[0][k].scale for k in names]) / 12 ** 0.5
    # weights[t] (t >= 1) is fitted from generation t - 1's records,
    # weights[0] from the calibration sample of pop rows
    checks = {
        "gens": len(rows) == gens,
        "eps": all(math.isfinite(r["eps"]) and r["eps"] > 0 for r in rows),
        "launches": all(r["kde_launches"] >= 1 for r in rows if r["t"] >= 1),
        "history_rows": (list(abc.history.get_all_populations().t)
                         == [-1] + [r["t"] for r in rows]),
        "mean": bool(np.all(np.abs(mean - log_truth) <= 4 * std)),
        "std": bool(np.all(std <= 0.75 * prior_std)),
    }
    paths = [r["path"] for r in rows]
    if defaults:
        # each block that follows a block runs from the weights the one
        # before refit on the card, pre-seeded on the host at its exit
        follows = [r["t"] for r, prev in zip(rows[1:], rows)
                   if r["path"] == prev["path"] == "pipelined"]
        checks["paths"] = (paths[0] == "sequential" and "pipelined" in paths
                           and set(paths) <= {"sequential", "pipelined"})
        checks["weights"] = bool(follows) and all(
            t in distance.weights and np.all(np.isfinite(distance.weights[t]))
            for t in follows)
    elif fuse > 1:
        # a block's interior weights live on the card; its exit hands the
        # in-block refit for generation 1 + K to the host schedule
        w_exit = distance.weights.get(1 + fuse)
        checks["weights"] = bool(w_exit is not None
                                 and np.all(np.isfinite(w_exit)))
    else:
        checks["weights"] = (sorted(distance.weights) == list(range(gens))
                             and all(r["records"] >= ADAPTIVE_POP
                                     for r in rows[:-1]))
    fused = fused_report(abc, rows) if fuse > 1 else {}
    if fused:
        checks.update(fused["fused_checks"])
    return {
        "pop": pop, "gens_asked": gens, "gens_run": len(rows),
        "ok": all(checks.values()), "checks": checks, "paths": paths,
        "kde_launches": launches, "wall_s": wall,
        "peak_mem_gb": max(r["peak_mem_gb"] for r in rows),
        "params": names, "posterior_mean": mean.tolist(),
        "posterior_std": std.tolist(), "truth": log_truth.tolist(),
        "prior_std": prior_std.tolist(),
        "generations": [
            {**generation_row(r), "records": r["records"],
             "refit_s": r["refit_s"],
             **({"weight_min": float(distance.weights[r["t"]].min()),
                 "weight_max": float(distance.weights[r["t"]].max()),
                 "zero_weights": int((distance.weights[r["t"]] == 0).sum())}
                if r["t"] in distance.weights else {})}
            for r in rows],
        **fused,
    }


def _phase_adaptive(torch, state, name: str):
    row = run_adaptive(torch, name)
    state.setdefault("launches", {})[name] = row["kde_launches"]
    emit({"phase": name, **row})
    if not row["ok"]:
        raise RuntimeError(f"{name} failed its checks: {row['checks']}")


def phase_lv1e5(torch, state):
    _phase_adaptive(torch, state, "lv1e5")


def phase_sir1e5(torch, state):
    _phase_adaptive(torch, state, "sir1e5")


#: BASELINE config #5, as the JAX package's petab_ode_pop100k row runs it
STOCHASTIC_POP = 100_000
STOCHASTIC_BATCH = 1 << 18
STOP_TEMPERATURE = "Stopping: temperature reached 1"

#: the SBML decay model of the JAX package's PEtab tests
SBML_DECAY = """\
<?xml version="1.0" encoding="UTF-8"?>
<sbml xmlns="http://www.sbml.org/sbml/level3/version2/core"
      level="3" version="2">
  <model id="decay">
    <listOfCompartments>
      <compartment id="cell" size="1" constant="true"/>
    </listOfCompartments>
    <listOfSpecies>
      <species id="A" compartment="cell" initialConcentration="1"
               boundaryCondition="false" constant="false"/>
    </listOfSpecies>
    <listOfParameters>
      <parameter id="k1" value="0.7" constant="true"/>
    </listOfParameters>
    <listOfReactions>
      <reaction id="degrade" reversible="false">
        <listOfReactants>
          <speciesReference species="A" stoichiometry="1"/>
        </listOfReactants>
        <kineticLaw>
          <math xmlns="http://www.w3.org/1998/Math/MathML">
            <apply><times/><ci>k1</ci><ci>A</ci></apply>
          </math>
        </kineticLaw>
      </reaction>
    </listOfReactions>
  </model>
</sbml>
"""


def petab_importer():
    """bench.py's petab_ode_pop100k problem: one rate ``k``, uniform on
    [0.01, 3] (lin scale), ``dy/dt = −k·y``, y0 = 1, t_max 2 in 20 RK4
    steps, observed after steps 4, 9, 14, 19 with σ = 0.05, data from
    ``default_rng(0)``."""
    import numpy as np
    import pandas as pd

    from pyabc_tpu_torch.petab import ODEPetabImporter

    par_df = pd.DataFrame({
        "parameterId": ["k"], "parameterScale": ["lin"],
        "lowerBound": [0.01], "upperBound": [3.0], "estimate": [1],
        "objectivePriorType": ["uniform"],
        "objectivePriorParameters": ["0.01;3.0"]}).set_index("parameterId")
    t_max, n_steps = 2.0, 20
    obs_idx = np.asarray([4, 9, 14, 19])
    times = (obs_idx + 1) * (t_max / n_steps)
    rng = np.random.default_rng(0)
    data = np.exp(-0.7 * times) + 0.05 * rng.normal(size=times.shape)
    return ODEPetabImporter(
        par_df, rhs=lambda y, theta: -theta[:, 0:1] * y, y0=[1.0],
        t_max=t_max, n_steps=n_steps, obs_idx=obs_idx,
        measurements={"y0": data}, sigma=0.05)


def sbml_importer():
    """The SBML decay model in two conditions (A(0) = 1 in ``c0``, 2 in
    ``c1`` through the condition table), measured at t = 0.5, 1, 1.5, 2
    in each (``c0``: exp(−0.7 t) + 0.05·N(0, 1) from ``default_rng(0)``;
    ``c1``: 2·exp(−0.7 t) + 0.05·N(0, 1) from ``default_rng(1)``); ``k1``
    uniform on [0.01, 3]; the problem built from in-memory tables (no
    YAML), the importer's default 200 RK4 steps."""
    import numpy as np
    import pandas as pd

    from pyabc_tpu_torch.petab import PetabProblem, SBMLPetabImporter

    times = np.asarray([0.5, 1.0, 1.5, 2.0])
    c0 = np.exp(-0.7 * times) + 0.05 * np.random.default_rng(0).normal(
        size=times.shape)
    c1 = 2.0 * np.exp(-0.7 * times) + 0.05 * np.random.default_rng(
        1).normal(size=times.shape)
    problem = PetabProblem(
        SBML_DECAY,
        parameter_df=pd.DataFrame({
            "parameterId": ["k1"], "parameterScale": ["lin"],
            "lowerBound": [0.01], "upperBound": [3.0], "estimate": [1],
            "objectivePriorType": ["uniform"],
            "objectivePriorParameters": ["0.01;3.0"]}),
        observable_df=pd.DataFrame({
            "observableId": ["obs_a"], "observableFormula": ["A"],
            "noiseFormula": [0.05]}),
        measurement_df=pd.DataFrame({
            "observableId": "obs_a",
            "simulationConditionId": ["c0"] * 4 + ["c1"] * 4,
            "time": list(times) * 2, "measurement": list(c0) + list(c1)}),
        condition_df=pd.DataFrame({"conditionId": ["c0", "c1"],
                                   "A": [1.0, 2.0]}))
    return SBMLPetabImporter(problem)


#: name -> (importer, generations, temperature aggregation, quadrature
#: points over the prior)
STOCHASTIC = {"petab1e5": (petab_importer, 6, max, 40001),
              "sbml1e5": (sbml_importer, 8, min, 20001)}


def quadrature(torch, model, points: int) -> tuple:
    """(mean, std) of the exact posterior of the one parameter: the
    model's own llh on the CPU over ``points`` equally spaced values of
    the uniform prior [0.01, 3], weighted by exp(llh)."""
    k = torch.linspace(0.01, 3.0, points, dtype=torch.float64)
    gen = torch.Generator()
    gen.manual_seed(0)
    llh = model.simulate(gen, k.to(torch.float32)[:, None])["llh"].double()
    p = torch.exp(llh - llh.max())
    p = p / p.sum()
    mean = float((p * k).sum())
    return mean, float((p * (k - mean) ** 2).sum().sqrt())


def scheme_solved(proposals: dict) -> bool:
    """Whether the temperature of a generation came from its schemes
    (which read the records, and with them the new proposal's density)
    rather than from the final, clamped, initial or installed value."""
    return not ({"final", "clamped", "initial_temperature", "installed"}
                & set(proposals))


def llh_max(importer) -> float:
    """The largest value the ODE importer's Gaussian llh can take (every
    residual 0): the kernel's analytic pdf maximum."""
    n_obs = sum(len(v) for v in importer.measurements.values())
    return -0.5 * n_obs * math.log(2 * math.pi * importer.sigma ** 2)


def run_stochastic(torch, name: str, fuse: int = 1,
                   run_mode: str = "auto") -> tuple:
    """``(row, abc)``: one config-#5 workload through ``ABCSMC.run`` on
    the card, with its per-generation timeline and the gates of the
    module docstring.  With ``fuse`` K > 1 the run takes the fused
    engine's eligible form of the triple: ``Temperature`` with the
    acceptance-rate scheme alone, and the acceptor's pdf norm from the
    kernel's analytic maximum; ``run_mode="onedispatch"`` then runs it as
    one dispatch."""
    import numpy as np

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda
    from pyabc_tpu_torch.sampler.fused import kde_launches_per_gen

    make, gens, aggregate, points = STOCHASTIC[name]
    importer = make()
    t_q = time.perf_counter()
    mu_q, sd_q = quadrature(torch, importer.create_model(), points)
    quadrature_s = time.perf_counter() - t_q
    kernel = importer.create_kernel()
    if fuse > 1:
        temperature = pt.Temperature(schemes=[pt.AcceptanceRateScheme()])
        acceptor = pt.StochasticAcceptor(
            pdf_norm_method=pt.pdf_norm_from_kernel)
        kernel.pdf_max = llh_max(importer)
    else:
        temperature = pt.Temperature(aggregate_fun=aggregate)
        acceptor = pt.StochasticAcceptor()
    abc = pt.ABCSMC(
        importer.create_model(), importer.create_prior(), kernel,
        population_size=STOCHASTIC_POP, eps=temperature, acceptor=acceptor,
        sampler=pt.VectorizedSampler(min_batch_size=STOCHASTIC_BATCH,
                                     max_batch_size=STOCHASTIC_BATCH,
                                     device="cuda"),
        fuse_generations=fuse, run_mode=run_mode, history_mode="eager",
        seed=0, device="cuda")
    abc.new("sqlite://", importer.get_observed())
    weighted_kde_logpdf_cuda.launches = 0
    t0 = time.perf_counter()
    abc.run(max_nr_populations=gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = weighted_kde_logpdf_cuda.launches
    rows = abc.timeline
    name_k = importer.create_prior().get_parameter_names()[0]
    df, w = abc.history.get_distribution(m=0, t=abc.history.max_t)
    k = df[name_k].to_numpy(np.float64)
    w = np.asarray(w, np.float64) / np.sum(w)
    mean = float(np.sum(w * k))
    std = float(np.sqrt(np.sum(w * (k - mean) ** 2)))
    ess = float(1.0 / np.sum(w ** 2))
    temps = [temperature(r["t"]) for r in rows]

    # K1 per generation t >= 1 (one model): the finalize's deferred
    # proposal density, one density per record batch at ingest, and the
    # new proposal's density at the previous generation's records when a
    # scheme read them (ABCSMC._prepare_next_iteration)
    def expected(r):
        if r["t"] == 0:
            return 0
        if r["path"] in ("fused", "onedispatch"):
            return kde_launches_per_gen(1, True)
        return (1 + r["record_batches"]
                + scheme_solved(temperature.temperature_proposals[r["t"]]))

    checks = {
        "final_temperature": temps[-1] == 1.0,
        "monotone": all(a >= b for a, b in zip(temps, temps[1:])),
        "stop": abc.stop_reason == STOP_TEMPERATURE,
        "launches": all(r["kde_launches"] == expected(r)
                        and (r["t"] == 0 or r["kde_launches"] >= 2)
                        for r in rows),
        "mean": abs(mean - mu_q) <= max(1e-3, 4 * sd_q / ess ** 0.5),
        "std": abs(std / sd_q - 1) <= 0.05 + 4 / (2 * ess) ** 0.5,
    }
    if name == "petab1e5":
        if fuse == 1:
            checks["gens"] = len(rows) == gens
        checks["quadrature"] = (f"{mu_q:.3g}", f"{sd_q:.3g}") == \
            ("0.685", "0.0523")
    if run_mode == "onedispatch":
        fused = onedispatch_report(abc, rows, wall)
        checks.update(fused["onedispatch_checks"])
    else:
        fused = fused_report(abc, rows) if fuse > 1 else {}
        if fused:
            checks.update(fused["fused_checks"])
    return {
        "pop": STOCHASTIC_POP, "gens_asked": gens, "gens_run": len(rows),
        "ok": all(checks.values()), "checks": checks,
        "stop_reason": abc.stop_reason, "kde_launches": launches,
        "wall_s": wall, "peak_mem_gb": max(r["peak_mem_gb"] for r in rows),
        "param": name_k, "posterior_mean": mean, "posterior_std": std,
        "ess": ess, "quadrature_mean": mu_q, "quadrature_std": sd_q,
        "quadrature_points": points, "quadrature_s": quadrature_s,
        "tol_mean": max(1e-3, 4 * sd_q / ess ** 0.5),
        "tol_std_ratio": 0.05 + 4 / (2 * ess) ** 0.5,
        "pdf_norm_method": acceptor.get_config()["pdf_norm_method"],
        "generations": [
            {**generation_row(r), "temperature": r["eps"],
             "pdf_norm": acceptor.pdf_norms.get(r["t"]),
             "proposals": temperature.temperature_proposals.get(r["t"]),
             "kde_launches_expected": expected(r), "records": r["records"],
             "record_batches": r["record_batches"]} for r in rows],
        **fused,
    }, abc


def _phase_stochastic(torch, state, name: str):
    row, _ = run_stochastic(torch, name)
    state.setdefault("launches", {})[name] = row["kde_launches"]
    if name == "petab1e5":
        # K1 row (g): the generation with the most records
        g = max((r for r in row["generations"] if r["t"] >= 1),
                key=lambda r: r["records"], default=None)
        if g is not None:
            state["petab_record_shape"] = (g["records"],
                                           g["kde_support"][0]["rows"])
    emit({"phase": name, **row})
    if not row["ok"]:
        raise RuntimeError(f"{name} failed its checks: {row['checks']}")


def phase_petab1e5(torch, state):
    _phase_stochastic(torch, state, "petab1e5")


def phase_sbml1e5(torch, state):
    _phase_stochastic(torch, state, "sbml1e5")


def profile_last_generation(torch, abc, gens: int) -> dict:
    """Run ``gens - 1`` generations unprofiled, then the last one as a
    resumed ``run()`` under ``torch.profiler``: its device time by kernel
    and the device's idle share."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    abc.run(max_nr_populations=gens - 1)
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
    if busy_s <= 0:
        raise RuntimeError("the profiler saw no device time")
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    return {"t": gen["t"], "wall_s": wall, "sample_s": gen["sample_s"],
            "evaluations": gen["evaluations"],
            "rounds": int(np.ceil(gen["evaluations"] / gen["batch"])),
            "batch": gen["batch"], "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / wall,
            "device_launches": sum(e.count for e in kernels),
            "kde_launches": gen["kde_launches"],
            "top_device": [{"name": e.key[:80], "calls": e.count,
                            "device_s": dev_us(e) * 1e-6} for e in top]}


def phase_profile(torch, state):
    """The slowest generation of the pop-1e6 run (generation 10)."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import make_two_gaussians_problem

    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(
        models, priors, distance, population_size=1_000_000,
        eps=pt.MedianEpsilon(),
        sampler=pt.VectorizedSampler(max_batch_size=1 << 19,
                                     max_rounds_per_call=16, device="cuda"),
        stores_sum_stats=False, ingest_mode="sequential",
        history_mode="eager", seed=0, device="cuda")
    abc.new("sqlite://", observed)
    emit({"phase": "profile", "ok": True,
          **profile_last_generation(torch, abc, 11)})


def simulator_call(torch, model, theta) -> dict:
    """The device time and kernel launches of one simulator call at the
    batch size, as ``torch.profiler`` sees them, and the wall of one
    unprofiled call between two device syncs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=theta.device)
    gen.manual_seed(1)
    model.simulate(gen, theta)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.simulate(gen, theta)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.simulate(gen, theta)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in kernels) * 1e-6
    return {"batch": int(theta.shape[0]), "device_s": busy,
            "launches": sum(e.count for e in kernels), "wall_s": wall}


def timed_generation(torch, abc) -> dict:
    """One more generation, unprofiled, with the model's ``simulate``
    timed on the host clock between two device syncs: the simulator's
    seconds against the generation's ``sample_s``."""
    model = abc.models[0]
    spent = []

    def timed(generator, theta):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(generator, theta)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    real, model.simulate = model.simulate, timed
    try:
        abc.run(max_nr_populations=1)
    finally:
        del model.simulate
    gen = abc.timeline[-1]
    return {"t": gen["t"], "sample_s": gen["sample_s"],
            "simulator_calls": len(spent), "simulator_s": sum(spent),
            "simulator_share_of_sample_s": sum(spent) / gen["sample_s"]}


def phase_simprof(torch, state):
    """For each adaptive workload: its last generation profiled, one more
    with the simulator timed, and one simulator call at the batch size
    profiled on its own; for each config-#5 workload, one simulator call
    at its batch size."""
    for name, (make, *_) in STOCHASTIC.items():
        importer = make()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        theta = importer.create_prior().rvs_array(gen, STOCHASTIC_BATCH)
        emit({"phase": "simprof", "workload": name, "ok": True,
              "simulator_call": simulator_call(
                  torch, importer.create_model(), theta)})
    for name in ADAPTIVE:
        abc, _, priors, _ = adaptive_abc(name)
        row = profile_last_generation(torch, abc, ADAPTIVE[name][2])
        split = timed_generation(torch, abc)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        theta = priors[0].rvs_array(gen, row["batch"])
        emit({"phase": "simprof", "workload": name, "ok": True, **row,
              "timed_generation": split,
              "simulator_call": simulator_call(torch, abc.models[0],
                                               theta)})


def phase_repeat(torch, state):
    """Whether the card repeats: the scans behind resampling, then
    config #2 fused at pop 16384 over twenty seeds."""
    from pyabc_tpu_torch.ops.choice import ordered_cumsum

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    scans = {}
    for n in (16384, 100_000, 1_000_000, 1_500_000):
        x = torch.softmax(torch.randn(n, generator=gen, device="cuda"), 0)
        row = {}
        for name, fn in (("torch_cumsum", lambda v: torch.cumsum(v, 0)),
                         ("ordered_cumsum", ordered_cumsum)):
            ref = fn(x)
            row[name] = sum(not torch.equal(fn(x), ref) for _ in range(50))
        scans[n] = row
    emit({"phase": "repeat", "ok": True, "calls": 50,
          "differing_calls": scans})
    rows = []
    for seed in range(20):
        r = run_main_path(torch, 16384, 11, seed=seed, fuse=FUSE_K)
        rows.append({"seed": seed, "ok": r["ok"],
                     "ess": r["generations"][-1]["ess"],
                     "pb_err": r["p_model_b"] - r["p_analytic"],
                     "paths": "".join(p[0] for p in r["paths"]),
                     "wall_s": r["wall_s"]})
    emit({"phase": "repeat", "ok": True, "fused16384_seeds": rows,
          "collapsed": sum(r["ess"] < 0.01 * 16384 or not r["ok"]
                           for r in rows)})


def kernels_line(state) -> dict:
    """The per-kernel summary: times at the pop-16384 finalize shape
    (``ms`` is the whole wrapper call, ``kernel_only_ms`` the launches
    alone), the same numbers at every compared shape, the largest error
    over all of them, launches on the main path."""
    rows = state.get("kernel_rows", [])
    main = rows[0] if rows else {}
    launches = state.get("launches", {})
    keys = ("kernel_only_ms", "call_ms", "plain_ms", "library_ms",
            "library_chunks", "bound_ms", "bound_share", "max_abs_err",
            "partial_kernel")
    return {"kernels": [{
        "name": "kde_logpdf", "route": "cuda",
        "source": "pyabc_tpu_torch/csrc/kde_logpdf.cu",
        "replaces": "pyabc_tpu/ops/kde_pallas.py:77",
        "launches": sum(launches.values()),
        "launches_by_phase": launches,
        "max_abs_err": max((r["max_abs_err"] for r in rows), default=None),
        "ms": main.get("call_ms"),
        "kernel_only_ms": main.get("kernel_only_ms"),
        "plain_ms": main.get("plain_ms"),
        "bound_ms": main.get("bound_ms"), "bound_by": "operations",
        "library_ms": main.get("library_ms"),
        "shape": main.get("shape"),
        "by_shape": [{"shape": r["shape"], **{k: r.get(k) for k in keys}}
                     for r in rows]}]}


PHASES = {"card": phase_card, "build": phase_build,
          "kernels": phase_kernels, "pop16384": phase_pop16384,
          "pop1e6": phase_pop1e6, "lv1e5": phase_lv1e5,
          "sir1e5": phase_sir1e5, "petab1e5": phase_petab1e5,
          "sbml1e5": phase_sbml1e5, "fused16384": phase_fused16384,
          "fused1e6": phase_fused1e6, "fusedlv1e5": phase_fusedlv1e5,
          "fusedpetab1e5": phase_fusedpetab1e5,
          "onedispatch1e6": phase_onedispatch1e6,
          "onedispatchpetab1e5": phase_onedispatchpetab1e5,
          "pipelined1e6": phase_pipelined1e6,
          "pipelinedsir1e6": phase_pipelinedsir1e6,
          "profile": phase_profile, "repeat": phase_repeat,
          "simprof": phase_simprof, "k1perm": phase_k1perm}


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
