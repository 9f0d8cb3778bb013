"""The device-memory capacity model: a ledger from run shape to peak bytes.

Port of ``pyabc_tpu/capacity/model.py``.  Nothing here allocates: every
entry point is arithmetic over the run's shape, so the orchestrator
(``smc.py``) consults it before a device engine runs and either takes
the (batch, K, max_T, at-rest precision) point that fits the budget or
raises a :class:`CapacityError` that carries the whole ledger.

:func:`ledger` is re-derived for the port's own buffers (its docstring
names the allocation behind each column); :func:`plan`'s search, the
budget resolution, :class:`CapacityPlan` and :class:`CapacityError` are
the JAX package's.

Budget resolution, in order:

- ``PYABC_TPU_HBM_BUDGET`` — an explicit budget, used verbatim
  (suffixes ``K``/``M``/``G``/``T``, e.g. ``12G``; plain = bytes);
- the card's total memory (``torch.cuda.mem_get_info``) scaled by
  ``1 - PYABC_TPU_HBM_HEADROOM`` (default headroom 0.1);
- a CPU device reports none: budget 0, unconstrained, every plan fits.
"""

from __future__ import annotations

import dataclasses
import math
import os
from collections import OrderedDict
from typing import Callable, Optional

from ..ops.kde_cuda import G, PARAMS_FLOATS, geometry, split_plan
from ..ops.precision import CARRY_ITEMSIZE, resolve_carry_precision

HBM_BUDGET_ENV = "PYABC_TPU_HBM_BUDGET"
HBM_HEADROOM_ENV = "PYABC_TPU_HBM_HEADROOM"

#: the at-rest precision ladder ``carry_precision=auto`` descends —
#: widest (exact) mode first, so a fitting f32 plan always wins
AUTO_LADDER = ("f32", "bf16", "int8")

#: round-budget headroom of the completability constraint: a geometry
#: with ``ceil(headroom * population / batch) > max_T`` cannot fill the
#: population within its round budget (the engine undershoots and the
#: run falls back to the sequential engine), so plan() never emits one
ROUND_HEADROOM = 4.0

#: allocations of a run that do not scale with its shape: the cuBLAS
#: and cuBLASLt workspaces and the allocator's first blocks (the
#: intercept of tests/test_torch_capacity_cuda.py's measured peaks over
#: three populations: 39 MB on an H100; 48 MiB here)
RUNTIME_BYTES = 48 * 1024 ** 2

_SUFFIX = {"k": 1024, "m": 1024 ** 2, "g": 1024 ** 3, "t": 1024 ** 4}


def parse_bytes(text) -> int:
    """``'12G' -> 12884901888``; accepts K/M/G/T (binary), an optional
    trailing ``b``/``ib``, or a plain byte count (int or float)."""
    if isinstance(text, (int, float)):
        return int(text)
    raw = str(text).strip().lower()
    if not raw:
        return 0
    for tail in ("ib", "b"):
        if raw.endswith(tail) and len(raw) > len(tail):
            raw = raw[: -len(tail)]
            break
    mult = 1
    if raw and raw[-1] in _SUFFIX:
        mult = _SUFFIX[raw[-1]]
        raw = raw[:-1]
    try:
        return int(float(raw) * mult)
    except ValueError:
        raise ValueError(
            f"{HBM_BUDGET_ENV}: cannot parse {text!r} as a byte count "
            f"(expected e.g. '12G', '900M', or plain bytes)") from None


def detect_hbm_bytes(device=None) -> int:
    """The card's total memory in bytes (``torch.cuda.mem_get_info``), or
    0 for a CPU device or where no card is present."""
    import torch
    if device is not None and torch.device(device).type != "cuda":
        return 0
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.mem_get_info(device)[1])


def resolved_budget_bytes(device=None) -> int:
    """The effective budget: the explicit env value verbatim, else the
    detected card memory scaled by the headroom fraction, else 0
    (unconstrained)."""
    raw = os.environ.get(HBM_BUDGET_ENV, "").strip()
    if raw:
        return parse_bytes(raw)
    phys = detect_hbm_bytes(device)
    if phys <= 0:
        return 0
    headroom = float(os.environ.get(HBM_HEADROOM_ENV, "0.1"))
    headroom = min(max(headroom, 0.0), 0.9)
    return int(phys * (1.0 - headroom))


def _ceil_div(a: int, b: int) -> int:
    return -(-int(a) // max(int(b), 1))


def kde_scratch_bytes(m: int, n: int, d: int) -> int:
    """K1's allocations for one call of ``m`` queries against ``n``
    support rows (``ops/kde_cuda.py`` ``KdeCall``): the output, the
    packed support and the per-split partial maxima and sums."""
    if m <= 0 or n <= 0:
        return 0
    p = geometry(d)[0]
    n_pad = _ceil_div(n, G) * G
    splits = split_plan(m, n, d)[1]
    return 4 * (m + PARAMS_FLOATS + n_pad * p + 2 * splits * m)


def ledger(*, population: int, param_dim: int, stat_dim: int,
           engine: str = "fused", batch: int = 4096, K: int = 1,
           max_T: int = 32, carry_precision: str = "f32",
           devices: int = 1, wire_stats: bool = True, models: int = 1,
           support_cap: Optional[int] = None, record_rows: int = 0,
           cal_rows: int = 0, store_gens: int = 0, loop_states: int = 2,
           sim_mult: int = 4, wire_slots: Optional[int] = None,
           graph_pool: bool = False) -> "OrderedDict[str, int]":
    """Peak-byte ledger of one device generation of the port.

    With ``n`` the population, ``B`` the batch, ``cap = n + B``, ``d``
    and ``s`` the parameter and statistic widths, ``w`` the at-rest bytes
    per element, and ``row = 8 + 4·(d + 2 + s)`` the bytes of one row of
    an accept buffer (int64 model index, float32 theta, distance, log
    weight and statistics), the columns are, in bytes:

    - ``carry_at_rest`` — the previous generation's carry while this one
      runs (``sampler/fused.py`` ``build_one_gen``: ``carry`` in,
      ``new_carry`` out).  At f32 it is counted as ``(cap + 1)·row`` plus
      the corrected log weights ``4n``: an upper bound, since the engine
      copies its ``n`` rows out of the accept buffers it keeps.
      Narrowed, its theta/distance/stats buffers are freed and it keeps
      the model-index buffer ``(cap + 1)·8``, the log weights ``4n`` and
      the narrowed lanes ``w·n·(d + 1 + s)``, counted twice: the next
      carry's narrowed copy is written while the input is
      alive.  The float32 promotion of the narrowed lanes lives only
      while the generation refits its proposal and sets its epsilon,
      before ``accept_window`` and ``round_batch`` exist, and is smaller
      than they are, so it adds nothing to the peak.  The JAX package's
      column counts ``n`` rows at rest.
    - ``accept_window`` — the engine's accept buffers, refilled each
      generation (the static inputs of its captured round on the card):
      ``(cap + 1)·row`` (one dump row).  The JAX package's column counts
      the same rows at its int32 model index.
    - ``round_batch`` — one round's proposals, simulation, distances and
      compaction indices at ``B``: ``B·sim_mult·(16 + 4·(d + s + 4))``,
      ``sim_mult`` state copies of the simulator's working set.
    - ``generation_scratch`` — the per-generation temporaries over the
      population (the quantile's sort and cumsum, the refit's weights,
      the proposal density, the corrected weights, the summary lanes):
      ``24n``.  No JAX column matches; XLA folds these into its temps.
    - ``kde_scratch`` — K1's one allocation for the finalize density
      (``ops/kde_cuda.py`` ``KdeCall``: output, packed support, split
      partials) over ``n`` queries against the capped support
      (``support_cap``, else ``n``).  No JAX column matches.
    - ``refit_support`` — each model's refit support at its capped size:
      ``models·sup·(4d + 8)``.
    - ``wire_egress`` — the wire slots a block or a run writes its
      generations into, ``slots·n·(8 + 4·(d + 2) [+ 4s with
      wire_stats])``: ``K`` for a fused block, none for the sequential
      engine, and for a one-dispatch run the generations it may write,
      ``min(wire_slots, max_T)`` (``wire_slots``: the generations left in
      the run; ``max_T`` without it).  These are the tensors the pending
      ``GenStream`` fetches read.  The JAX package's column counts
      ``max_T`` generations, the size of its stacked output.
    - ``record_ring`` — the stochastic triple's record ring, in and out:
      ``2·record_rows·(4d + 20)``.
    - ``fidelity_rings`` — the calibration rings ``cal_lo``/``cal_full``,
      in and out: ``2·2·cal_rows·4``.
    - ``store_ring`` — the lazy History's ``DeviceRunStore``: the
      ``store_gens`` generations resident when the engine starts, at most
      ``n·row`` each (a sequential generation deposits every lane; the
      engine's own generations are its wire slots).  No JAX column
      matches.
    - ``runtime`` — :data:`RUNTIME_BYTES`, what a run allocates whatever
      its shape.  No JAX column matches.
    - ``loop_states`` — the sequential sampler's cached loop buffers
      (``sampler/device_loop.py``), ``loop_states·(cap + 1)·row``: the
      prior round's and the generation round's, alive across the run.
      No JAX column matches.
    - ``graph_pool`` — with ``graph_pool`` (the card captures the rounds
      as CUDA graphs into the sampler's pool: ``sampler/device_loop.py``)
      the pool, which keeps a round's working set between replays, and
      the outputs a generation reads after its rounds: ``round_batch``'s
      bytes again, a working set the eager allocator's cache no longer
      lends to the rest of the generation (``chip_smoke.py``'s
      capacity1e7 SIR rounds at B = 2^22 leave 1.26 GB in the pool
      against 1.48 GB of ``round_batch`` on an H100).  No JAX column
      matches: XLA's programs own their temporaries.

    Population terms are divided across ``devices``; supports are not.
    """
    if engine not in ("sequential", "fused", "onedispatch"):
        raise ValueError(f"capacity: unknown engine {engine!r}")
    n, d, s = int(population), int(param_dim), int(stat_dim)
    devices = max(int(devices), 1)
    B = max(int(batch), 1)
    mode = resolve_carry_precision(carry_precision)
    if mode == "auto":
        raise ValueError("ledger() needs a concrete carry_precision; "
                         "plan() resolves 'auto'")
    if engine == "sequential":
        mode = "f32"  # the host loop never stores a compressed carry
    w = CARRY_ITEMSIZE[mode]

    n_dev = _ceil_div(n, devices)
    b_dev = _ceil_div(B, devices)
    cap_rows = n_dev + b_dev + 1
    row = 8 + 4 * (d + 2 + s)
    bulk = d + 1 + s
    device_engine = engine != "sequential"

    if not device_engine:
        carry = 0
    elif mode == "f32":
        carry = cap_rows * row + 4 * n_dev
    else:
        carry = cap_rows * 8 + 4 * n_dev + 2 * w * n_dev * bulk
    run_slots = (int(max_T) if wire_slots is None
                 else min(int(wire_slots), int(max_T)))
    slots = {"sequential": 0, "fused": int(K),
             "onedispatch": run_slots}[engine]
    wire_row = 8 + 4 * (d + 2) + (4 * s if wire_stats else 0)
    sup = n if support_cap is None else min(int(support_cap), n)

    out: "OrderedDict[str, int]" = OrderedDict()
    out["carry_at_rest"] = carry
    out["accept_window"] = cap_rows * row
    out["round_batch"] = b_dev * int(sim_mult) * (16 + 4 * (d + s + 4))
    out["generation_scratch"] = 24 * n_dev
    out["kde_scratch"] = kde_scratch_bytes(n_dev, sup, d)
    out["refit_support"] = int(models) * sup * (4 * d + 8)
    out["wire_egress"] = slots * n_dev * wire_row
    out["record_ring"] = 2 * int(record_rows) * (4 * d + 20)
    out["fidelity_rings"] = 2 * 2 * int(cal_rows) * 4
    out["store_ring"] = int(store_gens) * n_dev * row
    out["loop_states"] = int(loop_states) * cap_rows * row
    out["graph_pool"] = out["round_batch"] if graph_pool else 0
    out["runtime"] = RUNTIME_BYTES
    return out


def predict_peak_bytes(**kwargs) -> int:
    """Sum of the :func:`ledger` columns: the predicted peak of one
    device generation."""
    return sum(ledger(**kwargs).values())


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """A (precision, geometry) point the budget admits."""
    carry_precision: str
    batch: int
    K: int
    max_T: int
    devices: int
    predicted_bytes: int
    budget_bytes: int        # 0 = unconstrained
    ledger: "OrderedDict[str, int]"
    note: str = ""

    @property
    def predicted_mb(self) -> float:
        return self.predicted_bytes / (1024.0 * 1024.0)


class CapacityError(RuntimeError):
    """No (batch, K, max_T, precision) point fits the memory budget.

    Carries the full ledger of the smallest candidate tried at the pinned
    precision (``.ledger``), the resolved budget (``.budget``), the losing
    prediction (``.predicted``), the original request (``.request``) and —
    when a narrower at-rest mode would fit — a ``.hint`` naming it."""

    def __init__(self, message: str, *, request: dict, ledger: dict,
                 budget: int, predicted: int, hint: Optional[str] = None):
        super().__init__(message)
        self.request = request
        self.ledger = ledger
        self.budget = budget
        self.predicted = predicted
        self.hint = hint


def _fmt_mb(b: int) -> str:
    return f"{b / (1024.0 * 1024.0):.1f} MB"


def _render_ledger(led: dict) -> str:
    width = max(len(k) for k in led)
    return "\n".join(f"    {k.ljust(width)}  {_fmt_mb(v):>10}"
                     for k, v in led.items())


def _batch_rungs(batch: int,
                 round_to_batch: Optional[Callable[[int], int]]):
    """Descending halvings of the requested rung, floored at 256 (or
    the requested batch when smaller), snapped to the sampler's valid
    rungs when a rounder is supplied."""
    floor = min(int(batch), 256)
    out, b = [], int(batch)
    for _ in range(12):
        snapped = int(round_to_batch(b)) if round_to_batch else b
        snapped = max(snapped, 1)
        if snapped not in out:
            out.append(snapped)
        if b <= floor:
            break
        b = max(b // 2, floor)
    return out


def plan(*, population: int, param_dim: int, stat_dim: int,
         engine: str = "fused", batch: Optional[int] = None, K: int = 1,
         max_T: int = 32, carry_precision: Optional[str] = None,
         devices: int = 1, budget: Optional[int] = None,
         round_to_batch: Optional[Callable[[int], int]] = None,
         round_headroom: Optional[float] = None, device=None,
         **lanes) -> CapacityPlan:
    """Choose the widest (precision, geometry) point fitting the budget.

    Search order: the precision ladder outermost (the requested mode
    only, or f32 -> bf16 -> int8 for ``auto``), then batch rungs
    descending, then block ``K`` descending, then ``max_T`` descending:
    exactness first, the requested geometry second.

    Round-bounded engines (fused, onedispatch) face the completability
    constraint ``ceil(round_headroom * population / batch) <= max_T``
    (default :data:`ROUND_HEADROOM`); the smallest-candidate bytes a
    :class:`CapacityError` reports honour it too.

    ``budget=None`` resolves via :func:`resolved_budget_bytes` (on
    ``device``); a non-positive budget is unconstrained and returns the
    request verbatim (``auto`` resolving to f32)."""
    if batch is None:
        batch = min(int(population), 4096)
    mode = resolve_carry_precision(carry_precision)
    if budget is None:
        budget = resolved_budget_bytes(device)
    budget = int(budget or 0)
    headroom = max(float(ROUND_HEADROOM if round_headroom is None
                         else round_headroom), 1.0)

    def _completable(b: int, t: int) -> bool:
        if engine == "sequential":
            return True  # the host loop rounds until done
        return math.ceil(headroom * int(population) / max(int(b), 1)) \
            <= int(t)

    def _ledger_at(prec, b, k, t):
        return ledger(population=population, param_dim=param_dim,
                      stat_dim=stat_dim, engine=engine, batch=b, K=k,
                      max_T=t, carry_precision=prec, devices=devices,
                      **lanes)

    if budget <= 0:
        prec = "f32" if mode == "auto" else mode
        led = _ledger_at(prec, batch, K, max_T)
        return CapacityPlan(prec, int(batch), int(K), int(max_T),
                            int(devices), sum(led.values()), 0, led,
                            note="unconstrained")

    ladder = AUTO_LADDER if mode == "auto" else (mode,)
    rungs = _batch_rungs(batch, round_to_batch)
    ks = list(range(int(K), 0, -1))
    ts = [int(max_T)]
    while ts[-1] > 8:
        ts.append(max(ts[-1] // 2, 8))

    smallest = None  # ledger of the tiniest candidate at ladder[0]
    for prec in ladder:
        for b in rungs:
            for k in ks:
                for t in ts:
                    if not _completable(b, t):
                        continue
                    led = _ledger_at(prec, b, k, t)
                    total = sum(led.values())
                    if prec == ladder[0]:
                        if smallest is None or total < smallest[1]:
                            smallest = (led, total, b, k, t)
                    if total <= budget:
                        clamped = (prec != ladder[0] or b != batch
                                   or k != K or t != max_T)
                        note = ("clamped to fit budget" if clamped
                                else "fits as requested")
                        return CapacityPlan(prec, b, k, t, int(devices),
                                            total, budget, led, note)

    request = dict(population=population, param_dim=param_dim,
                   stat_dim=stat_dim, engine=engine, batch=batch, K=K,
                   max_T=max_T, carry_precision=mode, devices=devices,
                   **lanes)
    if smallest is None:
        # no (batch, max_T) point can fill the population within the
        # round budget: a bytes budget never fixes that
        led = _ledger_at(ladder[0], batch, K, max_T)
        raise CapacityError(
            f"capacity: no (batch, max_T) point can fill population="
            f"{population} within {max_T} rounds at {headroom:.1f}x "
            f"headroom (engine={engine}); raise max_T or the batch "
            f"ceiling", request=request, ledger=led, budget=budget,
            predicted=sum(led.values()), hint=None)

    # nothing fits: find the narrowest mode that would, for the hint
    hint = None
    for prec in AUTO_LADDER[1:]:
        if prec in ladder:
            continue
        for b in rungs:
            for t in ts:
                if not _completable(b, t):
                    continue
                total = sum(_ledger_at(prec, b, 1, t).values())
                if total <= budget:
                    hint = (f"PYABC_TPU_CARRY_PRECISION={prec} would "
                            f"fit (predicted {_fmt_mb(total)} <= budget "
                            f"{_fmt_mb(budget)})")
                    break
            if hint:
                break
        if hint:
            break

    led, total, b, k, t = smallest
    msg = (
        f"capacity: no (batch, K, max_T, precision) point fits the "
        f"HBM budget\n  population={population} devices={devices} "
        f"engine={engine} carry_precision={mode}\n"
        f"  budget: {_fmt_mb(budget)}\n"
        f"  smallest candidate tried: batch={b} K={k} max_T={t} -> "
        f"predicted {_fmt_mb(total)}\n{_render_ledger(led)}")
    if hint:
        msg += f"\n  hint: {hint}"
    raise CapacityError(msg, request=request, ledger=led, budget=budget,
                        predicted=total, hint=hint)
