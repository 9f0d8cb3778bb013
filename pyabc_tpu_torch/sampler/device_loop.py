"""The rejection loop with compaction into fixed buffers.

Port of ``build_stateful_loop`` from ``pyabc_tpu/sampler/device_loop.py``
as a Python loop over rounds.  Accepted candidates accumulate in
device-resident buffers of ``cap = n_target + B`` rows; each round's
accepted rows land at ``pos = count + cumsum(accepted) − 1`` and rows at
or past ``cap`` are dropped (written to one dump row past the end).  The
compaction keeps (round, lane) order, and the caller truncates to the
first ``n_target`` rows — the reference's DYN de-biasing protocol: keep
every result of every started round, in a deterministic order.

With ``record_cap > 0`` every *valid* candidate (accepted or not) is also
scattered, in the same (round, lane) order, into NaN-filled record
buffers ``rec_stats``, ``rec_distance``, ``rec_accepted``, ``rec_m``,
``rec_theta`` and ``rec_log_proposal`` of ``max(record_cap, 1)`` rows;
rows past the cap are dropped.

Returns ``(start, step, finalize, reset)``:

- ``start() -> state`` — empty state; buffers are allocated on the first
  round, from that round's shapes, and reused by ``reset``;
- ``step(generator, params, state) -> state`` — up to ``max_rounds``
  rounds, stopping early once ``count >= n_target`` (one host read of the
  count per round);
- ``finalize(state, params) -> view`` — the first ``min(count,
  n_target)`` rows; with ``weight_correction`` the deferred proposal
  density is subtracted here, once, over the accepted rows;
- ``reset(state) -> state`` — a cursor rewind for the next generation;
  the record buffers are refilled with NaN.

:func:`harvest_rec` takes a call's records out of a state.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .base import RECORD_KEYS

_KEYS = ("m", "theta", "distance", "log_weight", "stats")


def _fill_records(rec: dict) -> dict:
    """Record buffers back to empty: NaN floats, False, model 0."""
    for k, v in rec.items():
        v.fill_(float("nan") if v.is_floating_point() else 0)
    return rec


def build_stateful_loop(raw_round: Callable, B: int, n_target: int,
                        max_rounds: int,
                        weight_correction: Optional[Callable] = None,
                        record_cap: int = 0):
    """``raw_round(generator, params) -> RoundResult`` of B candidates;
    ``weight_correction(m, theta, params) -> log_denom`` marks the rounds'
    log weights as partial (see ``RoundKernel.generation_round``);
    ``record_cap`` rows of records per call (0: none)."""
    cap = n_target + B
    rc = max(int(record_cap), 1)

    def start() -> dict:
        return {"count": None, "rounds": 0, "bufs": None, "rec": None,
                "rec_count": None}

    def _allocate(rr, device) -> dict:
        # one dump row at index cap takes every dropped write
        return {
            "m": torch.zeros(cap + 1, dtype=rr.m.dtype, device=device),
            "theta": torch.zeros(cap + 1, rr.theta.shape[1],
                                 dtype=torch.float32, device=device),
            "distance": torch.full((cap + 1,), float("nan"),
                                   device=device),
            "log_weight": torch.full((cap + 1,), float("-inf"),
                                     device=device),
            "stats": torch.zeros(cap + 1, rr.stats.shape[1],
                                 dtype=torch.float32, device=device),
        }

    def _allocate_records(rr, device) -> dict:
        # rc rows plus the dump row; harvest hands out the first rc
        return _fill_records({
            k: torch.empty((rc + 1,) + tuple(getattr(rr, k).shape[1:]),
                           dtype=getattr(rr, k).dtype, device=device)
            for k in RECORD_KEYS})

    def scatter(state: dict, rr) -> None:
        dev = rr.m.device
        if state["bufs"] is None:
            state["bufs"] = _allocate(rr, dev)
        if state["count"] is None:
            state["count"] = torch.zeros((), dtype=torch.int64, device=dev)
        acc = rr.accepted
        count = state["count"]
        pos = count + torch.cumsum(acc.to(torch.int64), 0) - 1
        idx = torch.where(acc & (pos < cap), pos, cap)
        bufs = state["bufs"]
        for k in _KEYS:
            bufs[k][idx] = getattr(rr, k)
        state["count"] = torch.clamp(count + acc.sum(), max=cap)
        if record_cap:
            if state["rec"] is None:
                state["rec"] = _allocate_records(rr, dev)
            if state["rec_count"] is None:
                state["rec_count"] = torch.zeros((), dtype=torch.int64,
                                                 device=dev)
            val = rr.valid
            rcount = state["rec_count"]
            rpos = rcount + torch.cumsum(val.to(torch.int64), 0) - 1
            ridx = torch.where(val & (rpos < rc), rpos, rc)
            for k in RECORD_KEYS:
                state["rec"][k][ridx] = getattr(rr, k)
            state["rec_count"] = torch.clamp(rcount + val.sum(), max=rc)

    def step(generator, params, state: dict) -> dict:
        for _ in range(max_rounds):
            if state["count"] is not None and \
                    int(state["count"]) >= n_target:
                break
            scatter(state, raw_round(generator, params))
            state["rounds"] += 1
        return state

    def finalize(state: dict, params) -> dict:
        take = min(int(state["count"]), n_target)
        view = {k: state["bufs"][k][:take] for k in _KEYS}
        if weight_correction is not None and take:
            log_denom = weight_correction(view["m"], view["theta"], params)
            lw = view["log_weight"]
            # -inf partial weights stay -inf (-inf - -inf would be NaN)
            view["log_weight"] = torch.where(torch.isfinite(lw),
                                             lw - log_denom, lw)
        return view

    def reset(state: dict) -> dict:
        if state["count"] is not None:
            state["count"] = torch.zeros_like(state["count"])
        if state["rec_count"] is not None:
            state["rec_count"] = torch.zeros_like(state["rec_count"])
            _fill_records(state["rec"])
        state["rounds"] = 0
        return state

    return start, step, finalize, reset


def harvest_rec(state: dict) -> Tuple[dict, dict]:
    """``(rec, state)``: this call's records — ``rec_<key>`` buffers of
    ``max(record_cap, 1)`` rows, NaN past ``rec_count`` — and the state
    with fresh NaN-filled record buffers and the record count at 0.

    Records are taken out every call rather than carried: the device
    buffer bounds one call, and ``Sample.append_record_batch`` bounds the
    generation at ``max_records``, earliest first.  The harvested buffers
    leave the state, so a later ``reset`` never overwrites them."""
    old = state["rec"]
    if old is None:
        return {"rec_count": 0}, state
    rec = {"rec_" + k: v[:-1] for k, v in old.items()}
    rec["rec_count"] = state["rec_count"]
    state["rec"] = _fill_records({k: torch.empty_like(v)
                                  for k, v in old.items()})
    state["rec_count"] = torch.zeros_like(state["rec_count"])
    return rec, state
