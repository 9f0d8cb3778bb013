"""The rejection loop with compaction into fixed buffers.

Port of ``build_stateful_loop`` from ``pyabc_tpu/sampler/device_loop.py``
as a Python loop over rounds.  Accepted candidates accumulate in
device-resident buffers of ``cap = n_target + B`` rows; each round's
accepted rows land at ``pos = count + cumsum(accepted) − 1`` and rows at
or past ``cap`` are dropped (written to one dump row past the end).  The
compaction keeps (round, lane) order, and the caller truncates to the
first ``n_target`` rows — the reference's DYN de-biasing protocol: keep
every result of every started round, in a deterministic order.

Returns ``(start, step, finalize, reset)``:

- ``start() -> state`` — empty state; buffers are allocated on the first
  round, from that round's shapes, and reused by ``reset``;
- ``step(generator, params, state) -> state`` — up to ``max_rounds``
  rounds, stopping early once ``count >= n_target`` (one host read of the
  count per round);
- ``finalize(state, params) -> view`` — the first ``min(count,
  n_target)`` rows; with ``weight_correction`` the deferred proposal
  density is subtracted here, once, over the accepted rows;
- ``reset(state) -> state`` — a cursor rewind for the next generation.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

_KEYS = ("m", "theta", "distance", "log_weight", "stats")


def build_stateful_loop(raw_round: Callable, B: int, n_target: int,
                        max_rounds: int,
                        weight_correction: Optional[Callable] = None):
    """``raw_round(generator, params) -> RoundResult`` of B candidates;
    ``weight_correction(m, theta, params) -> log_denom`` marks the rounds'
    log weights as partial (see ``RoundKernel.generation_round``)."""
    cap = n_target + B

    def start() -> dict:
        return {"count": None, "rounds": 0, "bufs": None}

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

    def scatter(state: dict, rr) -> None:
        if state["bufs"] is None:
            state["bufs"] = _allocate(rr, rr.m.device)
        if state["count"] is None:
            state["count"] = torch.zeros((), dtype=torch.int64,
                                         device=rr.m.device)
        acc = rr.accepted
        count = state["count"]
        pos = count + torch.cumsum(acc.to(torch.int64), 0) - 1
        idx = torch.where(acc & (pos < cap), pos, cap)
        bufs = state["bufs"]
        for k in _KEYS:
            bufs[k][idx] = getattr(rr, k)
        state["count"] = torch.clamp(count + acc.sum(), max=cap)

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
        state["rounds"] = 0
        return state

    return start, step, finalize, reset
