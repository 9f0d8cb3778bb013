"""Single-device vectorized sampler.

Port of ``pyabc_tpu/sampler/vectorized.py``.  One generation repeats
fixed-size candidate rounds on the device until ``n`` are accepted
(:mod:`.device_loop`), then fetches the compacted accepted buffers to
the host once.  The candidate batch ``B`` comes from a power-of-two
ladder chosen by the :class:`~pyabc_tpu_torch.autotune.BatchAutotuner`
(acceptance-rate EWMA with variance, undershoot feedback, hysteresis).

The proposal density is always deferred out of the rounds when the round
function supports it: rounds produce partial weights and ``finalize``
subtracts the KDE density once over the accepted rows — one KDE kernel
launch per model per generation.  The f16 wire codec and the record
buffers of the JAX package are not ported: the host reads the float32
buffers, and adaptive distances and temperature schemes come later.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import numpy as np

from ..autotune import BatchAutotuner
from ..convert import to_numpy, to_torch
from ..device import resolve_device
from .base import Sample, Sampler, SamplingError
from .device_loop import build_stateful_loop

logger = logging.getLogger("ABC.Sampler")


def _pow2_at_least(x: float) -> int:
    return 1 << max(int(np.ceil(np.log2(max(x, 1)))), 0)


class VectorizedSampler(Sampler):
    """On-device rejection-loop sampler."""

    def __init__(self,
                 min_batch_size: int = 256,
                 max_batch_size: int = 1 << 18,
                 safety_factor: float = 1.2,
                 max_rounds_per_call: int = 64,
                 device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.min_batch_size = int(min_batch_size)
        self.max_batch_size = int(max_batch_size)
        self.safety_factor = float(safety_factor)
        self.max_rounds_per_call = int(max_rounds_per_call)
        self._tuner = BatchAutotuner()
        #: loop buffers per (round fn, B, n, deferred), reused across
        #: generations (a reset is a cursor rewind); at most 4 kept
        self._states: Dict[Tuple, tuple] = {}
        #: candidate batch of the last generation sampled
        self.last_batch: Optional[int] = None

    def choose_batch(self, n: int) -> int:
        return self._tuner.choose_batch(n, self.safety_factor,
                                        self._round_to_valid_batch)

    def _round_to_valid_batch(self, b: float) -> int:
        return int(np.clip(_pow2_at_least(b), self.min_batch_size,
                           self.max_batch_size))

    def sample_until_n_accepted(self, n, round_fn, generator, params,
                                max_eval=np.inf, all_accepted=False
                                ) -> Sample:
        sample = Sample()
        # params arrive as host numpy (fits are control plane); pin them
        # on the device once per generation
        params = to_torch(params, self.device)
        if all_accepted:
            # calibration: exact-size rounds; failed simulations (NaN
            # distance) are dropped, so top up until n
            B = self.last_batch = self._round_to_valid_batch(n)
            zero_rounds = 0
            while sample.n_accepted < n:
                before = sample.n_accepted
                sample.append_round(round_fn(generator, params, B,
                                             all_accepted=True))
                zero_rounds = (zero_rounds + 1
                               if sample.n_accepted == before else 0)
                if zero_rounds >= 3:
                    raise SamplingError(
                        "calibration produced no valid simulations in 3 "
                        "consecutive full rounds")
                if sample.nr_evaluations >= max_eval \
                        and sample.n_accepted < n:
                    logger.warning("max_eval reached during calibration "
                                   "(%d/%d)", sample.n_accepted, n)
                    break
            self.nr_evaluations_ = sample.nr_evaluations
            return sample

        B = self.last_batch = self.choose_batch(n)
        defer = (getattr(round_fn, "supports_deferred_proposal", False)
                 and hasattr(round_fn, "__self__"))
        if defer:
            raw = lambda gen, p: round_fn(gen, p, B,  # noqa: E731
                                          with_proposal=False)
            weight_fn = round_fn.__self__.proposal_log_density
        else:
            raw = lambda gen, p: round_fn(gen, p, B)  # noqa: E731
            weight_fn = None
        owner = getattr(round_fn, "__self__", round_fn)
        loop_key = (getattr(owner, "_uid", id(owner)),
                    getattr(round_fn, "__name__", ""), B, n, defer)
        cached = self._states.pop(loop_key, None)
        start, step, finalize, reset = build_stateful_loop(
            raw, B, n, self.max_rounds_per_call, weight_correction=weight_fn)
        state = reset(cached) if cached is not None else start()
        while True:
            state = step(generator, params, state)
            count, rounds = int(state["count"]), state["rounds"]
            self._tuner.observe(count, max(rounds * B, 1), rounds=rounds)
            if count >= n:
                break
            if rounds * B >= max_eval:
                logger.warning("max_eval=%s reached with %d/%d accepted",
                               max_eval, count, n)
                break
        view = finalize(state, params)
        sample.append_device_batch(to_numpy(view), rounds * B, count)
        self._states[loop_key] = state
        while len(self._states) > 4:
            self._states.pop(next(iter(self._states)))
        self.nr_evaluations_ = sample.nr_evaluations
        return sample
