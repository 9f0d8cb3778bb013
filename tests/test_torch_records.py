"""The record stream of the port's device loop against the JAX package's.

One sequence of candidate rounds, made in numpy from a seed, goes
through the JAX package's ``build_stateful_loop`` and the port's, with
records on.  The JAX loop runs its rounds inside ``lax.while_loop`` and
hands each one a fresh key; its round function finds that key in a
table of the call's keys (computed on the host with the same splits)
and returns the matching round, so both loops see the same rounds in
the same order.  After every call the harvested ``rec_*`` buffers and
``rec_count`` must be equal exactly, NaN tails included; so must the
accepted buffers at finalize.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyabc_tpu.sampler.base import RoundResult as JaxRound
from pyabc_tpu.sampler.base import Sample as JaxSample
from pyabc_tpu.sampler.device_loop import \
    build_stateful_loop as jax_build_loop
from pyabc_tpu_torch.sampler.base import RECORD_KEYS, RoundResult, Sample
from pyabc_tpu_torch.sampler.device_loop import (build_stateful_loop,
                                                 harvest_rec)

D, S = 2, 3
FIELDS = ("m", "theta", "distance", "accepted", "log_weight", "stats",
          "valid", "log_proposal")


def _rounds(n_rounds, B, seed, accept_p=0.3, valid_p=0.8):
    """Stacked rounds ``{field: [n_rounds, B, ...]}``: accepted rows are
    valid; some stats rows and some deferred densities are NaN."""
    rng = np.random.default_rng(seed)
    valid = rng.uniform(size=(n_rounds, B)) < valid_p
    accepted = valid & (rng.uniform(size=(n_rounds, B)) < accept_p)
    stats = rng.standard_normal((n_rounds, B, S)).astype(np.float32)
    stats[rng.uniform(size=(n_rounds, B)) < 0.05] = np.nan
    log_prop = rng.standard_normal((n_rounds, B)).astype(np.float32)
    log_prop[1::2] = np.nan
    lw = rng.standard_normal((n_rounds, B)).astype(np.float32)
    return {
        "m": rng.integers(0, 2, (n_rounds, B)).astype(np.int32),
        "theta": rng.standard_normal((n_rounds, B, D)).astype(np.float32),
        "distance": rng.uniform(size=(n_rounds, B)).astype(np.float32),
        "accepted": accepted,
        "log_weight": np.where(accepted, lw, -np.inf).astype(np.float32),
        "stats": stats, "valid": valid, "log_proposal": log_prop,
    }


class _Loops:
    """The same rounds through both packages' loops."""

    def __init__(self, data, B, n_target, max_rounds, record_cap):
        self.data = data
        self.max_rounds = max_rounds
        self.next_round = 0   # the port's replay cursor
        start, self.step, self.finalize, self.reset = build_stateful_loop(
            self._port_round, B, n_target, max_rounds,
            record_cap=record_cap)
        (j_start, self.j_step, self.j_finalize, self.j_harvest,
         self.j_reset, _) = jax_build_loop(
            self._jax_round, B, n_target, max_rounds, record_cap, D, S)
        self.state, self.j_state = start(), j_start()
        self.key = jax.random.PRNGKey(0)

    def _port_round(self, generator, params):
        r = self.next_round
        self.next_round += 1
        return RoundResult(**{
            k: torch.as_tensor(self.data[k][r].astype(np.int64)
                               if k == "m" else self.data[k][r])
            for k in FIELDS})

    @staticmethod
    def _jax_round(sub, params):
        hit = jnp.all(params["keys"] == sub[None, :], axis=1)
        j = jnp.argmax(hit)
        return JaxRound(**{k: params["rounds"][k][j] for k in FIELDS})

    def call(self):
        """One step call in each loop, then one harvest in each."""
        self.key, call_key = jax.random.split(self.key)
        keys, k = [], call_key
        for _ in range(self.max_rounds):
            k, sub = jax.random.split(k)
            keys.append(sub)
        r0 = int(self.j_state["rounds"])
        params = {"keys": jnp.stack(keys), "rounds": {
            f: jnp.asarray(v[r0:r0 + self.max_rounds])
            for f, v in self.data.items()}}
        self.j_state = self.j_step(call_key, params, self.j_state)
        self.state = self.step(None, {}, self.state)
        assert self.state["rounds"] == int(self.j_state["rounds"])
        rec, self.state = harvest_rec(self.state)
        j_rec, self.j_state = self.j_harvest(self.j_state)
        return rec, j_rec


def _assert_records_equal(rec, j_rec):
    assert int(rec["rec_count"]) == int(j_rec["rec_count"])
    for k in RECORD_KEYS:
        got = rec["rec_" + k].numpy()
        ref = np.asarray(j_rec["rec_" + k])
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)   # NaN == NaN here


@pytest.mark.parametrize("B,n_target,max_rounds,record_cap", [
    (16, 40, 2, 32),    # record_cap = B * max_rounds: never overflows
    (16, 40, 3, 20),    # a call's valid rows overflow the cap
    (8, 30, 1, 8),      # one round per call
])
def test_harvests_match_jax(B, n_target, max_rounds, record_cap):
    loops = _Loops(_rounds(40, B, seed=B + record_cap), B, n_target,
                   max_rounds, record_cap)
    calls = 0
    while int(loops.state["count"] or 0) < n_target:
        rec, j_rec = loops.call()
        _assert_records_equal(rec, j_rec)
        calls += 1
    assert calls >= 2
    assert int(loops.state["count"]) == int(loops.j_state["count"])
    view = loops.finalize(loops.state, {})
    _, j_view = loops.j_finalize(loops.j_state, {})
    take = view["m"].shape[0]
    assert take == n_target
    for k in ("m", "theta", "distance", "log_weight", "stats"):
        np.testing.assert_array_equal(view[k].numpy(),
                                      np.asarray(j_view[k])[:take])


def test_reset_refills_with_nan_and_the_next_generation_matches():
    B, n_target = 16, 24
    loops = _Loops(_rounds(30, B, seed=3), B, n_target, 2, 24)
    loops.call()
    # a call whose records stay in the state (no harvest), then reset
    loops.state = loops.step(None, {}, loops.state)
    r0 = int(loops.j_state["rounds"])
    loops.j_state = loops.j_reset(loops.j_state)
    loops.state = loops.reset(loops.state)
    assert int(loops.state["rec_count"]) == int(loops.j_state["rec_count"])
    for k in RECORD_KEYS:
        np.testing.assert_array_equal(loops.state["rec"][k][:-1].numpy(),
                                      np.asarray(loops.j_state["rec_" + k]))
    assert torch.isnan(loops.state["rec"]["stats"]).all()
    # the next generation continues the round sequence in both
    loops.next_round = r0
    loops.data = {k: v[r0:] for k, v in loops.data.items()}
    loops.next_round = 0
    rec, j_rec = loops.call()
    _assert_records_equal(rec, j_rec)


def test_sample_keeps_the_first_max_records_across_calls():
    """Harvests of three calls into a Sample capped below their total:
    the earliest rows are kept, as in the JAX package's Sample."""
    B = 16
    loops = _Loops(_rounds(40, B, seed=9), B, 60, 2, 32)
    sample = Sample(record_rejected=True, max_records=50)
    j_sample = JaxSample(record_rejected=True, max_records=50)
    total = 0
    for _ in range(3):
        rec, j_rec = loops.call()
        total += int(rec["rec_count"])
        sample.append_record_batch(rec)
        j_sample.append_record_batch(j_rec)
    assert total > 50
    assert sample.n_recorded == 50
    got = sample.get_records()
    ref = j_sample.get_records_arrays()
    for k in RECORD_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    np.testing.assert_array_equal(sample.get_all_stats().numpy(),
                                  ref["stats"])


def test_append_round_respects_max_records():
    """tests/test_records.py's cap check on the port's Sample."""
    B = 8
    rr = RoundResult(m=torch.zeros(B, dtype=torch.int64),
                     theta=torch.zeros(B, 1), distance=torch.zeros(B),
                     accepted=torch.ones(B, dtype=torch.bool),
                     log_weight=torch.zeros(B), stats=torch.zeros(B, 1),
                     valid=torch.ones(B, dtype=torch.bool))
    s = Sample(record_rejected=True, max_records=5)
    s.append_round(rr)
    s.append_round(rr)
    assert s.n_recorded == 5
    assert s.get_all_stats().shape == (5, 1)


def test_without_records_the_loop_keeps_none():
    loops = build_stateful_loop(lambda g, p: None, 4, 4, 1)
    assert len(loops) == 4   # (start, step, finalize, reset), as before
    state = loops[0]()
    rec, state = harvest_rec(state)
    assert rec == {"rec_count": 0}
