"""The port's ahead-of-time surface and the in-place rejection loop, on
the CPU.

``aval_of`` / ``avals_like`` against the JAX package's on the same numpy
arrays; ``aot_compile`` / ``AotGuard`` as ``tests/test_autotune.py``'s
guard test holds the JAX package's (the result on a drifted shape, one
counted miss); ``jit_compile`` on CPU tensors is the function.  On the
CPU nothing is captured: the guard and the wrapper call the function,
and the loop's program (``device_loop.RoundProgram``) takes the same
in-place path through them that a card replays.  The loop's populations
and records equal, bit for bit, the round function called in a plain
Python loop on the same generator; a retry after a failed attempt puts
the accept cursor back by value and gives the same rows.
"""

import math

import numpy as np
import pytest
import torch
import torch.utils._pytree as torch_pytree

import jax
from pyabc_tpu.autotune import ladder as jax_ladder

from pyabc_tpu_torch.autotune import (AotGuard, TensorSpec, aot_compile,
                                      aval_of, avals_like, jit_compile)
from pyabc_tpu_torch.resilience.retry import RetryPolicy
from pyabc_tpu_torch.sampler import VectorizedSampler
from pyabc_tpu_torch.sampler.base import RECORD_KEYS, RoundResult
from pyabc_tpu_torch.sampler.device_loop import (RoundProgram,
                                                 build_stateful_loop,
                                                 harvest_rec)
from pyabc_tpu_torch.telemetry.metrics import REGISTRY

D, S = 2, 3


def _misses() -> float:
    c = REGISTRY.get("autotune_aot_signature_misses_total")
    return c.value if c else 0.0


def _tree():
    rng = np.random.default_rng(7)
    return {"a": rng.normal(size=(3, 2)),
            "b": (np.arange(4, dtype=np.int64),
                  np.zeros((), dtype=np.bool_)),
            "c": {"d": rng.normal(size=(5,)).astype(np.float32),
                  "e": np.ones((2, 1, 3), np.int32)}}


def _spec(leaf):
    return tuple(leaf.shape), np.dtype(leaf.dtype).name


def _port_spec(leaf):
    return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")


@pytest.mark.parametrize("as_tensors", [False, True])
def test_avals_like_matches_the_jax_package(as_tensors):
    tree = _tree()
    ours_in = (torch_pytree.tree_map(torch.as_tensor, tree) if as_tensors
               else tree)
    ref = jax_ladder.avals_like(tree)
    ours = avals_like(ours_in)
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
    our_leaves, our_def = torch_pytree.tree_flatten(ours)
    assert all(isinstance(x, TensorSpec) for x in our_leaves)
    assert [_port_spec(x) for x in our_leaves] == \
        [_spec(x) for x in ref_leaves]
    # the same nesting: dict keys and tuple arities, leaf for leaf
    assert ref_def.num_leaves == our_def.num_leaves
    assert jax.tree_util.tree_structure(
        torch_pytree.tree_unflatten([0] * our_def.num_leaves, our_def)) \
        == ref_def
    # spec leaves pass through, as ShapeDtypeStruct leaves do
    assert avals_like(ours) == ours
    assert jax_ladder.avals_like(ref) == ref


def test_aval_of_matches_the_jax_package_per_leaf():
    for x in (np.zeros((4, 3), np.float32), np.arange(5),
              np.array(2.5), np.ones((1,), np.bool_)):
        ref = jax_ladder.aval_of(x)
        assert _port_spec(aval_of(x)) == _spec(ref)
        assert aval_of(torch.as_tensor(x)) == aval_of(x)
    assert aval_of(aval_of(np.ones(2))) == aval_of(np.ones(2))
    assert aval_of(np.ones(2)).device == torch.device("cpu")


def test_aot_guard_serves_compiled_and_falls_back_on_drift():
    """``tests/test_autotune.py``'s guard test in the port."""
    fn = jit_compile(lambda x: x * 2.0)
    x = torch.ones(4)
    guard = aot_compile(fn, aval_of(x))
    assert isinstance(guard, AotGuard) and not guard.captured
    np.testing.assert_allclose(guard(x).numpy(), 2.0 * np.ones(4))
    miss0 = _misses()
    y = torch.ones(6)  # a pad bucket grew: the spec drifts
    np.testing.assert_allclose(guard(y).numpy(), 2.0 * np.ones(6))
    assert _misses() == miss0 + 1
    # back at the captured spec: no miss
    guard(torch.zeros(4))
    assert _misses() == miss0 + 1


def test_guard_specialize_and_static_leaves():
    calls = []

    def fn(x, scale, gen):
        calls.append(scale)
        return x * scale + torch.rand(x.shape, generator=gen)

    gen = torch.Generator()
    gen.manual_seed(3)
    guard = aot_compile(jit_compile(fn), aval_of(torch.ones(3)), 2.0, gen)
    miss0 = _misses()
    ref_gen = torch.Generator()
    ref_gen.set_state(gen.get_state())
    out = guard(torch.ones(3), 2.0, gen)
    torch.testing.assert_close(out, fn(torch.ones(3), 2.0, ref_gen),
                               rtol=0, atol=0)
    assert torch.equal(gen.get_state(), ref_gen.get_state())
    # a Python leaf is part of the spec: another value is a miss
    guard(torch.ones(3), 3.0, gen)
    assert _misses() == miss0 + 1
    guard.specialize(torch.ones(5), 3.0, gen)
    guard(torch.ones(5), 3.0, gen)
    assert _misses() == miss0 + 1
    assert guard.inputs[0].shape == (5,)


def test_jit_compile_on_cpu_tensors_is_the_function():
    def fn(x, params):
        return torch.cumsum(x, 0) * params["w"] + params["b"][0]

    jf = jit_compile(fn, donate_argnums=(0,))
    x = torch.arange(10, dtype=torch.float32)
    p = {"w": torch.tensor(0.5), "b": (torch.tensor(1.0),)}
    assert torch.equal(jf(x, p), fn(x, p))
    assert jf.graphs == 0   # nothing captured off the card

    @jit_compile
    def g(a):
        return a + 1

    assert torch.equal(g(x), x + 1)


# ---------------------------------------------------------------- the loop

def _round_fn(p_accept=0.4, fail_at=None):
    """A round of B candidates drawn from the generator (model, theta,
    distance, acceptance, stats), ``fail_at``: the calls that raise a
    CUDA out-of-memory error (transient) after drawing."""
    calls = {"n": 0}

    def round_fn(generator, params, B):
        calls["n"] += 1
        theta = torch.randn(B, D, generator=generator)
        u = torch.rand(B, generator=generator)
        stats = torch.randn(B, S, generator=generator)
        if fail_at is not None and calls["n"] in fail_at:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        acc = u < p_accept
        valid = u < 0.9
        m = (u * 2).to(torch.int64) % 2
        return RoundResult(m=m, theta=theta, distance=u, accepted=acc,
                           log_weight=torch.where(acc, -u, -math.inf),
                           stats=stats, valid=valid,
                           log_proposal=theta[:, 0])

    round_fn.calls = calls
    return round_fn


def _reference(round_fn, B, n, max_rounds, record_cap, seed, calls):
    """The round function in a plain Python loop: accepted rows in
    (round, lane) order up to ``n``, and each call's valid rows up to
    ``record_cap``."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    acc_rows, records, count = [], [], 0
    for _ in range(calls):
        call_rec = []
        for _ in range(max_rounds):
            if count >= n:
                break
            rr = round_fn(gen, {}, B)
            sel = rr.accepted
            acc_rows.append({k: getattr(rr, k)[sel]
                             for k in ("m", "theta", "distance",
                                       "log_weight", "stats")})
            count += int(sel.sum())
            call_rec.append({k: getattr(rr, k)[rr.valid]
                             for k in RECORD_KEYS})
        records.append({k: torch.cat([r[k] for r in call_rec])[:record_cap]
                        for k in RECORD_KEYS} if call_rec else None)
    pop = {k: torch.cat([r[k] for r in acc_rows])[:n] for k in acc_rows[0]}
    return pop, records


def _bits(a: torch.Tensor) -> torch.Tensor:
    return a.view(torch.int32) if a.dtype == torch.float32 else a


@pytest.mark.parametrize("graphs", [False, True])
def test_in_place_loop_equals_the_plain_loop(graphs):
    """``graphs=True`` on the CPU takes the card's route through
    ``aot_compile`` (the program's buffers are the guard's own, the
    refill its second program) with the function called in place of a
    replay."""
    B, n, max_rounds, record_cap, seed = 32, 50, 2, 40, 11
    round_fn = _round_fn()
    loop = build_stateful_loop(lambda g, p: round_fn(g, p, B), B, n,
                               max_rounds, record_cap=record_cap,
                               graphs=graphs)
    start, step, finalize, reset = loop
    gen = torch.Generator()
    gen.manual_seed(seed)
    state = start()
    recs = []
    for _ in range(3):
        state = step(gen, {}, state)
        rec, state = harvest_rec(state)
        recs.append(rec)
    assert loop.program.route == "graph" if graphs else "eager"
    view = finalize(state, {})
    pop, ref_recs = _reference(round_fn, B, n, max_rounds, record_cap,
                               seed, 3)
    for k, v in pop.items():
        assert torch.equal(_bits(view[k]), _bits(v)), k
    for rec, ref in zip(recs, ref_recs):
        if ref is None:
            assert int(rec["rec_count"]) == 0
            continue
        rc = int(rec["rec_count"])
        assert rc == ref["m"].shape[0]
        for k in RECORD_KEYS:
            got = rec["rec_" + k]
            assert torch.equal(_bits(got[:rc]), _bits(ref[k])), k
            if got.is_floating_point():
                assert torch.isnan(got[rc:]).all()
    # a reset rewinds in place: the same tensors, emptied
    bufs = {k: v for k, v in state["bufs"].items()}
    state = reset(state)
    assert int(state["count"]) == 0 and state["rounds"] == 0
    assert all(state["bufs"][k] is v for k, v in bufs.items())
    assert torch.isnan(state["bufs"]["distance"]).all()


def test_round_program_routes_agree_on_the_staged_shape():
    """The staged round's ``(RoundResult, pairs)``: the survivor count
    folds in place on both routes."""
    B = 16
    base = _round_fn(0.5)

    def staged(gen, params):
        rr = base(gen, params, B)
        return rr, (rr.distance, rr.distance, rr.valid.sum()[None])

    outs = []
    for graphs in (False, True):
        gen = torch.Generator()
        gen.manual_seed(5)
        prog = RoundProgram(staged, B, 20, staged=True, graphs=graphs)
        for _ in range(3):
            prog.run(gen, {})
        outs.append(prog)
    a, b = outs
    assert int(a.state["npass"]) == int(b.state["npass"]) > 0
    for k in a.state["bufs"]:
        assert torch.equal(_bits(a.state["bufs"][k][:-1]),
                           _bits(b.state["bufs"][k][:-1]))
    b.reset()
    assert int(b.state["npass"]) == 0 and int(b.state["count"]) == 0


def _sample(fail_at=None, record=False):
    round_fn = _round_fn(fail_at=fail_at)
    samp = VectorizedSampler(min_batch_size=64, max_batch_size=64,
                             max_rounds_per_call=4, device="cpu")
    samp._retry = RetryPolicy(max_attempts=3, base_delay_s=0.0)
    samp.record_rejected = record
    gen = torch.Generator()
    gen.manual_seed(2)
    sample = samp.sample_until_n_accepted(150, round_fn, gen, {})
    return sample, round_fn, gen


@pytest.mark.parametrize("record", [False, True])
def test_retry_restores_the_cursor_by_value(record):
    """The generation's second dispatch (rounds 5-8) fails on round 6,
    after round 5 wrote its rows and advanced the counts in place; it is
    retried from the cursor it started at: the same draws and the same
    rows as a run with no failure.  A cursor holding the count tensors
    themselves would "restore" the advanced counts, and the retry would
    append round 5's rows a second time."""
    clean, clean_fn, clean_gen = _sample(record=record)
    faulty, faulty_fn, faulty_gen = _sample(fail_at={6}, record=record)
    assert clean_fn.calls["n"] > 6
    assert faulty_fn.calls["n"] == clean_fn.calls["n"] + 2
    assert faulty.nr_evaluations == clean.nr_evaluations
    a = clean.get_accepted_population(150)
    b = faulty.get_accepted_population(150)
    for k in ("m", "theta", "weight", "distance"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert torch.equal(clean_gen.get_state(), faulty_gen.get_state())
    if record:
        ra, rb = clean.get_records(), faulty.get_records()
        for k in RECORD_KEYS:
            assert torch.equal(_bits(ra[k]), _bits(rb[k])), k


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card (the screen reads only
    ``is_cuda``)."""

    is_cuda = True


def test_the_capture_pre_screen_names_host_work():
    """The calls a CUDA graph cannot hold, as the pre-screen reads them
    (reads of the card need a CUDA tensor: on the CPU only the copies and
    the reported work show)."""
    from pyabc_tpu_torch.autotune import CaptureRefused, check_capturable
    from pyabc_tpu_torch.autotune.ladder import _host_work
    from pyabc_tpu_torch.transition.base import sub_generators

    x = torch.ones(3)
    # a tensor the screen takes for one on the card: its length is host
    # metadata, its value is not
    on_card = x.as_subclass(_OnCard)
    assert _host_work(torch.Tensor.__len__, (on_card,), {}) is None
    assert "reads the card" in _host_work(torch.Tensor.item, (on_card,), {})
    assert "copies" in _host_work(torch.Tensor.to, (x, "cuda"), {})
    assert "copies" in _host_work(torch.Tensor.to, (x,),
                                  {"device": torch.device("cuda")})
    assert "copies" in _host_work(torch.as_tensor, ([1.0],),
                                  {"device": "cuda"})
    assert _host_work(torch.Tensor.to, (x, torch.float64), {}) is None
    assert _host_work(torch.Tensor.copy_, (x, x), {}) is None
    assert _host_work(torch.Tensor.__bool__, (x[:1] > 0,), {}) is None
    # the port's own report: new generators from the host state
    errors0 = REGISTRY.counter("autotune_aot_errors_total").value
    gen = torch.Generator()
    gen.manual_seed(1)
    with pytest.raises(CaptureRefused, match="sub_generators"):
        check_capturable(sub_generators, gen, 2)
    assert REGISTRY.counter("autotune_aot_errors_total").value == errors0 + 1
    assert check_capturable(lambda a: a * 2, x).sum() == 6


def test_a_report_marks_only_its_own_threads_screen():
    """Another thread's uncapturable work (the host samplers' threads,
    the serve lanes) leaves a screen on this thread alone; the same work
    on this thread refuses it."""
    import threading

    from pyabc_tpu_torch.autotune.ladder import screened_call
    from pyabc_tpu_torch.transition.base import sub_generators

    gen = torch.Generator()
    gen.manual_seed(3)
    done = threading.Event()

    def other():
        sub_generators(torch.Generator(), 2)
        done.set()

    def screened(a):
        worker = threading.Thread(target=other)
        worker.start()
        worker.join()
        return a + 1

    out, refusal = screened_call(screened, torch.ones(2))
    assert done.is_set() and refusal is None
    assert torch.equal(out, torch.full((2,), 2.0))
    _, refusal = screened_call(sub_generators, gen, 2)
    assert refusal is not None and "sub_generators" in str(refusal)
    # nested screens: the inner one's report reaches the outer one too
    _, refusal = screened_call(
        lambda: screened_call(sub_generators, gen, 2)[0])
    assert refusal is not None


def test_the_sampler_keeps_at_most_max_loops_loops():
    """Each rung's loop holds its buffers and graphs: the ladder keeps
    the ``MAX_LOOPS`` most recent, and evicts older ones as the LRU
    does."""
    from pyabc_tpu_torch.autotune import CompiledLadder
    from pyabc_tpu_torch.sampler import vectorized

    round_fn = _round_fn()
    samp = VectorizedSampler(max_rounds_per_call=4, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(4)
    rungs = [16 << i for i in range(vectorized.MAX_LOOPS + 2)]
    for B in rungs:
        samp.min_batch_size = samp.max_batch_size = B
        samp.sample_until_n_accepted(20, round_fn, gen, {})
    kept = [k for k in samp._ladder.keys() if k[0] == "sloop"]
    assert [k[2] for k in kept] == rungs[-vectorized.MAX_LOOPS:]
    assert samp._ladder.summary()["evictions"] == 2

    ladder = CompiledLadder(capacity=8)
    for k in ("a1", "b1", "a2", "a3"):
        ladder.get(k, lambda: k)
    ladder.retain(lambda k: k.startswith("a"), 1)
    assert ladder.keys() == ["b1", "a3"]
