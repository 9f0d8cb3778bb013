"""The compiled round on the card: CUDA-graph capture of the sampler's
round and of the AOT surface, against the eager calls.

Marked ``cuda``: without a card every test here skips.  The file imports
neither JAX nor the JAX package, so it runs on the machine with the card
(which has no JAX), from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_graph_cuda.py

Equalities are bit for bit: a replay runs the eager round's kernels on
the same inputs and draws from the same generator state.
"""

import math

import pytest
import torch

import pyabc_tpu_torch as pt
from pyabc_tpu_torch.autotune import (CompiledLadder, aot_compile, aval_of,
                                      jit_compile)
from pyabc_tpu_torch.convert import to_torch
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.sampler.device_loop import RoundProgram
from pyabc_tpu_torch.telemetry.metrics import REGISTRY

pytestmark = pytest.mark.cuda

FIELDS = ("m", "theta", "distance", "accepted", "log_weight", "stats",
          "valid", "log_proposal")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (see the module docstring)")
    return torch.device("cuda")


def _count(name: str) -> float:
    c = REGISTRY.get(name)
    return c.value if c else 0.0


def _bits(a: torch.Tensor) -> torch.Tensor:
    if a.is_floating_point():
        return a.contiguous().view(torch.int32)
    return a


def _same(a, b) -> bool:
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _abc(pop=2000, simulate=None):
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    if simulate is not None:
        models[0].simulate = simulate(models[0].simulate)
    abc = pt.ABCSMC(models, priors, distance, population_size=pop,
                    eps=pt.MedianEpsilon(),
                    sampler=pt.VectorizedSampler(min_batch_size=8192,
                                                 max_batch_size=8192,
                                                 device="cuda"),
                    stores_sum_stats=False, seed=1, history_mode="eager",
                    device="cuda")
    abc.new("sqlite://", observed)
    return abc


def _recorded(abc):
    """Run 2 generations; the last generation round's (round_fn, params,
    n, B)."""
    samp = abc.sampler
    sample = samp.sample_until_n_accepted
    rec = {}

    def recording(n, round_fn, generator, params, *args, **kw):
        out = sample(n, round_fn, generator, params, *args, **kw)
        if getattr(round_fn, "__name__", "") == "generation_round":
            rec.update(round_fn=round_fn, params=params, n=n,
                       B=samp.last_batch)
        return out

    samp.sample_until_n_accepted = recording
    abc.run(max_nr_populations=2)
    del samp.sample_until_n_accepted
    return rec


def test_captured_round_equals_the_eager_round(dev):
    abc = _abc()
    rec = _recorded(abc)
    assert all(r["round_graph"] for r in abc.timeline)
    B, n = rec["B"], rec["n"]
    raw = abc.sampler.raw_round(rec["round_fn"], B)
    params = to_torch(rec["params"], dev)
    ladder = CompiledLadder()
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    gen_e = torch.Generator(device=dev)
    gen_e.set_state(gen.get_state())
    graph = RoundProgram(raw, B, n, graphs=True, pool=ladder.graph_pool)
    eager = RoundProgram(raw, B, n, graphs=False)
    for _ in range(4):   # the first eagerly, then 3 replays
        out_g, out_e = graph.run(gen, params), eager.run(gen_e, params)
        for k in FIELDS:
            assert _same(getattr(out_g, k), getattr(out_e, k)), k
        # the dump row takes dropped writes in no set order
        for k, v in eager.state["bufs"].items():
            assert _same(graph.state["bufs"][k][:-1], v[:-1]), k
        assert int(graph.state["count"]) == int(eager.state["count"])
        assert torch.equal(gen.get_state(), gen_e.get_state())
    assert graph.route == "graph" and graph.replays == 3
    assert ladder.pool_bytes()["reserved"] > 0


def test_replay_advances_the_generator_as_the_eager_call(dev):
    def fn(g, x):
        return x + torch.randn(x.shape, generator=g, device=x.device)

    x = torch.zeros(1 << 16, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    ref = torch.Generator(device=dev)
    ref.set_state(gen.get_state())
    jf = jit_compile(fn)
    for _ in range(3):
        assert _same(jf(gen, x), fn(ref, x))
        assert torch.equal(gen.get_state(), ref.get_state())
    assert jf.graphs == 1
    # the state put back (a retry) replays the same draws
    saved = gen.get_state()
    first = jf(gen, x).clone()
    gen.set_state(saved)
    assert _same(jf(gen, x), first)


def test_guard_recaptures_on_drift(dev):
    def fn(x):
        return torch.cumsum(x * 3.0, 0)

    a = torch.randn(1024, device=dev)
    b = torch.randn(2048, device=dev)
    guard = aot_compile(jit_compile(fn), aval_of(a))
    assert guard.captured
    miss0 = _count("autotune_aot_signature_misses_total")
    builds0 = _count("xla_compiles_total")
    assert _same(guard(a), fn(a))
    assert _same(guard(b).clone(), fn(b))
    assert _count("autotune_aot_signature_misses_total") == miss0 + 1
    assert _count("xla_compiles_total") == builds0 + 1   # the fallback's
    guard.specialize(b)
    assert _same(guard(b), fn(b))
    assert _count("autotune_aot_signature_misses_total") == miss0 + 1


def test_refused_capture_is_counted_and_recorded(dev):
    """A simulator that reads the card from the host cannot be captured:
    the refusal is counted, the rounds run eagerly, the timeline says so,
    and the run's generator is untouched by the failed capture."""
    def host_read(simulate):
        def simulate_and_read(generator, theta):
            float(theta.sum())   # a host read: refused in a capture
            return simulate(generator, theta)
        return simulate_and_read

    errors0 = _count("autotune_aot_errors_total")
    abc = _abc(simulate=host_read)
    h = abc.run(max_nr_populations=2)
    assert h.max_t == 1
    assert _count("autotune_aot_errors_total") > errors0
    assert not any(r["round_graph"] for r in abc.timeline)

    # the same run with the host read but no capture tried: same rows
    plain = _abc(simulate=host_read)
    plain.sampler.round_graphs = False
    h2 = plain.run(max_nr_populations=2)
    for t in range(2):
        a, b = h.get_distribution(m=0, t=t), h2.get_distribution(m=0, t=t)
        assert a[0].equals(b[0]) and (a[1] == b[1]).all()


def test_a_round_that_takes_a_length_is_captured(dev):
    """``len`` of a tensor on the card reads its shape, not the card: the
    pre-screen lets it through and the round replays."""
    from pyabc_tpu_torch.autotune.ladder import _host_work

    x = torch.ones(5, device=dev)
    assert _host_work(torch.Tensor.__len__, (x,), {}) is None

    def with_len(simulate):
        def simulate_sized(generator, theta):
            assert len(theta) == theta.shape[0]
            return simulate(generator, theta)
        return simulate_sized

    errors0 = _count("autotune_aot_errors_total")
    abc = _abc(simulate=with_len)
    abc.run(max_nr_populations=2)
    assert _count("autotune_aot_errors_total") == errors0
    assert all(r["round_graph"] for r in abc.timeline)


def test_captured_finalize_counts_its_k1_launches(dev):
    from pyabc_tpu_torch.ops.kde_cuda import weighted_kde_logpdf_cuda

    abc = _abc()
    g0 = weighted_kde_logpdf_cuda.graph_launches
    abc.run(max_nr_populations=3)
    rows = abc.timeline
    # generations 1 and 2 finalize at n through the captured graph: one
    # K1 launch per model, each counted at its replay
    assert weighted_kde_logpdf_cuda.graph_launches - g0 == 2 * 2
    assert all(r["kde_launches"] == 2 for r in rows if r["t"] >= 1)
    assert not math.isnan(abc.history.get_all_populations().epsilon.iloc[-1])


def test_captures_that_fail_are_refused_and_the_pool_lives_on(dev):
    """Calls the pre-screen cannot see fail in the capture itself.  A new
    generator fails before the card sees anything: the capture ends
    cleanly and the pool stays.  A device synchronize invalidates the
    capture, which leaves the allocator recording into the pool: the pool
    is retired (kept alive) and the ladder's next capture goes into a
    fresh one.  Both count as refusals; the card goes on working."""
    from pyabc_tpu_torch.autotune import CaptureRefused

    ladder = CompiledLadder()
    x = torch.randn(4096, device=dev)

    def new_generator(x):
        g = torch.Generator(device=x.device)
        return x + torch.rand(x.shape, generator=g, device=x.device)

    def synchronize(x):
        torch.cuda.synchronize()
        return x * 2.0

    first = ladder.graph_pool()
    errors0 = _count("autotune_aot_errors_total")
    with pytest.raises(CaptureRefused):
        jit_compile(new_generator, pool=ladder.graph_pool)(x)
    assert ladder.graph_pool() == first
    with pytest.raises(CaptureRefused):
        jit_compile(synchronize, pool=ladder.graph_pool)(x)
    assert _count("autotune_aot_errors_total") == errors0 + 2
    assert ladder.graph_pool() != first
    jf = jit_compile(lambda x: torch.cumsum(x, 0), pool=ladder.graph_pool)
    assert _same(jf(x), torch.cumsum(x, 0)) and jf.graphs == 1
    assert torch.isfinite(torch.rand(8, device=dev)).all()
