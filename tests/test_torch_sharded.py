"""Twins of the sharded-sampler cases of ``tests/test_samplers.py`` for
the port, and the port's sharded data plane held to itself and to the
JAX package.

- ``sharded8``: the two-competing-Gaussians problem through
  ``ShardedSampler`` over eight shards in one process (the port's
  counterpart of the JAX CPU rig's eight forced devices) hits the
  analytic model posterior within 0.15 (``tests/test_samplers.py:28``);
- a sharded round has the vectorized round's shapes, and one generator
  state gives the same round (``tests/test_samplers.py:71``);
- ``_round_to_valid_batch`` equals the JAX package's for 1, 2, 6 and 8
  shards over a sweep of targets (exact);
- a one-shard mesh is ``VectorizedSampler`` bit for bit;
- eight shards in one process are bit-identical to two gloo processes
  of four shards each (launched through ``python -m
  pyabc_tpu_torch.parallel.cli``), ``DefaultSampler`` is a
  ``ShardedSampler`` over the two-rank group, and the rounds' gathers
  book ``collective_s``;
- ``RedisEvalParallelSampler`` warns once about its broker arguments.
"""

import json
import os
import socket
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pyabc_tpu_torch.convert import to_torch
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(sampler, pop=600, gens=4, seed=5):
    models, priors, distance, observed, posterior_fn = \
        make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=pop,
                    sampler=sampler, seed=seed)
    abc.new("sqlite://", observed)
    return abc.run(max_nr_populations=gens), posterior_fn


def _populations(h) -> list:
    out = []
    for t in range(h.max_t + 1):
        for m in (0, 1):
            df, w = h.get_distribution(m=m, t=t)
            out.append((df.to_numpy().tolist(), np.asarray(w).tolist()))
    return out


def test_two_competing_gaussians_sharded8():
    h, posterior_fn = _run(pt.ShardedSampler(mesh=make_mesh([CPU] * 8)))
    p_b = float(h.get_model_probabilities(h.max_t).get(1, 0.0))
    assert abs(p_b - posterior_fn(1.0)) < 0.15
    pops = h.get_all_populations()
    assert pops.t.min() == -1
    assert (pops.samples > 0).all()


def test_sharded_matches_vectorized_round_shapes():
    """A sharded round returns the vectorized round's shapes, the batch
    split evenly over the shards, and the same generator state gives the
    same round."""
    from pyabc_tpu_torch.sampler.rounds import RoundKernel
    from pyabc_tpu_torch.sumstat import SumStatSpec

    models, priors, distance, observed, _ = make_two_gaussians_problem()
    x_0 = {k: torch.as_tensor(v, dtype=torch.float32)
           for k, v in observed.items()}
    spec = SumStatSpec.from_example(x_0)
    distance.bind(spec, x_0)
    kern = RoundKernel(
        models=models, parameter_priors=priors,
        model_prior_logits=torch.zeros(2),
        model_perturbation_kernel=pt.ModelPerturbationKernel(2),
        transitions=[pt.MultivariateNormalTransition() for _ in models],
        distance=distance, acceptor=pt.UniformAcceptor(), spec=spec,
        obs_flat=spec.flatten_single(x_0), dim=1)
    params = {"distance": to_torch(distance.get_params(0), CPU),
              "acceptor": {"eps": torch.tensor(1.0)}}
    sh = pt.ShardedSampler(mesh=make_mesh([CPU] * 8))
    fn = sh.round_at(kern.prior_round, 64)

    def draw():
        gen = torch.Generator().manual_seed(3)
        return fn(gen, params)

    rr, rr2 = draw(), draw()
    assert rr.theta.shape == (64, 1)
    assert rr.accepted.shape == (64,)
    assert torch.equal(rr.theta, rr2.theta)


@pytest.mark.parametrize("nd", [1, 2, 6, 8])
def test_round_to_valid_batch_equals_jax(nd):
    kw = dict(min_batch_size=48, max_batch_size=1 << 14)
    ours = pt.ShardedSampler(mesh=make_mesh([CPU] * nd), **kw)
    theirs = jpt.ShardedSampler(mesh=jax_make_mesh(jax.devices()[:nd]),
                                **kw)
    assert ours.n_devices == theirs.n_devices == nd
    assert ours.min_batch_size == theirs.min_batch_size
    targets = [0.5, 1, 3, 7, 47, 48, 49, 100, 255.5, 256, 257, 1000,
               3000, 6144, 6145, 9999, 16384, 20000, 1e6]
    got = [ours._round_to_valid_batch(b) for b in targets]
    want = [theirs._round_to_valid_batch(b) for b in targets]
    assert got == want
    assert all(B % nd == 0 for B in got)


def test_one_shard_mesh_is_vectorized_bit_for_bit():
    h_v, _ = _run(pt.VectorizedSampler(device="cpu"), pop=300, gens=3)
    h_s, _ = _run(pt.ShardedSampler(mesh=make_mesh([CPU])), pop=300,
                  gens=3)
    assert _populations(h_v) == _populations(h_s)


TWO_RANKS = """
import json, os
import torch
import pyabc_tpu_torch as pt
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.parallel.mesh import make_mesh, world

models, priors, distance, observed, _ = make_two_gaussians_problem()
abc = pt.ABCSMC(models, priors, distance, population_size=128, seed=17,
                sampler=pt.ShardedSampler(
                    mesh=make_mesh([torch.device("cpu")] * 4)))
abc.new("sqlite://", observed)
from pyabc_tpu_torch.wire import transfer
c0 = transfer.snapshot()["collective_s"]
h = abc.run(max_nr_populations=3)
collective_s = transfer.snapshot()["collective_s"] - c0
pops = []
for t in range(h.max_t + 1):
    for m in (0, 1):
        df, w = h.get_distribution(m=m, t=t)
        pops.append((df.to_numpy().tolist(), w.tolist()))
default = pt.DefaultSampler(device="cpu")
rank = world()[0]
with open(os.environ["OUT"], "w") as f:
    json.dump({"rank": rank, "world": world()[1],
               "n_devices": abc.sampler.n_devices, "pops": pops,
               "default": type(default).__name__,
               "default_shards": default.n_devices,
               "collective_s": collective_s}, f)
"""


def test_eight_shards_equal_two_gloo_ranks_of_four(tmp_path):
    script = tmp_path / "two_ranks.py"
    script.write_text(TWO_RANKS)
    port = _free_port()
    procs = []
    for i in range(2):
        env = dict(os.environ, PYTHONPATH=REPO,
                   OUT=str(tmp_path / f"out_{i}.json"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pyabc_tpu_torch.parallel.cli",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(i), str(script)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    # the one-process reference runs meanwhile
    h, _ = _run(pt.ShardedSampler(mesh=make_mesh([CPU] * 8)), pop=128,
                gens=3, seed=17)
    ref = json.loads(json.dumps(_populations(h)))
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
    infos = [json.loads((tmp_path / f"out_{i}.json").read_text())
             for i in range(2)]
    for i, info in enumerate(infos):
        assert (info["rank"], info["world"], info["n_devices"]) == (i, 2, 8)
        assert info["default"] == "ShardedSampler"
        assert info["default_shards"] == 2
        # every sharded round joined both ranks' rows
        assert info["collective_s"] > 0
    assert infos[0]["pops"] == infos[1]["pops"] == ref


def test_mesh_helpers_on_one_rank():
    """The mesh's JAX-named helpers in a one-rank world: every shard is
    this rank's, so its slice is every row; logical axes resolve through
    ``LOGICAL_AXIS_RULES``."""
    from pyabc_tpu_torch.parallel import mesh as pm
    m = pm.make_mesh([CPU] * 4)
    assert (m.size, m.world_size, m.local_shards) == (4, 1, [0, 1, 2, 3])
    assert pm.host_shard_slice(m, 10) == slice(0, 10)
    assert pm.host_shard_slice(None, 10) == slice(0, 10)
    assert pm.logical_sharding(m, "particles", "params").spec == (
        pm.PARTICLE_AXIS, None)
    assert pm.particle_sharding(m).spec == (pm.PARTICLE_AXIS,)
    assert pm.replicated(m).spec == ()
    hybrid = pm.make_hybrid_mesh(devices=[CPU] * 2)
    assert hybrid.shape == {pm.DCN_AXIS: 1, pm.ICI_AXIS: 2}
    hybrid = pm.make_hybrid_mesh(devices=[CPU])
    assert hybrid.shape == {pm.DCN_AXIS: 1, pm.ICI_AXIS: 1}
    assert pm.per_device_hbm_bytes() == 0  # the CPU reports none
    with pytest.raises(ValueError):
        pm.Mesh([CPU, torch.device("meta")], [0, 0])  # two devices


@pytest.mark.parametrize("make", [
    "default_device", "make_mesh", "make_pod_mesh", "make_hybrid_mesh",
    "ShardedSampler", "RedisEvalParallelSampler"])
def test_no_card_raises_without_an_explicit_cpu(make, monkeypatch):
    """Without a card the mesh and both scale-out samplers raise, as
    every entry point of the port does (``device.resolve_device``): the
    CPU is used only when it is asked for."""
    from pyabc_tpu_torch.parallel import mesh as pm
    from pyabc_tpu_torch.sampler import sharded
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = getattr(pm, make, None) or getattr(sharded, make)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn()


def test_deterministic_kernels_raise_where_none_exists():
    """Inside ``deterministic_kernels`` an op without a deterministic
    form raises instead of warning, and the caller's settings come back
    after the block."""
    from pyabc_tpu_torch.parallel.mesh import deterministic_kernels
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    with deterministic_kernels():
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.is_deterministic_algorithms_warn_only_enabled()
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled()) == before


@pytest.mark.parametrize("count,rate", [(0, 0.3), (90, 0.3), (40, 0.0),
                                        (10, 1.0)])
def test_gather_form_keeps_the_scatters_rows(count, rate):
    """The accepted-row write that multi-rank runs take on the card
    (``device_loop._gather_accepted``: one row per index) leaves every
    buffer row but the dump row as the scatter does, past the cap
    included (the round starts below its target: ``count < n_target``,
    ``cap = n_target + B``)."""
    from pyabc_tpu_torch.sampler import device_loop
    rng = np.random.default_rng(count)
    n_target, B = 100, 64
    cap = n_target + B
    acc = torch.from_numpy(rng.uniform(size=B) < rate)
    rows = {"theta": torch.from_numpy(rng.normal(size=(B, 3))).float(),
            "m": torch.from_numpy(rng.integers(0, 4, size=B))}
    out = []
    for write in (device_loop._gather_accepted, device_loop.append_accepted):
        bufs = {"theta": torch.full((cap + 1, 3), -7.0),
                "m": torch.full((cap + 1,), -1)}
        write([(bufs[k], rows[k]) for k in bufs], acc,
              torch.tensor(count), cap)
        out.append(bufs)
    for k in out[0]:
        assert torch.equal(out[0][k][:cap], out[1][k][:cap])
    n = int(acc.sum())
    assert torch.equal(out[0]["m"][count:count + n], rows["m"][acc])


def test_redis_sampler_warns_once(monkeypatch):
    from pyabc_tpu_torch.sampler.sharded import RedisEvalParallelSampler
    monkeypatch.setattr(RedisEvalParallelSampler,
                        "_warned_ignored_kwargs", False)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        s = RedisEvalParallelSampler(host="broker", port=6379,
                                     batch_size=512, device="cpu")
        RedisEvalParallelSampler(password="x", device="cpu")
    msgs = [str(w.message) for w in seen
            if issubclass(w.category, UserWarning)
            and "RedisEvalParallelSampler" in str(w.message)]
    assert len(msgs) == 1 and "host, port" in msgs[0]
    assert s.min_batch_size == 512
    assert isinstance(s, pt.ShardedSampler)


def test_screened_fused_run_over_two_shards():
    """The staged (screened) round split over two shards: each shard
    screens and simulates its own slots; the run's device generations
    are screened ones and it stays fused."""
    from pyabc_tpu_torch.models.sir import SIRTauLeap

    model = SIRTauLeap(n_steps=40, n_obs=8)
    g = torch.Generator().manual_seed(11)
    obs = model.simulate(g, torch.log(torch.tensor([[0.8, 0.2]])))
    observed = {k: v[0].numpy() for k, v in obs.items()}
    prior = pt.Distribution(log_beta=pt.RV("uniform", -2.0, 3.0),
                            log_gamma=pt.RV("uniform", -3.0, 3.0))
    abc = pt.ABCSMC([model], [prior], pt.PNormDistance(p=2),
                    population_size=200, fuse_generations=3,
                    fidelity="screen", seed=0,
                    sampler=pt.ShardedSampler(mesh=make_mesh([CPU] * 2)))
    abc.new("sqlite://", observed)
    h = abc.run(max_nr_populations=4)
    assert h.max_t == 3
    device_rows = [r for r in abc.timeline if r["path"] != "sequential"]
    assert device_rows and all(r["sims_low"] > 0 for r in device_rows)
    assert all(r["sims_full"] <= r["sims_low"] for r in device_rows)
