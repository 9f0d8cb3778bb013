"""Twins of ``tests/test_distributed_cluster.py`` for the port: a real
multi-process group formed through the port's worker CLI (``python -m
pyabc_tpu_torch.parallel.cli``) over gloo on the CPU.

Each worker joins the group at the coordinator, heartbeats into the
shared run dir, runs its script and exits; a crashing worker leaves a
stale heartbeat.  ``test_multihost_abcsmc`` runs a whole ABCSMC across
two ranks: the default sampler is a ``ShardedSampler`` over both ranks,
every rank computes the same model probabilities bit for bit, and the
stochastic triple (``Temperature``, ``StochasticAcceptor``, a kernel)
gives both ranks the same temperatures and posterior.  The workers'
children import no JAX.
"""

import json
import os
import socket
import subprocess
import sys
import time

from pyabc_tpu_torch.parallel import health

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=REPO, **(env_extra or {}))
    return subprocess.Popen(
        [sys.executable, "-m", "pyabc_tpu_torch.parallel.cli", *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(procs, timeout):
    try:
        return [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


WORKER_SCRIPT = """
import json, os, time
from pyabc_tpu_torch.parallel.mesh import world
rank, size = world()
with open(os.environ["CLUSTER_TEST_OUT"], "w") as f:
    json.dump({"process_index": rank, "process_count": size}, f)
time.sleep(3)  # stay up long enough for the manager-side liveness check
"""


def test_worker_cli_forms_real_cluster(tmp_path):
    n = 2
    port = _free_port()
    run_dir = str(tmp_path / "run")
    script = tmp_path / "prog.py"
    script.write_text(WORKER_SCRIPT)
    procs = [_worker(["--coordinator", f"127.0.0.1:{port}",
                      "--num-processes", str(n), "--process-id", str(i),
                      "--run-dir", run_dir, str(script)],
                     {"CLUSTER_TEST_OUT": str(tmp_path / f"out_{i}.json")})
             for i in range(n)]
    # while both run, heartbeats must appear
    deadline = time.monotonic() + 90
    seen_two = False
    while time.monotonic() < deadline:
        if all(p.poll() is not None for p in procs):
            break
        if len(health.worker_status(run_dir)) >= n:
            seen_two = True
        time.sleep(0.2)
    outs = _finish(procs, 60)
    for p, (_, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    # every worker saw the same group through a real coordinator
    for i in range(n):
        with open(tmp_path / f"out_{i}.json") as f:
            assert json.load(f) == {"process_index": i, "process_count": n}
    assert seen_two, "heartbeats never showed both workers alive"
    # clean exits deregistered the heartbeats
    assert health.worker_status(run_dir) == []


def test_worker_cli_crash_leaves_stale_heartbeat(tmp_path):
    """A worker that dies mid-script stays visible as STALE."""
    port = _free_port()
    run_dir = str(tmp_path / "run")
    script = tmp_path / "bad.py"
    script.write_text("raise RuntimeError('worker crashed')\n")
    p = _worker(["--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", "1", "--process-id", "0",
                 "--run-dir", run_dir, str(script)])
    (_, se), = _finish([p], 90)
    assert p.returncode != 0
    status = health.worker_status(run_dir, stale_after_s=1e9)
    assert len(status) == 1, se.decode()[-2000:]


ABC_PROGRAM = """
import json, os
import torch
import pyabc_tpu_torch as pt
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.parallel.mesh import world

models, priors, distance, observed, _ = make_two_gaussians_problem()
# the same seed on every rank: every rank runs the same program
abc = pt.ABCSMC(models, priors, distance, population_size=128, seed=17,
                device="cpu")
abc.new("sqlite://", observed)
h = abc.run(max_nr_populations=2)
probs = h.get_model_probabilities(h.max_t)

# the stochastic triple across the same group: the record machinery and
# the temperature schemes over sharded rounds
def m1(generator, theta):
    return {"y": theta[:, 0] + 0.1 * torch.randn(
        theta.shape[0], generator=generator, device=theta.device)}

abc2 = pt.ABCSMC(m1, pt.Distribution(a=pt.RV("norm", 0, 1)),
                 pt.IndependentNormalKernel(var=0.01),
                 population_size=96, eps=pt.Temperature(),
                 acceptor=pt.StochasticAcceptor(), seed=23, device="cpu")
abc2.new("sqlite://", {"y": 0.5})
h2 = abc2.run(max_nr_populations=2)
df2, w2 = h2.get_distribution()
post_mean = float(df2["a"].to_numpy() @ w2)
temp_last = float(h2.get_all_populations().epsilon.iloc[-1])

with open(os.environ["CLUSTER_TEST_OUT"], "w") as f:
    json.dump({"process_index": world()[0],
               "n_devices": abc.sampler.n_devices,
               "sampler": type(abc.sampler).__name__,
               "max_t": int(h.max_t),
               "p1": float(probs.get(1, 0.0)),
               "stoch_max_t": int(h2.max_t),
               "stoch_post_mean": post_mean,
               "stoch_temp": temp_last}, f)
"""


def test_multihost_abcsmc(tmp_path):
    """A whole ABCSMC across a real 2-process group: the default sampler
    shards rounds over both ranks and every rank holds the same
    population."""
    n = 2
    port = _free_port()
    script = tmp_path / "abc_prog.py"
    script.write_text(ABC_PROGRAM)
    procs = [_worker(["--coordinator", f"127.0.0.1:{port}",
                      "--num-processes", str(n), "--process-id", str(i),
                      str(script)],
                     {"CLUSTER_TEST_OUT": str(tmp_path / f"abc_out_{i}.json")})
             for i in range(n)]
    outs = _finish(procs, 300)
    for p, (_, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
    infos = []
    for i in range(n):
        with open(tmp_path / f"abc_out_{i}.json") as f:
            infos.append(json.load(f))
    for i, info in enumerate(infos):
        assert info["process_index"] == i
        assert info["n_devices"] == n        # one shard per rank
        assert info["sampler"] == "ShardedSampler"
        assert info["max_t"] == 1
    # every rank computed the same model probabilities
    assert abs(infos[0]["p1"] - infos[1]["p1"]) < 1e-12
    assert 0.3 < infos[0]["p1"] <= 1.0
    # stochastic triple: the same temperatures and posterior on each rank
    assert infos[0]["stoch_max_t"] >= 1
    assert abs(infos[0]["stoch_post_mean"]
               - infos[1]["stoch_post_mean"]) < 1e-12
    assert abs(infos[0]["stoch_temp"] - infos[1]["stoch_temp"]) < 1e-9
    assert abs(infos[0]["stoch_post_mean"] - 0.5) < 0.4
