"""Twins of ``tests/test_pod_onedispatch.py`` for the port: the pod
one-dispatch posture across two gloo ranks on the CPU, launched through
``python -m pyabc_tpu_torch.parallel.cli``.

- parity: the same one-dispatch program (lazy History, K = 2,
  ``ConstantEpsilon(0.5)``) on a pod of two ranks of four shards and in
  one process of eight shards: one dispatch per rank, and every rank's
  stop, depth, ε rows and p(B) equal each other's AND the one-process
  run's bit for bit (the port's carry is replicated, so the pod adds no
  reduction-order freedom: stronger than the JAX test's 1e-3 on p(B));
- kill -9 after the preemption barrier: each rank journals only its own
  rows into its ``h<rank>`` namespace, and ``pod_pending`` reassembles
  every lazy generation from the two shard journals, verified against
  the deposit-time global manifest — zero generations lost.

The device count and demonstrated depth come from the JAX package's
accelerator captures (``bench/multichip/``), as in the JAX test.
"""

import glob
import json
import os
import re
import signal
import socket
import sqlite3
import subprocess
import sys

from pyabc_tpu_torch.resilience.journal import (SpillJournal, pod_pending,
                                                verify_wire)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _multichip_contract():
    """(device count, generation depth) of the newest capture in
    ``bench/multichip/``; (8, 2) when it is not ok."""
    caps = sorted(glob.glob(
        os.path.join(REPO, "bench", "multichip", "MULTICHIP_r*.json")))
    assert caps, "bench/multichip fixture captures are missing"
    with open(caps[-1]) as f:
        cap = json.load(f)
    if not cap.get("ok"):
        return 8, 2
    gens = re.search(r"OK, (\d+) generations", cap.get("tail", ""))
    return int(cap.get("n_devices", 8)), int(gens.group(1)) if gens else 2


POD_PROGRAM = """
import json, os
import torch
import pyabc_tpu_torch as pt
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.parallel.mesh import make_mesh, world

models, priors, distance, observed, _ = make_two_gaussians_problem()
shards = int(os.environ["POD_SHARDS"])
abc = pt.ABCSMC(models, priors, distance, population_size=256, seed=17,
                run_mode="onedispatch", history_mode="lazy",
                fuse_generations=2, eps=pt.ConstantEpsilon(0.5),
                sampler=pt.ShardedSampler(
                    mesh=make_mesh([torch.device("cpu")] * shards)))
abc.new("sqlite:///" + os.environ["POD_DB"], observed)
h = abc.run(max_nr_populations=4)
probs = h.get_model_probabilities(h.max_t)
rows = h.get_all_populations()
with open(os.environ["CLUSTER_TEST_OUT"], "w") as f:
    json.dump({"process_index": world()[0],
               "n_devices": abc.sampler.n_devices,
               "sampler": type(abc.sampler).__name__,
               "max_t": int(h.max_t),
               "dispatches": int(abc.run_dispatches),
               "paths": [r["path"] for r in abc.timeline],
               "stop": abc.timeline.stop_reason,
               "p1": float(probs.get(1, 0.0)),
               "eps_rows": [float(e) for e in rows.epsilon]}, f)
"""


def _env(tmp_path, tag, i, extra=None):
    return dict(os.environ, PYTHONPATH=REPO,
                POD_DB=str(tmp_path / f"{tag}_h{i}.db"),
                CLUSTER_TEST_OUT=str(tmp_path / f"{tag}_out_{i}.json"),
                **(extra or {}))


def _spawn_pod(script, n, tmp_path, extra_env=None, tag="pod"):
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", "pyabc_tpu_torch.parallel.cli",
         "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(n), "--process-id", str(i), str(script)],
        env=_env(tmp_path, tag, i, extra_env),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for i in range(n)]


def _finish(procs, timeout=240):
    try:
        return [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def test_pod_onedispatch_parity(tmp_path):
    n = 2
    n_devices, rig_gens = _multichip_contract()
    script = tmp_path / "pod_prog.py"
    script.write_text(POD_PROGRAM)
    procs = _spawn_pod(script, n, tmp_path,
                       {"POD_SHARDS": str(n_devices // n)})
    # the one-process reference on the same shard count, run meanwhile
    ref = subprocess.Popen(
        [sys.executable, str(script)],
        env=_env(tmp_path, "ref", 0, {"POD_SHARDS": str(n_devices)}),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    outs = _finish(procs)
    (_, ref_se), = _finish([ref])
    for p, (_, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
    assert ref.returncode == 0, ref_se.decode()[-3000:]
    infos = [json.loads((tmp_path / f"pod_out_{i}.json").read_text())
             for i in range(n)]
    ref_info = json.loads((tmp_path / "ref_out_0.json").read_text())
    for i, info in enumerate(infos):
        assert info["process_index"] == i
        assert info["n_devices"] == n_devices
        assert info["sampler"] == "ShardedSampler"
        # the whole run after generation 0 is one dispatch per rank
        assert info["dispatches"] == 1
        assert info["paths"][1:] == ["onedispatch"] * info["max_t"]
    for key in ("stop", "max_t", "p1", "eps_rows"):
        assert infos[0][key] == infos[1][key] == ref_info[key], key
    assert ref_info["dispatches"] == 1
    assert infos[0]["max_t"] + 1 >= rig_gens


KILL_PROGRAM = """
import json, os, signal
import pyabc_tpu_torch as pt
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.storage.history import History

# pod preemption is slice-wide: every rank runs phase 1 of the barrier
# (the shard-local journal_tail) and is then killed -9 before any
# materialization: pinned to the run-end flush
def _preempted_flush(self, *a, **k):
    store = self._store
    if store is not None:
        if store.journal is None and self.journal is not None:
            store.attach_journal(self.journal)
        store.journal_tail()
    with open(os.environ["CLUSTER_TEST_OUT"], "w") as f:
        json.dump({"barrier": "done"}, f)
        f.flush(); os.fsync(f.fileno())
    os.kill(os.getpid(), signal.SIGKILL)

History.flush_lazy = _preempted_flush

models, priors, distance, observed, _ = make_two_gaussians_problem()
abc = pt.ABCSMC(models, priors, distance, population_size=128, seed=29,
                run_mode="onedispatch", history_mode="lazy",
                fuse_generations=2, eps=pt.ConstantEpsilon(0.5),
                device="cpu")
abc.new("sqlite:///" + os.environ["POD_DB"], observed)
abc.run(max_nr_populations=4)
"""


def test_pod_kill9_loses_zero_generations(tmp_path):
    """kill -9 after the journal barrier: the per-rank shard journals
    (sibling ``h<NNN>`` layout) reassemble every lazy generation.  The
    older generations reach the journal at eviction (a ring of 2), the
    resident tail through the barrier's ``journal_tail``."""
    n, n_gens = 2, 4
    jdir = tmp_path / "journal"
    script = tmp_path / "kill_prog.py"
    script.write_text(KILL_PROGRAM)
    procs = _spawn_pod(script, n, tmp_path, tag="kill", extra_env={
        "PYABC_TPU_STORE_GENS": "2",
        "PYABC_TPU_JOURNAL_DIR": str(jdir)})
    _finish(procs)
    assert all(p.returncode == -signal.SIGKILL for p in procs), \
        [p.returncode for p in procs]
    for i in range(n):
        with open(tmp_path / f"kill_out_{i}.json") as f:
            assert json.load(f) == {"barrier": "done"}
    assert sorted(os.listdir(jdir)) == ["h000", "h001"]
    merged = pod_pending(SpillJournal(str(jdir / "h000")))
    durable = {}
    for i in range(n):
        conn = sqlite3.connect(str(tmp_path / f"kill_h{i}.db"))
        durable[i] = dict(conn.execute(
            "SELECT t, lazy FROM populations WHERE t >= 0"))
        conn.close()
    assert durable[0] == durable[1]  # the same frontier on every rank
    assert sorted(durable[0]) == list(range(n_gens))
    lazy_ts = sorted(t for t, flag in durable[0].items() if flag)
    assert lazy_ts, "run never left lazy generations at the kill point"
    assert sorted(merged) == lazy_ts
    for t, entry in merged.items():
        # whole population rows, not one rank's shard
        verify_wire(entry["host_wire"], entry["digest"], t=t,
                    where="pod-replay-test")
        assert entry["n"] == 128
        assert entry["host_wire"]["m"].shape == (128,)
