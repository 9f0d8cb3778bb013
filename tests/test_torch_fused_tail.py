"""The fused engine's last generation at pop 16384, ten seeds per package.

Config #2 (two-Gaussian model selection, ``MedianEpsilon``) at pop 16384
with fused blocks of K = 4 over 11 generations — the smoke's
``fused16384`` phase: ``VectorizedSampler(max_batch_size=2^19,
max_rounds_per_call=16)``, ``stores_sum_stats=False`` — runs on the CPU
in the JAX package and in the port, seeds 0-9 each.  Each run records its
last generation's effective sample size, its p(B) against the analytic
posterior, and its engine path.  A run has collapsed when its ESS falls
below 1 % of the population or its p(B) misses ``run_gate``'s tolerance
max(2.5e-3, 2.5/√pop); the port must not collapse more often than the
reference.

Twenty runs of about a minute each: the test is marked ``slow`` (the
tier-1 selection ``-m 'not slow'`` leaves it out).  Run it alone with
``python -m pytest -m slow tests/test_torch_fused_tail.py -s``.
"""

import numpy as np
import pytest

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem
from pyabc_tpu_torch.models import make_two_gaussians_problem

pytestmark = pytest.mark.slow

POP = 16384
GENS = 11
SEEDS = range(10)
TOL_P = max(2.5e-3, 2.5 / POP ** 0.5)


def _run(pkg, seed: int) -> dict:
    problem = jax_problem if pkg is jpt else make_two_gaussians_problem
    kw = {"device": "cpu"} if pkg is pt else {}
    models, priors, distance, observed, posterior_fn = problem()
    abc = pkg.ABCSMC(
        models, priors, distance, population_size=POP,
        eps=pkg.MedianEpsilon(),
        sampler=pkg.VectorizedSampler(max_batch_size=1 << 19,
                                      max_rounds_per_call=16, **kw),
        stores_sum_stats=False, fuse_generations=4, seed=seed, **kw)
    abc.new("sqlite://", observed)
    h = abc.run(max_nr_populations=GENS)
    pop = h.get_population(h.max_t)
    w = np.asarray(pop.weight, np.float64)
    w = w / w.sum()
    rows = (abc.timeline.to_rows() if pkg is jpt else abc.timeline)
    return {"gens": h.max_t + 1, "ess": float(1.0 / np.sum(w ** 2)),
            "pb_err": float(w[np.asarray(pop.m) == 1].sum()
                            - posterior_fn(1.0)),
            "path": "".join(r["path"][0] for r in rows)}


def _collapsed(row: dict) -> bool:
    return row["ess"] < 0.01 * POP or abs(row["pb_err"]) >= TOL_P


@pytest.fixture(scope="module")
def tail_table():
    return {(name, seed): _run(pkg, seed)
            for name, pkg in (("jax", jpt), ("port", pt)) for seed in SEEDS}


def test_port_tail_collapses_no_more_often_than_the_reference(tail_table):
    for (name, seed), row in sorted(tail_table.items()):
        print(f"{name} seed {seed}: ESS {row['ess']:.0f}, "
              f"p(B) - analytic {row['pb_err']:+.4f}, path {row['path']}")
    assert all(row["gens"] == GENS for row in tail_table.values())
    port = sum(_collapsed(tail_table["port", s]) for s in SEEDS)
    ref = sum(_collapsed(tail_table["jax", s]) for s in SEEDS)
    assert port <= ref, (port, ref)
