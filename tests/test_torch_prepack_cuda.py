"""The early pack on the card: a generation's ``theta``/``distance``
blobs pack while the captured finalize computes its weights.

At the last count read the sampler copies the rows its finalize does not
change to the host and hands them to ``History.prepack`` before it
replays the finalize (K1 over the whole previous population).  Here, on
an SIR generation at pop 2^18: the event recorded at that hand-off
completes before the finalize's K1 does, by K1's time, and the
``history.prepack`` span overlaps the finalize's interval on the host
clock (from the hand-off to the return of the fetch that waits for K1).

Marked ``cuda``: without a card every test here skips.  The file imports
neither JAX nor the JAX package, so it runs on the machine with the card
(which has no JAX), from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_prepack_cuda.py
"""

import time

import pytest
import torch

import pyabc_tpu_torch as pt
from pyabc_tpu_torch.models import make_sir_problem
from pyabc_tpu_torch.sampler import vectorized
from pyabc_tpu_torch.storage import History
from pyabc_tpu_torch.telemetry import spans

pytestmark = pytest.mark.cuda

POP = 1 << 18


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (see the module docstring)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _tracer_on():
    spans.TRACER.reset()
    spans.TRACER.configure(enabled=True)
    yield
    spans.TRACER.reset()


def test_the_early_pack_runs_under_the_finalize(dev, monkeypatch):
    seen = {}
    real_prepack = History.prepack
    real_fetch = vectorized.fetch_to_host

    def prepack(self, t, rows):
        handed = torch.cuda.Event(enable_timing=True)
        handed.record()
        seen[t] = {"handed": handed, "t_handed": time.perf_counter()}
        return real_prepack(self, t, rows)

    def fetch(tree, *args, **kwargs):
        t = max(seen) if seen else None
        if t is not None and set(tree) == {"log_weight"} \
                and "finalized" not in seen[t]:
            # queued behind the finalize: completes when K1 has run
            finalized = torch.cuda.Event(enable_timing=True)
            finalized.record()
            out = real_fetch(tree, *args, **kwargs)
            seen[t].update(finalized=finalized,
                           t_finalized=time.perf_counter())
            return out
        return real_fetch(tree, *args, **kwargs)

    monkeypatch.setattr(History, "prepack", prepack)
    monkeypatch.setattr(vectorized, "fetch_to_host", fetch)
    models, priors, distance, observed = make_sir_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=POP,
                    eps=pt.MedianEpsilon(),
                    sampler=pt.VectorizedSampler(min_batch_size=POP,
                                                 max_batch_size=POP,
                                                 device="cuda"),
                    stores_sum_stats=False, seed=3, history_mode="eager",
                    ingest_mode="sequential", device="cuda")
    abc.new("sqlite://", observed)
    abc.run(max_nr_populations=3)
    torch.cuda.synchronize()
    assert sorted(seen) == [0, 1, 2]
    packs = {s.gen: s for s in spans.TRACER.spans()
             if s.name == "history.prepack"}
    for row in abc.timeline[1:]:
        t = row["t"]
        assert row["kde_launches"] >= 1 and row["prepacked_share"] > 0.5
        got = seen[t]
        # the hand-off's event precedes the end of K1 by K1's time
        assert got["handed"].elapsed_time(got["finalized"]) > 1.0
        span = packs[t]
        overlap = (min(span.t_end, got["t_finalized"])
                   - max(span.t_start, got["t_handed"]))
        assert span.t_start < got["t_finalized"] and overlap > 0, (
            t, span.t_start, span.t_end, got)
