"""The capacity model, the carry codec and the screened round on the card.

Marked ``cuda``: without a card every test here skips.  The file imports
neither JAX nor the JAX package (the machine with the card has no JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_capacity_cuda.py

- the capacity model's predicted peak against the card's measured one
  (``torch.cuda.max_memory_allocated`` over a one-dispatch call) at three
  populations, each dispatch writing all ``max_T`` generations it was
  planned for: the prediction bounds the measurement;
- one screened round on the card under
  ``torch.cuda.set_sync_debug_mode("error")``, its proposal drawn before:
  the calibrated threshold, the surrogate, the screen, the slot
  compaction, the full-fidelity stage and the scatter-back read nothing
  back to the host;
- the codec on the card equal to the codec on the CPU (bf16 bit-equal,
  int8 codes and aux lanes equal).
"""

import numpy as np
import pytest
import torch

import pyabc_tpu_torch as pt
from pyabc_tpu_torch.convert import carry_to_torch, to_torch
from pyabc_tpu_torch.fidelity import screen_threshold
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.models.sir import SIRTauLeap
from pyabc_tpu_torch.ops import precision
from pyabc_tpu_torch.random_variables import RV, Distribution

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (see the module docstring)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("PYABC_TPU_HBM_BUDGET", "PYABC_TPU_CARRY_PRECISION",
                "PYABC_TPU_FIDELITY"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("pop", [1 << 14, 1 << 17, 1 << 20])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_predicted_peak_bounds_the_measured_one(dev, monkeypatch, pop,
                                                mode):
    """Config #2, one dispatch of two generations (``max_T`` = 2), the
    batch pinned at 4·pop so a generation fills in one round."""
    monkeypatch.setenv("PYABC_TPU_CAPACITY_MEASURE", "1")
    monkeypatch.setenv("PYABC_TPU_CARRY_PRECISION", mode)
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(
        models, priors, distance, population_size=pop,
        eps=pt.ConstantEpsilon(1.0),
        sampler=pt.VectorizedSampler(min_batch_size=4 * pop,
                                     max_batch_size=4 * pop, device=dev),
        fuse_generations=2, run_mode="onedispatch", onedispatch_max_t=2,
        stores_sum_stats=False, seed=0, device=dev)
    abc.new("sqlite://", observed)
    abc.run(max_nr_populations=3)
    cap = abc.timeline.capacity
    assert [r["path"] for r in abc.timeline] == ["sequential",
                                                 "onedispatch",
                                                 "onedispatch"]
    assert cap["precision"] == mode and cap["max_T"] == 2
    measured = cap["measured_bytes"]
    print(f"pop {pop} {mode}: predicted {cap['predicted_bytes']} "
          f"measured {measured} ratio "
          f"{cap['predicted_bytes'] / measured:.3f}")
    assert 0 < measured <= cap["predicted_bytes"]


def _sir_abc(dev):
    model = SIRTauLeap(n_steps=40, n_obs=8)
    prior = Distribution(log_beta=RV("uniform", -2.0, 3.0),
                         log_gamma=RV("uniform", -3.0, 3.0))
    gen = torch.Generator()
    gen.manual_seed(11)
    obs = model.simulate(gen, torch.log(torch.tensor([[0.8, 0.2]])))
    abc = pt.ABCSMC([model], [prior], pt.PNormDistance(p=2),
                    population_size=2048,
                    sampler=pt.VectorizedSampler(device=dev),
                    fuse_generations=2, fidelity="screen", seed=1,
                    device=dev)
    abc.new("sqlite://", {k: v[0].numpy() for k, v in obs.items()})
    return abc


def test_screened_round_reads_nothing_back(dev):
    """A screened run's proposal, then one staged round and its threshold
    with every host read an error."""
    abc = _sir_abc(dev)
    h = abc.run(max_nr_populations=2)
    t = h.max_t + 1
    abc._fit_transitions(t, population=h.get_population(t - 1))
    probs = abc._model_probabilities(t - 1)
    params = to_torch({
        "model_log_probs": np.log(np.maximum(probs, 1e-300)).astype(
            np.float32),
        "transition": abc._trans_params,
        "distance": abc.distance_function.get_params(t),
        "acceptor": abc.acceptor.get_params(t, abc.eps)}, dev)
    rng = np.random.default_rng(2)
    d_full = torch.as_tensor(rng.gamma(2.0, 50.0, 1024).astype(np.float32),
                             device=dev)
    d_lo = d_full * torch.as_tensor(
        (1.0 + 0.1 * rng.standard_normal(1024)).astype(np.float32),
        device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    # the proposal is drawn first: the checked span is the cascade's own
    # (the surrogate, the screen, the slots, full fidelity, scatter-back)
    proposal = abc._kernel._propose(gen, params, 1 << 14)
    abc._kernel._propose = lambda *a: proposal
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tau = screen_threshold(d_lo, d_full, params["acceptor"]["eps"],
                               q=0.02, margin=1.25, min_corr=0.2,
                               min_pairs=32)
        rr, (plo, pfull, npass) = abc._kernel.staged_generation_round(
            gen, {**params, "fidelity": {"tau": tau}}, 1 << 14,
            full_fraction=0.25, with_proposal=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(tau))
    assert rr.distance.shape == (1 << 14,) and plo.shape == (1 << 12,)
    survived = int(npass[0])
    assert 0 < survived <= int(rr.valid.sum())
    filled = torch.isfinite(pfull)
    assert int(filled.sum()) == min(1 << 12, survived)
    assert int(torch.isfinite(rr.distance).sum()) == int(filled.sum())


def _carry(n=4096, d=3, s=5, seed=0):
    rng = np.random.default_rng(seed)
    theta = (rng.normal(size=(n, d)) * 10.0).astype(np.float32)
    theta[3, 1] = np.inf
    return {"m": rng.integers(0, 2, n).astype(np.int64),
            "log_weight": rng.normal(size=n).astype(np.float32),
            "theta": theta,
            "distance": rng.uniform(0.0, 5.0, n).astype(np.float32),
            "stats": rng.normal(size=(n, s)).astype(np.float32),
            "count": np.int64(n)}


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_codec_on_the_card_equals_the_cpu(dev, mode, seed):
    c = _carry(seed=seed)
    card = precision.encode_carry(carry_to_torch(c, dev), mode)
    host = precision.encode_carry(carry_to_torch(c, "cpu"), mode)
    assert set(card) == set(host)
    for k in host:
        assert card[k].dtype == host[k].dtype, k
        assert torch.equal(card[k].cpu(), host[k]), k
    card_dec = precision.decode_carry(card, mode)
    host_dec = precision.decode_carry(host, mode)
    for k in precision.CARRY_COMPRESSED_LANES:
        np.testing.assert_allclose(card_dec[k].cpu().numpy(),
                                   host_dec[k].numpy(), rtol=1e-6,
                                   atol=1e-6)
