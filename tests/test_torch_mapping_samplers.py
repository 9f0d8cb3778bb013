"""The port's host samplers and SGE mapper: twins of
``tests/test_mapping_samplers.py`` (same sizes, the same fake Dask
client), the K1 launches a host-sampled generation makes, repeatability
under thread timing, the error classification of a task, and
``DefaultSampler``'s capacity check against the JAX package's."""

import numpy as np
import pytest
import torch

import pyabc_tpu as jpt
import pyabc_tpu_torch as pt
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.sampler.base import RoundResult


class FakeDaskClient:
    """Thread-pool stand-in for ``distributed.Client``: the same
    submit/ncores/close surface (the JAX test's)."""

    def __init__(self, n_workers: int = 4):
        from concurrent.futures import ThreadPoolExecutor
        self._pool = ThreadPoolExecutor(max_workers=n_workers)
        self._n = n_workers

    def submit(self, fn, *args, pure=None):
        return self._pool.submit(fn, *args)

    def ncores(self):
        return {f"w{i}": 1 for i in range(self._n)}

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)


def _dask_sampler():
    try:
        import distributed  # noqa: F401
        return pt.DaskDistributedSampler(batch_size=8, client_max_jobs=4,
                                         device="cpu")
    except ImportError:
        return pt.DaskDistributedSampler(
            dask_client=FakeDaskClient(), batch_size=8, client_max_jobs=4,
            device="cpu")


SAMPLERS = {
    "mapping": lambda: pt.MappingSampler(map_=map, device="cpu"),
    "cfuture": lambda: pt.ConcurrentFutureSampler(
        client_max_jobs=4, batch_size=8, device="cpu"),
    "dask": _dask_sampler,
}


def _run(sampler, pop=60, gens=2, seed=11):
    models, priors, distance, observed, posterior_fn = \
        make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=pop,
                    sampler=sampler, seed=seed)
    abc.new("sqlite://", observed)
    abc.run(max_nr_populations=gens)
    return abc


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_blessed_problem_small(name):
    sampler = SAMPLERS[name]()
    h = _run(sampler).history
    assert h.max_t >= 1
    probs = h.get_model_probabilities(h.max_t)
    assert float(sum(probs)) == pytest.approx(1.0, abs=1e-5)
    if hasattr(sampler, "stop"):
        sampler.stop()


@pytest.mark.parametrize("name", ["cfuture", "dask"])
def test_same_seed_repeats_whatever_the_thread_timing(name):
    """Each task draws from its own generator (one draw of the run's
    plus the task id) and results count in submission order: two runs
    of one seed are equal bit for bit."""
    runs = [_run(SAMPLERS[name](), gens=3) for _ in range(2)]
    for t in range(3):
        a, b = (r.history.get_population(t) for r in runs)
        for key in ("m", "theta", "weight", "distance"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key))


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_proposal_density_runs_once_per_model_per_task(name, monkeypatch):
    """Every task's round evaluates the proposal density in the round:
    at t >= 1 the KDE runs M times per task (on the card, K1 launches;
    here the plain version's calls are counted)."""
    from pyabc_tpu_torch.ops import kde
    calls = []
    plain = kde.weighted_kde_logpdf

    def counted(*args, **kwargs):
        calls.append(args[0].shape[0])
        return plain(*args, **kwargs)

    monkeypatch.setattr(kde, "weighted_kde_logpdf", counted)
    sampler = SAMPLERS[name]()
    marks = []
    sample = sampler.sample_until_n_accepted

    def marked(*args, **kwargs):
        marks.append(len(calls))
        out = sample(*args, **kwargs)
        marks.append(len(calls))
        return out

    sampler.sample_until_n_accepted = marked
    abc = _run(sampler, gens=3)
    per_call = [b - a for a, b in zip(marks[::2], marks[1::2])]
    # calls: calibration, then t = 0, 1, 2
    assert len(sampler.task_counts) == len(per_call) == 4
    assert per_call[:2] == [0, 0]
    for t in (1, 2):
        assert per_call[t + 1] == abc.M * sampler.task_counts[t + 1]
    assert set(calls) == {1 if name == "mapping" else 8}


def _fake_round(fail: dict):
    """A round of B candidates that all accept, raising ``fail[task]``
    (popped) on the tasks listed there; tasks are told apart by their
    generator's first draw."""
    seen = {}

    def round_fn(gen, params, B, **kwargs):
        key = int(torch.randint(0, 1 << 30, (1,), generator=gen))
        task = seen.setdefault(key, len(seen))
        if task in fail:
            raise fail.pop(task)
        ones = torch.ones(B)
        return RoundResult(m=torch.zeros(B, dtype=torch.int64),
                           theta=torch.full((B, 1), float(task)),
                           distance=ones, accepted=ones.bool(),
                           log_weight=torch.zeros(B),
                           stats=torch.zeros(B, 1))

    return round_fn


def test_task_errors_follow_the_retry_classification():
    gen = torch.Generator().manual_seed(0)
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory")
    s = pt.ConcurrentFutureSampler(client_max_jobs=1, batch_size=2,
                                   device="cpu")
    # a transient error resubmits the same task: its rows come first
    sample = s.sample_until_n_accepted(4, _fake_round({0: oom}), gen, {})
    assert sample.nr_evaluations == 4 and s.nr_evaluations_ == 4
    # a model error writes the batch off and goes on
    sample = s.sample_until_n_accepted(
        4, _fake_round({0: ValueError("model")}), gen, {})
    assert sample.n_accepted == 4 and s.nr_evaluations_ == 6
    # a sticky CUDA error ends the call
    sticky = RuntimeError("CUDA error: an illegal memory access was "
                          "encountered")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        s.sample_until_n_accepted(4, _fake_round({1: sticky}), gen, {})
    s.stop()


def test_dask_sampler_requires_client_or_dask():
    try:
        import distributed  # noqa: F401
        pytest.skip("dask installed: local-cluster default applies")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="distributed"):
        pt.DaskDistributedSampler(device="cpu")


def test_dask_sampler_pickles_without_client():
    s = pt.DaskDistributedSampler(dask_client=FakeDaskClient(),
                                  device="cpu")
    state = s.__getstate__()
    assert "my_client" not in state
    s2 = pt.DaskDistributedSampler.__new__(pt.DaskDistributedSampler)
    s2.__setstate__(state)
    assert s2.my_client is None


def test_cfuture_stop_keeps_user_executor():
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(max_workers=2)
    s = pt.ConcurrentFutureSampler(cfuture_executor=pool, device="cpu")
    s.stop()
    assert pool.submit(lambda: 1).result() == 1  # still alive
    pool.shutdown()


def test_host_samplers_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for cls in (pt.MappingSampler, pt.ConcurrentFutureSampler):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.DefaultSampler()


def test_sge_local_fallback(tmp_path):
    from pyabc_tpu_torch.sge import SGE

    sge = SGE(tmp_directory=str(tmp_path), name="t")
    assert not sge.sge_available()
    assert sge.map(_square, [1, 2, 3, 4, 5]) == [1, 4, 9, 16, 25]


def _square(x):
    return x * x


def test_sge_preserves_failure_dir(tmp_path):
    from pyabc_tpu_torch.sge import SGE

    sge = SGE(tmp_directory=str(tmp_path), name="t")
    results = sge.map(_fail_on_three, [1, 3])
    assert results[0] == 1
    assert isinstance(results[1], Exception)
    assert any(p.name.endswith("_with_exception")
               for p in tmp_path.iterdir())


def _fail_on_three(x):
    if x == 3:
        raise ValueError("three")
    return x


def test_sge_batch_file_rendering(tmp_path):
    from pyabc_tpu.sge import SGE as JaxSGE
    from pyabc_tpu_torch.sge import SGE

    kw = dict(tmp_directory=str(tmp_path), name="job", memory="2G",
              time_h=12, queue="q.test")
    script = SGE(**kw)._render_batch_file(7, "/tmp/x")
    assert "#$ -t 1-7" in script
    assert "#$ -q q.test" in script
    assert "h_vmem=2G" in script
    assert "-m pyabc_tpu_torch.sge.execute_load" in script
    assert script == JaxSGE(**kw)._render_batch_file(7, "/tmp/x").replace(
        "pyabc_tpu.sge", "pyabc_tpu_torch.sge")


def test_profiling_context(tmp_path):
    from pyabc_tpu_torch.sge import SGE, ProfilingContext

    sge = SGE(tmp_directory=str(tmp_path), name="t",
              execution_context=ProfilingContext)
    assert sge.map(_square, [2]) == [4]


def test_default_sampler_capacity_error_as_the_jax_package(monkeypatch):
    """Under one memory budget both factories refuse a shape no point
    fits, at construction; a shape that fits gives the vectorized
    sampler on the resolved device."""
    from pyabc_tpu.capacity import CapacityError as JaxCapacityError
    from pyabc_tpu.platform_factory import DefaultSampler as jax_default
    from pyabc_tpu_torch.capacity import CapacityError

    monkeypatch.setenv("PYABC_TPU_HBM_BUDGET", "64M")
    shape = dict(population=10_000_000, param_dim=4, stat_dim=8)
    with pytest.raises(JaxCapacityError):
        jax_default(**shape)
    with pytest.raises(CapacityError):
        pt.DefaultSampler(**shape, device="cpu")
    small = dict(population=1000, param_dim=1, stat_dim=1)
    jax_default(**small)
    s = pt.DefaultSampler(**small, device="cpu", max_batch_size=4096)
    assert type(s) is pt.VectorizedSampler and s.device.type == "cpu"
    assert s.max_batch_size == 4096


def test_dask_real_local_cluster():
    """The real ``distributed`` transport, where the package is
    installed (the JAX test skips the same way without it)."""
    distributed = pytest.importorskip("distributed")
    client = distributed.Client(processes=False, dashboard_address=None)
    try:
        models, priors, distance, observed, posterior_fn = \
            make_two_gaussians_problem()
        abc = pt.ABCSMC(models, priors, distance, population_size=120,
                        sampler=pt.DaskDistributedSampler(
                            dask_client=client, batch_size=8,
                            client_max_jobs=4, device="cpu"),
                        seed=5)
        abc.new("sqlite://", observed)
        h = abc.run(max_nr_populations=3)
        probs = h.get_model_probabilities(h.max_t)
        assert abs(float(probs.get(1, 0.0)) - posterior_fn(1.0)) < 0.25
    finally:
        client.close()
