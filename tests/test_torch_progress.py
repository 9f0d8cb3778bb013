"""The port's progress bar against the JAX package's
(``pyabc_tpu/utils/progress.py``), and ``ABCSMC(show_progress=True)``
on each engine: bar lines on stderr, the same populations as without
the bar."""

import io

import numpy as np
import pytest

import pyabc_tpu_torch as pt
from pyabc_tpu.utils.progress import ProgressBar as JaxBar
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.utils.progress import ProgressBar


class _Tty(io.StringIO):
    def isatty(self):
        return True


@pytest.mark.parametrize("stream", [io.StringIO, _Tty], ids=["lines", "tty"])
@pytest.mark.parametrize("updates", [(3, 10), (0, 7, 12), (5,)],
                         ids=["full", "clamped", "partial"])
def test_bar_text_is_the_jax_packages(stream, updates):
    out = {}
    for name, cls in (("jax", JaxBar), ("port", ProgressBar)):
        buf = stream()
        with cls(10, desc="t=1", stream=buf, min_interval_s=0.0) as bar:
            for k in updates:
                bar.update(k)
        out[name] = buf.getvalue()
    assert out["port"] == out["jax"]
    assert f"{min(updates[-1], 10)}/10" in out["port"]


def _run(show_progress, **kwargs):
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=50,
                    sampler=pt.VectorizedSampler(max_batch_size=1024,
                                                 device="cpu"),
                    show_progress=show_progress, seed=12, **kwargs)
    abc.new("sqlite://", observed)
    abc.run(max_nr_populations=kwargs.get("fuse_generations", 1) + 2)
    return abc


@pytest.mark.parametrize("engine", [
    {}, {"fuse_generations": 2, "eps": pt.ConstantEpsilon(0.5)},
    {"fuse_generations": 2, "eps": pt.ConstantEpsilon(0.5),
     "run_mode": "onedispatch"}], ids=["sequential", "fused", "onedispatch"])
def test_show_progress_through_abcsmc(capsys, engine):
    """The JAX test's gate (``/50`` on stderr after a run), on each
    engine, and the populations of a run without the bar."""
    quiet = _run(False, **engine)
    assert "/50" not in capsys.readouterr().err
    shown = _run(True, **engine)
    err = capsys.readouterr().err
    assert shown.history.max_t >= 1
    assert "50/50" in err
    paths = [r["path"] for r in shown.timeline]
    assert paths == [r["path"] for r in quiet.timeline]
    if engine:
        assert engine.get("run_mode", "fused") in paths
    # one finished bar per device generation
    assert err.count("sampling |") >= sum(p != "sequential" for p in paths)
    for t in range(shown.history.max_t + 1):
        a, b = shown.history.get_population(t), quiet.history.get_population(t)
        for key in ("m", "theta", "weight", "distance"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
