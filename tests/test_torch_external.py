"""The port's host bridges, twins of tests/test_external.py: a shell
script as the model of a CPU run, the sum-stat / distance file protocol,
and the R bridge through the ``Rscript`` stub (tests/fake_rscript.py).
The same scripts and the same stub also run through the JAX package's
bridges, which must give the same statistics, sum-stat files and
distances (exact: both are host code over the same files)."""

import os
import pickle
import stat
import sys
import textwrap

import numpy as np
import pytest
import torch

import pyabc_tpu_torch as pt
from pyabc_tpu_torch.external import (ExternalDistance, ExternalHandler,
                                      ExternalModel, ExternalSumStat,
                                      HostFunctionModel, R, create_sum_stat)
from pyabc_tpu_torch.external.base import _dict_to_r_list, _r_call_expr


def _write_script(path, body):
    path.write_text(textwrap.dedent(body))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture
def model_script(tmp_path):
    return _write_script(tmp_path / "model.sh", r"""
        #!/bin/bash
        for a in "$@"; do
          case "$a" in
            mu=*) mu="${a#mu=}";;
            target=*) target="${a#target=}";;
          esac
        done
        echo "y $mu" > "$target"
        """)


def test_external_handler_runs(model_script):
    res = ExternalHandler("bash", model_script).run(["mu=0.25"])
    assert res["returncode"] == 0
    with open(res["loc"]) as f:
        assert f.read().split() == ["y", "0.25"]
    os.remove(res["loc"])


def test_host_function_model_round_trip():
    """numpy in, numpy out, once per call; the seed comes from the
    generator; a raising function gives NaN stats."""
    seeds = []

    def fn(theta, seed):
        seeds.append(seed)
        return {"s": theta.sum(1) * 2.0, "v": np.ones((theta.shape[0], 2))}

    m = HostFunctionModel(fn, {"s": (), "v": (2,)})
    theta = torch.arange(6, dtype=torch.float32).view(3, 2)
    out = m.simulate(torch.Generator().manual_seed(1), theta)
    assert out["s"].tolist() == [2.0, 10.0, 18.0]
    assert out["v"].shape == (3, 2) and out["v"].dtype == torch.float32
    m.simulate(torch.Generator().manual_seed(1), theta)
    assert seeds[0] == seeds[1]

    def broken(theta, seed):
        raise ValueError("boom")

    bad = HostFunctionModel(broken, {"s": ()})
    assert torch.isnan(bad.simulate(torch.Generator(), theta)["s"]).all()


def test_external_model_e2e_through_abcsmc(db_path, model_script):
    model = ExternalModel("bash", model_script, parameter_names=["mu"],
                          stat_shapes={"y": ()})
    assert isinstance(model, HostFunctionModel)
    abc = pt.ABCSMC(
        models=model,
        parameter_priors=pt.Distribution(mu=pt.RV("uniform", -1.0, 2.0)),
        distance_function=pt.PNormDistance(p=2),
        population_size=32,
        sampler=pt.VectorizedSampler(min_batch_size=32, max_batch_size=64,
                                     device="cpu"),
        seed=2)
    abc.new(db_path, {"y": 0.4})
    h = abc.run(max_nr_populations=3)
    df, w = h.get_distribution(m=0)
    assert float(np.sum(df["mu"].to_numpy() * w)) == pytest.approx(
        0.4, abs=0.15)


def test_external_sumstat_and_distance_protocol(tmp_path):
    sumstat_script = _write_script(tmp_path / "sumstat.sh", r"""
        #!/bin/bash
        for a in "$@"; do
          case "$a" in
            model_output=*) mo="${a#model_output=}";;
            target=*) target="${a#target=}";;
          esac
        done
        y=$(awk '{print $2}' "$mo")
        echo "s $(echo "$y 2" | awk '{print $1*$2}')" > "$target"
        """)
    distance_script = _write_script(tmp_path / "distance.sh", r"""
        #!/bin/bash
        for a in "$@"; do
          case "$a" in
            sumstat_0=*) s0="${a#sumstat_0=}";;
            sumstat_1=*) s1="${a#sumstat_1=}";;
            target=*) target="${a#target=}";;
          esac
        done
        a=$(awk '{print $2}' "$s0")
        b=$(awk '{print $2}' "$s1")
        echo "$a $b" | awk '{d=$1-$2; if (d<0) d=-d; print d}' > "$target"
        """)
    (tmp_path / "out0.txt").write_text("y 1.5\n")
    (tmp_path / "out1.txt").write_text("y 1.0\n")
    sumstat = ExternalSumStat("bash", sumstat_script)
    s0 = sumstat(create_sum_stat(str(tmp_path / "out0.txt")))
    s1 = sumstat(create_sum_stat(str(tmp_path / "out1.txt")))
    distance = ExternalDistance("bash", distance_script)
    assert distance(s0, s1) == pytest.approx(1.0)
    assert np.isnan(distance(s0, dict(s1, returncode=1)))
    bad = _write_script(tmp_path / "bad.sh", "#!/bin/bash\nexit 3\n")
    assert np.isnan(ExternalDistance("bash", bad)(s0, s1))
    for s in (s0, s1):
        os.remove(s["loc"])


def test_r_call_expression_shape():
    expr = _r_call_expr("/x/model.R", "myModel",
                        [_dict_to_r_list({"mu": 1.5})], "/tmp/t")
    assert expr.startswith('source("/x/model.R"); .res <- myModel(')
    assert "list(mu=1.5)" in expr


@pytest.fixture
def fake_rscript(tmp_path, monkeypatch):
    stub_src = os.path.join(os.path.dirname(__file__), "fake_rscript.py")
    shim = tmp_path / "Rscript"
    shim.write_text(f"#!/bin/sh\nexec {sys.executable} {stub_src} \"$@\"\n")
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    return shim


def test_r_bridge_subprocess_wire(tmp_path, fake_rscript):
    try:
        import rpy2  # noqa: F401
        pytest.skip("rpy2 present: subprocess transport not selected")
    except ImportError:
        pass
    source = tmp_path / "model.R"
    source.write_text("myModel <- function(pars) list(y = pars$mu * 2)\n")
    r = R(str(source))
    assert r._backend == "subprocess"
    assert r.model("myModel")({"mu": 1.5}) == {"y": 3.0}
    assert r.summary_statistics("mySummary")({"y": 3.0}) == {"s": 4.0}
    assert r.distance("myDistance")({"s": 4.0}, {"s": 3.0}) == 1.0
    assert r.observation("myObservation") == {"s": 3.0}
    r2 = pickle.loads(pickle.dumps(r))
    assert r2.model("myModel")({"mu": 2.0}) == {"y": 4.0}
    with pytest.raises(RuntimeError, match="Rscript failed"):
        r.model("myBroken")({"mu": 1.0})


# ---- the same scripts through the JAX package ----------------------------

def test_external_model_stats_match_jax(model_script):
    """One theta batch through the shell-script model of both packages:
    the same statistics, exactly (the script echoes its argument, and
    both packages format it with numpy's float32 repr)."""
    import jax
    import jax.numpy as jnp

    from pyabc_tpu.external import ExternalModel as JaxExternalModel

    theta = np.random.default_rng(4).uniform(-1.0, 1.0, (9, 1)).astype(
        np.float32)
    j_out = JaxExternalModel("bash", model_script, parameter_names=["mu"],
                             stat_shapes={"y": ()}).sample(
        jax.random.PRNGKey(0), jnp.asarray(theta))
    out = ExternalModel("bash", model_script, parameter_names=["mu"],
                        stat_shapes={"y": ()}).simulate(
        torch.Generator().manual_seed(0), torch.as_tensor(theta))
    np.testing.assert_array_equal(out["y"].numpy(), np.asarray(j_out["y"]))
    np.testing.assert_array_equal(out["y"].numpy(), theta[:, 0])


@pytest.mark.parametrize("fails", [False, True])
def test_host_function_model_matches_jax(fails):
    """A host function that ignores its seed gives the same statistics
    in both packages; a raising one gives NaN for the batch in both."""
    import jax
    import jax.numpy as jnp

    from pyabc_tpu.external import HostFunctionModel as JaxHostFunctionModel

    def fn(theta, seed):
        if fails:
            raise ValueError("boom")
        return {"s": np.sin(theta).sum(1), "v": np.stack(
            [theta[:, 0] * 3.0, theta[:, 1] - 1.0], 1)}

    shapes = {"s": (), "v": (2,)}
    theta = np.random.default_rng(5).normal(size=(7, 2)).astype(np.float32)
    j_out = JaxHostFunctionModel(fn, shapes).sample(jax.random.PRNGKey(1),
                                                    jnp.asarray(theta))
    out = HostFunctionModel(fn, shapes).simulate(
        torch.Generator().manual_seed(1), torch.as_tensor(theta))
    for k in shapes:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(j_out[k]))
    assert np.isnan(out["s"].numpy()).all() == fails


def test_sumstat_and_distance_match_jax(tmp_path):
    """The sum-stat and distance scripts of
    test_external_sumstat_and_distance_protocol through both packages:
    the same sum-stat files and the same distances (exact), NaN on a
    failed upstream and on a failing script in both."""
    from pyabc_tpu.external import ExternalDistance as JaxExternalDistance
    from pyabc_tpu.external import ExternalSumStat as JaxExternalSumStat
    from pyabc_tpu.external import create_sum_stat as jax_create_sum_stat

    sumstat_script = _write_script(tmp_path / "sumstat.sh", r"""
        #!/bin/bash
        for a in "$@"; do
          case "$a" in
            model_output=*) mo="${a#model_output=}";;
            target=*) target="${a#target=}";;
          esac
        done
        y=$(awk '{print $2}' "$mo")
        echo "s $(echo "$y 2" | awk '{print $1*$2}')" > "$target"
        """)
    distance_script = _write_script(tmp_path / "distance.sh", r"""
        #!/bin/bash
        for a in "$@"; do
          case "$a" in
            sumstat_0=*) s0="${a#sumstat_0=}";;
            sumstat_1=*) s1="${a#sumstat_1=}";;
            target=*) target="${a#target=}";;
          esac
        done
        a=$(awk '{print $2}' "$s0")
        b=$(awk '{print $2}' "$s1")
        echo "$a $b" | awk '{d=$1-$2; if (d<0) d=-d; print d}' > "$target"
        """)
    bad = _write_script(tmp_path / "bad.sh", "#!/bin/bash\nexit 3\n")
    outputs = []
    for i, y in enumerate([1.5, 1.0, -0.25, 3.125]):
        (tmp_path / f"out{i}.txt").write_text(f"y {y}\n")
        outputs.append(str(tmp_path / f"out{i}.txt"))

    def run(sumstat_cls, distance_cls, create):
        sumstat = sumstat_cls("bash", sumstat_script)
        stats = [sumstat(create(loc)) for loc in outputs]
        texts = []
        for s in stats:
            with open(s["loc"]) as f:
                texts.append(f.read())
        distance = distance_cls("bash", distance_script)
        ds = [distance(stats[0], s) for s in stats[1:]]
        ds.append(distance(stats[0], dict(stats[1], returncode=1)))
        ds.append(distance_cls("bash", bad)(stats[0], stats[1]))
        for s in stats:
            os.remove(s["loc"])
        return texts, np.asarray(ds)

    j_texts, j_ds = run(JaxExternalSumStat, JaxExternalDistance,
                        jax_create_sum_stat)
    texts, ds = run(ExternalSumStat, ExternalDistance, create_sum_stat)
    assert texts == j_texts
    np.testing.assert_array_equal(ds, j_ds)
    np.testing.assert_array_equal(ds[:3], [1.0, 3.5, 3.25])
    assert np.isnan(ds[3:]).all()


def test_r_bridge_matches_jax(tmp_path, fake_rscript):
    """The R bridge of both packages through the same Rscript stub: the
    same call expression and the same model, sum-stat, distance and
    observation values (exact)."""
    from pyabc_tpu.external import R as JaxR
    from pyabc_tpu.external.base import _dict_to_r_list as jax_r_list
    from pyabc_tpu.external.base import _r_call_expr as jax_call_expr

    try:
        import rpy2  # noqa: F401
        pytest.skip("rpy2 present: subprocess transport not selected")
    except ImportError:
        pass
    pars = {"mu": 1.5, "sigma": 0.25}
    assert _dict_to_r_list(pars) == jax_r_list(pars)
    assert (_r_call_expr("/x/m.R", "f", [_dict_to_r_list(pars)], "/t")
            == jax_call_expr("/x/m.R", "f", [jax_r_list(pars)], "/t"))
    source = tmp_path / "model.R"
    source.write_text("myModel <- function(pars) list(y = pars$mu * 2)\n")
    results = []
    for cls in (JaxR, R):
        r = cls(str(source))
        results.append([r.model("myModel")({"mu": mu})
                        for mu in (1.5, -0.5, 2.25)]
                       + [r.summary_statistics("mySummary")({"y": 3.0}),
                          r.distance("myDistance")({"s": 4.0}, {"s": 3.0}),
                          r.observation("myObservation")])
    assert results[0] == results[1]
