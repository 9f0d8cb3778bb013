"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, runs with JAX made unimportable, and never picks the CPU on its
own."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from pyabc_tpu_torch.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "pyabc_tpu")


def _port_files():
    files = sorted((ROOT / "pyabc_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert "pyabc_tpu_torch/smc.py" in names
    assert "pyabc_tpu_torch/ops/kde_cuda.py" in names
    for new in ("distance/kernel.py", "acceptor/pdf_norm.py",
                "epsilon/temperature.py", "models/ode.py",
                "petab/__init__.py", "petab/base.py", "petab/ode.py",
                "petab/sbml.py", "petab/problem.py", "sampler/fused.py",
                "ops/quantile_sketch.py", "wire/__init__.py",
                "wire/transfer.py", "wire/streaming.py", "wire/ingest.py",
                "wire/store.py", "cv/__init__.py", "cv/bootstrap.py",
                "external/__init__.py", "external/base.py",
                "transition/local_transition.py", "transition/randomwalk.py",
                "transition/model_selection.py",
                "transition/predict_population_size.py",
                "ops/precision.py", "capacity/__init__.py",
                "capacity/model.py", "autotune/occupancy.py",
                "fidelity/__init__.py", "fidelity/config.py",
                "fidelity/calibrate.py", "fidelity/screen.py",
                "telemetry/__init__.py", "telemetry/metrics.py",
                "telemetry/spans.py", "telemetry/timeline.py",
                "telemetry/lanes.py", "telemetry/flight.py",
                "resilience/__init__.py", "resilience/faults.py",
                "resilience/retry.py", "resilience/checkpoint.py",
                "resilience/journal.py", "version.py", "utils/__init__.py",
                "utils/progress.py", "utils/transfer.py",
                "platform_factory.py", "storage/reference_export.py",
                "storage/export.py", "sampler/eps_mixin.py",
                "sampler/mapping.py", "sampler/dask_sampler.py",
                "sge/__init__.py", "sge/config.py", "sge/db.py",
                "sge/execute_load.py", "sge/execution_contexts.py",
                "sge/sge.py", "sge/util.py", "parallel/__init__.py",
                "parallel/health.py", "telemetry/aggregate.py",
                "visualization/__init__.py", "visualization/util.py",
                "visualization/kde.py", "visualization/run_plots.py",
                "visserver/__init__.py", "visserver/app.py",
                "visserver/server.py", "autotune/ladder.py",
                "autotune/cache.py", "telemetry/studytrace.py",
                "serve/__init__.py", "serve/spec.py", "serve/shards.py",
                "serve/tracing.py", "serve/queue.py", "serve/cache.py",
                "serve/admission.py", "serve/multiplex.py",
                "serve/worker.py", "parallel/mesh.py", "parallel/cli.py",
                "sampler/sharded.py", "sched/__init__.py",
                "sched/autoscale.py", "sched/platform.py",
                "sched/scheduler.py", "tools/__init__.py",
                "tools/loadgen.py", "telemetry/phases.py"):
        assert f"pyabc_tpu_torch/{new}" in names
    assert (ROOT / "pyabc_tpu_torch/csrc/kde_logpdf.cu").is_file()


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_jax_package_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_runs_with_jax_unimportable():
    """A fresh interpreter with ``sys.modules["jax"] = None`` imports the
    port and runs a 2-generation CPU ABCSMC."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "pyabc_tpu"):
            sys.modules[name] = None
        import pyabc_tpu_torch as pt
        from pyabc_tpu_torch.models import make_two_gaussians_problem
        models, priors, distance, observed, _ = make_two_gaussians_problem()
        abc = pt.ABCSMC(models, priors, distance, population_size=200,
                        sampler=pt.VectorizedSampler(device="cpu"), seed=3)
        abc.new("sqlite://", observed)
        h = abc.run(max_nr_populations=2)
        assert h.max_t == 1, h.max_t
        assert not any(m.split(".")[0] in ("jax", "jaxlib")
                       for m, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_resolve_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_sampler_and_abcsmc_default_to_the_card(monkeypatch):
    """No argument means the card: without one, construction raises
    instead of silently running on the CPU."""
    import pyabc_tpu_torch as pt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        pt.VectorizedSampler()
    prior = pt.Distribution(mu=pt.RV("norm", 0.0, 1.0))
    with pytest.raises(RuntimeError):
        pt.ABCSMC(lambda g, th: {"y": th[:, 0]}, prior)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No card: non-zero exit and no result line, in the checkout and in
    a directory holding chip_smoke.py alone."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
