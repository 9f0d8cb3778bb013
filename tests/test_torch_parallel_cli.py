"""Twins of ``tests/test_parallel_cli.py`` for the port's worker and
manager CLI (``python -m pyabc_tpu_torch.parallel.cli``, argparse), and
``top``'s text held to the JAX package's ``_render_top`` on one run
directory the port wrote.
"""

import os
import socket

import pytest

import pyabc_tpu_torch as pt
from pyabc_tpu.parallel.cli import _render_top as jax_render_top
from pyabc_tpu_torch.models import make_two_gaussians_problem
from pyabc_tpu_torch.parallel import cli, health
from pyabc_tpu_torch.telemetry import aggregate, flight, lanes, spans


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """The tracer sink, flight ring and progress word are process-global:
    every test starts and ends clean, with no run dir from the
    environment."""
    for env in (health.RUN_DIR_ENV, aggregate.HOST_ENV, spans.TRACE_ENV):
        monkeypatch.delenv(env, raising=False)
    spans.TRACER.reset()
    flight.RECORDER.reset()
    lanes.PROGRESS.reset()
    yield
    spans.TRACER.reset()
    flight.RECORDER.reset()
    lanes.PROGRESS.reset()


def test_worker_runs_script(tmp_path, monkeypatch):
    """The worker joins the group, then runs the script as __main__."""
    calls = {}

    def fake_init(coordinator, num_processes, process_id):
        calls["init"] = (coordinator, num_processes, process_id)

    import pyabc_tpu_torch.parallel.mesh as mesh
    monkeypatch.setattr(mesh, "initialize_distributed", fake_init)
    out = tmp_path / "ran.txt"
    script = tmp_path / "prog.py"
    script.write_text(
        "import sys, pathlib\n"
        "assert __name__ == '__main__'\n"
        f"pathlib.Path({str(out)!r}).write_text('ok')\n")
    assert cli.main(["--coordinator", "host:1234", "--num-processes", "4",
                     "--process-id", "1", str(script)]) == 0
    assert calls["init"] == ("host:1234", 4, 1)
    assert out.read_text() == "ok"


def test_worker_propagates_script_error(tmp_path, monkeypatch):
    import pyabc_tpu_torch.parallel.mesh as mesh
    monkeypatch.setattr(mesh, "initialize_distributed", lambda *a: None)
    script = tmp_path / "bad.py"
    script.write_text("raise RuntimeError('boom')\n")
    with pytest.raises(RuntimeError, match="boom"):
        cli.main([str(script)])


def test_manager_info(capsys):
    assert cli.main(["info"]) == 0
    out = capsys.readouterr().out
    assert "process 0/1" in out
    assert "local devices" in out


_FAKE_METRICS = {
    "uptime_s": 10.0, "generations": 4, "evaluations": 5000,
    "accepted": 400, "acceptance_rate": 0.08, "d2h_mb": 12.5,
    "d2h_mb_per_s": 250.0, "compute_s": 3.0, "fetch_s": 0.05,
    "decode_s": 0.01, "overlap_s": 0.04, "rewinds": 2,
    "ingest_inflight": 1,
}


def _beat(tmp_path, metrics_fn):
    hb = health.Heartbeat(str(tmp_path), process_index=0,
                          metrics_fn=metrics_fn)
    hb.beat()
    return hb


def test_heartbeat_embeds_metrics(tmp_path):
    _beat(tmp_path, lambda: dict(_FAKE_METRICS))
    entry = health.worker_status(str(tmp_path))[0]
    assert entry["alive"]
    assert entry["metrics"]["evaluations"] == 5000
    assert entry["metrics"]["rewinds"] == 2


def test_heartbeat_default_metrics_fn_is_telemetry_summary(tmp_path):
    _beat(tmp_path, None)
    m = health.worker_status(str(tmp_path))[0]["metrics"]
    assert {"uptime_s", "generations", "evaluations", "d2h_mb",
            "d2h_mb_per_s", "overlap_s", "rewinds"} <= set(m)


def test_heartbeat_survives_broken_metrics_fn(tmp_path):
    def boom():
        raise RuntimeError("registry on fire")

    _beat(tmp_path, boom)
    entry = health.worker_status(str(tmp_path))[0]
    assert entry["alive"]
    assert entry["metrics"] == {}


def test_info_renders_worker_throughput_line(tmp_path, capsys):
    _beat(tmp_path, lambda: dict(_FAKE_METRICS))
    assert cli.main(["info", "--run-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "Workers=1 Alive=1" in out
    assert "gens=4" in out
    assert "evals=5000 (500.0/s)" in out
    assert "acc_rate=0.08" in out
    assert "d2h=12.50MB@250.00MB/s" in out
    assert "rewinds=2" in out


def test_metrics_command_scrapes_run_dir(tmp_path, capsys):
    _beat(tmp_path, lambda: dict(_FAKE_METRICS))
    assert cli.main(["metrics", "--run-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    labels = f'host="{socket.gethostname()}",pid="{os.getpid()}"'
    assert f"pyabc_tpu_worker_evaluations{{{labels}}} 5000" in out
    assert f"pyabc_tpu_worker_d2h_mb_per_s{{{labels}}} 250.0" in out


def test_metrics_command_renders_local_registry(capsys):
    from pyabc_tpu_torch.telemetry.metrics import REGISTRY
    REGISTRY.reset()
    REGISTRY.counter("abc_evaluations_total",
                     "total model evaluations").inc(5)
    assert cli.main(["metrics"]) == 0
    out = capsys.readouterr().out
    assert "# TYPE abc_evaluations_total counter" in out
    assert "abc_evaluations_total 5.0" in out


def test_render_worker_prometheus_skips_non_numeric():
    from pyabc_tpu_torch.telemetry.metrics import render_worker_prometheus
    text = render_worker_prometheus([
        {"host": "h1", "pid": 7,
         "metrics": {"evaluations": 10, "alive": True, "note": "x"}},
        {"host": "h2", "pid": 8, "metrics": {}},
    ])
    assert text == 'pyabc_tpu_worker_evaluations{host="h1",pid="7"} 10\n'


def test_top_renders_the_jax_text_on_a_port_run_dir(tmp_path, monkeypatch,
                                                    capsys):
    """A one-dispatch port run publishes into a run dir beside a live
    heartbeat, then a stop and a reset: ``top`` prints what the JAX
    package's ``_render_top`` renders from the same files."""
    rd = str(tmp_path)
    monkeypatch.setenv(health.RUN_DIR_ENV, rd)
    models, priors, distance, observed, _ = make_two_gaussians_problem()
    abc = pt.ABCSMC(models, priors, distance, population_size=200,
                    eps=pt.ConstantEpsilon(0.2),
                    sampler=pt.VectorizedSampler(min_batch_size=2048,
                                                 max_batch_size=2048,
                                                 device="cpu"),
                    fuse_generations=2, run_mode="onedispatch", seed=0)
    abc.new("sqlite://", observed)
    abc.run(max_nr_populations=4)
    monkeypatch.delenv(health.RUN_DIR_ENV)
    hb = _beat(tmp_path, None)
    text = cli._render_top(rd)
    assert text == jax_render_top(rd)
    assert text.startswith("fleet: hosts=1 gens=")
    assert "engine=onedispatch" in text
    assert "recent generations:" in text
    assert cli.main(["top", "--run-dir", rd]) == 0
    assert capsys.readouterr().out == text + "\n"
    assert cli.main(["stop", "--run-dir", rd]) == 0
    assert health.stop_requested(rd)
    hb.stop(remove=False)
    assert cli.main(["reset-workers", "--run-dir", rd]) == 0
    assert "stale worker record" in capsys.readouterr().out
