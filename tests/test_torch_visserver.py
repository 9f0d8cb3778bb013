"""The port's web viewer against the JAX package's, over real HTTP.

Both servers run on one small JAX-written database of config #2 (pop
300, three generations) with ``port=0`` and one run directory holding a
telemetry snapshot and a heartbeat.  Every JSON route answers as the
JAX package's does (``/api/kde`` within the KDE tolerance of
``tests/test_ops_kde_pallas.py``), every HTML route returns 200 and
``/plot`` a PNG.  Over a serving queue in the run directory, the queue
state of ``/api/serve`` and ``/api/sched`` and the traces of
``/api/trace`` answer as the JAX package's do.
"""

import contextlib
import json
import os
import threading
import urllib.error
import urllib.request

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.models import make_two_gaussians_problem as jax_problem  # noqa: E402
from pyabc_tpu.visserver.server import run_app as jax_run_app  # noqa: E402
from pyabc_tpu_torch.parallel import health  # noqa: E402
from pyabc_tpu_torch.telemetry import aggregate, spans  # noqa: E402
from pyabc_tpu_torch.visserver import server  # noqa: E402
from pyabc_tpu_torch.visserver.server import run_app  # noqa: E402

KDE_RTOL, KDE_ATOL = 5e-3, 1e-8


@pytest.fixture(scope="module")
def db_and_run_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("vis")
    path = str(root / "jax.db")
    models, priors, distance, observed, _ = jax_problem()
    abc = jpt.ABCSMC(models, priors, distance, population_size=300,
                     sampler=jpt.VectorizedSampler(), seed=3)
    abc.new(path, observed)
    abc.run(max_nr_populations=3)
    run_dir = str(root / "run")
    aggregate.TelemetryPublisher(run_dir, min_interval_s=0.0).publish(
        force=True)
    spans.TRACER.reset()
    health.Heartbeat(run_dir).beat()
    return path, run_dir


@contextlib.contextmanager
def _serving(start, db, run_dir, **kw):
    httpd = start(db, port=0, blocking=False, run_dir=run_dir, **kw)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]

    def get(path):
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=30) as r:
                return r.status, r.headers.get("Content-Type"), r.read()
        except urllib.error.HTTPError as err:
            return err.code, err.headers.get("Content-Type"), err.read()
    try:
        yield get
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=5)
        assert not thread.is_alive()


@pytest.fixture(scope="module")
def both(db_and_run_dir):
    db, run_dir = db_and_run_dir
    with _serving(jax_run_app, db, run_dir) as jget, \
            _serving(run_app, db, run_dir, device="cpu") as pget:
        yield jget, pget


def _strict(body):
    return json.loads(body.decode(), parse_constant=lambda c: (
        _ for _ in ()).throw(AssertionError(f"non-strict JSON: {c}")))


@pytest.mark.parametrize("route", ["/api/runs", "/api/run/1", "/api/fleet",
                                   "/api/serve", "/api/sched",
                                   "/api/nonsense"])
def test_json_route_equals_the_jax_package(both, route):
    jget, pget = both
    js, jctype, jbody = jget(route)
    ps, pctype, pbody = pget(route)
    assert (ps, pctype) == (js, jctype) == (
        (404 if route == "/api/nonsense" else 200), "application/json")
    got, ref = _strict(pbody), _strict(jbody)
    if route == "/api/fleet":
        # the snapshot's host and pid beat: alive in both readers
        assert got["hosts"][0]["alive"] is ref["hosts"][0]["alive"] is True
    assert got == ref
    if route == "/api/run/1":
        assert got["max_t"] == 2 and got["populations"][0]["epsilon"] is None
    if route == "/api/fleet":
        assert got["enabled"] and len(got["hosts"]) == 1


def test_kde_route_equals_the_jax_package(both):
    jget, pget = both
    t = 2
    for m in (0, 1):
        route = f"/api/kde/1/{m}/{t}?x=mu"
        got, ref = _strict(pget(route)[2]), _strict(jget(route)[2])
        assert got["n"] == ref["n"] and len(got["grid"]) == 120
        np.testing.assert_array_equal(got["grid"], ref["grid"])
        np.testing.assert_allclose(got["density"], ref["density"],
                                   rtol=KDE_RTOL, atol=KDE_ATOL)


def test_metrics_equal_the_jax_package(both):
    jget, pget = both
    ps, pctype, pbody = pget("/metrics")
    js, jctype, jbody = jget("/metrics")
    assert (ps, pctype) == (js, jctype) == (200, "text/plain")
    assert pbody == jbody and b"pyabc_tpu_fleet_hosts 1" in pbody


@pytest.mark.parametrize("route,needle", [
    ("/", b"tslider"), ("/runs", b"ABC runs"),
    ("/abc/1", b"model probabilities"), ("/abc/1/model/0/t/2", b"particles"),
    ("/abc/1/model/1/t/1", b"particles"), ("/nonsense", b"not found")])
def test_html_route(both, route, needle):
    jget, pget = both
    status, ctype, body = pget(route)
    assert status == 200 and ctype == "text/html" and needle in body
    if route == "/":
        assert body == jget(route)[2]


def test_plot_route_returns_a_png(both):
    _, pget = both
    status, ctype, body = pget("/plot/1/0/2")
    assert status == 200 and ctype == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n"


def test_serving_branches_name_what_is_missing(db_and_run_dir, tmp_path,
                                              monkeypatch):
    """The serving routes over one queue in the run directory, with one
    study served by the port's worker and one submitted after it: the
    queue state of ``/api/serve``, the leases of ``/api/sched`` and the
    assembled traces of ``/api/trace/<id>`` (both studies, and a key
    that matches nothing) answer as the JAX package's do; with no run
    directory these routes are off, as in the JAX package.  (The name
    dates from when these routes answered 500 naming the missing
    ``serve/``; it is kept so the test keeps its identity.)"""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.serve import ServeWorker, StudyQueue, StudySpec

    db, _ = db_and_run_dir
    run_dir = str(tmp_path)
    serve_dir = os.path.join(run_dir, "serve")
    monkeypatch.delenv("PYABC_TPU_SERVE_DIR", raising=False)
    monkeypatch.setenv("PYABC_TPU_SERVE_MULTIPLEX", "2")

    def spec(seed):
        return StudySpec(model=_serve_model,
                         prior=pt.Distribution(mu=pt.RV("uniform", -1., 2.)),
                         observed={"y": 0.4}, population_size=100,
                         seed=seed, max_generations=2)

    queue = StudyQueue(root=serve_dir)
    served = queue.submit(spec(0))
    assert ServeWorker(root=serve_dir, worker_id="w_vis",
                       device="cpu").run_forever(queue, once=True) == 1
    waiting = queue.submit(spec(1))
    with _serving(run_app, db, run_dir, device="cpu") as get, \
            _serving(jax_run_app, db, run_dir) as jget:
        for route in ("/api/serve", "/api/sched",
                      f"/api/trace/{served.id}",
                      f"/api/trace/{waiting.trace_id}",
                      f"/api/trace/{served.digest}", "/api/trace/abc123"):
            status, ctype, body = get(route)
            assert (status, ctype) == (200, "application/json"), route
            got, ref = _strict(body), _strict(jget(route)[2])
            assert got == ref, route
        serve = _strict(get("/api/serve")[2])
        assert serve["queue"]["done"] == serve["queue"]["pending"] == 1
        sched = _strict(get("/api/sched")[2])
        assert sched["leases"]["lapsed"] == 0
        trace = _strict(get(f"/api/trace/{served.id}")[2])
        assert trace["found"] and trace["workers"] == ["w_vis"]
        assert "published" in [e["event"] for e in trace["events"]]
        assert not _strict(get("/api/trace/abc123")[2])["found"]
    with _serving(run_app, db, "", device="cpu") as get, \
            _serving(jax_run_app, db, "") as jget:
        for route in ("/api/fleet", "/api/serve", "/api/sched",
                      "/api/trace/abc123", "/metrics"):
            assert get(route) == jget(route)


def _serve_model(generator, theta):
    import torch
    noise = 0.1 * torch.randn(theta.shape[0], 1, generator=generator,
                              device=theta.device)
    return {"y": theta[:, :1] + noise}


def test_cli_parses_the_jax_packages_options(monkeypatch):
    seen = {}
    monkeypatch.setattr(server, "run_app",
                        lambda *a, **kw: seen.update(args=a, kw=kw))
    server.main(["--db", "x.db", "--run-dir", "rd", "--port", "9",
                 "--device", "cpu"])
    assert seen == {"args": ("x.db", 9, "127.0.0.1"),
                    "kw": {"run_dir": "rd", "device": "cpu"}}
