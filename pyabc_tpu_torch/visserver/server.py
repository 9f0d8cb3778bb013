"""Web visualization server (port of ``pyabc_tpu/visserver/server.py``).

Served with the standard library's ``http.server``:

- ``/`` — the interactive single-page UI (``visserver/app.py``).
- ``/api/runs``, ``/api/run/<id>``, ``/api/kde/<id>/<m>/<t>?x=<par>`` —
  the JSON API the page (or any notebook or tool) reads; the KDE runs on
  the server's ``device`` through the weighted-KDE kernel.
- ``/abc/<id>``, ``/abc/<id>/model/<m>/t/<t>``, ``/plot/...`` — HTML
  pages and matplotlib PNGs of a run.
- With ``run_dir``: ``/api/fleet`` and ``/metrics``, the live view of a
  run in flight from the telemetry snapshots (``telemetry/aggregate.py``)
  and heartbeats (``parallel/health.py``).  ``/api/serve`` and
  ``/api/sched`` give the fleet rollup's serving and scheduling slices
  with the serving queue's state (``serve/queue.py``: its stats, leases
  and lapsed claims), and ``/api/trace/<id>`` one study's assembled
  lifecycle trace (``telemetry/studytrace.py``).

Run: ``python -m pyabc_tpu_torch.visserver.server --db abc.db
[--run-dir DIR] [--port 8765] [--device cpu]``.
"""

from __future__ import annotations

import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..storage.history import History

_PAGE = """<!doctype html><html><head><title>pyabc_tpu</title>
<style>body{{font-family:sans-serif;margin:2em}}img{{max-width:45em}}</style>
</head><body>{body}</body></html>"""


class _Handler(BaseHTTPRequestHandler):
    db_path: str = ""
    #: shared run directory for the LIVE fleet view (--run-dir); empty
    #: = post-hoc History browsing only, the pre-fleet behavior
    run_dir: str = ""
    #: where the KDE routes evaluate their densities (None: the card)
    device = None

    def _send(self, content, ctype="text/html"):
        data = content if isinstance(content, bytes) else content.encode()
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass

    def do_GET(self):  # noqa: N802 (http.server API)
        try:
            self._route()
        except Exception as e:  # an error page, never a dead server
            if urlparse(self.path).path.startswith("/api/"):
                self._json({"error": str(e)}, status=500)
            else:
                self._send(_PAGE.format(body=f"<pre>error: {e}</pre>"))

    def _route(self):
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        if not parts:
            return self._spa()
        if parts[0] == "api":
            return self._api(parts[1:], parse_qs(url.query))
        if parts[0] == "runs":
            return self._index()
        if parts[0] == "abc" and len(parts) == 2:
            return self._run(int(parts[1]))
        if (parts[0] == "abc" and len(parts) == 6 and parts[2] == "model"
                and parts[4] == "t"):
            return self._population(int(parts[1]), int(parts[3]),
                                    int(parts[5]))
        if parts[0] == "plot" and len(parts) == 4:
            return self._kde_png(int(parts[1]), int(parts[2]), int(parts[3]))
        if parts == ["metrics"]:
            return self._metrics()
        self._send(_PAGE.format(body="<p>not found</p>"))

    def _spa(self):
        from .app import PAGE
        self._send(PAGE)

    def _json(self, obj, status=200):
        def clean(o):
            """Strict JSON: bare Infinity/NaN (e.g. the calibration
            epsilon) breaks browsers' response.json()."""
            if isinstance(o, dict):
                return {k: clean(v) for k, v in o.items()}
            if isinstance(o, list):
                return [clean(v) for v in o]
            if isinstance(o, float) and not (-1e308 < o < 1e308):
                return None
            return o
        data = json.dumps(clean(obj), allow_nan=False).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _metrics(self):
        """Fleet Prometheus endpoint (needs --run-dir), so the viewer's
        host doubles as the scrape target."""
        if not self.run_dir:
            return self._send("# no --run-dir configured\n",
                              ctype="text/plain")
        from ..telemetry import aggregate

        self._send(aggregate.render_prometheus(self.run_dir),
                   ctype="text/plain")

    def _api(self, parts, query):
        """JSON API: runs / run metadata / per-(m, t, parameter) KDE /
        live fleet state."""
        if parts == ["fleet"]:
            return self._json(self._fleet_state())
        if parts == ["serve"]:
            return self._json(self._serve_state())
        if parts == ["sched"]:
            return self._json(self._sched_state())
        if parts[0] == "trace" and len(parts) == 2:
            return self._json(self._trace_state(parts[1]))
        if parts == ["runs"]:
            h = History(self.db_path, abc_id=1)
            runs = h.all_runs()
            return self._json([
                {"id": int(r.id), "start_time": str(r.start_time)}
                for r in runs.itertuples()])
        if parts[0] == "run" and len(parts) == 2:
            h = History(self.db_path, abc_id=int(parts[1]))
            pops = h.get_all_populations()
            per_pop = h.get_nr_particles_per_population()
            # one pivot query for all (t, m) probabilities; parameter
            # names from the TEXT column — no population-blob unpacking
            pivot = h.get_model_probabilities()
            probs = {int(t): {int(m): float(p) for m, p in row.items()}
                     for t, row in pivot.iterrows()}
            models = sorted(int(m) for m in pivot.columns) or [0]
            name_rows = h._conn.execute(
                "SELECT m, param_names FROM model_populations WHERE "
                "abc_smc_id=? AND t=?", (h.id, h.max_t)).fetchall()
            names = {int(m): json.loads(pn) if pn else []
                     for m, pn in name_rows}
            params = {m: names.get(m, []) for m in models}
            rows = []
            for r in pops.itertuples():
                n_part = int(per_pop.get(r.t, 0))
                rows.append({
                    "t": int(r.t), "epsilon": float(r.epsilon),
                    "samples": int(r.samples),
                    "acceptance_rate": (n_part / r.samples
                                        if r.samples else 0.0),
                    "particles": n_part})
            return self._json({
                "models": models, "parameters": params,
                "max_t": int(h.max_t), "populations": rows,
                "model_probabilities": probs})
        if parts[0] == "kde" and len(parts) == 4:
            abc_id, m, t = int(parts[1]), int(parts[2]), int(parts[3])
            h = History(self.db_path, abc_id=abc_id)
            df, w = h.get_distribution(m=m, t=t)
            x = query.get("x", [df.columns[0]])[0]
            from ..transition import MultivariateNormalTransition
            from ..visualization.kde import kde_1d
            # fixed scaling=1 here: the CV-scaled default re-runs a
            # bootstrap grid search per request, too slow for a live
            # t-slider; the PNG routes keep the CV default
            grid, dens = kde_1d(df, w, x, numx=120,
                                kde=MultivariateNormalTransition(),
                                device=self.device)
            return self._json({"grid": [float(g) for g in grid],
                               "density": [float(d) for d in dens],
                               "n": int(len(df))})
        self._json({"error": "unknown api route"}, status=404)

    def _fleet_state(self) -> dict:
        """Live per-run view from the telemetry snapshots in the run
        directory: eps/acceptance trajectory, engine decision, compile
        counts, wire MB/s, resilience ledger — refreshing while the run
        is in flight (the History only learns a generation at append
        time, and nothing mid-generation)."""
        if not self.run_dir:
            return {"enabled": False}
        from ..parallel import health
        from ..telemetry import aggregate

        snaps = aggregate.read_snapshots(self.run_dir)
        alive = {(e.get("host"), e.get("pid")): bool(e.get("alive"))
                 for e in health.worker_status(self.run_dir)}
        hosts = []
        trajectory = []
        engine = None
        pod_hosts = 1
        for s in snaps:
            hb = s.get("heartbeat") or {}
            m = s.get("metrics") or {}
            pod = s.get("pod") or {}
            pod_hosts = max(pod_hosts,
                            int(pod.get("process_count", 1)))
            hosts.append({
                "host": s["host"], "pid": s["pid"],
                "alive": alive.get((s["host"], s["pid"])),
                "process_index": pod.get("process_index"),
                "accepted": hb.get("accepted", 0),
                "collective_s": float(m.get(
                    "wire_collective_seconds_total", 0.0)),
                "generations": hb.get("generations", 0),
                "evaluations": hb.get("evaluations", 0),
                "acceptance_rate": hb.get("acceptance_rate", 0.0),
                "d2h_mb": hb.get("d2h_mb", 0.0),
                "d2h_mb_per_s": hb.get("d2h_mb_per_s", 0.0),
                "retries": hb.get("retries", 0),
                "degrades": hb.get("degrades", 0),
                "checkpoints": hb.get("checkpoints", 0),
                "n_compiles": int(m.get("xla_compiles_total", 0)),
                "flight_dumps": int(m.get("flight_dumps_total", 0)),
                "egress": s.get("egress") or {},
                "written_unix": s.get("written_unix"),
                "run_progress": s.get("run_progress"),
            })
            for r in s.get("trajectory") or []:
                row = dict(r)
                row["host"] = s["host"]
                trajectory.append(row)
                if r.get("engine") is not None:
                    engine = r["engine"]
        trajectory.sort(key=lambda r: (r.get("gen", -1), r["host"]))
        from ..telemetry.lanes import merge_progress
        return {"enabled": True, "hosts": hosts,
                "pod_hosts": pod_hosts,
                "trajectory": trajectory, "engine": engine,
                # the fleet-merged in-dispatch progress word: lets the
                # live card advance while every host is still blocked
                # inside a one-dispatch call (telemetry/lanes.py)
                "run_progress": merge_progress(
                    [s.get("run_progress") for s in snaps])}

    def _serve_state(self) -> dict:
        """Live serving-tier view (needs --run-dir): the ``serve_*``
        rollup (studies served, cache hit/miss/eviction, warm engines,
        per-tenant attribution) from the worker snapshots plus the
        admission queue's directory state under ``<run_dir>/serve``."""
        if not self.run_dir:
            return {"enabled": False}
        import os

        from ..telemetry import aggregate

        roll = aggregate.fleet_rollup(self.run_dir)
        out = {"enabled": True, "serve": roll.get("serve") or {}}
        serve_dir = os.path.join(self.run_dir, "serve")
        if os.path.isdir(os.path.join(serve_dir, "queue")):
            from ..serve.queue import StudyQueue
            out["queue"] = StudyQueue(root=serve_dir).stats()
        return out

    def _sched_state(self) -> dict:
        """Live scheduler view (needs --run-dir): the ``sched_*``
        rollup (workers alive/dead, leases lapsed, requeues,
        quarantines, desired replicas) from the scheduler snapshots
        plus the queue's current lease state — how many claims exist
        and how many have already lapsed past the TTL."""
        if not self.run_dir:
            return {"enabled": False}
        import os

        from ..telemetry import aggregate

        roll = aggregate.fleet_rollup(self.run_dir)
        out = {"enabled": True, "sched": roll.get("sched") or {}}
        serve_dir = os.path.join(self.run_dir, "serve")
        if os.path.isdir(os.path.join(serve_dir, "queue")):
            from ..serve.queue import StudyQueue
            q = StudyQueue(root=serve_dir)
            out["queue"] = q.stats()
            out["leases"] = {"lease_s": q.lease_s,
                             "lapsed": len(q.lapsed())}
        return out

    def _trace_state(self, key: str) -> dict:
        """One study's assembled lifecycle trace (``/api/trace/<id>``, id
        = trace id, ticket id, or digest): the ordered events and the
        folded critical-path phases."""
        if not self.run_dir:
            return {"enabled": False}
        import os

        from ..telemetry import studytrace

        serve_dir = os.environ.get("PYABC_TPU_SERVE_DIR",
                                   os.path.join(self.run_dir, "serve"))
        trace = studytrace.StudyTrace.assemble(serve_dir, key)
        if trace is None:
            return {"enabled": True, "found": False, "key": key}
        return {"enabled": True, "found": True, "key": key,
                **trace.to_dict()}

    def _index(self):
        h = History(self.db_path, abc_id=1)
        runs = h.all_runs()
        rows = "".join(
            f'<li><a href="/abc/{r.id}">run {r.id}</a> ({r.start_time})</li>'
            for r in runs.itertuples())
        self._send(_PAGE.format(body=f"<h1>ABC runs</h1><ul>{rows}</ul>"))

    def _run(self, abc_id: int):
        h = History(self.db_path, abc_id=abc_id)
        pops = h.get_all_populations()
        probs = h.get_model_probabilities()
        links = "".join(
            f'<li><a href="/abc/{abc_id}/model/{m}/t/{h.max_t}">'
            f"model {m} @ t={h.max_t}</a></li>"
            for m in h.alive_models())
        self._send(_PAGE.format(body=(
            f"<h1>run {abc_id}</h1><h2>populations</h2>"
            f"{pops.to_html(index=False)}"
            f"<h2>model probabilities</h2>{probs.to_html()}"
            f"<h2>posteriors</h2><ul>{links}</ul>")))

    def _population(self, abc_id: int, m: int, t: int):
        h = History(self.db_path, abc_id=abc_id)
        df, w = h.get_distribution(m=m, t=t)
        self._send(_PAGE.format(body=(
            f"<h1>run {abc_id} / model {m} / t={t}</h1>"
            f"<p>{len(df)} particles, parameters: "
            f"{', '.join(df.columns)}</p>"
            f'<img src="/plot/{abc_id}/{m}/{t}">')))

    def _kde_png(self, abc_id: int, m: int, t: int):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from ..visualization import plot_kde_1d, plot_kde_matrix

        h = History(self.db_path, abc_id=abc_id)
        df, w = h.get_distribution(m=m, t=t)
        if len(df.columns) == 1:
            ax = plot_kde_1d(df, w, df.columns[0], device=self.device)
            fig = ax.figure
        else:
            axes = plot_kde_matrix(df, w, device=self.device)
            fig = axes[0][0].figure
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=80)
        plt.close(fig)
        self._send(buf.getvalue(), ctype="image/png")


def run_app(db: str, port: int = 8765, host: str = "127.0.0.1",
            blocking: bool = True, run_dir: str = "", device=None):
    """Start the server over the History database ``db``.  ``run_dir``
    also enables the live fleet view (``/api/fleet``, ``/metrics``) over
    a shared telemetry run directory; ``device`` is where the KDE routes
    run (None: the card).  ``blocking=False`` returns the server
    unstarted (``port=0`` picks a free port: ``server_address[1]``)."""
    # a handler class per server: two servers in one process keep
    # their own database, run directory and device
    handler = type("_BoundHandler", (_Handler,), {
        "db_path": db, "run_dir": run_dir or "", "device": device})
    httpd = ThreadingHTTPServer((host, port), handler)
    if blocking:
        print(f"serving {db} on http://{host}:{httpd.server_address[1]}")
        httpd.serve_forever()
    return httpd


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m pyabc_tpu_torch.visserver.server",
        description="Browse a History database; with --run-dir, watch "
                    "the run in flight.")
    parser.add_argument("--db", required=True)
    parser.add_argument("--port", default=8765, type=int)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--run-dir", default="",
                        help="shared telemetry run dir: enables the live "
                             "fleet view (/api/fleet, /metrics)")
    parser.add_argument("--device", default=None,
                        help="where the KDE routes run (default: the card)")
    args = parser.parse_args(argv)
    run_app(args.db, args.port, args.host, run_dir=args.run_dir,
            device=args.device)


if __name__ == "__main__":
    main()
