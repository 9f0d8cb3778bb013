"""The distributed worker and its manager commands (port of
``pyabc_tpu/parallel/cli.py``), with ``argparse``::

    python -m pyabc_tpu_torch.parallel.cli --coordinator HOST:PORT \\
        --num-processes N --process-id I [--run-dir DIR] script.py
    python -m pyabc_tpu_torch.parallel.cli info [--run-dir DIR]
    python -m pyabc_tpu_torch.parallel.cli metrics [--run-dir DIR] [--fleet]
    python -m pyabc_tpu_torch.parallel.cli top --run-dir DIR [--watch S]
        [--trace] [--study KEY] [--serve-dir DIR] [--export PATH]
    python -m pyabc_tpu_torch.parallel.cli stop --run-dir DIR
    python -m pyabc_tpu_torch.parallel.cli reset-workers --run-dir DIR

The reference farms pickled closures through a Redis broker
(``pyabc/sampler/redis_eps/cli.py``); here every rank runs the SAME
script: the worker joins the ``torch.distributed`` group
(:func:`~.mesh.initialize_distributed`, the backend by its rule), and
inside the script the default sampler is a
:class:`~pyabc_tpu_torch.sampler.sharded.ShardedSampler` over every
rank.  With ``--run-dir`` each worker heartbeats into the shared
directory; a clean exit removes its heartbeat, a crash leaves it, so
``info`` reports the worker STALE.
"""

from __future__ import annotations

import argparse
import os
import runpy
import sys
import time
from typing import List, Optional

MANAGER_COMMANDS = ("info", "metrics", "top", "stop", "reset-workers")


def work(argv: Optional[List[str]] = None) -> int:
    """Join the process group and run the script as ``__main__`` (every
    rank runs the same program).  A script error propagates."""
    ap = argparse.ArgumentParser(
        prog="pyabc_tpu_torch.parallel.cli",
        description="Join the process group and run SCRIPT.")
    ap.add_argument("--coordinator", default=None,
                    help="rendezvous address host:port (rank 0 listens)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--run-dir", default=None,
                    help="shared dir for heartbeats and the clean stop "
                         "(any filesystem every rank mounts)")
    ap.add_argument("script")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    from . import health, mesh

    if args.coordinator is not None or "MASTER_ADDR" in os.environ:
        mesh.initialize_distributed(args.coordinator, args.num_processes,
                                    args.process_id)
    rank = mesh.world()[0]
    hb = None
    if args.run_dir:
        os.environ[health.RUN_DIR_ENV] = args.run_dir
        # a fresh launch means the operator wants to run: rank 0 clears
        # a STOP left over from an earlier `stop`
        if rank == 0:
            health.clear_stop(args.run_dir)
        hb = health.Heartbeat(args.run_dir, process_index=rank).start()
    try:
        sys.argv = [args.script] + list(args.script_args)
        runpy.run_path(args.script, run_name="__main__")
    except BaseException as err:
        # sys.exit(0)/sys.exit(None) is a clean exit; anything else
        # leaves the heartbeat file so `info` reports this worker STALE
        clean = isinstance(err, SystemExit) and err.code in (0, None)
        if hb is not None:
            hb.stop(remove=clean)
        raise
    if hb is not None:
        hb.stop()
    return 0


def info(run_dir: Optional[str] = None) -> str:
    """Worker health (with ``run_dir``) or this host's devices: the
    reference ``abc-redis-manager info``."""
    lines = []
    if run_dir:
        from . import health
        status = health.worker_status(run_dir)
        alive = sum(e["alive"] for e in status)
        lines.append(f"Workers={len(status)} Alive={alive}")
        for e in status:
            state = "alive" if e["alive"] else "STALE"
            lines.append(f"  {e['host']}:{e['pid']} "
                         f"proc={e['process_index']} {state}")
            m = e.get("metrics") or {}
            if m:
                evals = m.get("evaluations", 0)
                uptime = max(m.get("uptime_s", 0.0), 1e-9)
                lines.append(
                    f"    gens={m.get('generations', 0)} "
                    f"evals={evals} "
                    f"({evals / uptime:.1f}/s) "
                    f"acc_rate={m.get('acceptance_rate', 0.0):.4g} "
                    f"d2h={m.get('d2h_mb', 0.0):.2f}MB"
                    f"@{m.get('d2h_mb_per_s', 0.0):.2f}MB/s "
                    f"overlap_s={m.get('overlap_s', 0.0):.2f} "
                    f"rewinds={m.get('rewinds', 0)}")
        return "\n".join(lines)
    import torch

    from .mesh import world
    rank, size = world()
    local = ([torch.device("cuda", i)
              for i in range(torch.cuda.device_count())]
             if torch.cuda.is_available() else [torch.device("cpu")])
    lines.append(f"process {rank}/{size}")
    lines.append(f"local devices: {local}")
    lines.append(f"global devices: {len(local) * size}")
    return "\n".join(lines)


def metrics(run_dir: Optional[str] = None, fleet: bool = False) -> str:
    """Prometheus text: with ``run_dir`` one ``pyabc_tpu_worker_*``
    sample per worker heartbeat metric (labeled by host/pid), or the
    ``pyabc_tpu_fleet_*`` rollup with ``fleet``; without, this process's
    own registry."""
    if run_dir:
        if fleet:
            from ..telemetry import aggregate
            return aggregate.render_prometheus(run_dir)
        from ..telemetry.metrics import render_worker_prometheus
        from . import health
        return render_worker_prometheus(health.worker_status(run_dir))
    from ..telemetry.metrics import REGISTRY
    return REGISTRY.render_prometheus()


def _render_top(run_dir) -> str:
    """One frame of the fleet view: header totals, per-host rows, and
    the recent-generation tail (merged across hosts) — the JAX
    package's ``_render_top`` (``pyabc_tpu/parallel/cli.py:145-339``),
    text for text."""
    from ..telemetry import aggregate
    from . import health

    status = {(e.get("host"), e.get("pid")): e
              for e in health.worker_status(run_dir)}
    snaps = aggregate.read_snapshots(run_dir)
    lines = []
    tot = {"generations": 0, "evaluations": 0, "accepted": 0,
           "d2h_mb": 0.0, "retries": 0, "degrades": 0, "checkpoints": 0,
           "faults": 0, "flights": 0}
    rows = []
    engine = None
    for s in snaps:
        hb = s.get("heartbeat") or {}
        m = s.get("metrics") or {}
        for key in ("generations", "evaluations", "accepted", "retries",
                    "degrades", "checkpoints"):
            tot[key] += int(hb.get(key, 0))
        tot["d2h_mb"] += float(hb.get("d2h_mb", 0.0))
        tot["faults"] += int(m.get("resilience_faults_injected_total", 0))
        tot["flights"] += int(m.get("flight_dumps_total", 0))
        live = status.get((s.get("host"), s.get("pid")))
        state = ("alive" if live and live.get("alive")
                 else "STALE" if live else "?")
        evals = hb.get("evaluations", 0)
        uptime = max(hb.get("uptime_s", 0.0), 1e-9)
        rows.append(
            f"  {s['host']}:{s['pid']} {state} "
            f"gens={hb.get('generations', 0)} "
            f"evals={evals} ({evals / uptime:.1f}/s) "
            f"acc={hb.get('acceptance_rate', 0.0):.4g} "
            f"d2h={hb.get('d2h_mb', 0.0):.2f}MB"
            f"@{hb.get('d2h_mb_per_s', 0.0):.2f}MB/s "
            f"retries={hb.get('retries', 0)} "
            f"degrades={hb.get('degrades', 0)}")
        for r in s.get("trajectory") or []:
            if r.get("engine") is not None:
                engine = r["engine"]
    acc_rate = (tot["accepted"] / tot["evaluations"]
                if tot["evaluations"] else 0.0)
    lines.append(
        f"fleet: hosts={len(snaps)} gens={tot['generations']} "
        f"evals={tot['evaluations']} acc_rate={acc_rate:.4g} "
        f"d2h={tot['d2h_mb']:.2f}MB engine={engine or '-'}")
    # the in-dispatch progress word (telemetry/lanes.py): it keeps
    # ticking while a one-dispatch run's generation counters are frozen
    from ..telemetry.lanes import merge_progress
    prog = merge_progress([s.get("run_progress") for s in snaps])
    if prog is not None and prog.get("active"):
        eps_p = prog.get("eps")
        lines.append(
            f"in-dispatch: gen={prog.get('gen')} "
            f"done={prog.get('gens_done')}/{prog.get('t_limit')} "
            f"eps={'-' if eps_p is None else format(eps_p, '.4g')} "
            f"acc={prog.get('accepted', '-')} "
            f"rounds={prog.get('rounds', 0)} "
            f"hosts={prog.get('hosts_active', 1)}")
    # pod shard attribution (multi-rank runs): which rank each snapshot
    # is, its accepted share, and the host-side collective time
    pods = [(s, s.get("pod")) for s in snaps if s.get("pod")]
    if pods:
        n_pod = max(int(p["process_count"]) for _, p in pods)
        coll = sum(float((s.get("metrics") or {}).get(
            "wire_collective_seconds_total", 0.0)) for s, _ in pods)
        gens = max([int((s.get("heartbeat") or {}).get("generations", 0))
                    for s, _ in pods] or [0])
        shares = " ".join(
            f"h{p['process_index']}="
            f"{(s.get('heartbeat') or {}).get('accepted', 0)}"
            for s, p in sorted(pods,
                               key=lambda x: x[1]["process_index"]))
        lines.append(
            f"pod: hosts={n_pod} collective={coll:.3f}s "
            f"({coll / gens if gens else 0.0:.4f}s/gen) "
            f"accepted {shares}")
    lines.append(
        f"resilience: retries={tot['retries']} "
        f"degrades={tot['degrades']} checkpoints={tot['checkpoints']} "
        f"faults={tot['faults']} flight_dumps={tot['flights']}")
    # the multi-fidelity cascade: only rendered when a worker ran
    # screened generations
    sims_low = sum(int((s.get("metrics") or {}).get(
        "abc_sims_low_total", 0)) for s in snaps)
    if sims_low:
        sims_full = sum(int((s.get("metrics") or {}).get(
            "abc_sims_full_total", 0)) for s in snaps)
        screen_pass = sum(int((s.get("metrics") or {}).get(
            "abc_screen_pass_total", 0)) for s in snaps)
        lines.append(
            f"fidelity: sims_low={sims_low} sims_full={sims_full} "
            f"full_frac={sims_full / sims_low:.2f} "
            f"screen_rate={screen_pass / sims_low:.3f}")
    # the serving tier: studies totals (counters summed across workers,
    # point-in-time gauges maxed) and the per-tenant attribution
    serve_vals = {}
    for s in snaps:
        for k, v in (s.get("metrics") or {}).items():
            if (k.startswith("serve_") and isinstance(v, (int, float))
                    and not isinstance(v, bool)):
                serve_vals.setdefault(k, []).append(float(v))
    if serve_vals:
        from ..telemetry.aggregate import is_serve_gauge

        def sv(key):
            vals = serve_vals.get(key, [0.0])
            return max(vals) if is_serve_gauge(key) else sum(vals)

        looked = sv("serve_cache_hits_total") + sv(
            "serve_cache_misses_total")
        lines.append(
            f"serve: studies={int(sv('serve_studies_total'))} "
            f"multiplexed="
            f"{int(sv('serve_multiplexed_studies_total'))} "
            f"queue={int(sv('serve_queue_depth'))} "
            f"engines={int(sv('serve_engines_warm'))} "
            f"cache_hit_ratio="
            f"{sv('serve_cache_hits_total') / looked if looked else 0.0:.2f}")
        # the data plane: shard spread, tier split and shed pressure
        if sv("serve_partitions"):
            lines.append(
                f"  data: partitions={int(sv('serve_partitions'))} "
                f"depth_max={int(sv('serve_partition_depth_max'))} "
                f"t1_hit={sv('serve_cache_hit_ratio_t1'):.2f} "
                f"t2_hit={sv('serve_cache_hit_ratio_t2'):.2f} "
                f"shed={int(sv('serve_shed_total'))}")
        # the SLO burn ledger (telemetry/studytrace.py)
        over = sv("serve_slo_over_total")
        under = sv("serve_slo_under_total")
        if over or under:
            admitted = over + under
            lines.append(
                f"  slo: p99_slo={sv('serve_slo_p99_ms'):g}ms "
                f"over={int(over)} under={int(under)} "
                f"burn={over / admitted if admitted else 0.0:.1%} "
                f"shed={int(sv('serve_shed_total'))}")
        tenants = sorted(
            (k[len("serve_tenant_"):-len("_studies_total")], sv(k))
            for k in serve_vals
            if k.startswith("serve_tenant_")
            and k.endswith("_studies_total"))
        if tenants:
            lines.append("  tenants: " + " ".join(
                f"{t}={int(n)}" for t, n in tenants))
    # the scheduler (sched/): worker liveness as it sees it, lease
    # reaping and the autoscaler's replica target
    sched_vals = {}
    for s in snaps:
        for k, v in (s.get("metrics") or {}).items():
            if (k.startswith("sched_") and isinstance(v, (int, float))
                    and not isinstance(v, bool)):
                sched_vals.setdefault(k, []).append(float(v))
    if sched_vals:
        from ..telemetry.aggregate import _SCHED_GAUGES

        def sc(key):
            vals = sched_vals.get(key, [0.0])
            return max(vals) if key in _SCHED_GAUGES else sum(vals)

        lines.append(
            f"sched: alive={int(sc('sched_workers_alive'))} "
            f"dead={int(sc('sched_workers_dead'))} "
            f"lapsed={int(sc('sched_leases_lapsed_total'))} "
            f"requeues={int(sc('sched_requeues_total'))} "
            f"quarantined={int(sc('sched_quarantines_total'))} "
            f"desired={int(sc('sched_desired_replicas'))} "
            f"replicas={int(sc('sched_platform_replicas'))}")
    lines.extend(rows or ["  (no telemetry snapshots yet)"])
    # recent generations across the fleet, newest last
    tail = []
    for s in snaps:
        for r in (s.get("timeline_tail") or [])[-8:]:
            tail.append((r.get("gen", -1), s["host"], r))
    tail.sort(key=lambda x: x[0])
    if tail:
        lines.append("recent generations:")
        for gen, host, r in tail[-10:]:
            eps = r.get("eps")
            lines.append(
                f"  t={gen} [{host}] {r.get('path', '?')} "
                f"wall={r.get('wall_s', 0.0):.3f}s "
                f"eps={'-' if eps is None else format(eps, '.4g')} "
                f"acc={r.get('accepted', '-')}/{r.get('total', '-')} "
                f"engine={r.get('engine') or '-'}")
    return "\n".join(lines)


def _render_study(serve_dir: str, key: str,
                  export: Optional[str] = None) -> str:
    """The single-study trace view behind ``top --study``: the
    assembled lifecycle event list and the critical-path waterfall."""
    from ..telemetry import studytrace

    trace = studytrace.StudyTrace.assemble(serve_dir, key)
    if trace is None:
        return (f"no trace matching {key!r} under {serve_dir}/trace "
                "(tracing off, wrong serve dir, or already swept?)")
    lines = studytrace.waterfall_text(trace)
    lines.append("events:")
    for rec in trace.events:
        extra = " ".join(
            f"{k}={rec[k]}" for k in sorted(rec)
            if k not in ("trace_id", "event", "unix", "mono", "pid",
                         "digest", "ticket"))
        lines.append(f"  {rec.get('unix', 0.0):.6f} "
                     f"{rec.get('event', '?'):<12s} {extra}")
    if export:
        lines.append(
            f"chrome trace: {trace.write_chrome_trace(export)}")
    return "\n".join(lines)


def top(run_dir: str, watch: float = 0.0, trace: bool = False,
        study: Optional[str] = None, serve_dir: Optional[str] = None,
        export: Optional[str] = None, out=None):
    """The fleet view over a run directory (``abc-top``): per-host
    throughput, the resilience ledger, the engine and the recent
    generations; with ``study``, one study's latency waterfall.
    ``watch`` > 0 redraws every ``watch`` seconds until interrupted."""
    from ..telemetry import aggregate

    out = out or sys.stdout
    if study:
        if serve_dir is None:
            serve_dir = os.environ.get("PYABC_TPU_SERVE_DIR",
                                       os.path.join(run_dir, "serve"))
        print(_render_study(serve_dir, study, export=export), file=out)
        return
    while True:
        if trace:
            path = aggregate.write_merged_trace(run_dir)
            print(f"merged trace: {path}", file=out)
        print(_render_top(run_dir), file=out)
        if not watch:
            return
        time.sleep(watch)
        print("\033[2J\033[H", end="", file=out)


def stop(run_dir: str) -> str:
    """Clean stop: every host's run exits after its current generation
    (the reference's ``abc-redis-manager stop``)."""
    from . import health
    health.request_stop(run_dir)
    return "stop requested"


def reset_workers(run_dir: str) -> str:
    """Clear stale heartbeats after a crash (the reference's
    ``reset-workers``)."""
    from . import health
    removed = health.reset_workers(run_dir)
    return f"removed {removed} stale worker record(s)"


def manage(argv: Optional[List[str]] = None) -> int:
    """The manager commands: ``info``, ``metrics``, ``top``, ``stop``,
    ``reset-workers``."""
    ap = argparse.ArgumentParser(prog="pyabc_tpu_torch.parallel.cli",
                                 description="Manage a distributed run.")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("info", help="worker health or this host's devices")
    p.add_argument("--run-dir", default=None)
    p = sub.add_parser("metrics", help="Prometheus text exposition")
    p.add_argument("--run-dir", default=None)
    p.add_argument("--fleet", action="store_true",
                   help="with --run-dir: the cross-host rollup")
    p = sub.add_parser("top", help="live fleet view over a run dir")
    p.add_argument("--run-dir", required=True)
    p.add_argument("--watch", type=float, default=0.0,
                   help="refresh every N seconds (0 = print once)")
    p.add_argument("--trace", action="store_true",
                   help="also write the merged fleet Chrome trace")
    p.add_argument("--study", default=None,
                   help="one study's trace: trace id, ticket id or digest")
    p.add_argument("--serve-dir", default=None,
                   help="serve root holding the trace log (default "
                        "<run-dir>/serve, or $PYABC_TPU_SERVE_DIR)")
    p.add_argument("--export", default=None,
                   help="with --study: write a Chrome-trace JSON here")
    p = sub.add_parser("stop", help="clean stop after this generation")
    p.add_argument("--run-dir", required=True)
    p = sub.add_parser("reset-workers", help="clear stale heartbeats")
    p.add_argument("--run-dir", required=True)
    args = ap.parse_args(argv)

    if args.command == "info":
        print(info(args.run_dir))
    elif args.command == "metrics":
        print(metrics(args.run_dir, args.fleet), end="")
    elif args.command == "top":
        top(args.run_dir, args.watch, args.trace, args.study,
            args.serve_dir, args.export)
    elif args.command == "stop":
        print(stop(args.run_dir))
    else:
        print(reset_workers(args.run_dir))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    """A manager command when the first argument names one, else the
    worker."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in MANAGER_COMMANDS:
        return manage(argv)
    return work(argv)


if __name__ == "__main__":
    sys.exit(main())
