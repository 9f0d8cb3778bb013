"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the port (``pyabc_tpu_torch``).  Set-up imports the port, builds its
kernels and runs one whole inference (every shape the window uses);
the window then runs whole inferences, each a fresh ``ABCSMC`` with a
fresh sampler on the run's seed, while the median of those already run
fits in what is left of ``--seconds``.  After the window the last
inference's results are compared with the plain reference
(``reference/``, through the configuration's checks), and the last line
of standard output is one JSON object.

``--trace 0`` reports the cell's end-to-end metrics: ``infer_s`` (the
window's seconds in whole inferences over their number), ``peak_mem_gb``
(``torch.cuda.max_memory_allocated`` over the window) and ``setup_s``
(process start to the window).  ``--trace 1`` profiles the window's
first inference with ``torch.profiler`` and reports the per-layer
metrics, each read by ``metrics/<name>.py``.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import spec as _spec  # noqa: E402
from devtrace import DeviceTrace, tracer_spans  # noqa: E402

#: top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "pyabc_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is one of
    ``FORBIDDEN`` (``pyabc_tpu_torch`` is not ``pyabc_tpu``)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def prepare_env(root: Path):
    """The port's settings at their defaults, whatever the caller's
    environment holds, and every cache of a library inside the
    checkout at a fixed path."""
    for key in [k for k in os.environ if k.startswith("PYABC_TPU_")]:
        del os.environ[key]
    os.environ["USE_FLAX"] = "0"
    cache = root / "build" / "pbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def _sync(torch, device: str):
    if device == "cuda":
        torch.cuda.synchronize()


def run_cell(bench: "_spec.Bench", cell_name: str, seed: int,
             seconds: float, trace: bool, device: str = "cuda") -> dict:
    """One run of ``cell_name``: set-up, window, check.  Returns the
    result object (``checks`` last) and what the run saw besides: the
    window's inferences, their seconds, and whether the warm-up's and
    every window inference's evaluations, rounds, paths and final ε
    repeat exactly.  ``device="cpu"`` drives the same steps without a
    card (the harness's tests)."""
    import torch

    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    builder = bench.builder(cfg)
    gens = int(cfg["generations"])
    from pyabc_tpu_torch.telemetry import spans as port_spans
    from pyabc_tpu_torch.telemetry.metrics import REGISTRY

    def infer():
        t0 = time.perf_counter()
        abc = builder.new_inference(cfg, mix, seed, device)
        abc.run(max_nr_populations=gens)
        _sync(torch, device)
        return abc, t0, time.perf_counter()

    # set-up: one whole inference at the cell's sizes
    warm, _, _ = infer()
    summaries = [builder.summary(warm)]
    del warm
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reg0 = REGISTRY.to_dict()
    t_window = time.perf_counter()
    setup_s = t_window - _T0
    deadline = t_window + seconds
    durations, timelines, last, traced = [], [], None, None
    attempted = failed = 0
    while True:
        tr = DeviceTrace(torch, device) if trace and traced is None else None
        attempted += 1
        try:
            if tr is not None:
                port_spans.TRACER.configure(enabled=True, capacity=1 << 17)
                with tr:
                    abc, t0, t1 = infer()
                port_spans.TRACER.configure(enabled=False)
                traced = (tr, tracer_spans(port_spans.TRACER)
                          + [("infer", t0, t1)], list(abc.timeline))
            else:
                abc, t0, t1 = infer()
        except Exception:  # a failed inference ends the window
            traceback.print_exc()
            failed += 1
            break
        durations.append(t1 - t0)
        timelines.append(list(abc.timeline))
        summaries.append(builder.summary(abc))
        if len(abc.timeline) != gens:
            failed += 1
            break
        last = abc
        del abc
        if statistics.median(durations) > deadline - time.perf_counter():
            break
        last = None
        gc.collect()
    peak = (torch.cuda.max_memory_allocated() if device == "cuda"
            else None)
    reg1 = REGISTRY.to_dict()

    numbers = {}
    if last is not None:
        out = builder.outputs(last)
        del last
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        for name in cfg["checks_run"]:
            numbers.update(bench.check(name).compare(out, cfg, seed,
                                                     device))
    repeat = all(s == summaries[0] for s in summaries)
    correct = (failed == 0 and bool(numbers)
               and all(v <= lim for v, lim in numbers.values()))

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": int(cell["chips"]),
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    breakdown = trace_s = None
    if not trace:
        values = {"infer_s": (sum(durations) / len(durations)
                              if durations else None),
                  "peak_mem_gb": peak / 1e9 if peak is not None else None,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench.end_to_end(cell_name)
                   if values.get(m["name"]) is not None}
    else:
        red = {}
        if traced is not None:
            tr, host, rows = traced
            mark = time.perf_counter()
            red = tr.reduce(host)
            red["profiled_rows"] = rows
            trace_s = (tr.stop_s, time.perf_counter() - mark)
        ctx = {"cell": cell, "config": cfg, "mix": mix,
               "timelines": timelines, "inferences": len(durations),
               "registry_delta": {k: reg1.get(k, 0) - reg0.get(k, 0)
                                  for k in reg1
                                  if isinstance(reg1.get(k), (int, float))},
               "trace": red}
        metrics = {}
        for m in bench.per_layer(cell_name):
            value = bench.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if "busy_s" in red:
            dev["busy_s"] = red["busy_s"]
            dev["window_s"] = red["window_s"]
        if "top_ops" in red:
            breakdown = {"device_ops": red["top_ops"],
                         "idle_gaps": red["idle_gaps"]}
    result["metrics"] = metrics
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in numbers.items()}
    info = {"inferences": len(durations), "durations_s": durations,
            "repeat": repeat, "summaries": summaries,
            "trace_s": trace_s}
    return result, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = HERE.parent
    bench = _spec.Bench(root)
    cell = bench.cell(args.workload)
    prepare_env(root)
    if str(root) not in sys.path:
        sys.path.insert(1, str(root))
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, info = run_cell(bench, args.workload, args.seed, args.seconds,
                            bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(f"window: {info['inferences']} inferences, seconds "
          f"{info['durations_s']}; repeat {info['repeat']}: "
          f"{info['summaries'][-1]}; profiler stop and reduction "
          f"seconds {info['trace_s']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result), allow_nan=False))
    return 0


def _finite(obj):
    """``obj`` with every float that JSON cannot hold (inf, nan) as its
    name in a string."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    return obj


if __name__ == "__main__":
    sys.exit(main())
