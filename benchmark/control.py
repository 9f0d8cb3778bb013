"""The readings that the limits of ``correct`` are set from.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--dtype bfloat16] [--out <file.jsonl>]

For each seed, one inference of the cell at its own sizes, as the
window runs it; then every number its checks compare, for the port
(``program``), and the weights check again with the reference computed
in ``--dtype`` in the port's place (``control``: the precision below
the configuration's float32).  One JSON line a seed.  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import run as _run  # noqa: E402
import spec as _spec  # noqa: E402


def readings(bench, cell_name: str, seed: int, dtype: str,
             device: str = "cuda") -> dict:
    import torch

    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    builder = bench.builder(cfg)
    t0 = time.perf_counter()
    abc = builder.new_inference(cfg, mix, seed, device)
    abc.run(max_nr_populations=int(cfg["generations"]))
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summary = builder.summary(abc)
    out = builder.outputs(abc)
    del abc
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    program, control = {}, {}
    for name in cfg["checks_run"]:
        mod = bench.check(name)
        program.update(mod.compare(out, cfg, seed, device))
        if name == "weights":
            control.update(mod.compare(out, cfg, seed, device,
                                       control=getattr(torch, dtype)))
    return {"cell": cell_name, "seed": seed, "wall_s": wall,
            "summary": summary,
            "program": {k: v for k, (v, _) in program.items()},
            "control": {k: v for k, (v, _) in control.items()},
            "limits": {k: lim for k, (_, lim) in program.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    root = HERE.parent
    bench = _spec.Bench(root)
    _run.prepare_env(root)
    if str(root) not in sys.path:
        sys.path.insert(1, str(root))
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(_run._finite(readings(bench, args.workload, seed,
                                                 args.dtype)))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
