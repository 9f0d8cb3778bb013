"""Nothing the benchmark runs loads JAX or the JAX package: module
names are compared by their top-level part, whole, so the port
(``pyabc_tpu_torch``) is not the JAX package (``pyabc_tpu``)."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pyabc_tpu"}

_RUN = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
{body}
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _top_level(body: str) -> set:
    code = _RUN.format(bench=str(BENCH), root=str(ROOT), body=body)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT,
                          env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    body = """
import tempfile, shutil, pathlib, json
import run, spec
tmp = pathlib.Path(tempfile.mkdtemp())
shutil.copy(pathlib.Path({root!r}) / "BENCHMARK.json", tmp)
shutil.copytree({bench!r}, tmp / "benchmark")
for p in (tmp / "benchmark" / "configs").glob("*.json"):
    c = json.loads(p.read_text()); c["generations"] = 2
    c["sampler"] = {{"min_batch_size": 2048, "max_batch_size": 2048}}
    p.write_text(json.dumps(c))
for p in (tmp / "benchmark" / "traffic").glob("*.json"):
    m = json.loads(p.read_text()); m["population_size"] = 500
    p.write_text(json.dumps(m))
b = spec.Bench(tmp, home=tmp / "benchmark")
try:
    for cell in ("gmm2.seq1e6", "sir.seq1e6"):
        run.run_cell(b, cell, 1, 0.1, True, device="cpu")
finally:
    shutil.rmtree(tmp)
assert run.forbidden_modules() == []
""".format(root=str(ROOT), bench=str(BENCH))
    mods = _top_level(body)
    assert "pyabc_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_the_reference_loads_neither_jax_nor_the_port():
    body = """
import importlib, pathlib
for p in sorted(pathlib.Path({bench!r}, "reference").glob("*.py")):
    importlib.import_module("reference." + p.stem if p.stem != "__init__"
                            else "reference")
import spec
b = spec.Bench(pathlib.Path({root!r}))
for name in ("accept", "weights", "two_gaussians", "posterior_gate"):
    b.check(name)
""".format(root=str(ROOT), bench=str(BENCH))
    mods = _top_level(body)
    assert not mods & (FORBIDDEN | {"pyabc_tpu_torch"})


def test_forbidden_names_compare_whole():
    import run

    sys.modules.setdefault("pyabc_tpu_torch_lookalike", sys)
    try:
        assert "pyabc_tpu" not in run.forbidden_modules()
    finally:
        sys.modules.pop("pyabc_tpu_torch_lookalike", None)
