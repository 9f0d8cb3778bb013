"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library with
a plain C interface (no PyTorch headers: a build takes seconds, not
minutes) and loaded with :mod:`ctypes`.  Builds happen at first use, on
the machine with the card, into ``build/kernels/`` of the checkout; the
file name carries a hash of the source and the flags, so an edited source
is rebuilt and an unchanged one is reused.  A failed build raises with
nvcc's own error output.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: kernel library name -> CUDA source in csrc/
SOURCES: Dict[str, str] = {"kde_logpdf": "kde_logpdf.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
#: one build or load at a time: a host sampler's pool threads may reach
#: a kernel's first call together
_LOAD_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``; raises when the CUDA toolkit is missing."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def library_path(name: str) -> Path:
    """Where ``name``'s library lands, keyed by source and flag hash."""
    src = CSRC_DIR / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named kernel (default: all) that is not built yet,
    one ``nvcc`` process per source, all started together.

    Returns ``{name: {"seconds": s, "path": str, "ptxas": log}}`` for the
    libraries built by this call.  Raises ``RuntimeError`` with nvcc's
    stderr when any build fails.
    """
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        started[name] = (proc, tmp, target, time.perf_counter())
    built = {}
    failures = []
    for name, (proc, tmp, target, t0) in started.items():
        out, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {SOURCES[name]} "
                            f"(exit {proc.returncode}):\n{err}{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, target)
        built[name] = {"seconds": seconds, "path": str(target),
                       "ptxas": err.strip()}
    if failures:
        raise RuntimeError("\n".join(failures))
    return built


def _kernel_name(mangled: str) -> str:
    """``kde_partial_kernel<1,1>`` from ``_Z18kde_partial_kernelILi1ELb1EE…``
    (template arguments that are integers or booleans); else as given."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    start = m.end()
    name = mangled[start:start + int(m.group(1))]
    rest = mangled[start + int(m.group(1)):]
    if rest.startswith("I"):
        args = re.findall(r"L[ib](\d+)E", rest[:rest.find("EE") + 2])
        name += "<" + ",".join(args) + ">"
    return name


def ptxas_report(log: str) -> List[dict]:
    """Per ``__global__`` function: registers, stack frame and spill
    bytes and static shared memory, parsed from ``nvcc -Xptxas -v``
    output."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"function": _kernel_name(m.group(1)), "registers": None,
                   "stack": None, "spill_stores": None, "spill_loads": None,
                   "smem": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", line)
        if m:
            cur["stack"] = int(m.group(1))
            cur["spill_stores"] = int(m.group(2))
            cur["spill_loads"] = int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return rows


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                path = library_path(name)
                if not path.exists():
                    build_all([name])
                lib = ctypes.CDLL(str(path))
                _LOADED[name] = lib
    return lib
