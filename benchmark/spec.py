"""Everything the harness knows of a cell, found by name.

``BENCHMARK.json`` at the checkout's root names the cells; a cell names a
configuration (``benchmark/configs/<config>.json``, whose ``builder``
names a module ``benchmark/configs/<builder>.py``) and a traffic mix
(``benchmark/traffic/<mix>.json``).  Each per-layer metric is a reader
``benchmark/metrics/<metric>.py`` and each check a module
``benchmark/checks/<check>.py``.  A new cell, configuration, mix, metric
or check is new files and new entries: no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

#: the harness's own folder
HERE = Path(__file__).resolve().parent


class SpecError(ValueError):
    """A name that ``BENCHMARK.json`` or the harness's folders lack."""


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """The Python file at ``path`` as a module of its own (not imported
    into ``sys.modules`` under a package name)."""
    if not path.is_file():
        raise SpecError(f"no file {path}")
    name = "pbench_" + "_".join(path.with_suffix("").parts[-2:])
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` and the files it names.  ``root`` holds
    ``BENCHMARK.json``; ``home`` is the harness's folder (the default is
    this file's, a test gives a copy)."""

    def __init__(self, root: Path, home: Path = HERE):
        self.root = Path(root)
        self.home = Path(home)
        self.doc = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                cfg = load_json(self.root / c["file"])
                cfg.setdefault("name", name)
                return cfg
        raise SpecError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        path = self.home / "traffic" / f"{name}.json"
        if not path.is_file():
            raise SpecError(f"no traffic mix {path}")
        mix = load_json(path)
        mix.setdefault("name", name)
        return mix

    def builder(self, cfg: dict) -> ModuleType:
        return load_module(self.home / "configs" / f"{cfg['builder']}.py")

    def check(self, name: str) -> ModuleType:
        return load_module(self.home / "checks" / f"{name}.py")

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.doc["end_to_end"] if _covers(m, cell)]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics reported in ``cell``: those that list it,
        and those without a ``workloads`` key whose end-to-end metric the
        cell reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.doc["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.home / "metrics" / f"{metric}.py")


def _covers(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]
