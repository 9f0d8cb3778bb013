"""SGE config from ``~/.parallel`` INI (parity: pyabc/sge/config.py:6-31)."""

from __future__ import annotations

import configparser
import os


def get_config() -> dict:
    cfg = {
        "DIRECTORIES": {"TMP": os.environ.get("TMPDIR", "/tmp")},
        "BROKER": {"TYPE": "SQLITE"},
        "SGE": {"QUEUE": "p.openmp", "PARALLEL_ENVIRONMENT": "openmp",
                "PRIORITY": "-500"},
    }
    path = os.path.expanduser("~/.parallel")
    if os.path.exists(path):
        parser = configparser.ConfigParser()
        parser.read(path)
        for section in parser.sections():
            cfg.setdefault(section, {}).update(
                {k.upper(): v for k, v in parser[section].items()})
    return cfg
