"""Web viewer for History databases and a run in flight (port of
``pyabc_tpu/visserver/``)."""

from .server import run_app

__all__ = ["run_app"]
