"""Terminal progress bar for per-generation sampling.

The port's copy of ``pyabc_tpu/utils/progress.py``.  One bar tracks
``n_accepted / n`` per generation; updates are in-place ``\\r`` writes to
stderr when attached to a TTY and plain log-style lines otherwise (CI
logs stay readable).  The bar only formats counts it is given: it reads
nothing from the card.
"""

from __future__ import annotations

import sys
import time


class ProgressBar:
    """``bar = ProgressBar(n, 't=3'); bar.update(k); bar.finish()``."""

    def __init__(self, total: int, desc: str = "", width: int = 30,
                 stream=None, min_interval_s: float = 0.1):
        self.total = max(int(total), 1)
        self.desc = desc
        self.width = width
        self.stream = stream if stream is not None else sys.stderr
        self.min_interval_s = min_interval_s
        self._last_render = 0.0
        self._done = 0
        self._isatty = bool(getattr(self.stream, "isatty", lambda: False)())
        self._finished = False

    def update(self, done: int):
        """Set absolute progress (monotone; clamped to total)."""
        self._done = min(int(done), self.total)
        now = time.monotonic()
        if now - self._last_render < self.min_interval_s \
                and self._done < self.total:
            return
        self._last_render = now
        self._render(end="")

    def _render(self, end: str):
        frac = self._done / self.total
        filled = int(frac * self.width)
        bar = "█" * filled + "░" * (self.width - filled)
        line = (f"{self.desc + ' ' if self.desc else ''}"
                f"|{bar}| {self._done}/{self.total} ({frac:4.0%})")
        if self._isatty:
            self.stream.write("\r" + line + end)
        else:
            self.stream.write(line + "\n")
        self.stream.flush()

    def finish(self):
        if self._finished:
            return
        self._finished = True
        if self._isatty:
            self._render(end="\n")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
