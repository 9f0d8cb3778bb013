"""Where the port's built device programs persist (opt-in relocation).

Port of ``pyabc_tpu/autotune/cache.py:33-69``.  The JAX package points
JAX's persistent XLA cache at a directory; the port's persistent store
of compiled device code is the hash-keyed ``nvcc`` output of
:mod:`..ops._build` (``BUILD_DIR``, default ``build/kernels/`` of the
checkout).  The directory is resolved as in the JAX package:

- ``ABCSMC(compile_cache="/path")`` wins;
- else ``$PYABC_TPU_COMPILE_CACHE``;
- else nothing changes and the kernels build into the default.

A relocated directory holds the same hash-named libraries; a kernel that
is already built there is loaded, not rebuilt.

The setting is process-wide, as the JAX package's cache directory is
(JAX's global config): ``BUILD_DIR`` is one module attribute, so the
last ``ABCSMC(compile_cache=...)`` constructed in a process decides where
every later kernel load of that process looks, and a later
``compile_cache=None`` leaves it where it is.  A worker that holds
several engines should give them all the same directory.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

logger = logging.getLogger("ABC.Autotune")

#: environment variable naming the persistent compile-cache directory
COMPILE_CACHE_ENV = "PYABC_TPU_COMPILE_CACHE"


def configure_compile_cache(path: Optional[str] = None) -> Optional[str]:
    """Point the kernel build directory at ``path`` (explicit argument,
    else ``$PYABC_TPU_COMPILE_CACHE``); returns the resolved directory,
    or ``None`` when neither names one (no-op)."""
    resolved = path if path is not None \
        else os.environ.get(COMPILE_CACHE_ENV)
    if not resolved:
        return None
    resolved = os.path.abspath(os.path.expanduser(str(resolved)))
    os.makedirs(resolved, exist_ok=True)
    from ..ops import _build
    _build.BUILD_DIR = Path(resolved)
    logger.info("kernel build cache: %s", resolved)
    return resolved
