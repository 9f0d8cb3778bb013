"""Precision policies: the compute lanes and the at-rest carry.

Port of ``pyabc_tpu/ops/precision.py``.

**Compute lanes** (``$PYABC_TPU_PRECISION_LANES``): a per-component
policy, never a global cast — ABC acceptance is a threshold test, and a
distance on the wrong side of ε flips a particle.

- ``kde``: the plain KDE's cross product (:mod:`.kde`).  The ``bf16``
  lane forms it as the three-pass split product :func:`bf16x3_matmul`
  with float32 accumulation (logit error ~2^-20 of the exponent).  On
  the card every shape goes to K1 in float32 whatever the lane (the JAX
  package's accelerator kernel is the split already; K1's float32
  products are the more exact of the two).
- ``distance``: ``PNormDistance.compute`` rounds the weighted residual
  to bf16 (relative error 2^-8) and accumulates the norm in float32.

The value is ``f32`` (the default: every component exact), ``bf16``
(every component on its bf16 lane) or comma-separated
``component=mode`` pairs (``kde=bf16,distance=f32``).  It is resolved
once per process, at first use, and frozen: set it before the run is
built.  ``_reset_for_testing()`` drops the frozen policy.

**At-rest carry** (``$PYABC_TPU_CARRY_PRECISION``).  Between two generations of a fused
block or a one-dispatch run the population carry rests on the card; its
bulk lanes (``theta``, ``distance``, ``stats``) may rest narrowed and are
promoted back to float32 at the start of every generation, where the
accept, refit and resample window computes.

- ``f32`` (the default): the codec returns the same dict object, so a
  run computes exactly what it computed before the codec existed.
- ``bf16``: ``.to(torch.bfloat16)``, round to nearest even, as the JAX
  package's ``astype`` rounds.
- ``int8``: a per-column affine code (``_quantize_i8``) with float32
  scale and offset lanes ``<lane>_qs`` / ``<lane>_qm``, one value per
  column.
- ``auto``: the capacity planner (:mod:`..capacity.model`) resolves it
  to the widest mode whose plan fits the memory budget.

The model index ``m`` (int64 here), ``log_weight`` and every scalar or
mode lane (``count``, ``eps``, ``rate``, ``safety``, ``dist_w``, the
record and calibration rings) are never narrowed.  The mode is read per
call (``resolve_carry_precision``), never cached: it keys every engine
the orchestrator builds.
"""

from __future__ import annotations

import os
from functools import lru_cache

import torch

PRECISION_ENV = "PYABC_TPU_PRECISION_LANES"

#: components a policy may address
COMPONENTS = ("kde", "distance")
_MODES = ("f32", "bf16")

CARRY_PRECISION_ENV = "PYABC_TPU_CARRY_PRECISION"

#: at-rest modes; "auto" defers to the capacity planner
CARRY_MODES = ("f32", "bf16", "int8", "auto")

#: the carry lanes the codec narrows (population-sized bulk)
CARRY_COMPRESSED_LANES = ("theta", "distance", "stats")

#: bytes per element at rest, by mode (capacity model input)
CARRY_ITEMSIZE = {"f32": 4, "bf16": 2, "int8": 1}


def resolve_carry_precision(value=None) -> str:
    """The at-rest carry mode: ``value`` if given, else
    ``$PYABC_TPU_CARRY_PRECISION`` (default ``f32``); validated, never
    cached."""
    raw = (value if value is not None
           else os.environ.get(CARRY_PRECISION_ENV, "f32"))
    raw = str(raw).strip().lower()
    if raw not in CARRY_MODES:
        raise ValueError(
            f"{CARRY_PRECISION_ENV}={raw!r}: expected one of "
            f"{CARRY_MODES}")
    return raw


def _quantize_i8(x: torch.Tensor):
    """Per-column affine int8 code of a float array: ``(q[int8],
    scale[f32 cols], lo[f32 cols])`` with ``decode = (q + 127) * scale +
    lo``.

    Deterministic (``torch.round`` rounds half to even, as
    ``jnp.round``) and total: a non-finite entry takes the column's floor
    (the carry's non-finite rows lie past ``count`` and are masked
    downstream), and a column with no finite row gets ``lo = 0`` and
    scale 1e-30 so that its decode stays finite."""
    x = x.to(torch.float32)
    finite = torch.isfinite(x)
    big = torch.full_like(x, 3.4e38)
    lo = torch.where(finite, x, big).amin(0)
    hi = torch.where(finite, x, -big).amax(0)
    dead = lo > hi
    lo = torch.where(dead, torch.zeros_like(lo), lo)
    hi = torch.where(dead, torch.zeros_like(hi), hi)
    # a tensor divisor: a CUDA division by a host scalar multiplies by
    # its reciprocal, which rounds differently from the CPU and from XLA
    scale = torch.clamp((hi - lo) / torch.full_like(hi, 254.0), min=1e-30)
    xs = torch.where(finite, x, lo.expand_as(x))
    q = torch.clamp(torch.round((xs - lo) / scale), 0.0, 254.0) - 127.0
    return q.to(torch.int8), scale, lo


def encode_carry(carry: dict, mode: str) -> dict:
    """The carry with its bulk lanes narrowed to ``mode``.

    ``f32`` returns the same dict object.  Idempotent: a lane already at
    the target dtype passes through (a block's output re-enters the next
    block's seed narrowed).  ``int8`` adds the flat ``<lane>_qs`` /
    ``<lane>_qm`` float32 keys, one value per column."""
    if mode == "f32":
        return carry
    if mode not in ("bf16", "int8"):
        raise ValueError(f"encode_carry: bad mode {mode!r}")
    out = dict(carry)
    for k in CARRY_COMPRESSED_LANES:
        v = out.get(k)
        if v is None:
            continue
        if mode == "bf16":
            if v.dtype != torch.bfloat16:
                out[k] = v.to(torch.bfloat16)
        elif v.dtype != torch.int8:
            out[k], out[k + "_qs"], out[k + "_qm"] = _quantize_i8(v)
    return out


def decode_carry(carry: dict, mode: str) -> dict:
    """The carry with its bulk lanes promoted back to float32.  ``f32``
    is the identity (the same object); ``int8`` consumes and drops the
    aux keys; a lane already in float32 passes through."""
    if mode == "f32":
        return carry
    if mode not in ("bf16", "int8"):
        raise ValueError(f"decode_carry: bad mode {mode!r}")
    out = dict(carry)
    for k in CARRY_COMPRESSED_LANES:
        v = out.get(k)
        if v is None:
            continue
        if mode == "bf16":
            if v.dtype == torch.bfloat16:
                out[k] = v.to(torch.float32)
        elif v.dtype == torch.int8:
            scale = out.pop(k + "_qs")
            lo = out.pop(k + "_qm")
            out[k] = (v.to(torch.float32) + 127.0) * scale + lo
    return out


@lru_cache(maxsize=None)
def _resolve() -> dict:
    raw = os.environ.get(PRECISION_ENV, "f32").strip().lower()
    if raw in _MODES:
        return {c: raw for c in COMPONENTS}
    policy = {c: "f32" for c in COMPONENTS}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, mode = part.partition("=")
        key, mode = key.strip(), mode.strip()
        if not sep or key not in COMPONENTS or mode not in _MODES:
            raise ValueError(
                f"{PRECISION_ENV}={raw!r}: expected 'f32', 'bf16', or "
                f"comma-separated component=mode pairs with components "
                f"in {COMPONENTS} and modes in {_MODES}")
        policy[key] = mode
    return policy


def lanes(component: str) -> str:
    """The frozen precision mode ('f32' | 'bf16') for ``component``."""
    if component not in COMPONENTS:
        raise ValueError(f"unknown precision component {component!r}; "
                         f"expected one of {COMPONENTS}")
    return _resolve()[component]


def _reset_for_testing():
    """Drop the frozen policy so tests can exercise both lanes."""
    _resolve.cache_clear()


def split_bf16(a: torch.Tensor):
    """High/low bf16 split of a float32 tensor: ``hi + lo == a`` to
    about 2^-17 relative.  ``hi`` rounds to nearest even, as the JAX package's
    ``reduce_precision``; ``lo`` is the bf16 rounding of the remainder."""
    hi = a.to(torch.bfloat16)
    return hi, (a - hi.to(torch.float32)).to(torch.bfloat16)


def bf16x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as three products of bf16 parts accumulated in float32:
    ``ah·bh + ah·bl + al·bh``.  The dropped ``al·bl`` is O(2^-16)
    relative.  Each part is widened to float32 before its product, which
    is then exact, so only the accumulation rounds."""
    ah, al = split_bf16(a)
    bh, bl = split_bf16(b)
    f32 = torch.float32
    ah, al, bh, bl = (t.to(f32) for t in (ah, al, bh, bl))
    return ah @ bh + ah @ bl + al @ bh
