"""At-rest precision of a device engine's population carry.

Port of the ``CARRY_*`` policy and its codec from
``pyabc_tpu/ops/precision.py``.  Between two generations of a fused
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

Not ported (ROADMAP Queue 2): the ``PYABC_TPU_PRECISION_LANES`` compute
lanes and their bf16x3 product.
"""

from __future__ import annotations

import os

import torch

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
