"""CUDA wrapper for the weighted-KDE log-density kernel (K1).

Replaces the TPU kernel ``pyabc_tpu/ops/kde_pallas.py``
(``weighted_kde_logpdf_pallas`` and its ``_kernel``).  The wrapper does in
plain PyTorch what the Pallas wrapper does outside its kernel — the
weighted centre and the triangular whitening (:func:`.kde.whiten`) — then
hands ``z_x [M, d]``, ``z_s [N, d]`` and ``log_w [N]`` to the two
``__global__`` functions of ``csrc/kde_logpdf.cu``: a partial pass over
(query block, support split) and a merge of the splits.  The source says
what bounds the kernel (exp throughput, not bytes) and why the logit is
formed from coordinate differences.

On a CUDA tensor this launches the kernel or raises; it never falls back
to the plain version.  ``weighted_kde_logpdf_cuda.launches`` counts the
launches, so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .kde import _check_shapes, whiten

#: threads (= query rows) per block, and support rows per shared tile —
#: must match BLOCK / TILE in csrc/kde_logpdf.cu
BLOCK = 256
TILE = 256
#: largest dimension the kernel takes (MAX_D in the source)
MAX_D = 32
#: support rows one thread sums at most (bounds float32 sum error)
MAX_CHUNK = 4096
#: blocks to aim for: a few waves over the H100's 132 SMs
TARGET_BLOCKS = 132 * 8
_MAX_GRID_Y = 65535

_SIGNATURE = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
              + [ctypes.c_void_p] * 4)


def split_plan(m: int, n: int) -> Tuple[int, int]:
    """``(chunk, splits)``: support rows per split and the split count.

    Splits the support axis so that ``ceil(m / BLOCK) * splits`` blocks
    reach about ``TARGET_BLOCKS`` when the query count alone does not,
    caps each split at ``MAX_CHUNK`` rows, and rounds the chunk to whole
    tiles.  Pure integer arithmetic (tested on the CPU).
    """
    bx = max(1, -(-m // BLOCK))
    splits = max(1, -(-TARGET_BLOCKS // bx), -(-n // MAX_CHUNK))
    splits = min(splits, max(1, -(-n // TILE)))
    chunk = -(-(-(-n // splits)) // TILE) * TILE
    if -(-n // chunk) > _MAX_GRID_Y:
        chunk = -(-(-(-n // _MAX_GRID_Y)) // TILE) * TILE
    return chunk, -(-n // chunk)


def _lib() -> ctypes.CDLL:
    lib = _build.load("kde_logpdf")
    if lib.kde_logpdf_launch.argtypes is None:
        lib.kde_logpdf_launch.argtypes = _SIGNATURE
        lib.kde_logpdf_launch.restype = ctypes.c_int
        lib.kde_cuda_error_string.argtypes = [ctypes.c_int]
        lib.kde_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kde_logpdf_whitened(z_x: torch.Tensor, z_s: torch.Tensor,
                        log_w: torch.Tensor,
                        log_norm: torch.Tensor) -> torch.Tensor:
    """Launch the kernel pair on whitened inputs; returns ``[M]``.

    All inputs float32, contiguous, on one CUDA device; ``log_norm`` a
    one-element tensor.  Raises on anything the kernel does not take and
    on a failed launch.
    """
    tensors = (z_x, z_s, log_w, log_norm)
    dev = z_x.device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError("kde kernel inputs must share one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"kde kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kde kernel inputs must be contiguous")
    m, d = z_x.shape
    n = z_s.shape[0]
    if not 1 <= d <= MAX_D:
        raise ValueError(f"kde kernel takes 1 <= d <= {MAX_D}, got {d}")
    if z_s.shape[1] != d or log_w.shape != (n,) or log_norm.numel() != 1:
        raise ValueError("kde kernel input shapes disagree")
    if n == 0:
        raise ValueError("empty KDE support")
    if m >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError("kde kernel takes fewer than 2**31 rows")
    out = torch.empty(m, dtype=torch.float32, device=dev)
    if m == 0:
        return out
    chunk, splits = split_plan(m, n)
    pmax = torch.empty((splits, m), dtype=torch.float32, device=dev)
    psum = torch.empty((splits, m), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.kde_logpdf_launch(
            z_x.data_ptr(), z_s.data_ptr(), log_w.data_ptr(),
            log_norm.data_ptr(), m, n, d, chunk, splits,
            pmax.data_ptr(), psum.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("kde_logpdf kernel launch failed: "
                           + lib.kde_cuda_error_string(rc).decode())
    weighted_kde_logpdf_cuda.launches += 1
    return out


def weighted_kde_logpdf_cuda(x: torch.Tensor, support: torch.Tensor,
                             log_w: torch.Tensor, chol: torch.Tensor,
                             log_norm) -> torch.Tensor:
    """Same contract as :func:`.kde.weighted_kde_logpdf`, on the card."""
    _check_shapes(x, support, log_w, chol)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"weighted_kde_logpdf_cuda needs CUDA tensors, "
                         f"got {dev}")
    for t in (x, support, log_w, chol):
        if t.dtype != torch.float32:
            raise TypeError(f"kde inputs must be float32, got {t.dtype}")
    z_x, z_s = whiten(x, support, log_w, chol)
    ln = torch.as_tensor(log_norm, dtype=torch.float32,
                         device=dev).reshape(1).contiguous()
    return kde_logpdf_whitened(z_x, z_s, log_w.contiguous(), ln)


#: kernel launches on this process (reset by callers that count a run)
weighted_kde_logpdf_cuda.launches = 0


def bound_seconds(m: int, n: int, d: int, sm_clock_hz: float,
                  sms: int = 132) -> float:
    """Least time the card could take for ``m * n`` pairs: the larger of
    one ex2 per pair on 16 MUFU lanes per SM and ``d + 4`` FP32
    operations per pair on 128 lanes per SM, at the SM clock given."""
    pairs = float(m) * float(n)
    return max(pairs / (sms * 16 * sm_clock_hz),
               pairs * (d + 4) / (sms * 128 * sm_clock_hz))
