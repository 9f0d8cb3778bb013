"""CUDA wrapper for the weighted-KDE log-density kernel (K1).

Replaces the TPU kernel ``pyabc_tpu/ops/kde_pallas.py``
(``weighted_kde_logpdf_pallas`` and its ``_kernel``).  The whole function
runs on the card in the four ``__global__`` functions of
``csrc/kde_logpdf.cu``: the weighted centre and the scaled inverse
bandwidth factor (``kde_prep_kernel``), the base-2 packed support
(``kde_pack_kernel``), a partial pass over (query block, support split)
that whitens its queries as it loads them (``kde_partial_kernel``), and a
merge of the splits.  The wrapper checks its inputs, plans the grid,
allocates the output and one scratch buffer, and makes one ``ctypes``
call.  The source says what bounds the kernel (exp throughput, not bytes)
and why the logit is formed from coordinate differences.

On a CUDA tensor this launches the kernel or raises; it never falls back
to the plain version.  ``weighted_kde_logpdf_cuda.launches`` counts the
launches, so a run can show that its main path went through the kernel.
A call recorded into a CUDA graph launches nothing: the capture takes its
count back, and each replay of the graph counts it
(``autotune.ladder.register_launch_counter``), in ``launches`` and in
``weighted_kde_logpdf_cuda.graph_launches``.
:func:`base2_logpdf` repeats the kernel's arithmetic (base 2, prescaled
rows, sub-tiles, splits) in plain PyTorch, so that the CPU tests can hold
it against :func:`.kde.weighted_kde_logpdf`.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Tuple

import torch

from ..autotune.ladder import register_launch_counter
from . import _build
from .kde import NEG_BIG, _check_shapes

#: threads per block of the partial kernel (BLOCK in csrc/kde_logpdf.cu)
BLOCK = 128
#: support rows per split are a multiple of G (G in the source)
G = 16
#: largest dimension the kernel takes (MAX_D in the source)
MAX_D = 32
#: support rows one thread sums at most (bounds float32 sum error)
MAX_CHUNK = 4096
#: fewest support rows a split is cut to (a block's fixed costs — the
#: bulk copy's latency, its query loads — need rows to hide behind)
MIN_CHUNK = 256
#: shared memory one block's staged split may take
SMEM_BYTES = 48 * 1024
#: blocks to aim for: a few waves over the H100's 132 SMs
TARGET_BLOCKS = 132 * 8
_MAX_GRID_Y = 65535
#: floats of the params buffer: centre [MAX_D] and A [d * d]
PARAMS_FLOATS = MAX_D + MAX_D * MAX_D
#: log2(e), sqrt(log2(e) / 2) and the filler-row logit, as in the source
LOG2E = 1.4426950408889634
HALF_LOG2E_SQRT = 0.8493218002880191
NEVER = -3e38
#: ex2_fma's polynomial for 2^f on [-0.5, 0.5], lowest order first
EXP2_POLY = (1.0000001192092896, 0.6931469440460205, 0.24022120237350464,
             0.05550713092088699, 0.009675541892647743,
             0.0013276472454890609)
#: FP32-rate instructions of one ex2_fma: max, 3 adds, 5 FMAs, 2 integer
EXP2_FMA_COST = 11
_EXP2_SHIFT = 12582912.0  # 1.5 * 2^23

_SIGNATURE = ([ctypes.c_void_p] * 5 + [ctypes.c_float] + [ctypes.c_int] * 5
              + [ctypes.c_void_p] * 6)


def geometry(d: int) -> Tuple[int, int, int, int]:
    """``(P, Q, K, E)`` for dimension ``d``: floats per packed support row,
    query rows per thread, support rows per sub-tile and exps per sub-tile
    on the FMA pipe — the source's ``Geometry<D>`` (fixed templates for
    d <= 8, the generic path above)."""
    if not 1 <= d <= MAX_D:
        raise ValueError(f"kde kernel takes 1 <= d <= {MAX_D}, got {d}")
    if d == 1:
        return 2, 4, 8, 1
    if d <= 8:
        return -(-(d + 1) // 4) * 4, 4, 8, int(d <= 2)
    return d + 1, 2, 4, 0


def split_plan(m: int, n: int, d: int = 1) -> Tuple[int, int]:
    """``(chunk, splits)``: support rows per split and the split count.

    Splits the support axis so that ``ceil(m / (BLOCK * Q)) * splits``
    blocks reach about ``TARGET_BLOCKS`` when the query blocks alone do
    not (but cuts no split below ``MIN_CHUNK`` rows), caps a split at
    ``MAX_CHUNK`` rows and at what fits in ``SMEM_BYTES`` of shared memory
    (the kernel stages a whole split), and rounds the chunk to a multiple
    of ``G``.  Pure integer arithmetic
    (tested on the CPU).
    """
    p, q, _, _ = geometry(d)
    cap = min(MAX_CHUNK, SMEM_BYTES // (4 * p)) // G * G
    if -(-n // cap) > _MAX_GRID_Y:
        raise ValueError(f"kde kernel takes at most {_MAX_GRID_Y * cap} "
                         f"support rows at d = {d}, got {n}")
    bx = max(1, -(-m // (BLOCK * q)))
    splits = max(1, -(-TARGET_BLOCKS // bx), -(-n // cap))
    splits = min(splits, max(1, -(-n // MIN_CHUNK), -(-n // cap)))
    chunk = -(-(-(-n // splits)) // G) * G
    return chunk, -(-n // chunk)


#: guards the signature set-up and the launch count (host samplers launch
#: from pool threads)
_LOCK = threading.Lock()


def _lib() -> ctypes.CDLL:
    lib = _build.load("kde_logpdf")
    if lib.kde_logpdf_launch.argtypes is None:
        with _LOCK:
            lib.kde_cuda_error_string.argtypes = [ctypes.c_int]
            lib.kde_cuda_error_string.restype = ctypes.c_char_p
            lib.kde_logpdf_launch.restype = ctypes.c_int
            lib.kde_logpdf_launch.argtypes = _SIGNATURE
    return lib


class KdeCall:
    """One call's checked inputs, grid plan and scratch.  :meth:`run`
    launches the kernels; building the call once and running it many
    times times the kernels without the wrapper's own work."""

    def __init__(self, x: torch.Tensor, support: torch.Tensor,
                 log_w: torch.Tensor, chol: torch.Tensor, log_norm):
        _check_shapes(x, support, log_w, chol)
        dev = x.device
        if dev.type != "cuda":
            raise ValueError(f"weighted_kde_logpdf_cuda needs CUDA tensors, "
                             f"got {dev}")
        for t in (x, support, log_w, chol):
            if t.device != dev:
                raise ValueError("kde kernel inputs must share one CUDA "
                                 "device")
            if t.dtype != torch.float32:
                raise TypeError(f"kde inputs must be float32, got {t.dtype}")
        m, d = x.shape
        n = support.shape[0]
        if not 1 <= d <= MAX_D:
            raise ValueError(f"kde kernel takes 1 <= d <= {MAX_D}, got {d}")
        if m >= 2 ** 31 or n >= 2 ** 31:
            raise ValueError("kde kernel takes fewer than 2**31 rows")
        if isinstance(log_norm, torch.Tensor):
            if log_norm.numel() != 1 or log_norm.device != dev:
                raise ValueError("log_norm must be one value on the "
                                 "inputs' device")
            self._log_norm = log_norm.to(torch.float32).reshape(1)
            ln_ptr, ln_val = self._log_norm.data_ptr(), 0.0
        else:
            ln_ptr, ln_val = None, float(log_norm)
        self.m, self.n, self.d = m, n, d
        self.chunk, self.splits = split_plan(m, n, d)
        p = geometry(d)[0]
        n_pad = -(-n // G) * G
        self._inputs = [t.contiguous() for t in (x, support, log_w, chol)]
        self.out = torch.empty(m, dtype=torch.float32, device=dev)
        self._scratch = torch.empty(
            PARAMS_FLOATS + n_pad * p + 2 * self.splits * m,
            dtype=torch.float32, device=dev)
        base = self._scratch.data_ptr()
        f = 4  # bytes per float; PARAMS_FLOATS * 4 keeps `packed` 16-aligned
        packed = base + PARAMS_FLOATS * f
        pmax = packed + n_pad * p * f
        psum = pmax + self.splits * m * f
        self.device = dev
        self._args = ([t.data_ptr() for t in self._inputs]
                      + [ln_ptr, ln_val, m, n, d, self.chunk, self.splits,
                         base, packed, pmax, psum, self.out.data_ptr()])

    def run(self) -> torch.Tensor:
        """Launch prep, pack, partial and merge on the current stream;
        returns ``[M]``.  Raises on a failed launch."""
        if self.m == 0:
            return self.out
        lib = _lib()
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            rc = lib.kde_logpdf_launch(*self._args, stream)
        if rc != 0:
            raise RuntimeError("kde_logpdf kernel launch failed: "
                               + lib.kde_cuda_error_string(rc).decode())
        with _LOCK:
            weighted_kde_logpdf_cuda.launches += 1
        return self.out


def weighted_kde_logpdf_cuda(x: torch.Tensor, support: torch.Tensor,
                             log_w: torch.Tensor, chol: torch.Tensor,
                             log_norm) -> torch.Tensor:
    """Same contract as :func:`.kde.weighted_kde_logpdf`, on the card."""
    return KdeCall(x, support, log_w, chol, log_norm).run()


#: kernel launches on this process (reset by callers that count a run)
weighted_kde_logpdf_cuda.launches = 0
#: of those, the launches made by replays of captured graphs
weighted_kde_logpdf_cuda.graph_launches = 0


def _add_launches(n: int, replayed: bool):
    with _LOCK:
        weighted_kde_logpdf_cuda.launches += n
        if replayed:
            weighted_kde_logpdf_cuda.graph_launches += n


register_launch_counter("kde_logpdf",
                        lambda: weighted_kde_logpdf_cuda.launches,
                        _add_launches)


def exp2_fma(x: torch.Tensor) -> torch.Tensor:
    """The kernel's ``ex2_fma`` in float32 PyTorch with its constants and
    steps (each FMA as a multiply and an add): round ``x`` (clamped at
    -126) to the nearest integer j by the 1.5 * 2^23 shift, evaluate the
    polynomial at f = x - j, add j to the exponent bits."""
    x = torch.clamp(x.to(torch.float32), min=-126.0)
    t = x + _EXP2_SHIFT
    f = x - (t - _EXP2_SHIFT)
    p = torch.full_like(f, EXP2_POLY[-1])
    for c in EXP2_POLY[-2::-1]:
        p = p * f + c
    bits = p.view(torch.int32) + (t.view(torch.int32) << 23)
    return bits.view(torch.float32)


def base2_logpdf(x: torch.Tensor, support: torch.Tensor, log_w: torch.Tensor,
                 chol: torch.Tensor, log_norm) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (any device, float32).

    Centre and ``A = sqrt(log2 e / 2) L^-1`` as ``kde_prep_kernel``; rows
    packed as ``(A (s - c), log_w log2 e)`` and padded with ``NEVER``
    fillers to a multiple of ``G``; each split of :func:`split_plan`
    walked in sub-tiles of ``K`` rows with one max and one rescale per
    sub-tile, starting from ``NEG_BIG log2 e``, the last ``E`` exps of a
    sub-tile by :func:`exp2_fma`; the splits merged and converted back
    with one multiply by ln 2.
    """
    _check_shapes(x, support, log_w, chol)
    m, d = x.shape
    n = support.shape[0]
    _, _, k_rows, n_fma = geometry(d)
    chunk, splits = split_plan(m, n, d)
    center = torch.softmax(log_w, 0) @ support
    eye = torch.eye(d, dtype=chol.dtype, device=chol.device)
    a = HALF_LOG2E_SQRT * torch.linalg.solve_triangular(chol, eye,
                                                        upper=False)
    n_pad = -(-n // G) * G
    zs = torch.zeros(n_pad, d, dtype=torch.float32, device=x.device)
    ws = torch.full((n_pad,), NEVER, dtype=torch.float32, device=x.device)
    zs[:n] = (support - center) @ a.T
    ws[:n] = log_w * LOG2E
    zq = (x - center) @ a.T
    neg_big2 = torch.tensor(NEG_BIG, dtype=torch.float32) * LOG2E
    pmax = torch.empty(splits, m, dtype=torch.float32, device=x.device)
    psum = torch.empty(splits, m, dtype=torch.float32, device=x.device)
    for s in range(splits):
        j0 = s * chunk
        j1 = j0 + -(-min(chunk, n - j0) // G) * G
        mx = torch.full((m,), float(neg_big2), dtype=torch.float32,
                        device=x.device)
        sm = torch.zeros(m, dtype=torch.float32, device=x.device)
        for r0 in range(j0, j1, k_rows):
            diff = zq[:, None, :] - zs[None, r0:r0 + k_rows, :]
            logit = ws[None, r0:r0 + k_rows] - (diff * diff).sum(-1)
            mn = torch.maximum(mx, logit.max(1).values)
            arg = logit - mn[:, None]
            e = torch.exp2(arg)
            if n_fma:
                e[:, k_rows - n_fma:] = exp2_fma(arg[:, k_rows - n_fma:])
            sm = sm * torch.exp2(mx - mn) + e.sum(1)
            mx = mn
        pmax[s], psum[s] = mx, sm
    top = torch.maximum(pmax.max(0).values, neg_big2.to(x.device))
    tot = (psum * torch.exp2(pmax - top)).sum(0)
    return (top + torch.log2(tot)) * math.log(2.0) + log_norm


def bound_seconds(m: int, n: int, d: int, sm_clock_hz: float,
                  sms: int = 132) -> float:
    """Least time the card could take for ``m * n`` pairs, with both pipes
    computing exps: a share phi of them on the FMA pipe at
    ``EXP2_FMA_COST`` FP32 operations each, the rest on 16 MUFU lanes per
    SM, besides ``d + 4`` FP32 operations per pair on 128 lanes per SM —
    ``min over phi of max((1 - phi) / 16, (d + 4 + phi c) / 128)`` per
    pair and SM clock.  The two terms meet at phi = (4 - d) / (8 + c);
    from d = 4 on FP32 issue alone bounds it (phi = 0)."""
    c = EXP2_FMA_COST
    phi = max(0.0, (4.0 - d) / (8.0 + c))
    per_pair = max((1.0 - phi) / 16.0, (d + 4.0 + phi * c) / 128.0)
    return float(m) * float(n) * per_pair / (sms * sm_clock_hz)
