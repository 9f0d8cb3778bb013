"""Weighted Gaussian-KDE log-density — the plain PyTorch version and the
dispatching entry point.

For M query points against an N-point weighted Gaussian KDE with
covariance ``chol @ chol.T``,

    log p(x_i) = log Σ_j exp(log w_j − ½‖z_i − z_j‖²) + log_norm

over whitened coordinates ``z = chol⁻¹ (· − center)``, with ``center``
the weighted support mean (zero-mass pad rows then cannot move the
whitening origin, so padding is exactly neutral).  The support axis is
streamed in blocks with a running (max, sum) logsumexp, so the [M, N]
logit matrix never exists whole.

:func:`weighted_kde_logpdf` is the plain version: the CPU path, and the
reference the CUDA kernel (:mod:`.kde_cuda`) is held against on the card.
It forms each logit from the coordinate DIFFERENCE rather than the
expansion ``−½‖z_i‖² + z_i·z_j − ½‖z_j‖²`` the JAX package feeds its
matrix unit: in float32 that expansion cancels at |z| of a few tens
(½z² ≈ 1e3 carries an ulp of 1.2e-4), which is the whitened range of a
pop-1e6 posterior.  The difference form costs one subtraction per
dimension and is exact to float32 rounding of the result.

:func:`weighted_kde_logpdf_auto` sends a CUDA tensor to the kernel,
always, and a CPU tensor to the plain version.  There is no size rule:
the JAX package's rule was measured on another machine.
"""

from __future__ import annotations

import torch

#: queries per block and support rows per streamed block (plain version)
QUERY_BLOCK = 2048
SUPPORT_BLOCK = 8192

#: initial running max; pad rows carry log_w = NEG_BIG (see kde_cuda.py)
NEG_BIG = -1e30


def whiten(x: torch.Tensor, support: torch.Tensor, log_w: torch.Tensor,
           chol: torch.Tensor):
    """``(z_x [M, d], z_s [N, d])``: both point sets centred on the
    weighted support mean ``softmax(log_w) @ support`` and whitened by the
    lower-triangular ``chol`` — float32, contiguous."""
    center = torch.softmax(log_w, dim=0) @ support
    z_x = torch.linalg.solve_triangular(chol, (x - center).T, upper=False).T
    z_s = torch.linalg.solve_triangular(
        chol, (support - center).T, upper=False).T
    return z_x.contiguous(), z_s.contiguous()


def _check_shapes(x, support, log_w, chol):
    if x.dim() != 2 or support.dim() != 2 or log_w.dim() != 1:
        raise ValueError("expected x [M, d], support [N, d], log_w [N]")
    d = x.shape[1]
    if support.shape[1] != d or tuple(chol.shape) != (d, d):
        raise ValueError(
            f"dimension mismatch: x {tuple(x.shape)}, support "
            f"{tuple(support.shape)}, chol {tuple(chol.shape)}")
    if support.shape[0] != log_w.shape[0]:
        raise ValueError("support and log_w disagree on N")
    if support.shape[0] == 0:
        raise ValueError("empty KDE support")


def weighted_kde_logpdf(x: torch.Tensor, support: torch.Tensor,
                        log_w: torch.Tensor, chol: torch.Tensor, log_norm,
                        query_block: int = QUERY_BLOCK,
                        support_block: int = SUPPORT_BLOCK) -> torch.Tensor:
    """log Σ_j exp(log_w_j) N(x_i; X_j, chol cholᵀ) for every row of x —
    plain PyTorch, streamed over support blocks, float32.

    x: [M, d]; support: [N, d]; log_w: [N]; chol: [d, d] lower;
    log_norm: scalar −d/2·log 2π − Σ log chol_kk.
    """
    _check_shapes(x, support, log_w, chol)
    z_x, z_s = whiten(x, support, log_w, chol)
    m, d = z_x.shape
    n = z_s.shape[0]
    out = torch.empty(m, dtype=torch.float32, device=x.device)
    for q0 in range(0, m, query_block):
        zq = z_x[q0:q0 + query_block]
        q = zq.shape[0]
        mx = torch.full((q,), NEG_BIG, dtype=torch.float32, device=x.device)
        sm = torch.zeros(q, dtype=torch.float32, device=x.device)
        for s0 in range(0, n, support_block):
            zb = z_s[s0:s0 + support_block]
            sq = torch.zeros(q, zb.shape[0], dtype=torch.float32,
                             device=x.device)
            for k in range(d):
                diff = zq[:, k, None] - zb[None, :, k]
                sq.addcmul_(diff, diff)
            logits = log_w[s0:s0 + support_block][None, :] - 0.5 * sq
            new_mx = torch.maximum(mx, logits.max(dim=1).values)
            sm = (sm * torch.exp(mx - new_mx)
                  + torch.exp(logits - new_mx[:, None]).sum(dim=1))
            mx = new_mx
        out[q0:q0 + q] = mx + torch.log(sm)
    return out + log_norm


def weighted_kde_logpdf_auto(x: torch.Tensor, support: torch.Tensor,
                             log_w: torch.Tensor, chol: torch.Tensor,
                             log_norm) -> torch.Tensor:
    """The KDE log-density on the inputs' device: the CUDA kernel for a
    CUDA tensor (it launches or raises — never a fallback), the plain
    version for a CPU tensor."""
    if x.device.type == "cuda":
        from .kde_cuda import weighted_kde_logpdf_cuda
        return weighted_kde_logpdf_cuda(x, support, log_w, chol, log_norm)
    if x.device.type == "cpu":
        return weighted_kde_logpdf(x, support, log_w, chol, log_norm)
    raise ValueError(f"no weighted-KDE path for device {x.device}")
