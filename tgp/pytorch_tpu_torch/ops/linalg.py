"""Batched dense linear algebra (counterpart of `ops/linalg.py`).

Cholesky factorisations and triangular solves are `torch.linalg` (cuSOLVER
and cuBLAS on the card, LAPACK on the CPU), as the JAX package left them to
XLA.  All functions take arbitrary leading batch dimensions.  `kl_gaussian`
(the whiten=False KL) waits for ROADMAP Queue 1 item 18.
"""

from __future__ import annotations

import torch

from .. import config as cfg


def _eye(M, A):
    return torch.eye(M, dtype=A.dtype, device=A.device)


def _default_jitter(A):
    """Default jitter per matrix, shaped (..., 1, 1): the absolute base
    (1e-8) in fp64; the scale-aware max(10 * base * mean(diag A), base) in
    fp32."""
    base = cfg.jitter_value(A.dtype)
    if A.dtype != torch.float32:
        return torch.full(A.shape[:-2] + (1, 1), base, dtype=A.dtype,
                          device=A.device)
    mean_diag = torch.mean(torch.diagonal(A, dim1=-2, dim2=-1),
                           dim=-1)[..., None, None]
    return torch.clamp_min(10.0 * base * mean_diag, base)


def add_jitter(A, jitter: float | None = None):
    """A + jitter * I on the trailing two dims (`_default_jitter` if None)."""
    j = _default_jitter(A) if jitter is None else jitter
    return A + j * _eye(A.shape[-1], A)


def safe_cholesky(A, jitter: float | None = None):
    """Lower Cholesky with an escalating jitter ladder (x1, x10, x100).

    The ladder is evaluated as three factorisations outside the autograd
    graph and the first rung that factorises is selected per batch element.
    JAX tests the rung with isfinite(cholesky(...)) because it NaN-fills a
    failed factorisation; `torch.linalg.cholesky_ex` reports `info` instead,
    so the rung is selected on info == 0.  The selection stays on the device
    (`torch.where`): no host sync per request.  One differentiable Cholesky
    then runs at the chosen jitter, or at `jitter` when it is given (no
    ladder then).

    Returns (L, A_jittered).
    """
    eye = _eye(A.shape[-1], A)
    if jitter is not None:
        jit_sel = jitter
    else:
        with torch.no_grad():
            j0 = _default_jitter(A)
            ok1 = torch.linalg.cholesky_ex(A + j0 * eye).info == 0
            ok2 = torch.linalg.cholesky_ex(A + 10.0 * j0 * eye).info == 0
            jit_sel = torch.where(ok1[..., None, None], j0,
                                  torch.where(ok2[..., None, None], 10.0 * j0,
                                              100.0 * j0))
    Aj = A + jit_sel * eye
    # cholesky_ex, not cholesky: the latter checks `info` on the host.  A
    # factor that fails (even at 100x) is NaN-filled, as JAX's is.
    L, info = torch.linalg.cholesky_ex(Aj)
    L = torch.where((info == 0)[..., None, None], L,
                    torch.full((), float("nan"), dtype=L.dtype, device=L.device))
    return L, Aj


def tril_solve(L, B):
    """Solve L X = B with L lower-triangular (batched)."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def triu_solve(U, B):
    """Solve U X = B with U upper-triangular (batched)."""
    return torch.linalg.solve_triangular(U, B, upper=True)


def cholesky_solve(L, B):
    """Solve A X = B given A = L L^T (batched)."""
    return torch.cholesky_solve(B, L, upper=False)


def tril_mask(L):
    """Zero the strictly-upper triangle."""
    return torch.tril(L)


def kl_whitened(m, L_raw):
    """KL( N(m, S) || N(0, I) ) with S = tril(L_raw) tril(L_raw)^T:
        0.5 * ( -log|S| + m^T m + tr(S) - M ).

    m is (..., M), L_raw (..., M, M) with its lower triangle used; returns
    (...,).  The raw scale's diagonal is unconstrained, so a floor inside the
    log (1e-30 in fp64, 1e-12 otherwise) keeps a zero crossing from making
    the log-determinant -inf and its gradient 1/0.
    """
    L = tril_mask(L_raw)
    M = m.shape[-1]
    eps = 1e-30 if L.dtype == torch.float64 else 1e-12
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    log_det = torch.sum(torch.log(torch.square(diag) + eps), dim=-1)
    dot_mean = torch.sum(torch.square(m), dim=-1)
    trace = torch.sum(torch.square(L), dim=(-2, -1))      # tr(L L^T)
    return 0.5 * (-log_det + dot_mean + trace - float(M))
