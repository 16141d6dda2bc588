"""Batched dense linear algebra (counterpart of `ops/linalg.py`).

Cholesky factorisations and triangular solves are `torch.linalg` (cuSOLVER
and cuBLAS on the card, LAPACK on the CPU), as the JAX package left them to
XLA.  All functions take arbitrary leading batch dimensions.
"""

from __future__ import annotations

import contextlib
import math

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


def _round_tf32(x):
    """fp32 x rounded to TF32's 10-bit mantissa (to nearest, ties away from
    zero, as the tensor cores' conversion rounds)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(x):
    """x = hi + lo + (x's last 2^-22 or so): hi and lo are TF32 values."""
    hi = _round_tf32(x.contiguous())
    return hi, _round_tf32(x - hi)


def _matmul_in(a, b, mode: str):
    """a @ b at a reduced precision, on the TF32 tensor cores, fp32
    accumulation.  'high': three TF32 passes over the operands split into
    TF32 high and low parts (a_hi b_lo + a_lo b_hi + a_hi b_hi), the
    counterpart of the TPU's three bf16 passes; 'default': one pass over
    operands rounded to bf16, the TPU's one bf16 pass.  The operands are
    rounded here, so a matrix-vector product, which cuBLAS runs without
    tensor cores, gets the same precision as a GEMM."""
    with cfg.tf32_matmuls():
        if mode == "high":
            (a_hi, a_lo), (b_hi, b_lo) = _split_tf32(a), _split_tf32(b)
            return (torch.matmul(a_hi, b_lo) + torch.matmul(a_lo, b_hi)) \
                + torch.matmul(a_hi, b_hi)
        return torch.matmul(a.to(torch.bfloat16).to(a.dtype),
                            b.to(torch.bfloat16).to(b.dtype))


class _MatmulAt(torch.autograd.Function):
    """a @ b (equal batch shapes) at a reduced precision, forward and
    backward: a precision flag set around the forward alone would be gone
    by the time autograd runs the backward."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, b, mode):
        return _matmul_in(a, b, mode)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, mode = inputs
        ctx.save_for_backward(a, b)
        ctx.mode = mode

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _matmul_in(g, b.transpose(-1, -2), ctx.mode)
        if ctx.needs_input_grad[1]:
            gb = _matmul_in(a.transpose(-1, -2), g, ctx.mode)
        return ga, gb, None


#: the batched contractions of `marginal_qf` as matmuls: equation ->
#: (transpose a, squeeze the last axis of the result)
_MATMUL_FORMS = {"dnm,dmo->dn": (False, True), "dmk,dmn->dkn": (True, False),
                 "dkm,dmn->dkn": (False, False), "dmk,dmo->dko": (True, False),
                 "dnm,dmk->dnk": (False, False), "dmn,dmk->dnk": (True, False)}


def einsum_at(eq: str, a, b, mode: str = "highest"):
    """torch.einsum(eq, a, b) at solve precision `mode` ('highest' | 'high'
    | 'default', `config`'s meaning), in the forward and the backward.
    Only fp32 CUDA tensors change: in fp64 and on the CPU every mode is
    `torch.einsum` itself, and so is 'highest' everywhere."""
    if mode not in ("highest", "high", "default"):
        raise ValueError(f"unknown solve precision {mode!r}")
    if mode == "highest" or a.dtype != torch.float32 or a.device.type != "cuda":
        return torch.einsum(eq, a, b)
    transpose_a, squeeze = _MATMUL_FORMS[eq]
    a = a.expand(b.shape[:-2] + a.shape[-2:])
    b = b.expand(a.shape[:-2] + b.shape[-2:])
    out = _MatmulAt.apply(a.transpose(-1, -2) if transpose_a else a, b, mode)
    return out[..., 0] if squeeze else out


#: right-hand-side columns of one triangular solve, summed over the batch.
#: cuBLAS's batched trsm slows down a thousandfold past a few million
#: columns: on an NVIDIA H100 at 13 x 100 x n it takes 19.9 ms (fp32) and
#: 24.5 ms (fp64, at n = 409,600) up to n = 512,000 (6.66M columns), and
#: 18.9 s and 22.3 s at 614,400 (7.99M), in either layout
#: (`tools/trsm_columns.py`).  The limit sits below that bracket, which was
#: measured at this batch and M only.  Wider right-hand sides go in column
#: blocks; a column's solve does not depend on the others.
TRSM_COLUMNS = 1 << 22

#: replicas that `torch.func.vmap` maps the current call over (set by
#: `mapped_replicas`): a mapped solve's tensors show one replica's columns,
#: and cuBLAS sees all of them in one call
_MAPPED = 1


@contextlib.contextmanager
def mapped_replicas(R: int):
    """A scope in which the solves run under a map over R replicas, so that
    the column blocking counts every replica's columns."""
    global _MAPPED
    prev, _MAPPED = _MAPPED, int(R)
    try:
        yield
    finally:
        _MAPPED = prev


def _solve_triangular(A, B, upper: bool):
    n = B.shape[-1]
    step = max(1, TRSM_COLUMNS * n // max(B[..., 0, :].numel() * _MAPPED, 1))
    if n <= step:
        return torch.linalg.solve_triangular(A, B, upper=upper)
    # the blocks joined as rows of X^T: cuBLAS returns X column-major, so
    # each block of X^T is one contiguous run per matrix
    Bt = B.transpose(-1, -2)
    return torch.cat([torch.linalg.solve_triangular(
        A, Bt[..., i:i + step, :].transpose(-1, -2), upper=upper
    ).transpose(-1, -2) for i in range(0, n, step)], dim=-2).transpose(-1, -2)


def tril_solve(L, B):
    """Solve L X = B with L lower-triangular (batched)."""
    return _solve_triangular(L, B, upper=False)


def triu_solve(U, B):
    """Solve U X = B with U upper-triangular (batched)."""
    return _solve_triangular(U, B, upper=True)


def cholesky_solve(L, B):
    """Solve A X = B given A = L L^T (batched)."""
    return torch.cholesky_solve(B, L, upper=False)


def batched_log_gaussian(obs, mean, cov, cov_is_inverse: bool = False):
    """log N(obs | mean, diag(cov)) reduced over the trailing dim.

    obs, mean and cov are (*, N); with `cov_is_inverse`, `cov` holds the
    precision.  Returns (*,) log-densities.
    """
    N = mean.shape[-1]
    cte = N * math.log(2.0 * math.pi)
    log_det = torch.sum(torch.log(cov), dim=-1)
    inv_c = cov if cov_is_inverse else 1.0 / cov
    if cov_is_inverse:
        log_det = -log_det
    diff = obs - mean
    maha = torch.sum(diff * inv_c * diff, dim=-1)
    return -0.5 * (cte + log_det + maha)


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


def kl_gaussian(m_q, L_q_raw, m_p, K_p, jitter: float | None = None, L_p=None):
    """KL( N(m_q, S_q) || N(m_p, K_p) ) with S_q = tril(L_q) tril(L_q)^T, the
    unwhitened KL, through a jittered Cholesky L_p of K_p:
        0.5 * ( log|K_p| - log|S_q| - M + tr(K_p^{-1} S_q)
                + (m_p - m_q)^T K_p^{-1} (m_p - m_q) ).

    m_q, m_p are (..., M), L_q_raw and K_p (..., M, M); returns (...,).
    `L_p`, when given, is `safe_cholesky(K_p, jitter)[0]` already computed
    (the model passes `marginal_qf`'s factor of the same K_zz).
    """
    Lq = tril_mask(L_q_raw)
    M = m_q.shape[-1]
    Lp = safe_cholesky(K_p, jitter)[0] if L_p is None else L_p
    log_det_p = 2.0 * torch.sum(torch.log(torch.diagonal(Lp, dim1=-2, dim2=-1)),
                                dim=-1)
    log_det_q = torch.sum(torch.log(torch.square(
        torch.diagonal(Lq, dim1=-2, dim2=-1))), dim=-1)
    trace = torch.sum(torch.square(tril_solve(Lp, Lq)), dim=(-2, -1))
    sol = tril_solve(Lp, (m_p - m_q)[..., None])
    maha = torch.sum(torch.square(sol), dim=(-2, -1))
    return 0.5 * (log_det_p - log_det_q - float(M) + trace + maha)
