"""Global (but explicit) configuration of the PyTorch port.

Counterpart of `tgp/pytorch_tpu/config.py`: the few process-wide knobs that
genuinely are global (precision, default quadrature resolution) live here;
everything else is passed explicitly.

Precision policy:
  * 'fp64' — float64 everywhere, 100 quadrature points (reference parity).
  * 'fp32' — float32 everywhere; the default on the card.
  * 'bf16' is not ported yet (ROADMAP Queue 1 item 20).

Solve precision (`TGPSpec.solve_precision`), fp32 on the card only: the
factor's applications in `marginal_qf` run as 'highest' (true fp32), 'high'
(three TF32 tensor-core passes over the operands split into high and low
TF32 parts, as the TPU's 'high' is three bf16 passes) or 'default' (one
pass over operands rounded to bf16), with fp32 accumulation, in the
forward and in the backward; see `ops.linalg.einsum_at`.  The K_zz Gram, its Cholesky and the triangular
solves never leave true fp32.  In fp64, and on the CPU, every mode is
'highest'.

Devices: entry points take an explicit `device`; `default_device()` is CUDA
and raises where there is none.  Nothing falls back to the CPU: a caller that
wants the CPU says `device="cpu"`.
"""

from __future__ import annotations

import contextlib

import torch

_PRECISION = "fp32"

#: number of Gauss-Hermite nodes (the JAX package defaults to 100 everywhere)
quad_points = 100

#: seed used for numpy-side initialisation
config_seed = 0

#: fixed jitter scale added to K_zz diagonals before Cholesky, by dtype
JITTER_F32 = 1e-6
JITTER_F64 = 1e-8


def set_precision(mode: str) -> None:
    """Set process-wide precision mode ('fp64' | 'fp32').

    Hopper counterpart of the TPU matmul rule: the K_zz Gram and its
    Cholesky must run in true fp32, so TF32 stays off for both cuBLAS
    matmuls and cuDNN, and float32 matmul precision is 'highest'.
    """
    global _PRECISION, quad_points
    if mode == "bf16":
        raise NotImplementedError(
            "bf16 precision is not ported yet (ROADMAP Queue 1 item 20)")
    if mode not in ("fp64", "fp32"):
        raise ValueError(f"unknown precision mode {mode!r}")
    _PRECISION = mode
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    quad_points = 100


@contextlib.contextmanager
def tf32_matmuls():
    """A scope in which float32 cuBLAS matmuls may use TF32 tensor cores;
    it restores the matmul flags it found (those `set_precision` sets)."""
    prev = (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cuda.matmul.allow_tf32 = prev[1]


def precision() -> str:
    return _PRECISION


def default_dtype() -> torch.dtype:
    """dtype used for parameters and statistics."""
    return torch.float64 if _PRECISION == "fp64" else torch.float32


def jitter_value(dtype) -> float:
    """Fixed Cholesky jitter for a dtype (1e-6 fp32 / 1e-8 fp64)."""
    return JITTER_F64 if dtype == torch.float64 else JITTER_F32


def default_device() -> torch.device:
    """The card.  Raises on a host without CUDA: there is no CPU fallback."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, or `default_device()` when None."""
    return default_device() if device is None else torch.device(device)
