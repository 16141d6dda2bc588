"""Global (but explicit) configuration of the PyTorch port.

Counterpart of `tgp/pytorch_tpu/config.py`: the few process-wide knobs that
genuinely are global (precision, default quadrature resolution) live here;
everything else is passed explicitly.

Precision policy:
  * 'fp64' — float64 everywhere, 100 quadrature points (reference parity).
  * 'fp32' — float32 everywhere; the default on the card.
  * 'bf16' — parameters and statistics in float32; the cross term of the
    Gram's squared distances takes bfloat16 operands with float32
    accumulation (`matmul_dtype`, `ops/kernels.py::_sq_dist`) where the
    JAX package's TPU program computes the Gram with XLA ops: an rbf Gram
    below 2^18 entries, and every other stationary kernel.  A larger rbf
    Gram takes the fp32 kernel, as the TPU program takes its fp32 Pallas
    kernel.  TF32 stays off in every mode.

Random streams (`set_rng_impl`, `make_rng`): every generator the port makes
is a `torch.Generator` (Philox on the card); 'threefry2x32' (the default)
seeds it with the seed itself, 'rbg' with a second, fixed derivation of the
seed.  The two give the same distributions and different streams, as the
JAX package's two implementations do; on the card both are the same
generator, so 'rbg' is no faster here.

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

CPU math (`settle_cpu_math`, run when the port loads): MKL's vector math
library, which torch's CPU exp, log, sqrt and the like call, picks its code
branch from a cache that two threads can race to fill; the port fills it
once, in one thread, before anything of the port runs.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

_PRECISION = "fp32"

#: the stream of training-time draws: 'threefry2x32' or 'rbg'
rng_impl = "threefry2x32"

#: number of Gauss-Hermite nodes (the JAX package defaults to 100 everywhere)
quad_points = 100

#: Monte Carlo samples for training and testing deep or Bayesian models
S_train = 1
S_test = 100

#: seed used for numpy-side initialisation
config_seed = 0

#: fixed jitter scale added to K_zz diagonals before Cholesky, by dtype
JITTER_F32 = 1e-6
JITTER_F64 = 1e-8

PI = math.pi


def set_precision(mode: str) -> None:
    """Set process-wide precision mode ('fp64' | 'fp32' | 'bf16').

    Hopper counterpart of the TPU matmul rule: the K_zz Gram and its
    Cholesky must run in true fp32, so TF32 stays off for both cuBLAS
    matmuls and cuDNN, and float32 matmul precision is 'highest', in every
    mode; 'bf16' rounds only the Gram cross term's operands
    (`matmul_dtype`).
    """
    global _PRECISION, quad_points
    if mode not in ("fp64", "fp32", "bf16"):
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


def matmul_dtype() -> torch.dtype:
    """dtype of the Gram cross term's operands (bf16 in 'bf16' mode)."""
    return torch.bfloat16 if _PRECISION == "bf16" else default_dtype()


def set_rng_impl(impl: str) -> None:
    """Select the stream of the generators that `make_rng` makes:
    'threefry2x32' (the default) or 'rbg'.  Set it before building a
    Trainer or a battery; a Trainer's checkpoint records its own."""
    global rng_impl
    if impl not in ("threefry2x32", "rbg"):
        raise ValueError(f"unknown rng impl {impl!r} "
                         "(expected 'threefry2x32' or 'rbg')")
    rng_impl = impl


def stream_seed(seed: int, impl: str | None = None) -> int:
    """The seed that `make_rng` gives the generator: `seed` itself under
    'threefry2x32', and under 'rbg' the first 63 bits of
    numpy's SeedSequence((seed, 1))."""
    impl = impl or rng_impl
    if impl == "threefry2x32":
        return int(seed)
    state = np.random.SeedSequence((int(seed), 1)).generate_state(1, np.uint64)
    return int(state[0]) & (2 ** 63 - 1)


def make_rng(seed: int, device=None) -> torch.Generator:
    """A `torch.Generator` on `device` (None: the card) seeded under the
    configured `rng_impl`."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(stream_seed(seed))
    return gen


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


def settle_cpu_math() -> None:
    """Fill MKL's vector-math (VML) branch cache in the calling thread.

    torch's CPU exp, log, sqrt, sin, erf, tanh and the like on float and
    double tensors call MKL's VML (`vmsExp`, `vmdLn`, ...), and each VML
    call asks `mkl_vml_serv_cpu_detect` for the CPU's code branch.  That
    function fills a static on its first call with two stores: the branch
    as detected, then the branch mapped to VML's tables.  A thread that
    reads the static between the two stores indexes the tables with the
    unmapped value and runs another branch at another accuracy: on an
    AVX-512 host, the AVX2 branch at VML's EP accuracy (1.5e-4 relative in
    fp32, 3.3e-9 in fp64) where torch asks for the AVX-512 HA branch.  Two
    threads first meet there in the first call of a process that torch
    splits across threads (2048 elements or more), so that call's first
    chunk came out wrong now and then.  One call of 16 elements runs in
    the calling thread alone and fills the static before any such call.
    Without MKL it just computes exp(0).
    """
    torch.exp(torch.zeros(16, dtype=torch.float32))


settle_cpu_math()
