"""Fused ARD-RBF Gram and its VJP: the CUDA kernels in `csrc/` and their wrappers.

Computes K[d, i, j] = ks_d * exp(-0.5 * max(|x_di|^2 + |z_dj|^2 - 2 x_di.z_dj, 0))
on lengthscale-scaled inputs X1s (Dy, N, Dx), X2s (Dy, M, Dx), ks (Dy,).

  * `rbf_gram(X1s, X2s, ks)`: the single Gram, the JAX package's
    `rbf_gram_pallas`.
  * `rbf_gram_pair(Xs, Zs, ks)`: (K(X, Z), K(Z, Z)) from one launch, the two
    Grams of a `marginal_qf`.

Kernels:
  * `csrc/rbf_gram.cu` replaces the TPU kernel
    `tgp/pytorch_tpu/ops/pallas/rbf_gram.py::_forward` (`pallas_call` at :85).
    Bound by bytes and the launch: the flagship pair at bucket 4096 moves
    1.75 MB (0.52 us at 3.35 TB/s), so both Grams take one launch, and a block
    writes whole output rows with 16-byte stores.
  * `csrc/rbf_gram_bwd.cu` replaces its VJP `_bwd` (rbf_gram.py:114-131),
    which the JAX package leaves to XLA.  Bound by bytes (3.72 MB at the
    training shape 8611 x 100, 1.11 us), by operations at Dx = 90.  Two
    designs, both reading g once, recomputing K and summing per-block
    partials in a fixed order (no atomics, the same bits on every run): the
    block pass (a block a row tile, one wave) and the tile pass (a block a
    run of row tiles, Z and its dZ sums kept on chip, the next g tile loading
    while one is computed, fp64 products on the tensor cores).  `bwd_design`
    chooses by shape.
The source notes in the .cu files give the designs.

Under `torch.func.vmap` (the multi-seed battery, `train/multiseed.py`) the
Functions fold the mapped replica axis into the kernels' output axis: R
replicas of a (Dy, N, M) Gram are one launch at R*Dy, forward and backward.

Routing: a CUDA tensor always launches the kernels (or raises); a CPU tensor
takes the plain torch versions, `rbf_gram_reference` forward and autograd
through it.  `rbf_gram_bwd` (a transcription of `_bwd`) and
`rbf_gram_pair_bwd` are the backward kernel's plain versions, which the tests
and `chip_smoke.py` hold it against.  There is no third path.  Each source is
built with its own nvcc, all at once, into `build/kernels/` at first use and
bound with ctypes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_HEADER = _CSRC / "rbf_gram_common.cuh"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
#: (source, library) of each kernel
_UNITS = [(_CSRC / "rbf_gram.cu", _BUILD_DIR / "librbf_gram.so"),
          (_CSRC / "rbf_gram_bwd.cu", _BUILD_DIR / "librbf_gram_bwd.so")]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

#: forward kernel launches so far; a run sets it to 0 and reads it to prove
#: that a path went through the kernel
LAUNCHES = 0
#: backward kernel calls so far, either design (each is a pass and its
#: reduction)
BWD_LAUNCHES = 0
#: of those, the calls that ran the tile pass
BWD_TILE_LAUNCHES = 0

_libs = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def build() -> str:
    """Compile each stale kernel source into its library in `build/kernels/`,
    one nvcc per source, all started together; returns nvcc's output, with
    ptxas's registers, shared memory and spills ('' if all were current)."""
    stale = [(src, lib) for src, lib in _UNITS
             if not lib.exists() or lib.stat().st_mtime
             < max(src.stat().st_mtime, _HEADER.stat().st_mtime)]
    if not stale:
        return ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src, lib in stale:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(src)]
        jobs.append((lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    out, failed = [], []
    for lib, tmp, proc in jobs:         # wait for every nvcc before raising
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {lib.name} ({proc.returncode}):\n{stderr}")
        else:
            os.replace(tmp, lib)
            out.append(stdout + stderr)
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(out)


def _load():
    global _libs
    with _lib_lock:
        if _libs is None:
            build()
            fwd, bwd = (ctypes.CDLL(str(lib)) for _, lib in _UNITS)
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            for fn in (fwd.rbf_gram_f32, fwd.rbf_gram_f64):
                fn.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
                fn.restype = i32
            for fn in (bwd.rbf_gram_bwd_f32, bwd.rbf_gram_bwd_f64,
                       bwd.rbf_gram_bwd_tile_f32, bwd.rbf_gram_bwd_tile_f64):
                fn.argtypes = [ptr] * 9 + [i32] * 5 + [ptr]
                fn.restype = i32
            for fn in (bwd.rbf_gram_bwd_scratch_f32, bwd.rbf_gram_bwd_scratch_f64,
                       bwd.rbf_gram_bwd_tile_scratch_f32,
                       bwd.rbf_gram_bwd_tile_scratch_f64):
                fn.argtypes = [i32] * 6
                fn.restype = ctypes.c_int64
            bwd.rbf_gram_bwd_tile_setup.argtypes = []
            bwd.rbf_gram_bwd_tile_setup.restype = i32
            for fn in (bwd.rbf_gram_bwd_tile_kind_f32,
                       bwd.rbf_gram_bwd_tile_kind_f64):
                fn.argtypes = [i32] * 2
                fn.restype = i32
            _libs = (fwd, bwd)
    return _libs


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def sq_dist(X1s, X2s, operand_dtype=None):
    """Batched squared distances via the |x|^2 + |z|^2 - 2 x.z expansion,
    clamped at 0 (the JAX package's `kernels._sq_dist`): (Dy, N, M).

    `torch.maximum`, like `jnp.maximum`, passes half the gradient where d2 is
    exactly 0 (K_zz's diagonal), so autograd through it is JAX's gradient.
    `operand_dtype` (bf16) rounds the cross term's operands and multiplies
    them in the inputs' dtype, the accumulation of JAX's
    `preferred_element_type`; the norms keep the inputs' dtype, and the
    cotangents of the operands are rounded the same way by autograd.
    """
    n1 = torch.sum(torch.square(X1s), dim=-1)
    n2 = torch.sum(torch.square(X2s), dim=-1)
    if operand_dtype is not None and operand_dtype != X1s.dtype:
        X1s = X1s.to(operand_dtype).to(n1.dtype)
        X2s = X2s.to(operand_dtype).to(n1.dtype)
    cross = torch.matmul(X1s, X2s.transpose(-1, -2))
    d2 = n1[:, :, None] + n2[:, None, :] - 2.0 * cross
    return torch.maximum(d2, d2.new_zeros(()))


def rbf_gram_reference(X1s, X2s, ks):
    """Plain torch version, the same expansion as `kernels.py:202-217`."""
    return ks[:, None, None] * torch.exp(-0.5 * sq_dist(X1s, X2s))


def rbf_gram_pair_reference(Xs, Zs, ks):
    """Plain version of the pair: two `rbf_gram_reference` calls."""
    return rbf_gram_reference(Xs, Zs, ks), rbf_gram_reference(Zs, Zs, ks)


def rbf_gram_bwd(X1s, X2s, ks, K, g):
    """VJP of the Gram (torch transcription of the JAX package's `_bwd`).

    dK/dks is exp(-0.5 d2) recomputed directly rather than K/ks: ks =
    softplus(raw) underflows to 0 in fp32 for very negative raw, where the
    division would emit inf/NaN.
    """
    gK = g * K
    row = torch.sum(gK, dim=-1)                                  # (Dy, N)
    col = torch.sum(gK, dim=-2)                                  # (Dy, M)
    dX1 = torch.einsum("dnm,dmk->dnk", gK, X2s) - row[..., None] * X1s
    dX2 = torch.einsum("dnm,dnk->dmk", gK, X1s) - col[..., None] * X2s
    dks = torch.sum(g * torch.exp(-0.5 * sq_dist(X1s, X2s)), dim=(-2, -1))
    return dX1, dX2, dks


def rbf_gram_pair_bwd(Xs, Zs, ks, Kxz, Kzz, g_xz, g_zz):
    """VJP of the pair by `rbf_gram_bwd` on each Gram: dZ sums K_xz's column
    gradient and K_zz's row and column gradients."""
    dX, dZ_xz, dks_xz = rbf_gram_bwd(Xs, Zs, ks, Kxz, g_xz)
    dZ_row, dZ_col, dks_zz = rbf_gram_bwd(Zs, Zs, ks, Kzz, g_zz)
    return dX, dZ_xz + dZ_row + dZ_col, dks_xz + dks_zz


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _check(X1s, X2s, ks, *gs):
    for name, t in (("X1s", X1s), ("X2s", X2s), ("ks", ks)) \
            + tuple(("g", g) for g in gs):
        if t.device.type != "cuda" or t.device != X1s.device:
            raise ValueError(f"{name} must lie on the same CUDA device as X1s, "
                             f"got {t.device}")
        if t.dtype not in (torch.float32, torch.float64) or t.dtype != X1s.dtype:
            raise TypeError(f"{name} must be float32 or float64 like X1s, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if X1s.ndim != 3 or X2s.ndim != 3 or ks.ndim != 1:
        raise ValueError("expected X1s (Dy,N,Dx), X2s (Dy,M,Dx), ks (Dy,); got "
                         f"{tuple(X1s.shape)}, {tuple(X2s.shape)}, {tuple(ks.shape)}")
    Dy, N, Dx = X1s.shape
    M = X2s.shape[1]
    if X2s.shape[0] != Dy or X2s.shape[2] != Dx or ks.shape[0] != Dy:
        raise ValueError("shape mismatch: X1s (Dy,N,Dx), X2s (Dy,M,Dx), ks (Dy,); "
                         f"got {tuple(X1s.shape)}, {tuple(X2s.shape)}, "
                         f"{tuple(ks.shape)}")
    for g, want in zip(gs, ((Dy, N, M), (Dy, M, M))):
        if tuple(g.shape) != want:
            raise ValueError(f"cotangent shape {tuple(g.shape)}, expected {want}")
    # the C interface takes int sizes (ctypes would wrap a larger one
    # silently); the flat grid holds 2^31 - 1 blocks of Dy x row tiles, and a
    # launch beyond that is refused through its return value
    if max(Dy, N, M, Dx) >= 2 ** 31:
        raise ValueError(f"Gram of shape {(Dy, N, M, Dx)} exceeds int32 sizes")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_pair(Xs, Zs, ks, pair: bool):
    """One forward launch on the current stream: K(Xs, Zs) (Dy, N, M) and,
    if `pair`, K(Zs, Zs) (Dy, M, M), else None."""
    global LAUNCHES
    _check(Xs, Zs, ks)
    fwd, _ = _load()
    Dy, N, Dx = Xs.shape
    M = Zs.shape[1]
    Kxz = torch.empty((Dy, N, M), dtype=Xs.dtype, device=Xs.device)
    Kzz = torch.empty((Dy, M, M), dtype=Xs.dtype, device=Xs.device) if pair \
        else None
    if Kxz.numel() == 0 and (Kzz is None or Kzz.numel() == 0):
        return Kxz, Kzz
    fn = fwd.rbf_gram_f32 if Xs.dtype == torch.float32 else fwd.rbf_gram_f64
    with torch.cuda.device(Xs.device):
        err = fn(Xs.data_ptr(), Zs.data_ptr(), ks.data_ptr(), Kxz.data_ptr(),
                 None if Kzz is None else Kzz.data_ptr(), Dy, N, M, Dx,
                 _stream(Xs))
    if err != 0:
        raise RuntimeError(f"rbf_gram kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return Kxz, Kzz


def _launch(X1s, X2s, ks):
    """One forward launch of the single Gram; returns (Dy, N, M)."""
    return _launch_pair(X1s, X2s, ks, pair=False)[0]


#: `tile_kind`'s answers: the tile pass does not take the shape, or takes it
#: with its quad kernel, or with its fragment kernel
REFUSED, QUAD, FRAGMENT = 0, 1, 2
#: rows an SM in one wave of the block pass: its blocks of at most 64 rows,
#: two an SM (TN_MAX and BLOCKS_PER_SM in csrc/rbf_gram_bwd.cu)
_BLOCK_WAVE_ROWS = 128


def tile_kind(dtype, M, Dx) -> int:
    """Which kernel of the tile pass takes Gram columns M and features Dx,
    from the kernel's own plan (`rbf_gram_bwd_tile_kind_*`, which builds and
    loads the library): REFUSED where Z, its dZ sums and one 16-row tile do
    not fit 227 KB of shared memory, else QUAD or FRAGMENT."""
    _, bwd = _load()
    fn = (bwd.rbf_gram_bwd_tile_kind_f32 if dtype == torch.float32
          else bwd.rbf_gram_bwd_tile_kind_f64)
    return fn(M, Dx)


def bwd_design(dtype, Dy, N, M, Dx, sms, kind, pair=True) -> str:
    """The backward kernel's design for a shape: "block" (the block pass)
    or "tile" (the tile pass), from the shape, the dtype, the device's SM
    count and `kind`, the tile pass's kernel for the shape (`tile_kind`).

    From one `chip_smoke.py --bwd-compare` call timing both designs at every
    `KERNEL_SHAPES` shape (PERF.md, the VJP's row; NVIDIA H100 80GB HBM3).
    Two cut-offs fall between shapes that call did not time, and are
    interpolated there: fp64 Dx >= 8 (between Dx = 4, where the block pass
    won, and Dx = 13, where the tile pass won) and fp32 Dx >= 64 (between
    Dx = 17 and Dx = 90).
      * fp64 with Dx >= 8 and M >= 64 takes the tile pass, whose products
        run on the tensor cores (boston's and DGP-2's Dx = 13 at M = 100,
        1.5-2.4x; YearMSD's Dx = 90, 4.8x).  At Dx <= 4, or M = 20 and 50,
        the block pass is faster;
      * fp32 takes the tile pass past one wave of the block pass (its
        blocks of at most 64 rows, two an SM: more than 128 rows an SM)
        where the quad kernel takes it (the battery's R Dy = 10, 1.4x;
        --dgp_flow, 1.5-2.0x), and at Dx >= 64 (YearMSD, 1.1x).  One wave
        or less, and airline's M = 500, stay with the block pass: the
        flagship's pair, kin8nm's and the single Grams keep their bits.
    Not a fallback: a design that refuses a shape raises.
    """
    if kind == REFUSED:
        return "block"
    if dtype == torch.float64:
        return "tile" if Dx >= 8 and M >= 64 else "block"
    rows = Dy * (N + M if pair else N)
    if Dx >= 64 or (kind == QUAD and rows > _BLOCK_WAVE_ROWS * sms):
        return "tile"
    return "block"


_DEVICE_SMS = {}    # CUDA device index -> SM count, the tile pass set up on it
_PLANS = {}         # (device, dtype, Dy, N, M, Dx, pair, design) -> plan


def _sms(bwd, device):
    """The device's SM count, read once a process; the first call on a
    device also opts the tile pass in to its shared memory there."""
    sms = _DEVICE_SMS.get(device.index)
    if sms is None:
        with _lib_lock:
            err = bwd.rbf_gram_bwd_tile_setup()
            if err != 0:
                raise RuntimeError(f"rbf_gram_bwd tile setup failed: cudaError {err}")
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            _DEVICE_SMS[device.index] = sms
    return sms


def _plan_bwd(bwd, Xs, Dy, N, M, Dx, pair, design):
    """(C function, scratch values, SM count, is the tile pass) for a
    backward call, worked out once per shape and device."""
    key = (Xs.device.index, Xs.dtype, Dy, N, M, Dx, pair, design)
    plan = _PLANS.get(key)
    if plan is None:
        sms = _sms(bwd, Xs.device)
        chosen = design or bwd_design(Xs.dtype, Dy, N, M, Dx, sms,
                                      tile_kind(Xs.dtype, M, Dx), pair)
        if chosen not in ("block", "tile"):
            raise ValueError(f"unknown backward design {chosen!r}")
        pre = "rbf_gram_bwd_tile_" if chosen == "tile" else "rbf_gram_bwd_"
        suf = "f32" if Xs.dtype == torch.float32 else "f64"
        n_part = getattr(bwd, pre + "scratch_" + suf)(Dy, N, M, Dx, pair, sms)
        if n_part < 0:
            raise ValueError(f"the backward's {chosen} pass does not take "
                             f"M = {M}, Dx = {Dx} in {Xs.dtype} (shared memory)")
        plan = _PLANS[key] = (getattr(bwd, pre + suf), n_part, sms, chosen == "tile")
    return plan


def _launch_bwd(Xs, Zs, ks, g_xz, g_zz=None, design=None):
    """The backward kernel on the current stream: (dX, dZ, dks) for the
    cotangent g_xz of K(Xs, Zs) and, for the pair, g_zz of K(Zs, Zs).
    `design` ("block" or "tile") overrides `bwd_design`, for the tests and
    the comparison."""
    global BWD_LAUNCHES, BWD_TILE_LAUNCHES
    gs = (g_xz,) if g_zz is None else (g_xz, g_zz)
    _check(Xs, Zs, ks, *gs)
    _, bwd = _load()
    Dy, N, Dx = Xs.shape
    M = Zs.shape[1]
    if Dy == 0 or M == 0 or (N == 0 and g_zz is None):   # every entry is 0
        return torch.zeros_like(Xs), torch.zeros_like(Zs), torch.zeros_like(ks)
    with torch.cuda.device(Xs.device):
        fn, n_part, sms, tile = _plan_bwd(bwd, Xs, Dy, N, M, Dx,
                                          g_zz is not None, design)
        dX, dZ, dks = (torch.empty_like(t) for t in (Xs, Zs, ks))
        part = torch.empty(n_part, dtype=Xs.dtype, device=Xs.device)
        err = fn(Xs.data_ptr(), Zs.data_ptr(), ks.data_ptr(), g_xz.data_ptr(),
                 None if g_zz is None else g_zz.data_ptr(), dX.data_ptr(),
                 dZ.data_ptr(), dks.data_ptr(), part.data_ptr(), Dy, N, M, Dx,
                 sms, _stream(Xs))
    if err != 0:
        raise RuntimeError(f"rbf_gram_bwd kernel launch failed: cudaError {err}")
    BWD_LAUNCHES += 1
    BWD_TILE_LAUNCHES += tile
    return dX, dZ, dks


def _fold(info, in_dims, *ts):
    """Under `torch.func.vmap`: each tensor with the mapped axis moved to
    the front (a tensor the map does not batch is broadcast to it) and
    folded into the kernel's output axis, (R, Dy, ...) -> (R*Dy, ...)."""
    R = info.batch_size
    out = []
    for t, d in zip(ts, in_dims):
        t = t.expand((R,) + tuple(t.shape)) if d is None else t.movedim(d, 0)
        out.append(t.reshape((R * t.shape[1],) + tuple(t.shape[2:]))
                   .contiguous())
    return out


def _unfold(R, t):
    """(R*Dy, ...) -> (R, Dy, ...)."""
    return t.reshape((R, t.shape[0] // R) + tuple(t.shape[1:]))


class RBFGram(torch.autograd.Function):
    """The single Gram: kernel forward, kernel backward (K recomputed).
    Under `torch.func.vmap` the mapped axis folds into the output axis, so
    R mapped Grams are one launch forward and one backward call."""

    @staticmethod
    def forward(X1s, X2s, ks):
        return _launch(X1s, X2s, ks)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _launch_bwd(*ctx.saved_tensors, g.contiguous())

    @staticmethod
    def vmap(info, in_dims, X1s, X2s, ks):
        K = RBFGram.apply(*_fold(info, in_dims, X1s, X2s, ks))
        return _unfold(info.batch_size, K), 0


class RBFGramPair(torch.autograd.Function):
    """(K(X, Z), K(Z, Z)): one forward launch, one backward kernel call,
    for R mapped pairs under `torch.func.vmap` too (`RBFGram`'s fold)."""

    @staticmethod
    def forward(Xs, Zs, ks):
        return _launch_pair(Xs, Zs, ks, pair=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_xz, g_zz):
        return _launch_bwd(*ctx.saved_tensors, g_xz.contiguous(),
                           g_zz.contiguous())

    @staticmethod
    def vmap(info, in_dims, Xs, Zs, ks):
        Kxz, Kzz = RBFGramPair.apply(*_fold(info, in_dims, Xs, Zs, ks))
        R = info.batch_size
        return (_unfold(R, Kxz), _unfold(R, Kzz)), (0, 0)


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def rbf_gram(X1s, X2s, ks):
    """K = ks[:, None, None] * exp(-0.5 * d2(X1s, X2s)).

    CUDA tensors launch the kernel (raising on anything it does not take);
    CPU tensors take the plain version.
    """
    if _on_cpu(X1s, X2s, ks):
        return rbf_gram_reference(X1s, X2s, ks)
    return RBFGram.apply(X1s, X2s, ks)


def rbf_gram_pair(Xs, Zs, ks):
    """(K(Xs, Zs), K(Zs, Zs)): (Dy, N, M) and (Dy, M, M).

    CUDA tensors take one launch of the kernel for both; CPU tensors take
    `rbf_gram_pair_reference`.
    """
    if _on_cpu(Xs, Zs, ks):
        return rbf_gram_pair_reference(Xs, Zs, ks)
    return RBFGramPair.apply(Xs, Zs, ks)
