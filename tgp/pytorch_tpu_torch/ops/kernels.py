"""Batched ARD Gram-matrix kernels (counterpart of the JAX package's
`ops/kernels.py`).

  * a kernel is a static `KernelSpec` tree plus a dict of parameters: rbf,
    matern12/32/52, periodic, cosine, white, and the scale, product and
    additive combinators (spectral mixtures are additive trees of
    product(periodic or cosine, scale(rbf)));
  * `gram(spec, params, X1, X2, same=...)` returns (Dy, N, M) Gram matrices;
    `gram_diag(spec, params, X)` returns (Dy, N) diagonals;
  * `gram_pair(spec, params, X, Z)` returns (K(X, Z), K(Z, Z)) in one call,
    recursively over the tree: the two Grams of `marginal_qf`;
  * the white kernel adds noise only to K(X, X) evaluations (`same=True`
    and N = M), never to K_zz or K_xz.

Routing departs from the JAX package on purpose in fp32 and fp64: its gate
`_pallas_ok` sends only fp32 Grams of at least 2^18 elements to Pallas, to
amortise a launch on the TPU, and computes the smaller ones with XLA ops,
the same function.  Here every `rbf` or `scale(rbf)` Gram of a CUDA tensor,
in fp32 and fp64, goes through the CUDA kernels (`ops/rbf_gram.py`), as a
leaf of a product or additive tree too, and a CPU tensor takes the plain
version.  The other kinds are plain torch ops on either device.

In 'bf16' mode the two routes compute different functions, so the port
follows `_pallas_ok`: an rbf Gram with fewer than 2^18 entries (Dy * N * M,
per replica under `torch.func.vmap`) takes `_sq_dist` with bf16 operands in
torch ops, where the TPU program takes XLA ops, and a larger one the fp32
kernel; every other stationary kernel takes the bf16 cross term at any size.
The rule is fixed by the shapes, never a fallback.  `gram_pair` decides each
of its two Grams by its own size: one launch for both only when both reach
2^18.  `BF16_GRAMS` counts the Grams of the bf16 route, as
`rbf_gram.LAUNCHES` counts the kernel's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .. import config as cfg
from .rbf_gram import rbf_gram, rbf_gram_pair, sq_dist
from .transforms import softplus, np_inv_softplus

_STATIONARY = ("rbf", "matern12", "matern32", "matern52")

#: in 'bf16' mode, rbf Grams of at least this many entries take the fp32
#: kernel (the JAX package's `_PALLAS_MIN_ELEMS`)
BF16_KERNEL_MIN_ELEMS = 1 << 18
#: Grams computed with bf16 operands so far; a run sets it to 0 and reads it
BF16_GRAMS = 0


def _sq_dist(X1s, X2s):
    """Squared distances with the cross term's operands in
    `config.matmul_dtype()` (the JAX package's `_sq_dist`); each call in
    'bf16' mode is one Gram of the bf16 route."""
    global BF16_GRAMS
    mm = cfg.matmul_dtype()
    if mm == torch.bfloat16:
        BF16_GRAMS += 1
    return sq_dist(X1s, X2s, mm)


def _bf16_route(X1s, X2s) -> bool:
    """True where an rbf Gram takes `_sq_dist` with bf16 operands: 'bf16'
    mode and fewer than `BF16_KERNEL_MIN_ELEMS` entries."""
    return (cfg.precision() == "bf16" and X1s.shape[-3] * X1s.shape[-2]
            * X2s.shape[-2] < BF16_KERNEL_MIN_ELEMS)


def _rbf(X1s, X2s, ks):
    """The rbf Gram of scaled inputs by the route its size picks."""
    if _bf16_route(X1s, X2s):
        return ks[:, None, None] * torch.exp(-0.5 * _sq_dist(X1s, X2s))
    return rbf_gram(X1s.contiguous(), X2s.contiguous(), ks)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Static kernel description (hashable)."""

    kind: str      # 'rbf'|'matern12'|'matern32'|'matern52'|'periodic'|'cosine'|'white'|'scale'|'product'|'additive'
    children: Tuple["KernelSpec", ...] = ()
    ard: bool = True

    def __post_init__(self):
        if self.kind in ("scale",) and len(self.children) != 1:
            raise ValueError("scale kernel needs exactly one child")
        if self.kind in ("product", "additive") and len(self.children) < 1:
            raise ValueError(f"{self.kind} kernel needs children")


# -- spec builders ----------------------------------------------------------

def rbf():
    return KernelSpec("rbf")


def matern(nu: float):
    return KernelSpec({0.5: "matern12", 1.5: "matern32", 2.5: "matern52"}[nu])


def periodic():
    return KernelSpec("periodic")


def cosine():
    return KernelSpec("cosine")


def white():
    return KernelSpec("white")


def scale(child: KernelSpec):
    return KernelSpec("scale", (child,))


def product(*children: KernelSpec):
    return KernelSpec("product", tuple(children))


def additive(*children: KernelSpec):
    return KernelSpec("additive", tuple(children))


def spectral_mixture(num_components: int, base: str = "periodic") -> KernelSpec:
    """sum_k Periodic_k x ScaleRBF_k ('spectral_mixture') or
    Cosine_k x ScaleRBF_k ('sm')."""
    comp = periodic() if base == "periodic" else cosine()
    return additive(*[product(comp, scale(rbf())) for _ in range(num_components)])


def init_spectral_mixture_params(spec: KernelSpec, Dy: int, Dx: int,
                                 periods, lengthscales, magnitudes,
                                 dtype=None, device=None):
    """Per-component initialisation of a `spectral_mixture` spec: component
    k starts at period periods[k], lengthscale lengthscales[k] and output
    scale magnitudes[k]."""
    children = []
    for k, child in enumerate(spec.children):
        children.append(init_params(child, Dy, Dx, {
            "period": float(np.asarray(periods[k]).reshape(-1)[0]),
            "length_scale": float(np.asarray(lengthscales[k]).reshape(-1)[0]),
            "kernel_scale": float(np.asarray(magnitudes[k]).reshape(-1)[0]),
        }, dtype, device))
    return {"children": children}


def from_name(name: str) -> KernelSpec:
    """Name-compatible factory (the JAX package's table)."""
    table = {
        "rbf": rbf(),
        "scale_rbf": scale(rbf()),
        "matern32": matern(1.5),
        "scale_matern32": scale(matern(1.5)),
        "matern52": matern(2.5),
        "scale_matern52": scale(matern(2.5)),
        "whitenoise": white(),
        "periodic": periodic(),
        "cosine": cosine(),
    }
    if name not in table:
        raise NotImplementedError(f"unknown kernel name {name!r}")
    return table[name]


# -- parameter initialisation ----------------------------------------------

def init_params(spec: KernelSpec, Dy: int, Dx: int, init: dict | None = None,
                dtype=None, device=None):
    """Parameter dict for `spec`, batched over Dy outputs.

    `init` accepts 'length_scale', 'kernel_scale' and 'period'
    (inv-softplus loaded) and 'noisy_variance' (log loaded).
    """
    init = dict(init or {})
    dtype = dtype or cfg.default_dtype()
    device = cfg.resolve_device(device)
    ls = float(init.get("length_scale", 1.0))
    ks = float(init.get("kernel_scale", 1.0))
    nv = float(init.get("noisy_variance", 1e-9))
    period = float(init.get("period", 1.0))
    ard_dims = Dx if spec.ard else 1

    def full(shape, v):
        return torch.full(shape, float(v), dtype=dtype, device=device)

    def build(s: KernelSpec):
        if s.kind in _STATIONARY:
            return {"raw_lengthscale": full((Dy, ard_dims), np_inv_softplus(ls))}
        if s.kind == "periodic":
            return {"raw_lengthscale": full((Dy, ard_dims), np_inv_softplus(ls)),
                    "raw_period": full((Dy, ard_dims), np_inv_softplus(period))}
        if s.kind == "cosine":
            return {"raw_period": full((Dy, ard_dims), np_inv_softplus(period))}
        if s.kind == "white":
            return {"log_variance": full((Dy, 1), np.log(nv))}
        if s.kind == "scale":
            return {"raw_outputscale": full((Dy,), np_inv_softplus(ks)),
                    "child": build(s.children[0])}
        if s.kind in ("product", "additive"):
            return {"children": [build(c) for c in s.children]}
        raise NotImplementedError(s.kind)

    return build(spec)


# -- evaluation --------------------------------------------------------------

def _rbf_leaf(spec: KernelSpec, params, like):
    """(lengthscale (Dy, 1, Dx), output scale (Dy,)) of an rbf or scale(rbf)
    spec, the leaves that take the CUDA kernel; None for any other spec.
    The output scale of a bare rbf is 1."""
    if spec.kind == "rbf":
        ks = torch.ones((like.shape[0],), dtype=like.dtype, device=like.device)
        raw_ls = params["raw_lengthscale"]
    elif spec.kind == "scale" and spec.children[0].kind == "rbf":
        ks = softplus(params["raw_outputscale"])
        raw_ls = params["child"]["raw_lengthscale"]
    else:
        return None
    return softplus(raw_ls)[:, None, :], ks.contiguous()


def _scaled(X, raw_ls):
    """X / lengthscale, broadcasting ARD lengthscales (Dy, Dx) over
    (Dy, N, Dx)."""
    return X / softplus(raw_ls)[:, None, :]


def _stationary_from_d2(kind: str, d2):
    if kind == "rbf":
        return torch.exp(-0.5 * d2)
    r = torch.sqrt(d2 + 1e-20)
    if kind == "matern12":
        return torch.exp(-r)
    if kind == "matern32":
        a = math.sqrt(3.0) * r
        return (1.0 + a) * torch.exp(-a)
    if kind == "matern52":
        a = math.sqrt(5.0) * r
        return (1.0 + a + (5.0 / 3.0) * d2) * torch.exp(-a)
    raise NotImplementedError(kind)


def _combine(kind, parts):
    out = parts[0]
    for g in parts[1:]:
        out = out * g if kind == "product" else out + g
    return out


def gram(spec: KernelSpec, params, X1, X2, same: bool = False):
    """Full Gram matrix K(X1, X2): (Dy, N, M).

    `same=True` marks K(X, X) evaluations: a white kernel adds its noise to
    them (when N = M) and to nothing else.
    """
    leaf = _rbf_leaf(spec, params, X1)
    if leaf is not None:
        ls, ks = leaf
        return _rbf(X1 / ls, X2 / ls, ks)
    if spec.kind in _STATIONARY:
        d2 = _sq_dist(_scaled(X1, params["raw_lengthscale"]),
                      _scaled(X2, params["raw_lengthscale"]))
        return _stationary_from_d2(spec.kind, d2)
    if spec.kind == "periodic":
        ls = softplus(params["raw_lengthscale"])
        p = softplus(params["raw_period"])
        diff = X1[:, :, None, :] - X2[:, None, :, :]
        arg = math.pi * diff / p[:, None, None, :]
        return torch.exp(-2.0 * torch.sum(torch.square(torch.sin(arg))
                                          / torch.square(ls)[:, None, None, :],
                                          dim=-1))
    if spec.kind == "cosine":
        p = softplus(params["raw_period"])
        diff = X1[:, :, None, :] - X2[:, None, :, :]
        r = torch.sqrt(torch.sum(torch.square(diff / p[:, None, None, :]),
                                 dim=-1) + 1e-20)
        return torch.cos(2.0 * math.pi * r)
    if spec.kind == "white":
        Dy, N, M = X1.shape[0], X1.shape[-2], X2.shape[-2]
        if not same or N != M:
            return torch.zeros((Dy, N, M), dtype=X1.dtype, device=X1.device)
        var = torch.exp(params["log_variance"])                 # (Dy, 1)
        return var[..., None] * torch.eye(N, dtype=X1.dtype,
                                          device=X1.device)[None]
    if spec.kind == "scale":
        ks = softplus(params["raw_outputscale"])
        return ks[:, None, None] * gram(spec.children[0], params["child"],
                                        X1, X2, same)
    if spec.kind in ("product", "additive"):
        return _combine(spec.kind, [gram(c, p, X1, X2, same) for c, p in
                                    zip(spec.children, params["children"])])
    raise NotImplementedError(spec.kind)


def gram_pair(spec: KernelSpec, params, X, Z):
    """(K(X, Z), K(Z, Z)): (Dy, N, M) and (Dy, M, M), the two Grams of
    `marginal_qf` (port only; the JAX package calls `gram` twice).

    Recursive over the tree, combined as `gram` combines: each rbf or
    scale(rbf) leaf takes one `rbf_gram_pair` (on a CUDA tensor, one launch
    of the kernel for both Grams; on a CPU tensor, two plain Grams), with
    its lengthscale and output scale computed and Z scaled once; any other
    leaf takes two `gram` calls.  A K-component spectral mixture thus takes
    K launches.  In 'bf16' mode each of an rbf leaf's Grams takes the route
    of its own size (`_rbf`), and the pair is one launch only when both
    reach `BF16_KERNEL_MIN_ELEMS`.
    """
    leaf = _rbf_leaf(spec, params, X)
    if leaf is not None:
        ls, ks = leaf
        Xs, Zs = X / ls, Z / ls
        if _bf16_route(Xs, Zs) or _bf16_route(Zs, Zs):
            return _rbf(Xs, Zs, ks), _rbf(Zs, Zs, ks)
        return rbf_gram_pair(Xs.contiguous(), Zs.contiguous(), ks)
    if spec.kind == "scale":
        ks = softplus(params["raw_outputscale"])[:, None, None]
        Kxz, Kzz = gram_pair(spec.children[0], params["child"], X, Z)
        return ks * Kxz, ks * Kzz
    if spec.kind in ("product", "additive"):
        pairs = [gram_pair(c, p, X, Z)
                 for c, p in zip(spec.children, params["children"])]
        return (_combine(spec.kind, [k for k, _ in pairs]),
                _combine(spec.kind, [k for _, k in pairs]))
    return gram(spec, params, X, Z), gram(spec, params, Z, Z)


def gram_diag(spec: KernelSpec, params, X, same: bool = True):
    """diag K(X, X): (Dy, N)."""
    Dy, N = X.shape[0], X.shape[1]
    if spec.kind in _STATIONARY + ("periodic", "cosine"):
        return torch.ones((Dy, N), dtype=X.dtype, device=X.device)
    if spec.kind == "white":
        if not same:
            return torch.zeros((Dy, N), dtype=X.dtype, device=X.device)
        var = torch.exp(params["log_variance"])
        return torch.broadcast_to(var, (Dy, N)).to(X.dtype)
    if spec.kind == "scale":
        ks = softplus(params["raw_outputscale"])
        return ks[:, None] * gram_diag(spec.children[0], params["child"], X, same)
    if spec.kind in ("product", "additive"):
        return _combine(spec.kind, [gram_diag(c, p, X, same) for c, p in
                                    zip(spec.children, params["children"])])
    raise NotImplementedError(spec.kind)
