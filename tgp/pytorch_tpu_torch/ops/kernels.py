"""Batched ARD Gram-matrix kernels: the `rbf` and `scale` subset of the JAX
package's `ops/kernels.py`.

  * a kernel is a static `KernelSpec` tree plus a dict of parameters,
  * `gram(spec, params, X1, X2, same=...)` returns (Dy, N, M) Gram matrices;
    `gram_diag(spec, params, X)` returns (Dy, N) diagonals;
  * `gram_pair(spec, params, X, Z)` returns (K(X, Z), K(Z, Z)) in one call.

Routing departs from the JAX package on purpose: its gate `_pallas_ok`
sends only fp32 Grams of at least 2^18 elements to Pallas, to amortise a
launch on the TPU.  Here every `rbf` or `scale(rbf)` Gram of a CUDA tensor,
in fp32 and fp64, goes through the CUDA kernels (`ops/rbf_gram.py`), and a
CPU tensor takes the plain version.  Other kinds raise NotImplementedError
until ROADMAP Queue 1 item 17 ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .. import config as cfg
from .rbf_gram import rbf_gram, rbf_gram_pair, sq_dist as _sq_dist  # noqa: F401 (JAX name)
from .transforms import softplus, np_inv_softplus

_TODO = "is not ported yet (ROADMAP Queue 1 item 17)"


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Static kernel description (hashable)."""

    kind: str
    children: Tuple["KernelSpec", ...] = ()
    ard: bool = True

    def __post_init__(self):
        if self.kind in ("scale",) and len(self.children) != 1:
            raise ValueError("scale kernel needs exactly one child")
        if self.kind in ("product", "additive") and len(self.children) < 1:
            raise ValueError(f"{self.kind} kernel needs children")


def rbf():
    return KernelSpec("rbf")


def scale(child: KernelSpec):
    return KernelSpec("scale", (child,))


def from_name(name: str) -> KernelSpec:
    """Name-compatible factory (the ported subset of the JAX table)."""
    table = {"rbf": rbf(), "scale_rbf": scale(rbf())}
    if name in ("matern32", "scale_matern32", "matern52", "scale_matern52",
                "whitenoise", "periodic", "cosine"):
        raise NotImplementedError(f"kernel {name!r} {_TODO}")
    if name not in table:
        raise NotImplementedError(f"unknown kernel name {name!r}")
    return table[name]


def init_params(spec: KernelSpec, Dy: int, Dx: int, init: dict | None = None,
                dtype=None, device=None):
    """Parameter dict for `spec`, batched over Dy outputs.

    `init` accepts 'length_scale' and 'kernel_scale' (inv-softplus loaded).
    """
    init = dict(init or {})
    dtype = dtype or cfg.default_dtype()
    device = cfg.resolve_device(device)
    ls = float(init.get("length_scale", 1.0))
    ks = float(init.get("kernel_scale", 1.0))
    ard_dims = Dx if spec.ard else 1

    def build(s: KernelSpec):
        if s.kind == "rbf":
            return {"raw_lengthscale": torch.full(
                (Dy, ard_dims), float(np_inv_softplus(ls)), dtype=dtype,
                device=device)}
        if s.kind == "scale":
            return {"raw_outputscale": torch.full(
                        (Dy,), float(np_inv_softplus(ks)), dtype=dtype,
                        device=device),
                    "child": build(s.children[0])}
        raise NotImplementedError(f"kernel kind {s.kind!r} {_TODO}")

    return build(spec)


def _rbf_parts(spec: KernelSpec, params, like):
    """(lengthscale (Dy, 1, Dx), output scale (Dy,)) of an rbf or scale(rbf)
    spec; the output scale of a bare rbf is 1."""
    if spec.kind == "rbf":
        ks = torch.ones((like.shape[0],), dtype=like.dtype, device=like.device)
        raw_ls = params["raw_lengthscale"]
    elif spec.kind == "scale":
        child = spec.children[0]
        if child.kind != "rbf":
            raise NotImplementedError(f"scale({child.kind}) {_TODO}")
        ks = softplus(params["raw_outputscale"])
        raw_ls = params["child"]["raw_lengthscale"]
    else:
        raise NotImplementedError(f"kernel kind {spec.kind!r} {_TODO}")
    return softplus(raw_ls)[:, None, :], ks.contiguous()


def gram(spec: KernelSpec, params, X1, X2, same: bool = False):
    """Full Gram matrix K(X1, X2): (Dy, N, M).

    `same` marks K_xx evaluations (it only matters for white-noise kernels,
    which are not ported yet).
    """
    ls, ks = _rbf_parts(spec, params, X1)
    return rbf_gram((X1 / ls).contiguous(), (X2 / ls).contiguous(), ks)


def gram_pair(spec: KernelSpec, params, X, Z):
    """(K(X, Z), K(Z, Z)): (Dy, N, M) and (Dy, M, M), the two Grams of
    `marginal_qf` (port only; the JAX package calls `gram` twice).

    The lengthscale and output scale are computed once and Z is scaled once;
    a CUDA tensor takes one kernel launch for both Grams, a CPU tensor two
    `rbf_gram_reference` calls.
    """
    ls, ks = _rbf_parts(spec, params, X)
    return rbf_gram_pair((X / ls).contiguous(), (Z / ls).contiguous(), ks)


def gram_diag(spec: KernelSpec, params, X, same: bool = True):
    """diag K(X, X): (Dy, N)."""
    Dy, N = X.shape[0], X.shape[1]
    if spec.kind == "rbf":
        return torch.ones((Dy, N), dtype=X.dtype, device=X.device)
    if spec.kind == "scale":
        ks = softplus(params["raw_outputscale"])
        return ks[:, None] * gram_diag(spec.children[0], params["child"], X, same)
    raise NotImplementedError(f"kernel kind {spec.kind!r} {_TODO}")
