"""Model weights and specs from outside the port.

  * `params_from_jax` turns a JAX-package parameter tree, given as numpy
    arrays, into the port's params: the layout is the same dict/list tree
    (an input-dependent step's nets as `net_*/layers/[i]/{W, b, bn, ...}`),
    so this is a leaf-wise conversion, and a replica-stacked tree (the JAX
    package's `train/multiseed.stack_trees`) carries across as one stack.
    `params_to_numpy` is its inverse.
  * `spec_from_dict` (`models/serialization.py`) builds the port's
    `TGPSpec` or `DeepTGPSpec` from the dict that the JAX package's
    `models/serialization.py::spec_to_dict` emits, hypernet specs included.
  * `flagship_spec` / `flagship_params` build the flagship TGP that the
    serving path is measured on (the shapes of `benchmarks/serving.py`), with
    a seeded numpy perturbation of its init so that the flow is not the
    identity and the posterior is not trivial.  No trained weights ship with
    the repo: a model trained by the port's `train.Trainer` serves as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config as cfg
from .flows import generators
from .flows.core import spec_from_list
from .likelihoods.gaussian import LikelihoodSpec
from .models.serialization import spec_from_dict  # noqa: F401
from .models.tgp import TGPSpec, init_tgp_params
from .ops.kernels import from_name


def tree_map(fn, tree):
    """Apply fn to every leaf of a params tree (dicts, lists, tuples);
    dict keys are visited in sorted order, so draws taken inside fn come in
    a fixed order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree):
    """The leaves of a params tree as a list, in `tree_map`'s order (the
    order in which `jax.tree_util` flattens the same tree)."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """A tree shaped as `like` holding `leaves` (in `tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def params_from_jax(tree, device=None, dtype=None):
    """JAX-package params (leaves as numpy arrays) -> the port's params."""
    dtype = dtype or cfg.default_dtype()
    device = cfg.resolve_device(device)
    # torch.tensor copies: JAX hands out read-only numpy views
    return tree_map(
        lambda a: torch.tensor(np.asarray(a), dtype=dtype).to(device), tree)


def params_to_numpy(tree):
    """The port's params -> the same tree with numpy leaves (host copies),
    which the JAX package takes as its params."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


# ---------------------------------------------------------------------------
# the flagship serving model
# ---------------------------------------------------------------------------

FLAGSHIP_M = 100


def flagship_spec(N: int, Dx: int = 4, M: int = FLAGSHIP_M,
                  quad: int = 100) -> TGPSpec:
    """TGP with a 2-block SAL flow, a scale-RBF ARD kernel, whitened q(U)
    and the gaussian_flow likelihood, as `benchmarks/serving.py` builds it."""
    fspec, _ = spec_from_list(generators.SAL(2))
    return TGPSpec(Dy=1, Dx=Dx, M=M, N=float(N), kernel=from_name("scale_rbf"),
                   likelihood=LikelihoodSpec("gaussian_flow", 1,
                                             quad_points=quad),
                   flow=fspec)


def perturb_params(params, seed: int):
    """Seeded numpy perturbation of a params tree (any device or dtype).

    Z moves by 0.1 randn, q_mu by randn, q_L becomes 0.5 q_L plus a lower
    triangle of 0.05 randn, and every kernel, flow and likelihood parameter
    moves by 0.2 randn.  Draws are float64 and taken in a fixed order.
    """
    rng = np.random.RandomState(seed)

    def add(t, s):
        d = torch.as_tensor(s * rng.randn(*t.shape), dtype=t.dtype)
        return t + d.to(t.device)

    out = dict(params)
    out["Z"] = add(params["Z"], 0.1)
    out["q_mu"] = add(params["q_mu"], 1.0)
    L = params["q_L"]
    tri = torch.as_tensor(np.tril(0.05 * rng.randn(*L.shape)), dtype=L.dtype)
    out["q_L"] = 0.5 * L + tri.to(L.device)
    for key in ("kernel", "flow", "likelihood"):
        out[key] = tree_map(lambda t: add(t, 0.2), params[key])
    return out


def flagship_init(spec: TGPSpec, X_train, variance_scale: float = 1.0,
                  dtype=None, device=None):
    """The flagship's init: Z = the first M training rows, lengthscale and
    output scale 2, noise 0.05, identity SAL blocks, whitened q(U) =
    N(0, variance_scale I)."""
    return init_tgp_params(
        spec, X_train, np.asarray(X_train)[:spec.M],
        variance_scale=variance_scale,
        kernel_init={"length_scale": 2.0, "kernel_scale": 2.0},
        noise_init=0.05, dtype=dtype, device=device)


def flagship_params(spec: TGPSpec, X_train, seed: int = 0, dtype=None,
                    device=None):
    """The flagship's init (`flagship_init`) perturbed by
    `perturb_params(seed)`."""
    return perturb_params(
        flagship_init(spec, X_train, dtype=dtype, device=device), seed)
