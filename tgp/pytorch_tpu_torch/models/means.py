"""Mean functions: zero, identity (a fixed projection of the inputs) and
linear (counterpart of the JAX package's `models/means.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config as cfg


def projection_matrix(Dx: int, Dy: int, X: np.ndarray) -> np.ndarray:
    """Projection W (Dx, Dy) for the identity mean: the identity if Dy ==
    Dx, the identity padded with zeros if Dy > Dx, and the first Dy right
    singular vectors of the training inputs (numpy's SVD) if Dy < Dx."""
    X = np.asarray(X)
    if Dy == Dx:
        return np.eye(Dx)
    if Dy > Dx:
        return np.concatenate([np.eye(Dx), np.zeros((Dx, Dy - Dx))], axis=1)
    _, _, V = np.linalg.svd(X, full_matrices=False)
    return V[:Dy, :].T


def mean_init(kind: str, Dy: int, Dx: int, X=None, dtype=None, device=None,
              seed: int | None = None):
    """Parameter dict for a mean function.

    'identity' stores W as (Dy, Dx); the Trainer freezes it
    (`train.trainer.frozen_param_labels`).  'linear' draws its slopes a
    (Dy, Dx) from `np.random.RandomState(seed)` (`config.config_seed` when
    None), the JAX package's draw, and starts its offsets b (Dy, 1) at 0.
    """
    dtype = dtype or cfg.default_dtype()
    device = cfg.resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=device)

    if kind == "zero":
        return {}
    if kind == "identity":
        return {"W": t(projection_matrix(Dx, Dy, X).T)}
    if kind == "linear":
        rng = np.random.RandomState(cfg.config_seed if seed is None else seed)
        return {"a": t(rng.randn(Dy, Dx)), "b": t(np.zeros((Dy, 1)))}
    raise NotImplementedError(kind)


def mean_apply(kind: str, params, X):
    """m(X): X (Dy, N, Dx) -> (Dy, N)."""
    if kind == "zero":
        return torch.zeros(X.shape[:-1], dtype=X.dtype, device=X.device)
    if kind == "identity":
        return torch.einsum("dnk,dk->dn", X, params["W"])
    if kind == "linear":
        return torch.einsum("dnk,dk->dn", X, params["a"]) + params["b"]
    raise NotImplementedError(kind)
