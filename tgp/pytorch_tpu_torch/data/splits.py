"""Split helpers shared by the loaders: a numpy copy of the JAX package's
`data/splits.py` (`k_fold_indices`, `k_fold`, `random_split_validation`,
`random_split_prop`)."""

from __future__ import annotations

import numpy as np


def k_fold_indices(n: int, fold: int, num_folds: int):
    """(train_idx, test_idx) of a contiguous k-fold split, scikit-learn's
    KFold(shuffle=False): the first n % k folds get one extra row."""
    if not 0 <= fold < num_folds:
        raise ValueError(f"fold {fold} out of range for {num_folds} folds")
    sizes = np.full(num_folds, n // num_folds, dtype=int)
    sizes[: n % num_folds] += 1
    edges = np.concatenate([[0], np.cumsum(sizes)])
    te = np.arange(edges[fold], edges[fold + 1])
    tr = np.concatenate([np.arange(0, edges[fold]),
                         np.arange(edges[fold + 1], n)])
    return tr, te


def k_fold(X, Y, fold: int, num_folds: int):
    """(X_tr, Y_tr, X_te, Y_te) of fold `fold` of a contiguous k-fold."""
    if X.shape[0] != Y.shape[0]:
        raise ValueError(f"X has {X.shape[0]} rows and Y {Y.shape[0]}")
    tr, te = k_fold_indices(X.shape[0], fold, num_folds)
    return X[tr], Y[tr], X[te], Y[te]


def random_split_validation(X, Y, seed: int, n_val: int):
    """Seeded permutation, last n_val rows held out (numpy's legacy global
    seed, as in the JAX package)."""
    n = X.shape[0]
    if n_val > n:
        raise ValueError(f"n_val {n_val} > rows {n}")
    np.random.seed(seed)
    perm = np.random.permutation(n)
    tr, va = perm[: n - n_val], perm[n - n_val:]
    return X[tr], Y[tr], X[va], Y[va]


def random_split_prop(X, Y, prop: float):
    """Head/tail split at the proportion `prop` (the rows were shuffled at
    load time, if at all)."""
    n_tr = int(X.shape[0] * prop)
    return X[:n_tr], Y[:n_tr], X[n_tr:], Y[n_tr:]
