"""K-means inducing point initialisation in numpy alone.

The JAX package calls scikit-learn's `KMeans(init="k-means++", n_init,
random_state=seed)`; the port cannot (the card's machine has no
scikit-learn), so this is a transcription of that estimator's dense Lloyd
path as scikit-learn 1.9 computes it:
  * X is centred by its column means and the tolerance is tol (1e-4) times
    the mean column variance;
  * each of the n_init runs seeds by greedy k-means++ (2 + int(log k) local
    trials per center, draws from one `np.random.RandomState(seed)` in
    scikit-learn's order), then runs Lloyd iterations (at most 300) until
    the labels repeat or the squared center shift falls to the tolerance;
  * a run replaces the best so far when its inertia is lower and its
    clustering differs.
Only the order of floating-point sums can differ from scikit-learn's
(its assignment step works in chunks of 256 rows across threads).
"""

from __future__ import annotations

import numpy as np

from .. import config as cfg

_MAX_ITER = 300
_TOL = 1e-4


def _sq_dists(A, B, B_sq):
    """||a - b||^2 for rows of A against rows of B, clamped at 0, as
    scikit-learn's `_euclidean_distances(squared=True)` forms it."""
    d = -2 * (A @ B.T)
    d += np.einsum("ij,ij->i", A, A)[:, None]
    d += B_sq[None, :]
    return np.maximum(d, 0, out=d)


def _kmeans_plusplus(X, k, x_sq, rs):
    n = X.shape[0]
    w = np.ones(n, dtype=X.dtype)
    n_local_trials = 2 + int(np.log(k))
    centers = np.empty((k, X.shape[1]), dtype=X.dtype)
    center_id = rs.choice(n, p=w / w.sum())
    centers[0] = X[center_id]
    closest = _sq_dists(X[[center_id]], X, x_sq)
    pot = closest @ w
    for c in range(1, k):
        rand_vals = rs.uniform(size=n_local_trials) * pot
        cand = np.searchsorted(np.cumsum(w * closest), rand_vals)
        np.clip(cand, None, closest.size - 1, out=cand)
        d_cand = _sq_dists(X[cand], X, x_sq)
        np.minimum(closest, d_cand, out=d_cand)
        cand_pot = d_cand @ w.reshape(-1, 1)
        best = np.argmin(cand_pot)
        pot = cand_pot[best]
        closest = d_cand[best]
        centers[c] = X[cand[best]]
    return centers


def _assign(X, centers):
    """Labels by the smallest ||c||^2 - 2 x.c (the first on a tie)."""
    d = X @ centers.T
    d *= -2.0
    d += np.einsum("ij,ij->i", centers, centers)[None, :]
    return np.argmin(d, axis=1).astype(np.int32)


def _lloyd_step(X, centers, labels):
    """One assignment and update: (labels, new centers, center shifts)."""
    k, D = centers.shape
    labels[:] = _assign(X, centers)
    weight = np.bincount(labels, minlength=k).astype(X.dtype)
    new = np.stack([np.bincount(labels, weights=X[:, j], minlength=k)
                    for j in range(D)], axis=1)
    empty = np.where(weight == 0)[0]
    if empty.size:
        # scikit-learn's relocation: the points farthest from their center
        # become the empty clusters' centers
        dist = ((X - centers[labels]) ** 2).sum(axis=1)
        far = np.argpartition(dist, -empty.size)[:-empty.size - 1:-1]
        if np.max(dist) > 0:
            for new_id, idx in zip(empty, far):
                old_id = labels[idx]
                new[old_id] -= X[idx]
                new[new_id] = X[idx]
                weight[new_id] = 1.0
                weight[old_id] -= 1.0
    argmax_w = np.argmax(weight)
    for j in range(k):
        if weight[j] > 0:
            new[j] *= 1.0 / weight[j]
        else:
            new[j] = new[argmax_w]
    shift = np.sqrt(((new - centers) ** 2).sum(axis=1))
    return new, shift


def _kmeans_single(X, centers, tol):
    labels = np.full(X.shape[0], -1, dtype=np.int32)
    labels_old = labels.copy()
    strict = False
    for _ in range(_MAX_ITER):
        centers, shift = _lloyd_step(X, centers, labels)
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old[:] = labels
    if not strict:
        labels = _assign(X, centers)
    inertia = float(((X - centers[labels]) ** 2).sum())
    return labels, inertia, centers


def _same_clustering(labels1, labels2, k):
    mapping = np.full(k, -1, dtype=np.int32)
    for a, b in zip(labels1, labels2):
        if mapping[a] == -1:
            mapping[a] = b
        elif mapping[a] != b:
            return False
    return True


def kmeans_centers(X, num_Z: int, n_init: int = 1, seed: int | None = None):
    """(num_Z, Dx) k-means++ / Lloyd centers of X, best of n_init runs
    from `np.random.RandomState(seed)` (default: `config.config_seed`)."""
    if seed is None:
        seed = cfg.config_seed
    X = np.array(X, dtype=np.float64, order="C")
    tol = np.mean(np.var(X, axis=0)) * _TOL
    X_mean = X.mean(axis=0)
    X -= X_mean
    x_sq = np.einsum("ij,ij->i", X, X)
    rs = np.random.RandomState(seed)
    best = None
    for _ in range(n_init):
        init = _kmeans_plusplus(X, num_Z, x_sq, rs)
        labels, inertia, centers = _kmeans_single(X, init, tol)
        if best is None or (inertia < best[1] and not _same_clustering(
                labels, best[0], num_Z)):
            best = (labels, inertia, centers)
    return best[2] + X_mean
