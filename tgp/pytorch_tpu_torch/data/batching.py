"""Host-side minibatching: a numpy copy of the JAX package's
`data/batching.py` (`ArrayDataset`, `DataLoader`).

Shuffling draws from a private `np.random.Generator(PCG64(seed))`, so a
loader built with the same seed gives the same permutation stream as the
JAX package's: the port's Trainer and the JAX Trainer see the same batches.
"""

from __future__ import annotations

import numpy as np


class ArrayDataset:
    """In-memory (X, Y) dataset."""

    def __init__(self, X, Y):
        if X is None or Y is None:
            raise ValueError("ArrayDataset needs both X and Y")
        if X.shape[0] != Y.shape[0]:
            raise ValueError(f"X has {X.shape[0]} rows and Y {Y.shape[0]}")
        self.X = np.ascontiguousarray(X)
        self.Y = np.ascontiguousarray(Y)

    def __len__(self):
        return self.X.shape[0]


class DataLoader:
    """Shuffled minibatch iterator over an ArrayDataset.

    Each pass draws one permutation of the whole dataset and slices it into
    batches; the last batch holds the remainder unless `drop_last`.
    """

    def __init__(self, dataset: ArrayDataset, batch_size: int,
                 shuffle: bool = True, seed: int | None = 0,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.Generator(np.random.PCG64(seed)) if seed is not None \
            else np.random.default_rng()

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        idx = self._rng.permutation(n) if self.shuffle else np.arange(n)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, end, self.batch_size):
            sel = idx[start:start + self.batch_size]
            yield self.dataset.X[sel], self.dataset.Y[sel]
