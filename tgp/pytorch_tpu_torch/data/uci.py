"""UCI regression datasets with the committed fixed splits: a numpy-only
copy of the JAX package's `data/uci.py` (`load_uci_split`,
`standard_normalize`).

The CSVs are parsed with `np.loadtxt` (no pandas, no native parser), and
their md5 sums are checked as in the JAX package.  The classification
loaders live in `uci_classification.py`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
from pathlib import Path

import numpy as np

from .splits import random_split_validation

_DEFAULT_ROOT = str(Path(__file__).resolve().parents[3] / "data_assets")


def data_root() -> str:
    """The root of the data tables: `TGP_DATA_ROOT`, read at each call, else
    the repository's `data_assets/`."""
    return os.environ.get("TGP_DATA_ROOT", _DEFAULT_ROOT)


@dataclasses.dataclass
class UCISpec:
    name: str            # csv filename
    sep: str = ","
    header: bool = False
    target_index: int = -1
    task: str = "regression"
    md5: str | None = None
    categorical_cols: tuple = ()


UCI_TABLE = {
    "boston":     UCISpec("boston.csv", md5="686696c995bd450cdd718dad546014e0"),
    "concrete":   UCISpec("concrete.csv", md5="5b5b69bd932abfcab8062214cb48d5aa"),
    "kin8nm":     UCISpec("kin8nm.csv", md5="5d5e02dacbad6451fc6310bc2163cd7a"),
    "protein":    UCISpec("protein.csv", md5="2617524f6f3393d482b12a17329556eb"),
    "energy":     UCISpec("energy.csv", target_index=-2, md5="fdc160476bde85d01ab75b1e2b1c63c8"),
    "power":      UCISpec("power.csv", md5="4c0814dc6aec16aad6500f37243f16a0"),
    "wine_red":   UCISpec("wine-red.csv", md5="3a55dc882b07a5c342137152622d07fa"),
    "wine_white": UCISpec("wine-white.csv", sep=";", md5="024acd1a22808344471a56f318a49016"),
    "naval":      UCISpec("naval.tsv", sep=r"\s+", md5="4a95e860425c9cf765b56f0134ad99cf"),
}


def _asset_path(task: str, fname: str) -> str:
    return os.path.join(data_root(), task, "uci", fname)


def _check_md5(path: str, md5: str | None):
    if md5 is None:
        return
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    if h.hexdigest() != md5:
        raise ValueError(f"dataset file {path} is corrupted (md5 mismatch)")


def _load_csv(path: str, sep: str, header: bool) -> np.ndarray:
    delimiter = None if sep == r"\s+" else sep
    return np.loadtxt(path, delimiter=delimiter, skiprows=1 if header else 0,
                      dtype=np.float64, ndmin=2)


def load_uci_split(name: str, seed: int, use_validation=None,
                   normalize_y: bool = True):
    """Load a UCI dataset with the committed train/test split for `seed`.

    Returns dict with X_tr, Y_tr, X_va, Y_va, X_te, Y_te, Y_std, Y_mean.
    """
    spec = UCI_TABLE[name]
    path = _asset_path(spec.task, spec.name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"dataset asset {path} missing")
    _check_md5(path, spec.md5)
    data = _load_csv(path, spec.sep, spec.header)

    split_file = _asset_path(
        spec.task, "splits_idx_" + spec.name.split(".")[0] + ".pkl")
    if os.path.exists(split_file):
        # a pickle committed with the data (its md5-pinned companion)
        with open(split_file, "rb") as f:
            split_dict = pickle.load(f)
        tr_idx = split_dict[f"seed_{seed}"]["train"]
        te_idx = split_dict[f"seed_{seed}"]["test"]
    else:
        # no committed pickle: the seeded legacy shuffle, first 90% train
        shuffled = data.copy()
        np.random.seed(seed)
        np.random.shuffle(shuffled)
        n_tr = int(shuffled.shape[0] * 0.9)
        data = shuffled
        tr_idx = np.arange(n_tr)
        te_idx = np.arange(n_tr, shuffled.shape[0])

    # target_index -1: Y is the last column; -2 (energy): the second-to-last
    # is regressed and the last is dropped
    idx = spec.target_index
    X_tr, X_te = data[tr_idx][:, :idx], data[te_idx][:, :idx]
    Y_tr = data[tr_idx][:, idx:None if idx == -1 else idx + 1]
    Y_te = data[te_idx][:, idx:None if idx == -1 else idx + 1]

    X_va = Y_va = None
    if use_validation is not None:
        val_seed, n_val = use_validation
        X_tr, Y_tr, X_va, Y_va = random_split_validation(
            X_tr, Y_tr, val_seed, n_val)

    return standard_normalize(X_tr, Y_tr, X_va, Y_va, X_te, Y_te,
                              categorical_cols=spec.categorical_cols,
                              normalize_y=normalize_y)


def standard_normalize(X_tr, Y_tr, X_va, Y_va, X_te, Y_te,
                       categorical_cols=(), normalize_y=True):
    """Z-score with train statistics; categorical columns untouched."""
    eps = 1e-15
    X_mean = X_tr.mean(0)
    X_std = X_tr.std(0) + eps
    mask = np.ones(X_tr.shape[1], dtype=bool)
    if len(categorical_cols):
        mask[list(categorical_cols)] = False

    def nx(X):
        if X is None:
            return None
        X = X.copy()
        X[:, mask] = (X[:, mask] - X_mean[mask]) / X_std[mask]
        return X

    if normalize_y:
        Y_mean = Y_tr.mean(0)
        Y_std = Y_tr.std(0) + eps
    else:
        Y_mean, Y_std = 0.0, np.ones(Y_tr.shape[1]) if Y_tr.ndim > 1 else 1.0

    def ny(Y):
        if Y is None:
            return None
        return (Y - Y_mean) / Y_std if normalize_y else Y

    return {
        "X_tr": nx(X_tr), "Y_tr": ny(Y_tr),
        "X_va": nx(X_va), "Y_va": ny(Y_va),
        "X_te": nx(X_te), "Y_te": ny(Y_te),
        "Y_std": np.atleast_1d(np.asarray(Y_std, dtype=np.float64)),
        "Y_mean": Y_mean,
    }
