"""UCI classification datasets: the port's own copy (numpy only) of the JAX
package's `data/uci_classification.py`, which follows the reference
code/dsp/data/uci_datasets_classification.py —
  * Avila    (given train/test split file, 12 classes)
  * Banknote (committed split pickle, binary)
  * Movement (multi-file RSS sequence preprocessing, reference :121-154)
  * Activity (7-class AReM with CSV repair, reference :196-259)
  * Heart    (binary; categorical columns excluded from z-scoring,
              reference :287)

Only the split pickles are committed upstream; the raw corpora download
from the UCI repository.  With zero egress here, loaders look for the files
under data_assets/classification/uci/<name>/ and raise an actionable error
otherwise; all preprocessing logic is implemented and unit-tested on
synthetic files.
"""

from __future__ import annotations

import os
import pickle
import glob

import numpy as np

from .splits import random_split_validation
from .uci import _asset_path, standard_normalize

DOWNLOAD_URLS = {
    "avila": "https://archive.ics.uci.edu/ml/machine-learning-databases/00459/avila.zip",
    "banknote": "https://archive.ics.uci.edu/ml/machine-learning-databases/00267/data_banknote_authentication.txt",
    "movement": "https://archive.ics.uci.edu/ml/machine-learning-databases/00348/MovementAAL.zip",
    "activity": "https://archive.ics.uci.edu/ml/machine-learning-databases/00366/AReM.zip",
    "heart": "https://archive.ics.uci.edu/ml/machine-learning-databases/00519/heart_failure_clinical_records_dataset.csv",
}

#: columns excluded from z-scoring for heart (binary/categorical features,
#: reference: uci_datasets_classification.py:287)
HEART_CATEGORICAL = (1, 3, 5, 9, 10)


def _require(path, name):
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"classification corpus {name!r} not present at {path}. Download "
            f"from {DOWNLOAD_URLS.get(name, 'the UCI repository')} into "
            f"data_assets/classification/uci/ (zero-egress environment: "
            f"only the split pickles are committed)")
    return path


def _split_from_pickle(pkl_name: str, seed: int, n_rows: int):
    pkl = _asset_path("classification", pkl_name)
    with open(pkl, "rb") as f:
        split = pickle.load(f)
    tr = split[f"seed_{seed}"]["train"]
    te = split[f"seed_{seed}"]["test"]
    assert max(tr.max(), te.max()) < n_rows
    return tr, te


def load_banknote(seed: int, use_validation=None):
    """Banknote authentication: 4 features, binary target (last column)."""
    path = _require(_asset_path("classification",
                                "data_banknote_authentication.txt"), "banknote")
    data = np.loadtxt(path, delimiter=",")
    tr, te = _split_from_pickle("splits_idx_data_banknote_authentication.pkl",
                                seed, data.shape[0])
    return _finish(data[tr, :-1], data[tr, -1], data[te, :-1], data[te, -1],
                   use_validation)


def load_heart(seed: int, use_validation=None):
    """Heart-failure records: binary DEATH_EVENT target; categorical columns
    kept un-normalised (reference: uci_datasets_classification.py:287)."""
    path = _require(_asset_path(
        "classification", "heart_failure_clinical_records_dataset.csv"), "heart")
    data = np.genfromtxt(path, delimiter=",", skip_header=1)
    tr, te = _split_from_pickle(
        "splits_idx_heart_failure_clinical_records_dataset.pkl", seed,
        data.shape[0])
    return _finish(data[tr, :-1], data[tr, -1], data[te, :-1], data[te, -1],
                   use_validation, categorical_cols=HEART_CATEGORICAL)


def load_avila(seed: int = None, use_validation=None):
    """Avila bible-copyist classification: the corpus ships its own
    train/test split files (avila-tr.txt / avila-ts.txt); 12 classes coded
    A..Y in the last column."""
    base = _require(_asset_path("classification", "avila"), "avila")
    classes = list("ABCDEFGHIWXY")

    def read(fname):
        rows = []
        with open(os.path.join(base, fname)) as f:
            for line in f:
                parts = line.strip().split(",")
                if len(parts) < 2:
                    continue
                rows.append([float(v) for v in parts[:-1]] +
                            [float(classes.index(parts[-1]))])
        return np.asarray(rows)

    tr = read("avila-tr.txt")
    te = read("avila-ts.txt")
    return _finish(tr[:, :-1], tr[:, -1], te[:, :-1], te[:, -1], use_validation)


def parse_movement_rss(dataset_dir: str):
    """MovementAAL: one CSV per sequence (RSS readings); the reference
    flattens each sequence's per-column means into one feature row and takes
    the movement label from the target file (reference:
    uci_datasets_classification.py:121-154)."""
    target_file = os.path.join(dataset_dir, "MovementAAL_target.csv")
    targets = {}
    with open(target_file) as f:
        next(f)
        for line in f:
            sid, lab = line.strip().split(",")
            targets[int(sid)] = (int(lab) + 1) // 2  # {-1,1} -> {0,1}
    feats, labels = [], []
    for path in sorted(glob.glob(os.path.join(dataset_dir, "MovementAAL_RSS_*.csv"))):
        sid = int(os.path.basename(path).split("_")[-1].split(".")[0])
        arr = np.genfromtxt(path, delimiter=",", skip_header=1)
        feats.append(arr.mean(axis=0))
        labels.append(targets[sid])
    return np.asarray(feats), np.asarray(labels, dtype=np.float64)


def load_movement(seed: int, use_validation=None):
    base = _require(_asset_path("classification", "MovementAAL"), "movement")
    X, y = parse_movement_rss(os.path.join(base, "dataset"))
    tr, te = _split_from_pickle("splits_idx_movement.pkl", seed, X.shape[0])
    return _finish(X[tr], y[tr], X[te], y[te], use_validation)


def repair_arem_csv(path: str) -> np.ndarray:
    """AReM CSVs carry '# ' comment headers and occasional malformed rows
    (missing fields); the reference repairs them by dropping short rows
    (reference: uci_datasets_classification.py:196-259)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            if len(parts) < 7:
                continue
            try:
                rows.append([float(v) for v in parts[:7]])
            except ValueError:
                continue
    return np.asarray(rows)


ACTIVITY_CLASSES = ("bending1", "bending2", "cycling", "lying", "sitting",
                    "standing", "walking")


def load_activity(seed: int, use_validation=None):
    """AReM activity recognition: 7 classes, one directory per activity,
    one repaired CSV per session; features are per-session column means."""
    base = _require(_asset_path("classification", "AReM"), "activity")
    feats, labels = [], []
    for ci, cname in enumerate(ACTIVITY_CLASSES):
        for path in sorted(glob.glob(os.path.join(base, cname, "*.csv"))):
            arr = repair_arem_csv(path)
            if arr.size == 0:
                continue
            feats.append(arr[:, 1:].mean(axis=0))  # drop time column
            labels.append(float(ci))
    X, y = np.asarray(feats), np.asarray(labels)
    rng = np.random.RandomState(seed)
    perm = rng.permutation(X.shape[0])
    n_tr = int(0.9 * X.shape[0])
    tr, te = perm[:n_tr], perm[n_tr:]
    return _finish(X[tr], y[tr], X[te], y[te], use_validation)


def _finish(X_tr, y_tr, X_te, y_te, use_validation, categorical_cols=()):
    y_tr = y_tr.reshape(-1, 1)
    y_te = y_te.reshape(-1, 1)
    X_va = Y_va = None
    if use_validation is not None:
        # shared helper, not perm[:-n_val]: that form empties the training
        # set when n_val == 0
        val_seed, n_val = use_validation
        X_tr, y_tr, X_va, Y_va = random_split_validation(
            X_tr, y_tr, val_seed, n_val)
    out = standard_normalize(X_tr, y_tr, X_va, Y_va, X_te, y_te,
                             categorical_cols=categorical_cols,
                             normalize_y=False)
    out["Y_std"] = np.ones(1)
    return out


def synthetic_corpus(kind: str):
    """Fixed synthetic classification corpora (the zero-egress stand-ins the
    measured classification protocol runs on), draw for draw the JAX
    package's: `experiments/classification_protocol.py` and the registry's
    synthetic loaders take it from here.  The corpus is FIXED
    (RandomState(0)); only the split varies by seed."""
    rng = np.random.RandomState(0)
    N, Dx = 1200, 4
    X = rng.randn(N, Dx)
    if kind == "binary":
        logits = np.sin(2 * X[:, 0]) + X[:, 1] * X[:, 2]
        y = (logits + 0.4 * rng.randn(N) > 0).astype(np.float64)
    else:
        W = rng.randn(Dx, 3)
        scores = np.tanh(X @ W) + 0.3 * rng.randn(N, 3)
        y = np.argmax(scores, axis=1).astype(np.float64)
    return X, y


def _load_synthetic(kind: str, seed: int, use_validation=None):
    """Seeded 90/10 split of the fixed corpus (split protocol as
    UCI_data.__generate_splits__, reference uci_datasets.py:109-134)."""
    X, y = synthetic_corpus(kind)
    np.random.seed(seed)
    perm = np.random.permutation(X.shape[0])
    n_tr = int(0.9 * X.shape[0])
    tr, te = perm[:n_tr], perm[n_tr:]
    return _finish(X[tr], y[tr], X[te], y[te], use_validation)


def load_synthetic_binary(seed: int, use_validation=None):
    return _load_synthetic("binary", seed, use_validation)


def load_synthetic_multiclass(seed: int, use_validation=None):
    return _load_synthetic("multiclass", seed, use_validation)


CLASSIFICATION_LOADERS = {
    "banknote": load_banknote,
    "heart": load_heart,
    "avila": load_avila,
    "movement": load_movement,
    "activity": load_activity,
    "synthetic_binary": load_synthetic_binary,
    "synthetic_multiclass": load_synthetic_multiclass,
}

NUM_CLASSES = {"banknote": 2, "heart": 2, "avila": 12, "movement": 2,
               "activity": 7, "synthetic_binary": 2,
               "synthetic_multiclass": 3}
