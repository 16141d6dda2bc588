"""The large, spatial and time-series regression corpora: a copy of the JAX
package's `data/large.py` without pandas.

  * `load_airline`: the 2008 flights (2,058,097 rows after filtering, 8
    features and the delay), with the split of `splits_idx_airline.pkl`
    when it is present, else a seeded permutation whose first
    min(AIRLINE_N_TR, 0.95 n) rows train.
  * `load_year`: YearPredictionMSD, the target in the first column, its
    prescribed split (the first 463,715 rows train).
  * `load_rainfall`: SIC97 rainfall from pickled partitions, targets
    unnormalised (Y_std = 1).
  * `load_rainfall_spatial`: SIC97 over plain (x, y) coordinates, k-fold
    or a seeded random split over stations.
  * `load_air_quality`: one LAQN site's pm25 over a window of dates, k-fold
    or a head/tail split.

The tables live under the data root (`uci.data_root()`: `TGP_DATA_ROOT`,
read at each call, or `data_assets/`); a missing table raises
FileNotFoundError naming it.  Nothing downloads.  The numeric tables
(airline, year) are parsed by the native parser (`native.read_csv`, built
with g++, which the CUDA build needs too; it raises where it cannot be
built, and the tests hold it against `np.loadtxt`).  The CSVs with named
columns (SIC97, LAQN) are read with the standard
library's `csv` module with pandas' semantics: an empty or NA field is NaN
(and the LAQN rows whose species is NaN are dropped), dates are parsed as
naive datetimes and turned into seconds since the epoch.
"""

from __future__ import annotations

import csv
import os
import pickle

import numpy as np

from . import native
from .splits import k_fold, random_split_prop, random_split_validation
from .uci import data_root, standard_normalize

AIRLINE_N_TR = 2058097 - 100000

# pandas' default NA strings (`pandas.read_csv(na_values=None)`)
_NA_STRINGS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])


def _require(path, name, hint):
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{name} corpus missing at {path}. {hint} (zero-egress: run the "
            f"dataset tooling offline, see tools/ in the reference)")
    return path


def _read_columns(path: str) -> dict:
    """{column name: list of field strings} of a CSV with a header row
    (blank lines skipped, as pandas skips them)."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    header, body = rows[0], rows[1:]
    for r in body:
        if len(r) != len(header):
            raise ValueError(f"{path}: a row has {len(r)} fields, the header "
                             f"{len(header)}")
    return {name: [r[i] for r in body] for i, name in enumerate(header)}


def _floats(fields) -> np.ndarray:
    return np.array([np.nan if s in _NA_STRINGS else float(s)
                     for s in fields], dtype=np.float64)


def _datetimes(fields) -> np.ndarray:
    """Naive date strings as datetime64[ns]."""
    return np.array([np.datetime64(s, "ns") for s in fields],
                    dtype="datetime64[ns]")


def _validation(X_tr, Y_tr, use_validation):
    if use_validation is None:
        return X_tr, Y_tr, None, None
    val_seed, n_val = use_validation
    return random_split_validation(X_tr, Y_tr, val_seed, n_val)


def load_airline(seed: int = 1, use_validation=None,
                 data_dir: str | None = None):
    """The 2008 airline delays: `airline.csv` (features, then the target in
    the last column) and, when present, `splits_idx_airline.pkl`."""
    d = data_dir or os.path.join(data_root(), "regression", "airline")
    data = native.read_csv(_require(
        os.path.join(d, "airline.csv"), "airline",
        "Produce airline.csv with the dataverse download + awk pipeline"))
    split_pkl = os.path.join(d, "splits_idx_airline.pkl")
    if os.path.exists(split_pkl):
        with open(split_pkl, "rb") as f:
            split = pickle.load(f)
        tr = split[f"seed_{seed}"]["train"]
        te = split[f"seed_{seed}"]["test"]
    else:
        np.random.seed(seed)
        perm = np.random.permutation(data.shape[0])
        n_tr = min(AIRLINE_N_TR, int(0.95 * data.shape[0]))
        tr, te = perm[:n_tr], perm[n_tr:]
    X_tr, Y_tr, X_va, Y_va = _validation(data[tr, :-1], data[tr, -1:],
                                         use_validation)
    return standard_normalize(X_tr, Y_tr, X_va, Y_va, data[te, :-1],
                              data[te, -1:])


def load_year(seed: int = 1, use_validation=None, data_dir: str | None = None,
              n_train: int = 463715):
    """YearPredictionMSD: `YearPredictionMSD.txt`, the year in the first
    column, the first `n_train` rows train (the prescribed 463,715; smaller
    for small files).  `seed` is unused: the split is fixed."""
    d = data_dir or os.path.join(data_root(), "regression", "uci")
    data = native.read_csv(_require(
        os.path.join(d, "YearPredictionMSD.txt"), "year",
        "Download YearPredictionMSD.txt.zip from the UCI archive"))
    X, Y = data[:, 1:], data[:, :1]
    X_tr, Y_tr, X_va, Y_va = _validation(X[:n_train], Y[:n_train],
                                         use_validation)
    return standard_normalize(X_tr, Y_tr, X_va, Y_va, X[n_train:],
                              Y[n_train:])


def load_rainfall(partition: int = 0, use_validation=None,
                  data_dir: str | None = None):
    """SIC97 rainfall from `data_train_<p>.pickle` ({"X", "Y"}) and
    `data_test_<p>.pickle` ({"test": {"X", "Y"}}); nothing normalised."""
    d = data_dir or os.path.join(data_root(), "regression", "rainfall")
    tr_p = _require(os.path.join(d, f"data_train_{partition}.pickle"),
                    "rainfall", "Run the SIC97 setup tooling")
    with open(tr_p, "rb") as f:
        train = pickle.load(f)
    with open(os.path.join(d, f"data_test_{partition}.pickle"), "rb") as f:
        test = pickle.load(f)["test"]
    X_tr, Y_tr, X_va, Y_va = _validation(np.asarray(train["X"]),
                                         np.asarray(train["Y"]),
                                         use_validation)
    return {"X_tr": X_tr, "Y_tr": Y_tr, "X_va": X_va, "Y_va": Y_va,
            "X_te": np.asarray(test["X"]), "Y_te": np.asarray(test["Y"]),
            "Y_std": np.ones(1), "Y_mean": 0.0}


def load_rainfall_spatial(partition: int = 0, use_validation=None,
                          options: dict | None = None,
                          data_dir: str | None = None):
    """SIC97 rainfall over (x, y): `sic_full.dat` (columns x, y, rainfall),
    shuffled by options['seed'] when options['shuffle'] (default True),
    then fold `partition` of options['num_folds'] (split_type 'k_fold', the
    default) or `partition` as the seed of a random split holding out
    options['validation_size'] rows ('random_split').  Inputs z-scored on
    the training rows, targets left as they are (Y_std = 1)."""
    options = dict(options or {})
    d = data_dir or os.path.join(data_root(), "rainfall_spatial")
    cols = _read_columns(_require(os.path.join(d, "sic_full.dat"),
                                  "rainfall_spatial",
                                  "Download SIC97 (sic97data_01/sic_full.dat)"))
    x = np.stack([_floats(cols["x"]), _floats(cols["y"])], axis=1)
    y = _floats(cols["rainfall"])[:, None]
    if options.get("shuffle", True):
        np.random.seed(options.get("seed", 0))
        p = np.random.permutation(x.shape[0])
        x, y = x[p], y[p]
    split_type = options.get("split_type", "k_fold")
    if split_type == "k_fold":
        X_tr, Y_tr, X_te, Y_te = k_fold(x, y, partition,
                                        options.get("num_folds", 5))
    elif split_type == "random_split":
        X_tr, Y_tr, X_te, Y_te = random_split_validation(
            x, y, partition, options["validation_size"])
    else:
        raise ValueError(f"unknown split_type {split_type!r}")
    out = standard_normalize(X_tr, Y_tr, None, None, X_te, Y_te,
                             normalize_y=False)
    out["Y_std"] = np.ones(1)
    return out


def load_air_quality(partition: int = 0, use_validation=None,
                     options: dict | None = None,
                     data_dir: str | None = None):
    """One LAQN site's series from `aq_data.csv` (columns date, site and the
    species): the rows of options['site'] (HP5) with options['start_date']
    (2019-03-15) <= date < options['end_date'] (2019-04-15) whose species
    (pm25) is not NaN; x is the date in seconds since the epoch.  Fold
    `partition` of options['num_folds'] ('k_fold', the default), or the
    first options['validation_size'] (0.9) of the rows train
    ('random_split').  Inputs z-scored on the training rows, targets left
    as they are (Y_std = 1)."""
    options = dict(options or {})
    d = data_dir or os.path.join(data_root(), "air_pollution")
    cols = _read_columns(_require(os.path.join(d, "aq_data.csv"),
                                  "air_quality",
                                  "Run the LAQN download tooling"))
    species = options.get("species", "pm25")
    date = _datetimes(cols["date"])
    keep = ((np.array(cols["site"]) == options.get("site", "HP5"))
            & (date >= np.datetime64(options.get("start_date", "2019-03-15"),
                                     "ns"))
            & (date < np.datetime64(options.get("end_date", "2019-04-15"),
                                    "ns")))
    y = _floats(cols[species])
    keep &= ~np.isnan(y)
    epoch = date[keep].astype(np.int64) // 10 ** 9
    x = epoch.astype(np.float64)[:, None]
    y = y[keep][:, None]
    split_type = options.get("split_type", "k_fold")
    if split_type == "k_fold":
        X_tr, Y_tr, X_te, Y_te = k_fold(x, y, partition,
                                        options.get("num_folds", 5))
    elif split_type == "random_split":
        X_tr, Y_tr, X_te, Y_te = random_split_prop(
            x, y, options.get("validation_size", 0.9))
    else:
        raise ValueError(split_type)
    out = standard_normalize(X_tr, Y_tr, None, None, X_te, Y_te,
                             normalize_y=False)
    out["Y_std"] = np.ones(1)
    return out


LARGE_LOADERS = {
    "airline": load_airline,
    "year": load_year,
    "rainfall": load_rainfall,
    "air_quality": load_air_quality,
    "rainfall_spatial": load_rainfall_spatial,
}
