"""The port's split helpers, large-corpus loaders, native parser and
archive helpers against the JAX package, on synthetic files.

Mirrors `tests/test_splits_and_spatial.py`, the large-corpus cases of
`tests/test_classification_and_large.py` and the native and archive cases
of `tests/test_native_and_utils.py`; every array a loader returns is held
bitwise against the JAX loader's on the same file.  The native parser is
held against `np.loadtxt` and JAX `native.read_csv`: where JAX's returns
None for a ragged file (and falls back to pandas), the port raises, as
`np.loadtxt` does.

The CSVs with named columns (SIC97, LAQN), which the JAX loaders read
with pandas: the port parses each field with Python's `float`, correctly
rounded, and so recovers the values written.  pandas 3's default parser
(`float_precision="high"`) misses the nearest double by one unit in the
last place for some fields (7 of SIC97's 60 synthetic rainfalls), so the
JAX loaders are run with `float_precision="round_trip"`, which rounds
correctly.  And the JAX LAQN loader's x is `pd.to_datetime(...)
.astype("int64") // 10**9`, seconds since the epoch under pandas'
datetime64[ns]; pandas 3 parses these strings to datetime64[us], which
turns that x into thousands of seconds.  The port keeps seconds, and the
JAX loader is run with `pd.to_datetime` giving nanoseconds
(`pandas_as_written`).
"""

import importlib
import pickle
import time
import zipfile

import numpy as np
import pandas as pd
import pytest

from tgp.pytorch_tpu.data import archive as jarchive
from tgp.pytorch_tpu.data import large as jlarge
from tgp.pytorch_tpu.data import native as jnative
from tgp.pytorch_tpu.data import registry as jreg
from tgp.pytorch_tpu.data import splits as jsplits

from tgp.pytorch_tpu_torch import data as pdata
from tgp.pytorch_tpu_torch.data import archive as parchive
from tgp.pytorch_tpu_torch.data import large as plarge
from tgp.pytorch_tpu_torch.data import native as pnative
from tgp.pytorch_tpu_torch.data import registry as preg
from tgp.pytorch_tpu_torch.data import splits as psplits


def jax_native_parser(wait_s=60.0):
    """Make sure the JAX package's native parser is loaded before a test
    compares with it, directly or through a JAX loader.

    `jnative._load()` builds `native/libtgpdata.so` (`make -B`) when it is
    missing or stale, and a process whose first load fails keeps `_lib =
    None` for the rest of its life, after which every JAX loader falls back
    to pandas, whose parse differs by one unit in the last place.  Test
    workers started together all build the same file at once, so a worker
    can load it while another one is rewriting it.  This clears such a
    cached failure and loads again, for up to `wait_s` seconds while
    another process's build finishes, and then fails by name instead of
    letting the test compare against the fallback.  It changes only the
    module's cached state."""
    deadline = time.monotonic() + wait_s
    while True:
        if jnative._lib is None and jnative._tried:
            jnative._tried = False
        if jnative._load() is not None or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    assert jnative.available(), (
        "the JAX package's native parser (native/libtgpdata.so) did not "
        f"load within {wait_s} s")


def _same_split(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w),
                                          err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(w).dtype, k


@pytest.fixture
def pandas_as_written(monkeypatch):
    """pandas as the JAX loaders assume it: `pd.read_csv` rounding each
    field to the nearest double, `pd.to_datetime` in nanoseconds."""
    read, to_dt = pd.read_csv, pd.to_datetime
    monkeypatch.setattr(pd, "read_csv", lambda *a, **k: read(
        *a, **{"float_precision": "round_trip", **k}))
    monkeypatch.setattr(pd, "to_datetime",
                        lambda *a, **k: to_dt(*a, **k).astype("datetime64[ns]"))


# ---------------------------------------------------------------------------
# splits (tests/test_splits_and_spatial.py)
# ---------------------------------------------------------------------------

def test_k_fold_matches_sklearn_kfold():
    from sklearn.model_selection import KFold
    for n, k in [(100, 5), (103, 5), (47, 4)]:
        sk = [te for _, te in KFold(n_splits=k, shuffle=False).split(
            np.zeros((n, 1)))]
        for fold in range(k):
            tr, te = psplits.k_fold_indices(n, fold, k)
            np.testing.assert_array_equal(te, sk[fold])
            np.testing.assert_array_equal(
                tr, np.setdiff1d(np.arange(n), sk[fold]))
            for a, b in zip((tr, te), jsplits.k_fold_indices(n, fold, k)):
                np.testing.assert_array_equal(a, b)


def test_k_fold_bad_fold_raises():
    with pytest.raises(ValueError):
        psplits.k_fold_indices(10, 5, 5)
    with pytest.raises(ValueError):
        psplits.k_fold(np.zeros((4, 1)), np.zeros((3, 1)), 0, 2)


def test_random_split_validation_matches_legacy_global_seed():
    X = np.arange(40, dtype=float).reshape(20, 2)
    Y = np.arange(20, dtype=float).reshape(20, 1)
    got = psplits.random_split_validation(X, Y, seed=3, n_val=5)
    np.random.seed(3)
    perm = np.random.permutation(20)
    np.testing.assert_array_equal(got[0], X[perm[:15]])
    np.testing.assert_array_equal(got[2], X[perm[15:]])
    for a, b in zip(got, jsplits.random_split_validation(X, Y, 3, 5)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(psplits.random_split_prop(X, Y, 0.7),
                    jsplits.random_split_prop(X, Y, 0.7)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        psplits.random_split_validation(X, Y, 3, 21)


# ---------------------------------------------------------------------------
# SIC97, LAQN and the registry's partition corpora
# ---------------------------------------------------------------------------

def _write_sic(path, n=60):
    rng = np.random.RandomState(0)
    df = pd.DataFrame({"id": np.arange(n),
                       "x": rng.uniform(0, 300, n),
                       "y": rng.uniform(0, 200, n),
                       "rainfall": rng.gamma(2.0, 50.0, n)})
    df.to_csv(path / "sic_full.dat", index=False)
    return df


def _write_aq(path, n=50, nan_row=3):
    rng = np.random.RandomState(1)
    dates = pd.date_range("2019-03-16", periods=n, freq="h")
    df = pd.DataFrame({"date": dates, "site": ["HP5"] * n,
                       "pm25": rng.rand(n)})
    if nan_row is not None:
        df.loc[nan_row, "pm25"] = np.nan
    df.to_csv(path / "aq_data.csv", index=False)
    return df


def test_rainfall_spatial_kfold(tmp_path, pandas_as_written):
    _write_sic(tmp_path)
    folds = []
    opts = {"split_type": "k_fold", "num_folds": 5, "shuffle": True,
            "seed": 0}
    for p in range(5):
        out = plarge.load_rainfall_spatial(p, options=opts,
                                           data_dir=str(tmp_path))
        assert out["X_tr"].shape == (48, 2) and out["X_te"].shape == (12, 2)
        assert abs(out["X_tr"].mean()) < 1e-8
        assert out["Y_tr"].min() > 0
        folds.append(out["X_te"])
        _same_split(out, jlarge.load_rainfall_spatial(
            p, options=opts, data_dir=str(tmp_path)))
    assert not np.allclose(folds[0], folds[1])
    # the values written, to the bit, unshuffled and unnormalised
    df = _write_sic(tmp_path)
    cols = plarge._read_columns(str(tmp_path / "sic_full.dat"))
    for c in ("x", "y", "rainfall"):
        np.testing.assert_array_equal(plarge._floats(cols[c]), df[c])


def test_rainfall_spatial_random_split_and_shuffle_seed(tmp_path,
                                                         pandas_as_written):
    _write_sic(tmp_path)
    outs = []
    for p in (1, 2):
        opts = {"split_type": "random_split", "validation_size": 10,
                "shuffle": True, "seed": 0}
        outs.append(plarge.load_rainfall_spatial(p, options=opts,
                                                 data_dir=str(tmp_path)))
        _same_split(outs[-1], jlarge.load_rainfall_spatial(
            p, options=opts, data_dir=str(tmp_path)))
    assert outs[0]["X_te"].shape[0] == 10
    assert not np.allclose(outs[0]["X_te"], outs[1]["X_te"])
    opts = {"shuffle": False, "split_type": "k_fold", "num_folds": 4}
    _same_split(plarge.load_rainfall_spatial(1, options=opts,
                                             data_dir=str(tmp_path)),
                jlarge.load_rainfall_spatial(1, options=opts,
                                             data_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="split_type"):
        plarge.load_rainfall_spatial(0, options={"split_type": "other"},
                                     data_dir=str(tmp_path))


def test_registry_routes_partition_corpora(tmp_path, monkeypatch,
                                           pandas_as_written):
    (tmp_path / "rainfall_spatial").mkdir()
    _write_sic(tmp_path / "rainfall_spatial")
    (tmp_path / "air_pollution").mkdir()
    _write_aq(tmp_path / "air_pollution", nan_row=None)
    monkeypatch.setenv("TGP_DATA_ROOT", str(tmp_path))
    importlib.reload(jlarge)             # the JAX loader reads it at import
    try:
        for name, opts in (
                ("rainfall_spatial", {"split_type": "k_fold", "num_folds": 5,
                                      "shuffle": True, "seed": 0}),
                ("air_quality", {"split_type": "k_fold", "num_folds": 5})):
            loaders, dc = preg.return_dataset(name, batch_size=32, seed=0,
                                              options=opts)
            jl, jd = jreg.return_dataset(name, batch_size=32, seed=0,
                                         options=opts)
            assert dc["Dy"] == jd["Dy"] == 1 and dc["Dx"] == jd["Dx"]
            for k in ("X_tr", "Y_tr", "N_tr", "Y_std", "Y_mean"):
                np.testing.assert_array_equal(dc[k], jd[k], err_msg=k)
            for a, b in zip(loaders, jl):
                np.testing.assert_array_equal(a.dataset.X, b.dataset.X)
                np.testing.assert_array_equal(a.dataset.Y, b.dataset.Y)
            X, _ = next(iter(loaders[0]))
            assert X.shape[1] == dc["Dx"]
        assert dc["Dx"] == 1 and dc["N_tr"] == 40
    finally:
        monkeypatch.undo()
        importlib.reload(jlarge)


def test_air_quality_kfold(tmp_path, pandas_as_written):
    _write_aq(tmp_path)
    opts = {"split_type": "k_fold", "num_folds": 5}
    out = plarge.load_air_quality(0, options=opts, data_dir=str(tmp_path))
    assert out["X_tr"].shape[0] + out["X_te"].shape[0] == 49   # NaN dropped
    _same_split(out, jlarge.load_air_quality(0, options=opts,
                                             data_dir=str(tmp_path)))
    opts = {"split_type": "random_split", "validation_size": 0.8}
    _same_split(plarge.load_air_quality(0, options=opts,
                                        data_dir=str(tmp_path)),
                jlarge.load_air_quality(0, options=opts,
                                        data_dir=str(tmp_path)))


def test_air_quality_filters_site_window_and_missing_values(tmp_path,
                                                           pandas_as_written):
    """Other sites, rows outside [start_date, end_date) and empty or NA
    fields are dropped as pandas drops them; x is seconds since the
    epoch."""
    lines = ["date,site,pm25,no2"]
    rng = np.random.RandomState(2)
    for i, d in enumerate(pd.date_range("2019-03-14 20:00", periods=60,
                                        freq="30min")):
        site = "HP5" if i % 4 else "BX1"
        val = ("" if i % 7 == 3 else "NA" if i % 11 == 5
               else repr(float(rng.rand())))
        lines.append(f"{d:%Y-%m-%d %H:%M:%S},{site},{val},{rng.rand()!r}")
    (tmp_path / "aq_data.csv").write_text("\n".join(lines) + "\n")
    for opts in ({"num_folds": 3}, {"species": "no2", "num_folds": 2},
                 {"start_date": "2019-03-15 02:00", "num_folds": 2}):
        got = plarge.load_air_quality(1, options=opts, data_dir=str(tmp_path))
        _same_split(got, jlarge.load_air_quality(1, options=opts,
                                                 data_dir=str(tmp_path)))
    raw = plarge._datetimes(["2019-03-15 01:30:00"])
    assert int(raw.astype(np.int64)[0] // 10 ** 9) == 1552613400


# ---------------------------------------------------------------------------
# airline, year, rainfall (tests/test_classification_and_large.py)
# ---------------------------------------------------------------------------

def test_rainfall_pickled_partitions(tmp_path):
    rng = np.random.RandomState(4)
    X, Y = rng.randn(20, 2), rng.randn(20, 1)
    with open(tmp_path / "data_train_0.pickle", "wb") as f:
        pickle.dump({"X": X[:15], "Y": Y[:15]}, f)
    with open(tmp_path / "data_test_0.pickle", "wb") as f:
        pickle.dump({"test": {"X": X[15:], "Y": Y[15:]}}, f)
    out = plarge.load_rainfall(0, data_dir=str(tmp_path))
    assert out["X_tr"].shape == (15, 2) and out["X_te"].shape == (5, 2)
    assert out["Y_std"][0] == 1.0
    _same_split(out, jlarge.load_rainfall(0, data_dir=str(tmp_path)))
    _same_split(plarge.load_rainfall(0, (2, 4), data_dir=str(tmp_path)),
                jlarge.load_rainfall(0, (2, 4), data_dir=str(tmp_path)))


def _write_airline(path, n=200):
    rng = np.random.RandomState(0)
    data = np.c_[rng.randn(n, 3), rng.randn(n)]
    np.savetxt(path / "airline.csv", data, delimiter=",")
    return data


def test_airline_loader_fallback_split(tmp_path):
    jax_native_parser()
    _write_airline(tmp_path)
    out = plarge.load_airline(seed=1, data_dir=str(tmp_path))
    assert out["X_tr"].shape[1] == 3
    assert out["X_tr"].shape[0] + out["X_te"].shape[0] == 200
    assert out["X_tr"].shape[0] == 190            # int(0.95 n) < AIRLINE_N_TR
    assert abs(out["X_tr"].mean()) < 1e-8
    for seed, val in ((1, None), (4, None), (1, (0, 0)), (1, (3, 7))):
        _same_split(plarge.load_airline(seed, val, data_dir=str(tmp_path)),
                    jlarge.load_airline(seed, val, data_dir=str(tmp_path)))
    assert plarge.AIRLINE_N_TR == jlarge.AIRLINE_N_TR == 1958097


def test_airline_loader_reads_a_committed_split(tmp_path):
    jax_native_parser()
    _write_airline(tmp_path, n=50)
    rng = np.random.RandomState(5)
    perm = rng.permutation(50)
    with open(tmp_path / "splits_idx_airline.pkl", "wb") as f:
        pickle.dump({"seed_2": {"train": perm[:40], "test": perm[40:]}}, f)
    out = plarge.load_airline(2, data_dir=str(tmp_path))
    assert out["X_tr"].shape == (40, 3)
    _same_split(out, jlarge.load_airline(2, data_dir=str(tmp_path)))


def test_zero_row_validation_split_keeps_training_set(tmp_path):
    """use_validation=(seed, 0) keeps every training row in the airline and
    year loaders (`tests/test_classification_and_large.py:160-170`)."""
    _write_airline(tmp_path)
    full = plarge.load_airline(1, data_dir=str(tmp_path))
    zero = plarge.load_airline(1, (0, 0), data_dir=str(tmp_path))
    five = plarge.load_airline(1, (0, 5), data_dir=str(tmp_path))
    assert zero["X_tr"].shape[0] == full["X_tr"].shape[0]
    assert zero["X_va"].shape[0] == 0 and five["X_va"].shape[0] == 5
    assert five["X_tr"].shape[0] == full["X_tr"].shape[0] - 5
    _write_year(tmp_path)
    zero = plarge.load_year(1, (0, 0), data_dir=str(tmp_path), n_train=40)
    assert zero["X_tr"].shape[0] == 40 and zero["X_va"].shape[0] == 0


def _write_year(path, n=60, d=6):
    rng = np.random.RandomState(3)
    data = np.c_[rng.randint(1922, 2011, n), rng.randn(n, d) * 30.0]
    np.savetxt(path / "YearPredictionMSD.txt", data, delimiter=",",
               fmt=["%d"] + ["%.8f"] * d)
    return data


def test_year_loader_matches_jax(tmp_path):
    jax_native_parser()
    data = _write_year(tmp_path)
    out = plarge.load_year(data_dir=str(tmp_path), n_train=40)
    assert out["X_tr"].shape == (40, 6) and out["X_te"].shape == (20, 6)
    # the target is the first column, z-scored on the training rows
    np.testing.assert_allclose(out["Y_std"], data[:40, :1].std(0) + 1e-15)
    for val in (None, (2, 8)):
        _same_split(plarge.load_year(1, val, data_dir=str(tmp_path),
                                     n_train=40),
                    jlarge.load_year(1, val, data_dir=str(tmp_path),
                                     n_train=40))


def test_registry_routes_airline_and_year(tmp_path, monkeypatch):
    jax_native_parser()
    (tmp_path / "regression" / "airline").mkdir(parents=True)
    _write_airline(tmp_path / "regression" / "airline")
    monkeypatch.setenv("TGP_DATA_ROOT", str(tmp_path))
    importlib.reload(jlarge)
    try:
        pl, pd_ = preg.return_dataset("airline", 64, seed=2)
        jl, jd = jreg.return_dataset("airline", 64, seed=2)
        assert pd_["N_tr"] == jd["N_tr"] == 190 and pd_["Dx"] == 3
        for k in ("X_tr", "Y_tr", "Y_std", "Y_mean"):
            np.testing.assert_array_equal(pd_[k], jd[k], err_msg=k)
        assert len(pl[0]) == len(jl[0]) == 3
        for (xp, yp), (xj, yj) in zip(pl[0], jl[0]):    # same shuffle
            np.testing.assert_array_equal(xp, xj)
            np.testing.assert_array_equal(yp, yj)
        with pytest.raises(FileNotFoundError, match="year corpus missing"):
            preg.return_dataset("year", 64)
    finally:
        monkeypatch.undo()
        importlib.reload(jlarge)


@pytest.mark.parametrize("name", ["airline", "year", "rainfall",
                                  "air_quality", "rainfall_spatial"])
def test_missing_corpus_raises_actionable_error(name, tmp_path, monkeypatch):
    monkeypatch.setenv("TGP_DATA_ROOT", str(tmp_path))
    importlib.reload(jlarge)
    try:
        with pytest.raises(FileNotFoundError) as ep:
            preg.return_dataset(name, 64)
        with pytest.raises(FileNotFoundError) as ej:
            jreg.return_dataset(name, 64)
        assert str(ep.value) == str(ej.value)
        assert "zero-egress" in str(ep.value) and str(tmp_path) in str(ep.value)
    finally:
        monkeypatch.undo()
        importlib.reload(jlarge)
    assert pdata.UCI_REGRESSION == list(jreg.UCI_REGRESSION)
    assert pdata.UCI_CLASSIFICATION == list(jreg.UCI_CLASSIFICATION)


def test_loaders_parse_with_the_native_parser_alone(tmp_path, monkeypatch):
    """The loaders parse with the native parser: the same split as with
    `np.loadtxt` in its place, and where the library cannot be built the
    loader raises instead of falling back to another parser."""
    _write_airline(tmp_path)
    native = plarge.load_airline(1, data_dir=str(tmp_path))
    monkeypatch.setattr(pnative, "read_csv", lambda path: np.loadtxt(
        path, delimiter=",", dtype=np.float64, ndmin=2))
    _same_split(plarge.load_airline(1, data_dir=str(tmp_path)), native)
    monkeypatch.undo()
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "_error", "RuntimeError: no g++")
    with pytest.raises(RuntimeError, match="native data runtime is not "
                       "available: RuntimeError: no g\\+\\+"):
        plarge.load_airline(1, data_dir=str(tmp_path))


# ---------------------------------------------------------------------------
# the native parser and archives (tests/test_native_and_utils.py)
# ---------------------------------------------------------------------------

def test_native_csv_matches_numpy(tmp_path):
    jax_native_parser()
    assert pnative.available()
    rng = np.random.RandomState(0)
    data = rng.randn(500, 7)
    for fmt, name in (("%.12g", "t.csv"), ("%.18e", "full.csv")):
        path = tmp_path / name
        np.savetxt(path, data, delimiter=",", fmt=fmt)
        out = pnative.read_csv(str(path), n_threads=3)
        np.testing.assert_allclose(out, data, rtol=1e-10)
        np.testing.assert_array_equal(out, np.loadtxt(path, delimiter=","))
        np.testing.assert_array_equal(out, jnative.read_csv(str(path)))
    np.testing.assert_array_equal(pnative.read_csv(str(tmp_path / "full.csv")),
                                  data)


def test_native_whitespace_mode(tmp_path):
    jax_native_parser()
    path = tmp_path / "t.tsv"
    path.write_text("1.0   2.0   3.0\n  4.0  5.0   6.0\n")
    out = pnative.read_csv(str(path), sep=" ", ws_mode=True)
    np.testing.assert_array_equal(out, [[1, 2, 3], [4, 5, 6]])
    np.testing.assert_array_equal(out, jnative.read_csv(str(path), sep=" ",
                                                        ws_mode=True))


def test_native_gather_and_permutation():
    jax_native_parser()
    data = np.arange(40, dtype=np.float64).reshape(10, 4)
    perm = pnative.permutation(10, seed=1)
    assert sorted(perm) == list(range(10))
    np.testing.assert_array_equal(perm, jnative.permutation(10, seed=1))
    g = pnative.gather_rows(data, perm, 2, 5)
    np.testing.assert_array_equal(g, data[perm[2:7]])
    g32 = pnative.gather_rows(data, perm, 0, 3, out_dtype=np.float32)
    assert g32.dtype == np.float32
    np.testing.assert_array_equal(g32, data[perm[:3]].astype(np.float32))
    with pytest.raises(ValueError):
        pnative.gather_rows(data, perm, 8, 5)
    with pytest.raises(ValueError):
        pnative.gather_rows(data[:5], perm, 0, 10)


def test_archive_roundtrip(tmp_path):
    src = tmp_path / "a.txt"
    src.write_text("hello")
    zpath = tmp_path / "a.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        z.write(src, "a.txt")
    dest = tmp_path / "out"
    assert parchive.extract_archive(str(zpath), str(dest)) == str(dest)
    assert (dest / "a.txt").read_text() == "hello"
    assert parchive.check_integrity(str(zpath))
    assert not parchive.check_integrity(str(zpath), md5="0" * 32)
    assert not parchive.check_integrity(str(tmp_path / "absent.zip"))
    with pytest.raises(ValueError, match="unknown archive"):
        parchive.extract_archive(str(src))
    for md5 in (None, "0" * 32):
        assert (parchive.check_integrity(str(zpath), md5)
                == jarchive.check_integrity(str(zpath), md5))


def test_download_is_skipped_for_a_file_whose_md5_matches(tmp_path,
                                                          monkeypatch):
    """An archive already in the download root with the right md5 is only
    extracted: no fetch happens (a fetch would fail the test)."""
    import urllib.request

    def no_fetch(*a, **k):
        raise AssertionError("download attempted")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_fetch)
    src = tmp_path / "b.txt"
    src.write_text("tables")
    root = tmp_path / "root"
    root.mkdir()
    tpath = root / "b.tar"
    import tarfile
    with tarfile.open(tpath, "w") as t:
        t.add(src, "b.txt")
    import hashlib
    md5 = hashlib.md5(tpath.read_bytes()).hexdigest()
    dest = parchive.download_and_extract_archive(
        "https://example.org/data/b.tar", str(root), md5=md5,
        remove_finished=False)
    assert dest == str(root) and (root / "b.txt").read_text() == "tables"
    assert parchive.check_integrity(str(tpath), md5)


def test_native_csv_ragged_rows_error_not_garbage(tmp_path):
    """A short or long row raises (JAX's parser returns None there and
    falls back to pandas; np.loadtxt raises too)."""
    jax_native_parser()
    short = tmp_path / "short.csv"
    short.write_text("1.5\n7.25,8.5\n")
    long_ = tmp_path / "long.csv"
    long_.write_text("1.5,2.5\n7.25,8.5,9.9\n")
    bad = tmp_path / "bad.csv"
    bad.write_text("1.5,2.5\n7.25,x\n")
    for path in (short, long_, bad):
        assert jnative.read_csv(str(path)) is None
        with pytest.raises(ValueError, match="fields"):
            pnative.read_csv(str(path))
        with pytest.raises(ValueError):
            np.loadtxt(path, delimiter=",")
    crlf = tmp_path / "crlf.tsv"
    crlf.write_text("1.5   2.5\r\n7.25   8.5\r\n")
    out = pnative.read_csv(str(crlf), sep=" ", ws_mode=True)
    np.testing.assert_array_equal(out, [[1.5, 2.5], [7.25, 8.5]])
    np.testing.assert_array_equal(out, jnative.read_csv(str(crlf), sep=" ",
                                                        ws_mode=True))
    with pytest.raises(OSError):
        pnative.read_csv(str(tmp_path / "absent.csv"))


# ---------------------------------------------------------------------------
# the CLI and the sweep runner on the large corpora
# ---------------------------------------------------------------------------

def test_cli_trains_on_airline_as_the_jax_cli_does(tmp_path, monkeypatch,
                                                   capsys):
    """`--dataset airline` through the registry in both CLIs (SVGP, M=5,
    batches of 64 from 200 synthetic rows, 4 epochs): the result line, Z0,
    the curves, the parameters and the metrics at rtol 1e-8, atol 1e-10."""
    import jax
    import torch
    from test_torch_port_cli import F64, close, jax_run, result_line
    from tgp.pytorch_tpu_torch import weights
    from tgp.pytorch_tpu_torch.experiments import main as pmain

    (tmp_path / "regression" / "airline").mkdir(parents=True)
    _write_airline(tmp_path / "regression" / "airline")
    monkeypatch.setenv("TGP_DATA_ROOT", str(tmp_path))
    importlib.reload(jlarge)
    nt = torch.get_num_threads()
    try:
        argv = ["--model", "SVGP", "--dataset", "airline",
                "--train_test_seed_split", "1", "--num_inducing", "5",
                "--epochs", "4", "--batch_size", "64", "--platform", "cpu",
                "--verbose_each", "0"]
        mj, seen = jax_run(monkeypatch, argv)
        jline = result_line(capsys.readouterr().out)
        res = pmain.run(pmain.parse_args(argv))
        pline = result_line(capsys.readouterr().out)
    finally:
        monkeypatch.undo()
        importlib.reload(jlarge)
        torch.set_num_threads(nt)
    assert pline == jline and "Dataset airline" in pline
    close(res.Z0, seen["Z0"])
    jt, pt = seen["trainer"], res.trainer
    assert len(pt.train_loader) == 3 and pt.train_loader.dataset.X.shape == (190, 3)
    for attr in ("loss_curve", "ell_curve", "kld_curve"):
        close(np.asarray(getattr(pt, attr)),
              [float(v) for v in getattr(jt, attr)])
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jt.params),
                            weights.tree_leaves(pt.params)):
        close(b, a, err_msg=jax.tree_util.keystr(path), **F64)
    for split in ("train", "test"):
        for k in ("logL", "rmse"):
            close(res.metrics[split][k], mj[split][k])


def test_sweep_runs_the_large_tables_it_finds(tmp_path, monkeypatch):
    """With airline.csv under the data root and no YearMSD file, the large
    suite is refused naming year alone, and an airline cell runs."""
    from tgp.pytorch_tpu_torch.experiments import sweep as psweep

    (tmp_path / "regression" / "airline").mkdir(parents=True)
    _write_airline(tmp_path / "regression" / "airline")
    monkeypatch.setenv("TGP_DATA_ROOT", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        psweep.main(["--suite", "large", "--platform", "cpu"])
    assert "year" in str(e.value) and "airline (" not in str(e.value)
    recs = psweep.main(["--suite", "large", "--datasets", "airline",
                        "--models", "SVGP", "--seeds", "1",
                        "--num_inducing", "5", "--epochs", "2",
                        "--platform", "cpu", "--precision", "fp64"])
    assert len(recs) == 1 and "error" not in recs[0], recs
    assert recs[0]["dataset"] == "airline"
    assert np.isfinite(recs[0]["test_logL"])
