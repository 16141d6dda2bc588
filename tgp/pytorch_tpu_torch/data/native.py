"""The host data runtime (`csrc/tgpdata.cc`) through ctypes: the port's copy
of the JAX package's `data/native.py`.

`read_csv` parses a numeric CSV (comma, or runs of whitespace) into a
float64 array with the file memory-mapped and the rows split across
threads; `permutation` and `gather_rows` shuffle and gather rows.  The
library is built with g++ at first use into `build/native/` (again
whenever the source is newer) and bound with ctypes.

Unlike the JAX package, nothing here falls back to another parser: where
the library cannot be built, `available()` is False and the call raises
with the compiler's output; a file the parser refuses (a row with fewer
or more fields than the first, a field that is not a number) raises
ValueError.  The loaders in `large.py` choose the parser and record it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "tgpdata.cc"
_LIB = Path(__file__).resolve().parents[3] / "build" / "native" / "libtgpdata.so"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lib = None
_error = None           # why the library could not be built or loaded
_lock = threading.Lock()


def build() -> None:
    """Compile the library if it is missing or older than its source;
    raises RuntimeError with the compiler's output if that fails."""
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH to build "
                           f"{_LIB.name}")
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, str(_SRC), "-o", str(tmp),
                          "-lpthread"], capture_output=True, text=True,
                         timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {_SRC.name} ({res.returncode}):"
                           f"\n{res.stdout}{res.stderr}")
    os.replace(tmp, _LIB)


def _load():
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                build()
                lib = ctypes.CDLL(str(_LIB))
            except (RuntimeError, OSError, subprocess.SubprocessError) as e:
                _error = f"{type(e).__name__}: {e}"
            else:
                i64, ptr = ctypes.c_int64, ctypes.c_void_p
                lib.tgp_csv_shape.argtypes = [
                    ctypes.c_char_p, ctypes.c_char, ctypes.c_int,
                    ctypes.POINTER(i64), ctypes.POINTER(i64)]
                lib.tgp_csv_shape.restype = ctypes.c_int
                lib.tgp_csv_parse.argtypes = [
                    ctypes.c_char_p, ctypes.c_char, ctypes.c_int, ptr, i64,
                    i64, ctypes.c_int]
                lib.tgp_csv_parse.restype = ctypes.c_int
                lib.tgp_permutation.argtypes = [i64, ctypes.c_uint64, ptr]
                lib.tgp_gather_rows.argtypes = [ptr, i64, ptr, i64, i64, ptr]
                lib.tgp_gather_rows_f32.argtypes = lib.tgp_gather_rows.argtypes
                _lib = lib
    if _lib is None:
        raise RuntimeError(f"the native data runtime is not available: "
                           f"{_error}")
    return _lib


def available() -> bool:
    """True if the library is built (building it now if needed) and
    loaded."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def read_csv(path: str, sep: str = ",", ws_mode: bool = False,
             n_threads: int = 0) -> np.ndarray:
    """(rows, cols) float64 array of a numeric CSV without a header; the
    first non-empty row sets the columns.  `ws_mode` takes runs of spaces
    and tabs as one separator.  `n_threads` 0 uses every core."""
    if len(sep) != 1:
        raise ValueError(f"sep must be one character, got {sep!r}")
    lib = _load()
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.tgp_csv_shape(str(path).encode(), sep.encode(), int(ws_mode),
                           ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise OSError(f"cannot read {path} (tgp_csv_shape returned {rc})")
    out = np.empty((rows.value, cols.value), dtype=np.float64)
    rc = lib.tgp_csv_parse(str(path).encode(), sep.encode(), int(ws_mode),
                           out.ctypes.data_as(ctypes.c_void_p), rows.value,
                           cols.value, int(n_threads))
    if rc == -6:
        raise ValueError(f"{path}: a row has fewer or more than {cols.value} "
                         "fields, or a field is not a number")
    if rc != 0:
        raise OSError(f"cannot parse {path} (tgp_csv_parse returned {rc})")
    return out


def permutation(n: int, seed: int) -> np.ndarray:
    """A permutation of range(n) by splitmix64-seeded Fisher-Yates (not
    numpy's stream)."""
    lib = _load()
    out = np.empty(n, dtype=np.int64)
    lib.tgp_permutation(n, seed, out.ctypes.data_as(ctypes.c_void_p))
    return out


def gather_rows(data: np.ndarray, perm: np.ndarray, start: int, batch: int,
                out_dtype=np.float64) -> np.ndarray:
    """data[perm[start:start + batch]] as a new contiguous (batch, cols)
    array of `out_dtype` (float64 or float32)."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.float64)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    if start < 0 or start + batch > perm.shape[0]:
        raise ValueError(f"rows {start}:{start + batch} of a permutation of "
                         f"{perm.shape[0]}")
    rows, cols = data.shape
    sel = perm[start:start + batch]
    if batch and (sel.min() < 0 or sel.max() >= rows):
        raise ValueError(f"a permutation entry outside the {rows} rows")
    f32 = np.dtype(out_dtype) == np.float32
    out = np.empty((batch, cols), dtype=np.float32 if f32 else np.float64)
    fn = lib.tgp_gather_rows_f32 if f32 else lib.tgp_gather_rows
    fn(data.ctypes.data_as(ctypes.c_void_p), cols,
       perm.ctypes.data_as(ctypes.c_void_p), start, batch,
       out.ctypes.data_as(ctypes.c_void_p))
    return out
