"""Archive helpers for preparing corpora offline: a copy of the JAX
package's `data/archive.py` (`check_integrity`, `extract_archive`,
`download_and_extract_archive`).

The loaders never download: they read what is under the data root and
raise when a table is absent.  Only an explicit call of
`download_and_extract_archive` reaches the network.
"""

from __future__ import annotations

import hashlib
import os
import tarfile
import zipfile


def check_integrity(path: str, md5: str | None = None) -> bool:
    """True if `path` is a file and, when `md5` is given, its md5 matches."""
    if not os.path.isfile(path):
        return False
    if md5 is None:
        return True
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest() == md5


def extract_archive(path: str, dest: str | None = None,
                    remove_finished: bool = False) -> str:
    """Extract a zip or tar archive into `dest` (default: its directory);
    returns `dest`."""
    dest = dest or os.path.dirname(path)
    os.makedirs(dest, exist_ok=True)
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            z.extractall(dest)
    elif tarfile.is_tarfile(path):
        with tarfile.open(path) as t:
            t.extractall(dest, filter="data")
    else:
        raise ValueError(f"unknown archive format: {path}")
    if remove_finished:
        os.remove(path)
    return dest


def download_and_extract_archive(url: str, download_root: str,
                                 md5: str | None = None,
                                 remove_finished: bool = True) -> str:
    """Fetch `url` into `download_root` unless a file with the right md5 is
    already there, check it, and extract it (needs network access only for
    the fetch)."""
    import urllib.request

    os.makedirs(download_root, exist_ok=True)
    fname = os.path.join(download_root, url.split("/")[-1])
    if not check_integrity(fname, md5):
        urllib.request.urlretrieve(url, fname)
        if md5 is not None and not check_integrity(fname, md5):
            raise ValueError(f"md5 mismatch after download: {fname}")
    return extract_archive(fname, download_root, remove_finished)
