"""Cross-filesystem helpers for small files (port of
ace_tpu/data/cloud.py).

A netCDF file (an initial condition, a restart file, normalization
statistics) is one HDF5 blob that h5py opens only locally, so a remote
one is copied to a temporary directory first, through fsspec, which is
imported only for a remote path. ``file://`` URLs are local paths.
Zarr stores at a URL go through tensorstore's kvstore drivers
(``data/store.py:kvstore_spec``). Small files only.
"""

import os
import shutil
import tempfile


def _fsspec():
    try:
        import fsspec
    except ImportError as err:
        raise ImportError(
            "reading or writing a remote path needs the fsspec package"
        ) from err
    return fsspec


def is_local(path: str) -> bool:
    """True for plain paths and file:// URLs."""
    return "://" not in str(path) or str(path).startswith("file://")


def local_path(path: str) -> str:
    """A local path or file:// URL as a plain path."""
    return str(path).removeprefix("file://")


def inter_filesystem_copy(source: str, destination: str):
    """Copy between any two filesystems through fsspec streams. Not for
    large files."""
    fsspec = _fsspec()
    with fsspec.open(str(source), "rb") as f_src:
        with fsspec.open(str(destination), "wb") as f_dst:
            shutil.copyfileobj(f_src, f_dst)


def exists(path: str) -> bool:
    """Whether ``path`` exists, on any fsspec filesystem."""
    if is_local(path):
        return os.path.exists(local_path(path))
    fs, fs_path = _fsspec().url_to_fs(str(path))
    return fs.exists(fs_path)


def fetch_to_local(path: str) -> tuple[str, "_TempFetch | None"]:
    """A path that can be opened locally for ``path``, and the handle of
    its temporary copy (None for a local path): the caller closes it when
    the file is no longer needed."""
    if is_local(path):
        return local_path(path), None
    handle = _TempFetch()
    try:
        local = os.path.join(handle.dir,
                             os.path.basename(str(path)) or "file")
        inter_filesystem_copy(path, local)
    except BaseException:
        handle.close()
        raise
    return local, handle


class _TempFetch:
    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="ace_tpu_torch_fetch_")

    def close(self):
        shutil.rmtree(self.dir, ignore_errors=True)

    def __del__(self):
        self.close()
