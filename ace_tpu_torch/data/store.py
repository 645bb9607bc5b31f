"""Array-file access layer: netCDF4/HDF5 (via h5py) and zarr (via
tensorstore) (reference equivalents: xarray/netCDF4/zarr engines in
fme/core/dataset/xarray.py:403-533).

netCDF4 files are HDF5 containers, so h5py reads the reference's data and
stats files directly (dimension names come from HDF5 dimension scales).
Zarr v2 groups follow the xarray convention (_ARRAY_DIMENSIONS attr).

Exposes a uniform ``FileDataset`` with lazily-read variables, CF time
decoding to TimeCoord, and writers used by tests and the data writers.

A copy of ``ace_tpu/data/store.py`` (numpy on the host; tests hold it equal to
the original). Remote netCDF files are fetched through ``data/cloud.py``;
zarr stores at gs:// and s3:// URLs are read through tensorstore.
"""

import dataclasses
import json
import os
import re
from typing import Any, Mapping

import numpy as np

from ace_tpu_torch.data.time import (
    MICROS_PER_SECOND,
    TimeCoord,
    parse_datetime_string,
)

_UNITS_RE = re.compile(
    r"^\s*(\w+)\s+since\s+(.+?)\s*$", re.IGNORECASE
)
_UNIT_SECONDS = {
    "second": 1, "seconds": 1, "sec": 1, "secs": 1, "s": 1,
    "minute": 60, "minutes": 60, "min": 60, "mins": 60,
    "hour": 3600, "hours": 3600, "hr": 3600, "hrs": 3600, "h": 3600,
    "day": 86400, "days": 86400, "d": 86400,
}


def decode_cf_time(values: np.ndarray, units: str, calendar: str) -> TimeCoord:
    """Decode CF 'X since <datetime>' values to a TimeCoord."""
    m = _UNITS_RE.match(units)
    if not m:
        raise ValueError(f"cannot parse time units {units!r}")
    unit, epoch_str = m.groups()
    scale = _UNIT_SECONDS[unit.lower()]
    calendar = calendar or "proleptic_gregorian"
    if calendar == "gregorian":
        calendar = "standard"
    epoch = parse_datetime_string(epoch_str, calendar)
    micros = epoch + np.round(
        np.asarray(values, dtype=np.float64) * scale * MICROS_PER_SECOND
    ).astype(np.int64)
    return TimeCoord(micros, calendar)


def encode_cf_time(time: TimeCoord, units: str | None = None):
    """Encode a TimeCoord to CF values + (units, calendar)."""
    if units is None:
        units = "seconds since 1970-01-01T00:00:00"
    m = _UNITS_RE.match(units)
    unit, epoch_str = m.groups()
    scale = _UNIT_SECONDS[unit.lower()]
    epoch = parse_datetime_string(epoch_str, time.calendar)
    vals = (time.values - epoch) / (scale * MICROS_PER_SECOND)
    return vals, units, time.calendar


@dataclasses.dataclass
class Variable:
    name: str
    dims: tuple[str, ...]
    shape: tuple[int, ...]
    dtype: Any
    attrs: dict
    _reader: Any = dataclasses.field(repr=False, default=None)

    def read(self, selection=()) -> np.ndarray:
        return self._reader(selection)


class FileDataset:
    """A read-only view of one file/group of named variables."""

    def __init__(self, variables: dict[str, Variable], attrs: dict):
        self.variables = variables
        self.attrs = attrs

    def __contains__(self, name):
        return name in self.variables

    def __getitem__(self, name) -> Variable:
        return self.variables[name]

    def keys(self):
        return self.variables.keys()

    def read_time(self, name: str = "time") -> TimeCoord:
        var = self.variables[name]
        return decode_cf_time(
            var.read(()),
            var.attrs.get("units", "seconds since 1970-01-01"),
            var.attrs.get("calendar", "proleptic_gregorian"),
        )

    def close(self):
        pass


def _h5_attr(value):
    if isinstance(value, bytes):
        return value.decode()
    if isinstance(value, np.ndarray) and value.dtype.kind == "S":
        return [v.decode() for v in value]
    if isinstance(value, np.generic):
        return value.item()
    return value


class H5Dataset(FileDataset):
    """netCDF4/HDF5 file reader (h5py). A remote path (gs://, s3://,
    http(s)://, memory://) is copied to a temporary file first
    (``data/cloud.py``), since HDF5 needs a local file; file:// URLs are
    local."""

    def __init__(self, path: str):
        import h5py

        from ace_tpu_torch.data.cloud import fetch_to_local

        path, self._fetch = fetch_to_local(path)
        try:
            self._f = h5py.File(path, "r")
        except BaseException:
            if self._fetch is not None:
                self._fetch.close()
            raise
        variables: dict[str, Variable] = {}
        for name, ds in self._f.items():
            if not hasattr(ds, "shape"):
                continue
            dims = []
            for i in range(len(ds.shape)):
                label = None
                try:
                    if ds.dims[i].label:
                        label = ds.dims[i].label
                    elif len(ds.dims[i]) > 0:
                        label = ds.dims[i][0].name.split("/")[-1]
                except Exception:
                    label = None
                dims.append(label or f"dim_{i}")
            attrs = {k: _h5_attr(v) for k, v in ds.attrs.items()
                     if not k.startswith(("DIMENSION", "_Netcdf", "CLASS",
                                          "NAME", "REFERENCE_LIST"))}

            def reader(selection, _ds=ds):
                return np.asarray(_ds[selection] if selection != () else _ds[()])

            variables[name] = Variable(
                name=name, dims=tuple(dims), shape=tuple(ds.shape),
                dtype=ds.dtype, attrs=attrs, _reader=reader,
            )
        attrs = {k: _h5_attr(v) for k, v in self._f.attrs.items()}
        super().__init__(variables, attrs)

    def close(self):
        self._f.close()
        if self._fetch is not None:
            self._fetch.close()


def kvstore_spec(path: str) -> dict:
    """tensorstore kvstore spec for a zarr path: gs:// and s3:// URLs go
    to the matching tensorstore driver, anything else (a file:// URL too)
    is a local directory."""
    for scheme, driver in (("gs://", "gcs"), ("s3://", "s3")):
        if path.startswith(scheme):
            bucket, _, sub = path[len(scheme):].partition("/")
            return {"driver": driver, "bucket": bucket,
                    "path": sub.rstrip("/") + "/" if sub else ""}
    return {"driver": "file",
            "path": path.removeprefix("file://").rstrip("/") + "/"}


class ZarrDataset(FileDataset):
    """Zarr v2 group reader via tensorstore (xarray conventions): local
    directories and gs:// or s3:// stores share one code path."""

    def __init__(self, path: str):
        import tensorstore as ts

        self._path = path
        spec = kvstore_spec(path)
        kv = ts.KvStore.open(spec).result()
        keys = [k.decode() for k in kv.list().result()]

        def read_json(key):
            result = kv.read(key).result()
            if result.state == "missing":
                return None
            return json.loads(result.value.decode())

        variables: dict[str, Variable] = {}
        root_attrs = read_json(".zattrs") or {}
        entries = sorted({
            k.split("/", 1)[0] for k in keys if "/" in k
        })
        for entry in entries:
            zarray = read_json(f"{entry}/.zarray")
            if zarray is None:
                continue
            attrs = read_json(f"{entry}/.zattrs") or {}
            dims = tuple(attrs.pop("_ARRAY_DIMENSIONS", []))
            if not dims:
                dims = tuple(
                    f"dim_{i}" for i in range(len(zarray["shape"]))
                )
            arr_spec = dict(spec)
            arr_spec["path"] = spec["path"] + entry + "/"
            store = ts.open({
                "driver": "zarr",
                "kvstore": arr_spec,

            }, open=True).result()

            def reader(selection, _s=store):
                return np.asarray(
                    (_s[selection] if selection != () else _s).read().result()
                )

            variables[entry] = Variable(
                name=entry, dims=dims, shape=tuple(zarray["shape"]),
                dtype=np.dtype(zarray["dtype"]), attrs=attrs, _reader=reader,
            )
        super().__init__(variables, root_attrs)


def open_file_dataset(path: str, engine: str | None = None) -> FileDataset:
    if engine is None:
        stripped = str(path).rstrip("/")
        remote = "://" in str(path) and not str(path).startswith("file://")
        if stripped.endswith((".nc", ".nc4", ".h5", ".hdf5")):
            engine = "netcdf4"
        elif remote or stripped.endswith(".zarr") or (
            os.path.isdir(path) and os.path.exists(os.path.join(path, ".zgroup"))
        ):
            engine = "zarr"
        else:
            engine = "netcdf4"
    if engine in ("netcdf4", "h5netcdf", "h5"):
        return H5Dataset(path)
    if engine == "zarr":
        return ZarrDataset(path)
    raise ValueError(f"unknown engine {engine!r}")


# ----- writers -----


def write_h5(
    path: str,
    data: Mapping[str, np.ndarray],
    dims: Mapping[str, tuple[str, ...]],
    coords: Mapping[str, np.ndarray] | None = None,
    attrs: Mapping[str, Mapping] | None = None,
    time: TimeCoord | None = None,
    global_attrs: Mapping | None = None,
):
    """Write an HDF5 file with dimension scales (netCDF-style)."""
    import h5py

    coords = dict(coords or {})
    attrs = dict(attrs or {})
    if time is not None:
        vals, units, calendar = encode_cf_time(time)
        coords["time"] = vals
        attrs.setdefault("time", {})
        attrs["time"] = {**attrs.get("time", {}),
                         "units": units, "calendar": calendar}
    with h5py.File(path, "w") as f:
        for k, v in (global_attrs or {}).items():
            f.attrs[k] = v
        for cname, cvals in coords.items():
            ds = f.create_dataset(cname, data=np.asarray(cvals))
            ds.make_scale(cname)
            for k, v in attrs.get(cname, {}).items():
                ds.attrs[k] = v
        for name, arr in data.items():
            ds = f.create_dataset(name, data=np.asarray(arr))
            for i, dim in enumerate(dims[name]):
                ds.dims[i].label = dim
                if dim in coords:
                    ds.dims[i].attach_scale(f[dim])
            for k, v in attrs.get(name, {}).items():
                ds.attrs[k] = v


def write_zarr(
    path: str,
    data: Mapping[str, np.ndarray],
    dims: Mapping[str, tuple[str, ...]],
    coords: Mapping[str, np.ndarray] | None = None,
    attrs: Mapping[str, Mapping] | None = None,
    time: TimeCoord | None = None,
    chunks: Mapping[str, list[int]] | None = None,
):
    """Write a zarr v2 group (xarray conventions) via tensorstore.

    ``chunks`` optionally maps a variable name to its chunk shape;
    variables not listed are written as one whole-array chunk.
    """
    import tensorstore as ts

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, ".zgroup"), "w") as f:
        json.dump({"zarr_format": 2}, f)
    coords = dict(coords or {})
    attrs = dict(attrs or {})
    if time is not None:
        vals, units, calendar = encode_cf_time(time)
        coords["time"] = vals
        attrs["time"] = {**attrs.get("time", {}),
                         "units": units, "calendar": calendar}
    all_vars: dict[str, tuple[np.ndarray, tuple[str, ...]]] = {}
    for cname, cvals in coords.items():
        all_vars[cname] = (np.asarray(cvals), (cname,))
    for name, arr in data.items():
        all_vars[name] = (np.asarray(arr), tuple(dims[name]))
    chunks = dict(chunks or {})
    for name, (arr, arr_dims) in all_vars.items():
        arr_dir = os.path.join(path, name)
        store = ts.open({
            "driver": "zarr",
            "kvstore": {"driver": "file", "path": arr_dir},
            "metadata": {
                "shape": list(arr.shape),
                "chunks": list(chunks.get(name, arr.shape)),
                "dtype": arr.dtype.str,
            },
            "create": True, "delete_existing": True,
        }).result()
        store.write(arr).result()
        var_attrs = {"_ARRAY_DIMENSIONS": list(arr_dims),
                     **attrs.get(name, {})}
        with open(os.path.join(arr_dir, ".zattrs"), "w") as f:
            json.dump(var_attrs, f)
