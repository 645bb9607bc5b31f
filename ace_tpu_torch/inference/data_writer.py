"""Streaming prediction writers (reference: fme/ace/inference/data_writer/
— raw netCDF per-rank (raw.py:96), zarr (zarr.py:109), restart snapshots).

HDF5 writer uses resizable (unlimited-time) datasets; zarr writer appends
along time via tensorstore resize. Restart files carry the final
prognostic state + time for segmented runs.

A copy of ``ace_tpu/inference/data_writer.py`` (numpy on the host; tests hold it equal to
the original).
"""

import dataclasses
import json
import logging
import os
from typing import Any

import numpy as np

from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.data.store import encode_cf_time
from ace_tpu_torch.data.time import TimeCoord
from ace_tpu_torch.core.typing_ import TensorMapping



def _select_names(names: list | None, data: TensorMapping) -> list:
    """Configured names act as an allowlist intersected with what the
    model actually produced (reference raw.py:158-161 get_all_names);
    unknown names are skipped with a log line instead of a KeyError."""
    if names is None:
        return list(data.keys())
    missing = [n for n in names if n not in data]
    if missing:
        logging.info(
            "data_writer names not in outputs, skipping: %s", missing
        )
    return [n for n in names if n in data]


def _horizontal_coords_arrays(coords) -> tuple[dict, tuple]:
    """(coords dict, spatial dim names) for lat-lon or HEALPix grids."""
    if hasattr(coords, "lat"):
        return (
            {"lat": np.asarray(coords.lat), "lon": np.asarray(coords.lon)},
            ("lat", "lon"),
        )
    names = ("face", "height", "width")
    return (
        {n: np.arange(s, dtype="f8") for n, s in zip(names, coords.shape)},
        names,
    )


class H5DataWriter:
    """Appends [batch, time, lat, lon] batches along an unlimited time dim
    (reference: data_writer/raw.py).
    """

    def __init__(self, path: str, dataset_info: DatasetInfo,
                 names: list[str] | None = None):
        import h5py

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = h5py.File(path, "w")
        self._names = names
        self._info = dataset_info
        self._n_time = 0
        self._time_units = "seconds since 1970-01-01T00:00:00"
        coords = dataset_info.horizontal_coordinates
        if hasattr(coords, "lat"):
            self._f.create_dataset("lat", data=np.asarray(coords.lat))
            self._f.create_dataset("lon", data=np.asarray(coords.lon))
        else:
            # HEALPix (face, height, width) index coordinates
            for name, n in zip(
                ("face", "height", "width"), coords.shape
            ):
                self._f.create_dataset(name, data=np.arange(n, dtype="f8"))

    def append_batch(self, data: TensorMapping, time: TimeCoord):
        names = _select_names(self._names, data)
        n_new = time.values.shape[-1]
        first = self._n_time == 0
        if first:
            vals, units, calendar = encode_cf_time(time)
            sample_shape = np.asarray(data[names[0]]).shape
            b = sample_shape[0]
            self._f.create_dataset(
                "time", shape=(b, 0), maxshape=(b, None), dtype="f8"
            )
            self._f["time"].attrs["units"] = units
            self._f["time"].attrs["calendar"] = calendar
            for name in names:
                arr = np.asarray(data[name])
                self._f.create_dataset(
                    name,
                    shape=(arr.shape[0], 0, *arr.shape[2:]),
                    maxshape=(arr.shape[0], None, *arr.shape[2:]),
                    dtype="f4",
                    chunks=(arr.shape[0], 1, *arr.shape[2:]),
                )
                meta = self._info.variable_metadata.get(name)
                if meta is not None:
                    self._f[name].attrs["units"] = meta.units
                    self._f[name].attrs["long_name"] = meta.long_name
        t0 = self._n_time
        vals, _, _ = encode_cf_time(time, self._time_units)
        self._f["time"].resize(t0 + n_new, axis=1)
        self._f["time"][:, t0:] = np.atleast_2d(vals)
        for name in names:
            if name not in data:
                continue
            arr = np.asarray(data[name])
            self._f[name].resize(t0 + n_new, axis=1)
            self._f[name][:, t0:] = arr
        self._n_time = t0 + n_new

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


class ZarrDataWriter:
    """Appends batches along time into a zarr v2 group via tensorstore
    (reference: data_writer/zarr.py:109).
    """

    def __init__(self, path: str, dataset_info: DatasetInfo,
                 names: list[str] | None = None):
        import tensorstore as ts

        self._path = path
        self._names = names
        self._info = dataset_info
        self._n_time = 0
        self._stores: dict[str, Any] = {}
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, ".zgroup"), "w") as f:
            json.dump({"zarr_format": 2}, f)
        # spatial coordinate arrays (the reference zarr writer stores
        # them so _ARRAY_DIMENSIONS references resolve, zarr.py:152)
        coords, _ = _horizontal_coords_arrays(
            dataset_info.horizontal_coordinates
        )
        for cname, cvals in coords.items():
            cvals = np.asarray(cvals)
            arr_dir = os.path.join(path, cname)
            store = ts.open({
                "driver": "zarr",
                "kvstore": {"driver": "file", "path": arr_dir},
                "metadata": {
                    "shape": list(cvals.shape),
                    "chunks": list(cvals.shape),
                    "dtype": cvals.dtype.str,
                },
                "create": True, "delete_existing": True,
            }).result()
            store.write(cvals).result()
            with open(os.path.join(arr_dir, ".zattrs"), "w") as f:
                json.dump({"_ARRAY_DIMENSIONS": [cname]}, f)

    def _create(self, name: str, arr: np.ndarray, attrs: dict,
                dtype: str = "<f4"):
        import tensorstore as ts

        arr_dir = os.path.join(self._path, name)
        store = ts.open({
            "driver": "zarr",
            "kvstore": {"driver": "file", "path": arr_dir},
            "metadata": {
                "shape": [arr.shape[0], 0, *arr.shape[2:]],
                "chunks": [arr.shape[0], 1, *arr.shape[2:]],
                "dtype": dtype,
            },
            "create": True, "delete_existing": True,
        }).result()
        with open(os.path.join(arr_dir, ".zattrs"), "w") as f:
            json.dump(attrs, f)
        self._stores[name] = store

    def append_batch(self, data: TensorMapping, time: TimeCoord):
        import tensorstore as ts  # noqa: F401

        names = _select_names(self._names, data)
        n_new = time.values.shape[-1]
        _, spatial_dims = _horizontal_coords_arrays(
            self._info.horizontal_coordinates
        )
        dims = ["sample", "time", *spatial_dims]
        if self._n_time == 0:
            for name in names:
                arr = np.asarray(data[name])
                meta = self._info.variable_metadata.get(name)
                attrs = {"_ARRAY_DIMENSIONS": dims[: arr.ndim]}
                if meta is not None:
                    attrs.update(
                        {"units": meta.units, "long_name": meta.long_name}
                    )
                self._create(name, arr, attrs)
            vals, units, calendar = encode_cf_time(time)
            # float64: float32 cannot represent modern epochs to better
            # than ~2 minutes
            self._create(
                "time", np.atleast_2d(vals).astype(np.float64),
                {"_ARRAY_DIMENSIONS": ["sample", "time"],
                 "units": units, "calendar": calendar},
                dtype="<f8",
            )
        t0, t1 = self._n_time, self._n_time + n_new
        for name in names:
            if name not in data:
                continue
            arr = np.asarray(data[name], dtype=np.float32)
            store = self._stores[name]
            store = store.resize(
                exclusive_max=[arr.shape[0], t1, *arr.shape[2:]]
            ).result()
            self._stores[name] = store
            store[:, t0:t1].write(arr).result()
        vals, _, _ = encode_cf_time(time)
        tstore = self._stores["time"]
        tstore = tstore.resize(
            exclusive_max=[vals.shape[0] if vals.ndim > 1 else 1, t1]
        ).result()
        self._stores["time"] = tstore
        tstore[:, t0:t1].write(
            np.atleast_2d(vals).astype(np.float64)
        ).result()
        self._n_time = t1

    def flush(self):
        pass

    def close(self):
        pass


class NullDataWriter:
    """(reference: fme/core/generics/writer.py NullDataWriter)."""

    def append_batch(self, data, time):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def save_restart(path: str, prognostic_data: TensorMapping, time: TimeCoord,
                 dataset_info: DatasetInfo):
    """Write a restart file with the final prognostic state
    (reference: data_writer restart.nc behavior).
    """
    from ace_tpu_torch.data.store import write_h5

    coords, spatial_dims = _horizontal_coords_arrays(
        dataset_info.horizontal_coordinates
    )
    data = {k: np.asarray(v) for k, v in prognostic_data.items()}
    dims = {k: ("sample", "time", *spatial_dims)[: v.ndim]
            for k, v in data.items()}
    vals, units, calendar = encode_cf_time(time)
    data["time"] = np.atleast_2d(vals)
    dims["time"] = ("sample", "time")
    write_h5(path, data, dims, coords=coords,
             attrs={"time": {"units": units, "calendar": calendar}})


class _MultiWriter:
    def __init__(self, writers):
        self._writers = writers

    def append_batch(self, data, time):
        for w in self._writers:
            w.append_batch(data, time)

    def flush(self):
        for w in self._writers:
            w.flush()

    def close(self):
        for w in self._writers:
            w.close()


@dataclasses.dataclass
class DataWriterConfig:
    """(reference: fme/ace/inference/data_writer/main.py:37)."""

    save_prediction_files: bool = True
    save_monthly_files: bool = False
    output_format: str = "netcdf"  # "netcdf" | "zarr"
    names: list[str] | None = None
    time_coarsen_factor: int = 1

    def validate_time_coarsen(self, n_forward_steps: int,
                              forward_steps_in_memory: int) -> None:
        """Reject rollout lengths the coarsener cannot tile — trailing
        steps would silently never reach the output (reference
        data_writer/main.py:95 validate_time_coarsen)."""
        f = self.time_coarsen_factor
        if f <= 1 or not self.save_prediction_files:
            return
        if n_forward_steps % f != 0:
            raise ValueError(
                f"n_forward_steps ({n_forward_steps}) must be divisible "
                f"by time_coarsen_factor ({f})"
            )

    def build(self, experiment_dir: str, dataset_info: DatasetInfo):
        writers = []
        if self.save_prediction_files:
            if self.output_format == "zarr":
                raw = ZarrDataWriter(
                    os.path.join(
                        experiment_dir, "autoregressive_predictions.zarr"
                    ),
                    dataset_info, self.names,
                )
            else:
                raw = H5DataWriter(
                    os.path.join(
                        experiment_dir, "autoregressive_predictions.nc"
                    ),
                    dataset_info, self.names,
                )
            if self.time_coarsen_factor > 1:
                raw = TimeCoarsenWriter(raw, self.time_coarsen_factor)
            writers.append(raw)
        if self.save_monthly_files:
            writers.append(MonthlyMeanWriter(
                os.path.join(experiment_dir, "monthly_mean_predictions.nc"),
                dataset_info, self.names,
            ))
        if not writers:
            return NullDataWriter()
        if len(writers) == 1:
            return writers[0]
        return _MultiWriter(writers)


class MonthlyMeanWriter:
    """Streams batches into per-calendar-month means, written at close
    (reference: fme/ace/inference/data_writer/monthly.py:89).
    """

    def __init__(self, path: str, dataset_info: DatasetInfo,
                 names: list[str] | None = None):
        self._path = path
        self._info = dataset_info
        self._names = names
        # per-sample month bins: samples may start at different initial
        # times (reference monthly.py:169-190 bins each sample by its
        # own calendar month)
        self._sums: dict[str, dict[tuple[int, int, int], np.ndarray]] = {}
        self._counts: dict[tuple[int, int, int], int] = {}
        self._calendar: str | None = None

    def append_batch(self, data: TensorMapping, time: TimeCoord):
        comps = time.components()
        years = np.atleast_2d(comps["year"])
        months = np.atleast_2d(comps["month"])
        self._calendar = time.calendar
        names = _select_names(self._names, data)
        n_samples, n_time = years.shape
        for b in range(n_samples):
            for t in range(n_time):
                key = (b, int(years[b, t]), int(months[b, t]))
                self._counts[key] = self._counts.get(key, 0) + 1
                for name in names:
                    arr = np.asarray(data[name])[b, t]
                    sums = self._sums.setdefault(name, {})
                    if key in sums:
                        sums[key] = sums[key] + arr
                    else:
                        sums[key] = arr.copy()

    def flush(self):
        pass

    def close(self):
        from ace_tpu_torch.data.store import write_h5
        from ace_tpu_torch.data.time import encode_time

        if not self._counts:
            return
        samples = sorted({k[0] for k in self._counts})
        months_per_sample = {
            b: sorted((y, m) for (bb, y, m) in self._counts if bb == b)
            for b in samples
        }
        n_months = max(len(v) for v in months_per_sample.values())
        calendar = self._calendar or "proleptic_gregorian"
        _, spatial_dims = _horizontal_coords_arrays(
            self._info.horizontal_coordinates
        )
        out_data, dims, attrs = {}, {}, {}
        for name, sums in self._sums.items():
            first = next(iter(sums.values()))
            stacked = np.full(
                (len(samples), n_months, *first.shape), np.nan,
                np.float32,
            )
            for bi, b in enumerate(samples):
                for mi, (y, m) in enumerate(months_per_sample[b]):
                    stacked[bi, mi] = (
                        sums[(b, y, m)] / self._counts[(b, y, m)]
                    )
            out_data[name] = stacked
            dims[name] = ("sample", "month", *spatial_dims)
        units = "days since 0001-01-01"
        valid_time = np.full((len(samples), n_months), np.nan)
        counts = np.zeros((len(samples), n_months), np.int64)
        for bi, b in enumerate(samples):
            for mi, (y, m) in enumerate(months_per_sample[b]):
                micros = int(encode_time(
                    np.asarray([y]), m, 1, calendar=calendar
                )[0])
                valid_time[bi, mi] = micros / (86400.0 * 10**6)
                counts[bi, mi] = self._counts[(b, y, m)]
        out_data["valid_time"] = valid_time
        dims["valid_time"] = ("sample", "month")
        attrs["valid_time"] = {"units": units, "calendar": calendar}
        out_data["counts"] = counts
        dims["counts"] = ("sample", "month")
        coords, _ = _horizontal_coords_arrays(
            self._info.horizontal_coordinates
        )
        write_h5(self._path, out_data, dims, coords=coords, attrs=attrs)


class TimeCoarsenWriter:
    """Averages every ``coarsen_factor`` steps before delegating to an
    inner writer (reference: data_writer/time_coarsen.py).
    """

    def __init__(self, writer, coarsen_factor: int):
        if coarsen_factor < 1:
            raise ValueError("coarsen_factor must be >= 1")
        self._writer = writer
        self._factor = coarsen_factor
        self._buffer: list[tuple[dict, TimeCoord]] = []
        self._buffered_steps = 0

    def append_batch(self, data: TensorMapping, time: TimeCoord):
        self._buffer.append((dict(data), time))
        self._buffered_steps += time.values.shape[-1]
        while self._buffered_steps >= self._factor:
            self._emit_one()

    def _concat_buffer(self):
        names = self._buffer[0][0].keys()
        data = {
            k: np.concatenate(
                [np.asarray(d[k]) for d, _ in self._buffer], axis=1
            )
            for k in names
        }
        times = np.concatenate(
            [t.values for _, t in self._buffer], axis=-1
        )
        calendar = self._buffer[0][1].calendar
        return data, TimeCoord(times, calendar)

    def _emit_one(self):
        data, time = self._concat_buffer()
        f = self._factor
        coarse = {k: v[:, :f].mean(axis=1, keepdims=True)
                  for k, v in data.items()}
        # time labels coarsen to the mean of the window's labels
        # (reference time_coarsen.py:183 batch_time.coarsen(...).mean())
        t_mean = time.values[..., :f].mean(
            axis=-1, keepdims=True
        ).astype(np.int64)
        t_out = TimeCoord(t_mean, time.calendar)
        self._writer.append_batch(coarse, t_out)
        rest = {k: v[:, f:] for k, v in data.items()}
        rest_time = TimeCoord(time.values[..., f:], time.calendar)
        self._buffer = [(rest, rest_time)]
        self._buffered_steps = rest_time.values.shape[-1]

    def flush(self):
        self._writer.flush()

    def close(self):
        self._writer.close()
