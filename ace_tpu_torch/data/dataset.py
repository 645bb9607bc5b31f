"""Dataset layer: lazy window reads over multi-file netCDF/HDF5 or zarr
stores (port of ace_tpu/data/dataset.py onto the port's coordinates and
dataset info; reference: fme/core/dataset/xarray.py XarrayDataConfig/
XarrayDataset).

A sample is a contiguous window of ``n_timesteps`` steps of every
requested variable, read on the host as numpy, shaped [T, H, W]. Static
fields are broadcast along time; the derived static fields x/y/z
(Euclidean coordinates of the grid) are synthesized on demand
(reference: xarray.py:202 StaticDerivedData).

Everything here stays numpy on the host. Lat-lon grids (``[T, lat,
lon]``) and HEALPix grids (``face``, ``height`` and ``width`` dims, ``[T,
12, nside, nside]``) with a hybrid sigma-pressure coordinate, a depth
coordinate (``idepth_N`` with the per-layer ``mask_N`` and ``deptho``) or
none are read, and the static ``mask_*`` fields become the dataset info's
``MaskProvider``.
"""

import dataclasses
import datetime
import functools
import glob
import logging
import os

import numpy as np

from ace_tpu_torch.core.coordinates import (
    DepthCoordinate,
    HEALPixCoordinates,
    HybridSigmaPressureCoordinate,
    LatLonCoordinates,
)
from ace_tpu_torch.core.dataset_info import DatasetInfo, VariableMetadata
from ace_tpu_torch.core.masking import MaskProvider
from ace_tpu_torch.core.typing_ import Slice
from ace_tpu_torch.data.store import FileDataset, open_file_dataset
from ace_tpu_torch.data.time import RepeatedInterval, TimeCoord, TimeSlice

LAT_NAMES = ("lat", "latitude", "grid_yt", "y")
LON_NAMES = ("lon", "longitude", "grid_xt", "x")
STATIC_DERIVED_NAMES = ("x", "y", "z")

STATIC_DERIVED_METADATA = {
    "x": VariableMetadata(units="", long_name="Euclidean x-coordinate"),
    "y": VariableMetadata(units="", long_name="Euclidean y-coordinate"),
    "z": VariableMetadata(units="", long_name="Euclidean z-coordinate"),
}


@dataclasses.dataclass
class OverwriteConfig:
    """Overwrite field values at load time
    (reference: fme/core/dataset/xarray.py:365 OverwriteConfig).

    constant: {name: value} fills fields with a constant.
    multiply_scalar: {name: factor} scales fields.
    """

    constant: dict[str, float] = dataclasses.field(default_factory=dict)
    multiply_scalar: dict[str, float] = dataclasses.field(
        default_factory=dict
    )

    def __post_init__(self):
        overlap = set(self.constant) & set(self.multiply_scalar)
        if overlap:
            raise ValueError(
                f"variables in both constant and multiply_scalar: {overlap}"
            )

    def apply(self, name: str, arr: np.ndarray) -> np.ndarray:
        if name in self.constant:
            return np.full_like(arr, self.constant[name])
        if name in self.multiply_scalar:
            return arr * self.multiply_scalar[name]
        return arr


@dataclasses.dataclass
class XarrayDataConfig:
    """Dataset config with the reference's YAML surface
    (reference: fme/core/dataset/xarray.py:403).

    Parameters:
        data_path: directory containing data files (or a zarr group path).
        file_pattern: glob for files inside data_path.
        engine: "netcdf4" (HDF5) or "zarr"; inferred when None.
        n_repeats: repeat the time series this many times.
        subset: index subset of the time dimension.
        spatial_dimensions: only "latlon" currently.
        renamed_variables: mapping from on-disk name -> desired name.
        fill_nans: optional constant to replace NaNs with.
    """

    data_path: str
    file_pattern: str = "*.nc"
    engine: str | None = None
    n_repeats: int = 1
    # index Slice, datetime-string TimeSlice, or RepeatedInterval mask
    # (reference: xarray.py subset options, core/dataset/time.py)
    subset: Slice | TimeSlice | RepeatedInterval = dataclasses.field(
        default_factory=Slice
    )
    spatial_dimensions: str = "latlon"
    renamed_variables: dict[str, str] | None = None
    fill_nans: float | None = None
    overwrite: OverwriteConfig = dataclasses.field(
        default_factory=OverwriteConfig
    )
    # label names applying to every sample of this dataset (reference:
    # xarray.py:468 labels; conditional models one-hot these)
    labels: list[str] | None = None

    def build(self) -> "XarrayDataset":
        return XarrayDataset(self)


def _find_dim(names, candidates):
    for c in candidates:
        if c in names:
            return c
    return None


class XarrayDataset:
    """Multi-file time-concatenated dataset with lazy window reads."""

    def __init__(self, config: XarrayDataConfig):
        self.config = config
        path = config.data_path
        if path.startswith(("gs://", "s3://")):
            # remote zarr groups read through the tensorstore kvstore
            files = [path]
        elif os.path.isdir(path) and os.path.exists(
            os.path.join(path, ".zgroup")
        ):
            files = [path]
        else:
            files = sorted(glob.glob(os.path.join(path, config.file_pattern)))
            if os.path.isfile(path):
                files = [path]
        if not files:
            raise FileNotFoundError(
                f"no files matching {config.file_pattern!r} in {path}"
            )
        self._files: list[FileDataset] = [
            open_file_dataset(f, config.engine) for f in files
        ]
        self._rename = dict(config.renamed_variables or {})

        # global time index
        times = [f.read_time() for f in self._files]
        self._file_offsets = np.concatenate(
            [[0], np.cumsum([len(t) for t in times])]
        )
        all_time = times[0]
        for t in times[1:]:
            all_time = all_time.concat(t)
        if config.n_repeats > 1:
            # repeat the series forward in time with the same spacing
            span = all_time.values[-1] - all_time.values[0] + int(
                np.diff(all_time.values)[0] if len(all_time) > 1 else 0
            )
            reps = [all_time.values + i * span
                    for i in range(config.n_repeats)]
            all_time = TimeCoord(np.concatenate(reps), all_time.calendar)
        self._base_n_times = int(self._file_offsets[-1])
        full_indices = np.arange(self._base_n_times * config.n_repeats)
        if isinstance(config.subset, TimeSlice):
            sel = config.subset.indices(all_time)
        elif isinstance(config.subset, RepeatedInterval):
            base_timestep = None
            if len(all_time) > 1:
                base_timestep = datetime.timedelta(
                    microseconds=int(np.diff(all_time.values)[0])
                )
            sel = config.subset.indices(all_time, base_timestep)
        else:
            sel = full_indices[config.subset.slice]
        # subsetting restricts SAMPLE START positions, not the time axis:
        # every window stays contiguous at the base timestep (reference
        # XarraySubset subsets samples, fme/core/dataset/xarray.py). The
        # full axis is kept for window content and inference lookups.
        self.all_time = TimeCoord(all_time.values, all_time.calendar)
        self._start_indices = full_indices[sel]

        first = self._files[0]
        # horizontal coordinates: HEALPix (face/height/width dims) or
        # lat-lon (reference: fme/core/dataset/xarray.py grid detection)
        lat_name = _find_dim(first.keys(), LAT_NAMES)
        lon_name = _find_dim(first.keys(), LON_NAMES)
        if "face" in first.keys() and "height" in first.keys() and (
            "width" in first.keys()
        ):
            self.horizontal_coordinates: (
                LatLonCoordinates | HEALPixCoordinates
            ) = HEALPixCoordinates(
                face=first["face"].read(()),
                height=first["height"].read(()),
                width=first["width"].read(()),
            )
        elif lat_name is None or lon_name is None:
            raise ValueError(
                "could not find lat/lon or face/height/width coordinates"
            )
        else:
            self._lat_name, self._lon_name = lat_name, lon_name
            self.horizontal_coordinates = LatLonCoordinates(
                lat=first[lat_name].read(()),
                lon=first[lon_name].read(()),
            )
        # vertical coordinate from ak_N/bk_N scalars (atmosphere) or
        # idepth_N scalars + per-layer mask_N + deptho (ocean; reference:
        # fme/core/dataset/xarray.py:60 _get_vertical_coordinate)
        ak = {k: float(first[k].read(())) for k in first.keys()
              if k.startswith("ak_") and k[3:].isdigit()}
        bk = {k: float(first[k].read(())) for k in first.keys()
              if k.startswith("bk_") and k[3:].isdigit()}
        idepth = {k: float(first[k].read(())) for k in first.keys()
                  if k.startswith("idepth_") and k[7:].isdigit()}
        if idepth and ak and bk:
            raise ValueError(
                "Dataset contains both hybrid sigma-pressure (ak_N/bk_N)"
                " and depth (idepth_N) coordinates; the vertical"
                " coordinate is ambiguous."
            )
        if idepth:
            idepth_arr = np.asarray(
                [idepth[k] for k in sorted(idepth, key=lambda s_: int(s_[7:]))],
                np.float32,
            )
            layer_masks = {
                int(k[5:]): np.asarray(first[k].read(()), np.float32)
                for k in first.keys()
                if k.startswith("mask_") and k[5:].isdigit()
            }
            if layer_masks:
                mask = np.stack(
                    [layer_masks[i] for i in sorted(layer_masks)], axis=-1
                )
            else:
                logging.warning(
                    "Dataset has idepth_N but no mask_N variables; "
                    "DepthCoordinate mask set to 1 at all layers."
                )
                mask = np.ones(len(idepth_arr) - 1, np.float32)
            deptho = (
                np.asarray(first["deptho"].read(()), np.float32)
                if "deptho" in first.keys() else None
            )
            self.vertical_coordinate = DepthCoordinate(
                idepth=idepth_arr, mask=mask, deptho=deptho
            )
        elif ak and bk:
            self.vertical_coordinate = HybridSigmaPressureCoordinate(
                ak=np.asarray(
                    [ak[k] for k in sorted(ak, key=lambda s: int(s[3:]))]
                ),
                bk=np.asarray(
                    [bk[k] for k in sorted(bk, key=lambda s: int(s[3:]))]
                ),
            )
        else:
            self.vertical_coordinate = None

        if isinstance(config.subset, RepeatedInterval) and len(
            all_time
        ) > 1:
            # masked subsets are not evenly spaced; the physical timestep
            # is the base dataset's spacing
            self.timestep = datetime.timedelta(
                microseconds=int(np.diff(all_time.values)[0])
            )
        elif len(self.all_time) > 1:
            self.timestep = datetime.timedelta(
                seconds=self.all_time.timestep_seconds()
            )
        else:
            self.timestep = None

        # variable inventory: time-varying [time, lat, lon] and static
        self._time_dependent: dict[str, str] = {}
        self._static: dict[str, str] = {}
        self.variable_metadata: dict[str, VariableMetadata] = {}
        spatial = {lat_name, lon_name}
        for name, var in first.variables.items():
            out_name = self._rename.get(name, name)
            has_time = "time" in var.dims
            is_spatial = len(var.shape) >= 2
            if has_time and is_spatial:
                self._time_dependent[out_name] = name
            elif is_spatial or (not has_time and len(var.shape) in (2,)):
                self._static[out_name] = name
            elif not has_time and len(var.shape) == 2:
                self._static[out_name] = name
            if var.attrs.get("units") or var.attrs.get("long_name"):
                self.variable_metadata[out_name] = VariableMetadata(
                    units=var.attrs.get("units", ""),
                    long_name=var.attrs.get("long_name", ""),
                )
        self.variable_metadata.update(STATIC_DERIVED_METADATA)

    @property
    def names(self) -> list[str]:
        return sorted(
            set(self._time_dependent)
            | set(self._static)
            | set(STATIC_DERIVED_NAMES)
        )

    @property
    def n_times(self) -> int:
        """Number of valid sample-start positions (equals the full time
        length for the default all-inclusive subset)."""
        return len(self._start_indices)

    def n_windows(self, n_timesteps: int) -> int:
        """Number of subset starts whose full window fits in the axis."""
        limit = len(self.all_time) - n_timesteps
        return int(np.searchsorted(
            self._start_indices, limit, side="right"
        ))

    @functools.cached_property
    def mask_provider(self) -> MaskProvider | None:
        """The static ``mask_*`` fields, read once; None without any."""
        masks = {
            name: np.asarray(self._files[0][disk].read(()), np.float32)
            for name, disk in self._static.items()
            if name.startswith("mask_")
        }
        return MaskProvider(masks) if masks else None

    @property
    def dataset_info(self) -> DatasetInfo:
        return DatasetInfo(
            horizontal_coordinates=self.horizontal_coordinates,
            vertical_coordinate=self.vertical_coordinate,
            timestep=self.timestep,
            variable_metadata=self.variable_metadata,
            mask_provider=self.mask_provider,
            all_labels=tuple(sorted(self.config.labels or ())),
        )

    def _static_derived(self, name: str) -> np.ndarray:
        if isinstance(self.horizontal_coordinates, HEALPixCoordinates):
            x, y, z = self.horizontal_coordinates.xyz
            return np.asarray({"x": x, "y": y, "z": z}[name], np.float32)
        lat = np.deg2rad(self.horizontal_coordinates.lat)
        lon = np.deg2rad(self.horizontal_coordinates.lon)
        lat2d, lon2d = np.meshgrid(lat, lon, indexing="ij")
        if name == "x":
            return (np.cos(lat2d) * np.cos(lon2d)).astype(np.float32)
        if name == "y":
            return (np.cos(lat2d) * np.sin(lon2d)).astype(np.float32)
        if name == "z":
            return np.sin(lat2d).astype(np.float32)
        raise KeyError(name)

    def _read_window(self, disk_name: str, start: int, n: int) -> np.ndarray:
        """Read [start, start+n) of a time-dependent variable across files."""
        pieces = []
        remaining = n
        idx = start
        while remaining > 0:
            file_i = int(
                np.searchsorted(self._file_offsets, idx, side="right") - 1
            )
            local = idx - int(self._file_offsets[file_i])
            avail = int(self._file_offsets[file_i + 1]) - idx
            take = min(avail, remaining)
            pieces.append(
                self._files[file_i][disk_name].read(
                    (slice(local, local + take),)
                )
            )
            idx += take
            remaining -= take
        out = pieces[0] if len(pieces) == 1 else np.concatenate(pieces, axis=0)
        return out

    def get_window(
        self, start: int, n_timesteps: int, names: list[str]
    ) -> tuple[dict[str, np.ndarray], TimeCoord]:
        """Read a [n_timesteps, H, W] window for each name starting at
        global time index ``start`` (within the subset index space).
        """
        if start >= len(self._start_indices):
            raise IndexError(
                f"window start {start} exceeds {len(self._start_indices)} "
                "sample starts"
            )
        g = int(self._start_indices[start])
        if g + n_timesteps > len(self.all_time):
            raise IndexError(
                f"window [{g}, {g + n_timesteps}) exceeds dataset "
                f"length {len(self.all_time)}"
            )
        global_idx = np.arange(g, g + n_timesteps)
        base_idx = global_idx % self._base_n_times
        contiguous = bool(
            np.all(np.diff(base_idx) == 1)
        ) if len(base_idx) > 1 else True
        shape2d = self.horizontal_coordinates.shape
        out: dict[str, np.ndarray] = {}
        for name in names:
            if name in self._time_dependent:
                disk = self._time_dependent[name]
                if contiguous:
                    arr = self._read_window(disk, int(base_idx[0]), n_timesteps)
                else:
                    arr = np.concatenate(
                        [self._read_window(disk, int(i), 1) for i in base_idx],
                        axis=0,
                    )
            elif name in self._static:
                arr = np.broadcast_to(
                    self._files[0][self._static[name]].read(()),
                    (n_timesteps, *shape2d),
                ).copy()
            elif name in STATIC_DERIVED_NAMES:
                arr = np.broadcast_to(
                    self._static_derived(name), (n_timesteps, *shape2d)
                ).copy()
            else:
                raise KeyError(
                    f"variable {name!r} not in dataset (has {self.names})"
                )
            arr = np.asarray(arr, dtype=np.float32)
            if self.config.fill_nans is not None:
                arr = np.nan_to_num(arr, nan=self.config.fill_nans)
            out[name] = self.config.overwrite.apply(name, arr)
        return out, self.all_time[g : g + n_timesteps]


class MemoryDataset:
    """Forcing held in memory: ``[time, lat, lon]`` host arrays by name and
    their times, with what ``InferenceGriddedData`` reads of an
    ``XarrayDataset`` (``all_time``, ``n_times``, ``dataset_info``,
    ``get_window``). For forcing made by a program rather than read from
    files, as where no netCDF reader is installed."""

    def __init__(self, fields: dict[str, np.ndarray], time: TimeCoord,
                 dataset_info: DatasetInfo):
        self.fields, self.all_time = fields, time
        self.dataset_info = dataset_info

    @property
    def n_times(self) -> int:
        return len(self.all_time)

    def get_window(self, start: int, n_timesteps: int, names: list[str]):
        window = slice(start, start + n_timesteps)
        return ({k: self.fields[k][window] for k in names},
                self.all_time[window])


def _with_all_labels(info: DatasetInfo, datasets) -> DatasetInfo:
    """``info`` with the sorted union of ``datasets``' labels, the labels
    the loader one-hot encodes."""
    labels = set()
    for ds in datasets:
        labels.update(ds.dataset_info.all_labels)
    return dataclasses.replace(info, all_labels=tuple(sorted(labels)))


@dataclasses.dataclass
class ConcatDatasetConfig:
    """Time-concatenation of separately configured datasets
    (reference: fme/core/dataset/concat.py:107 ConcatDatasetConfig).
    """

    concat: list[XarrayDataConfig]
    strict: bool = True

    def build(self) -> "ConcatXarrayDataset":
        return ConcatXarrayDataset(
            [cfg.build() for cfg in self.concat], strict=self.strict
        )


class ConcatXarrayDataset:
    """Datasets concatenated along time, in the given order."""

    def __init__(self, datasets: list["XarrayDataset"], strict=True):
        self._datasets = datasets
        first = datasets[0]
        for other in datasets[1:]:
            if strict and not (
                other.horizontal_coordinates
                == first.horizontal_coordinates
            ):
                raise ValueError(
                    "concatenated datasets have mismatched coordinates"
                )
        self._offsets = np.concatenate(
            [[0], np.cumsum([d.n_times for d in datasets])]
        )
        values = np.concatenate(
            [d.all_time.values for d in datasets]
        )
        self.all_time = TimeCoord(values, first.all_time.calendar)

    @property
    def names(self) -> list[str]:
        return self._datasets[0].names

    @property
    def n_times(self) -> int:
        return int(self._offsets[-1])

    @property
    def timestep(self):
        return self._datasets[0].timestep

    @property
    def horizontal_coordinates(self):
        return self._datasets[0].horizontal_coordinates

    @property
    def vertical_coordinate(self):
        return self._datasets[0].vertical_coordinate

    @property
    def dataset_info(self) -> DatasetInfo:
        """The first dataset's, with the union of every dataset's labels
        (``ace_tpu`` keeps the first's labels only, so that a model built
        from it takes fewer labels than its loader gives)."""
        return _with_all_labels(self._datasets[0].dataset_info,
                                self._datasets)

    def n_windows(self, n_timesteps: int) -> int:
        """Samples never span segment boundaries (reference XarrayConcat
        wraps per-dataset sample sets in ConcatDataset)."""
        return sum(
            d.n_windows(n_timesteps) if hasattr(d, "n_windows")
            else max(0, d.n_times - n_timesteps + 1)
            for d in self._datasets
        )

    def window_start(self, index: int, n_timesteps: int) -> int:
        """Global time index of the index-th valid (non-spanning) window."""
        for seg, d in enumerate(self._datasets):
            n_seg = (
                d.n_windows(n_timesteps) if hasattr(d, "n_windows")
                else max(0, d.n_times - n_timesteps + 1)
            )
            if index < n_seg:
                return int(self._offsets[seg]) + index
            index -= n_seg
        raise IndexError("window index exceeds concatenated windows")

    def get_window(self, start: int, n_timesteps: int, names: list[str]):
        """Read a window at global time index ``start``; windows that
        would span a segment boundary are rejected — two stitched time
        ranges are not one contiguous sample (use n_windows/window_start
        to enumerate valid samples)."""
        seg = int(np.searchsorted(self._offsets, start, "right") - 1)
        if seg >= len(self._datasets):
            raise IndexError("window exceeds concatenated length")
        local = start - int(self._offsets[seg])
        if local + n_timesteps > self._datasets[seg].n_times:
            raise ValueError(
                f"window [{start}, {start + n_timesteps}) spans the "
                f"boundary of concatenated segment {seg}"
            )
        return self._datasets[seg].get_window(local, n_timesteps, names)


@dataclasses.dataclass
class MergeDatasetConfig:
    """Variable-wise merge of datasets sharing a time coordinate; the
    first source containing a variable wins
    (reference: fme/core/dataset/merged.py:308 MergeDatasetConfig).
    """

    merge: list[XarrayDataConfig]

    def build(self) -> "MergedXarrayDataset":
        return MergedXarrayDataset([cfg.build() for cfg in self.merge])


class MergedXarrayDataset:
    def __init__(self, datasets: list[XarrayDataset]):
        if not datasets:
            raise ValueError("merge list must be non-empty")
        self._datasets = datasets
        t0 = datasets[0].all_time
        for ds in datasets[1:]:
            if len(ds.all_time) != len(t0) or not np.array_equal(
                ds.all_time.values, t0.values
            ):
                raise ValueError(
                    "merged datasets must share the same time coordinate"
                )
        self.all_time = t0
        self._source: dict[str, XarrayDataset] = {}
        for ds in datasets:
            for name in ds.names:
                self._source.setdefault(name, ds)

    @property
    def names(self) -> list[str]:
        return sorted(self._source)

    @property
    def n_times(self) -> int:
        """Number of valid sample-start positions: the first source's
        (the sources share one time axis)."""
        return self._datasets[0].n_times

    def n_windows(self, n_timesteps: int) -> int:
        """Number of subset starts whose full window fits in the axis."""
        return self._datasets[0].n_windows(n_timesteps)

    @property
    def timestep(self):
        return self._datasets[0].timestep

    @property
    def horizontal_coordinates(self):
        return self._datasets[0].horizontal_coordinates

    @property
    def vertical_coordinate(self):
        return self._datasets[0].vertical_coordinate

    @property
    def dataset_info(self) -> DatasetInfo:
        info = self._datasets[0].dataset_info
        metadata = dict(info.variable_metadata)
        for ds in self._datasets[1:]:
            for k, v in ds.variable_metadata.items():
                metadata.setdefault(k, v)
        return _with_all_labels(
            dataclasses.replace(info, variable_metadata=metadata),
            self._datasets)

    def get_window(self, start: int, n_timesteps: int, names: list[str]):
        out: dict[str, np.ndarray] = {}
        time = None
        by_source: dict[int, list[str]] = {}
        for name in names:
            if name not in self._source:
                raise KeyError(
                    f"variable {name!r} not in any merged dataset"
                )
            by_source.setdefault(id(self._source[name]), []).append(name)
        for ds in self._datasets:
            wanted = by_source.get(id(ds))
            if not wanted:
                continue
            data, time = ds.get_window(start, n_timesteps, wanted)
            out.update(data)
        return out, time
