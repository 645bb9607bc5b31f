"""Downscaling generation entry (port of ace_tpu/downscaling/predict.py).

    python -m ace_tpu_torch.downscaling.predict <config.yaml> [--device cpu]

It reads the YAML of ``python -m ace_tpu.downscaling.predict``: a
checkpoint (or a mixture of denoising experts), coarse snapshots over a
time range, optional patches, dated events and named time ranges. The
fields are written as ``ace_tpu`` writes them: netCDF through
``write_h5`` (``downscaled_predictions.nc``, ``<event>_event.nc``), zarr
through ``write_zarr`` (``<name>.zarr``). Each output's draws come from a
``torch.Generator`` seeded as ``ace_tpu`` seeds its keys (``seed``, and
``seed + crc32(name) % 2**16`` for an event or a time range).
"""

import dataclasses
import logging
import os
import zlib

import numpy as np
import torch

from ace_tpu_torch.core.cli import get_parser, prepare_config, prepare_directory
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.typing_ import Slice
from ace_tpu_torch.data.dataset import XarrayDataConfig
from ace_tpu_torch.data.store import write_h5
from ace_tpu_torch.data.time import RepeatedInterval, TimeSlice
from ace_tpu_torch.device import entry_device
from ace_tpu_torch.downscaling.models import (
    DenoisingMoEBundledConfig,
    DenoisingMoEConfig,
)
from ace_tpu_torch.train.trainer import LoggingConfig


class StreamingMoments:
    """Welford's streaming mean and std over ensemble members delivered in
    groups (the count advances per member)."""

    def __init__(self):
        self.count = 0
        self._mean = None
        self._m2 = None

    def update(self, members):
        if self._mean is None:
            self._mean = np.zeros(members.shape[1:], np.float64)
            self._m2 = np.zeros(members.shape[1:], np.float64)
        for member in members:
            self.count += 1
            delta = member - self._mean
            self._mean += delta / self.count
            self._m2 += delta * (member - self._mean)

    @property
    def mean(self):
        return self._mean

    @property
    def std(self):
        return np.sqrt(self._m2 / max(self.count - 1, 1))


def _region_indices(lat, lon, lat_extent, lon_extent, label=""):
    """``(y0, y1, xs, contiguous)`` of lat/lon extents; a longitude extent
    may wrap the prime meridian (e.g. [350, 10])."""
    lat, lon = np.asarray(lat), np.asarray(lon)
    lat_sel = np.ones(len(lat), bool)
    lon_sel = np.ones(len(lon), bool)
    if lat_extent is not None:
        lat_sel = (lat >= lat_extent[0]) & (lat <= lat_extent[1])
    if lon_extent is not None:
        lo, hi = lon_extent[0] % 360.0, lon_extent[1] % 360.0
        lon_n = lon % 360.0
        if lo <= hi:
            lon_sel = (lon_n >= lo) & (lon_n <= hi)
        else:
            lon_sel = (lon_n >= lo) | (lon_n <= hi)
    if not lat_sel.any() or not lon_sel.any():
        raise ValueError(
            f"{label}: lat/lon extent selects no grid points "
            f"(lat_extent={lat_extent}, lon_extent={lon_extent})")
    y0, y1 = np.nonzero(lat_sel)[0][[0, -1]]
    xs = np.nonzero(lon_sel)[0]
    contiguous = len(xs) == xs[-1] - xs[0] + 1
    return int(y0), int(y1), xs, contiguous


def _crop_window(window, y0, y1, xs, contiguous, device):
    if contiguous:
        out = {k: v[..., y0:y1 + 1, xs[0]:xs[-1] + 1]
               for k, v in window.items()}
    else:
        out = {k: np.take(v[..., y0:y1 + 1, :], xs, axis=-1)
               for k, v in window.items()}
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in out.items()}


def _crop_static(model, y0, y1, xs, contiguous):
    """The fine static fields over the same coarse region."""
    full = getattr(model, "static_inputs", None)
    if not getattr(model.config, "use_fine_topography", False) or (
            full is None):
        return None
    f = model.config.downscale_factor
    rows = full[y0 * f:(y1 + 1) * f]
    if contiguous:
        return rows[:, xs[0] * f:(xs[-1] + 1) * f]
    fine_xs = torch.as_tensor((xs[:, None] * f + np.arange(f)).ravel(),
                              device=rows.device)
    return rows.index_select(1, fine_xs)


def zarr_output_chunks(shape, max_mb: float = 10.0):
    """Chunks of a ``[..., lat, lon]`` float32 output: 1 along the leading
    axes; lat and lon halved (the larger first) until a chunk is at most
    ``max_mb``."""
    h, w = int(shape[-2]), int(shape[-1])
    while h * w * 4 > max_mb * 2 ** 20:
        if h >= w:
            h = max(1, -(-h // 2))
        else:
            w = max(1, -(-w // 2))
    return [1] * (len(shape) - 2) + [h, w]


@dataclasses.dataclass
class EventConfig:
    """A large ensemble of one dated snapshot over an optional crop."""

    name: str
    date: str  # "%Y-%m-%dT%H:%M"
    lat_extent: list[float] | None = None
    lon_extent: list[float] | None = None
    n_samples: int = 64
    save_generated_samples: bool = False


@dataclasses.dataclass
class TimeRangeOutputConfig:
    """A named time segment and region written to
    ``<experiment_dir>/<name>.zarr`` with dims (time, sample, lat, lon)."""

    name: str
    time_range: "TimeSlice | RepeatedInterval | Slice"
    n_samples: int = 1
    lat_extent: list[float] | None = None
    lon_extent: list[float] | None = None
    save_vars: list[str] | None = None
    # samples a generation call, bounding device memory
    max_samples_per_call: int = 8


@dataclasses.dataclass
class DownscalerConfig:
    """Exactly one of ``checkpoint_path`` and ``model`` (a mixture of
    denoising experts) selects the generator."""

    experiment_dir: str
    coarse_data: XarrayDataConfig
    checkpoint_path: str | None = None
    model: DenoisingMoEConfig | DenoisingMoEBundledConfig | None = None
    n_samples: int = 1
    start_index: int = 0
    n_timesteps: int = 1
    coarse_patch_extent_lat: int | None = None
    coarse_patch_extent_lon: int | None = None
    coarse_horizontal_overlap: int = 1
    seed: int = 0
    events: list[EventConfig] = dataclasses.field(default_factory=list)
    time_ranges: list[TimeRangeOutputConfig] = dataclasses.field(
        default_factory=list)
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)

    def __post_init__(self):
        if (self.coarse_patch_extent_lat is None) != (
                self.coarse_patch_extent_lon is None):
            raise ValueError(
                "set both or neither of coarse_patch_extent_lat/lon")
        if (self.checkpoint_path is None) == (self.model is None):
            raise ValueError(
                "exactly one of checkpoint_path or model must be set")


def load_downscaling_predictor(checkpoint_path, model_config, device=None):
    """The generator of the ``checkpoint_path``/``model`` union."""
    from ace_tpu_torch.downscaling.train import load_downscaling_model

    if model_config is not None:
        return model_config.build(device=device)
    return load_downscaling_model(checkpoint_path, device=device)


def build_generate(model, config):
    """``model.generate``, or a ``PatchPredictor``'s where the config sets
    a patch extent."""
    from ace_tpu_torch.downscaling.models import PatchPredictor

    if config.coarse_patch_extent_lat is None:
        return model.generate
    return PatchPredictor(
        model, coarse_patch_shape=(config.coarse_patch_extent_lat,
                                   config.coarse_patch_extent_lon),
        coarse_horizontal_overlap=config.coarse_horizontal_overlap,
    ).generate


def _seeded(device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def _named_seed(seed: int, name: str) -> int:
    # stable across processes (hash() is salted per interpreter)
    return seed + zlib.crc32(name.encode()) % 2 ** 16


def run_downscaler(config: DownscalerConfig, device=None) -> str:
    device = entry_device(device)
    model = load_downscaling_predictor(config.checkpoint_path, config.model,
                                       device)
    ds = config.coarse_data.build()
    names = model.config.in_names
    generate = build_generate(model, config)
    generator = _seeded(device, config.seed)
    outputs: dict[str, list] = {}
    for t in range(config.start_index,
                   config.start_index + config.n_timesteps):
        window, _ = ds.get_window(t, 1, names)
        coarse = {k: torch.as_tensor(v, device=device)
                  for k, v in window.items()}
        gen = generate(coarse, generator, n_samples=config.n_samples)
        for k, v in gen.items():
            outputs.setdefault(k, []).append(v[0])
        logging.info(f"downscaled timestep {t}")

    for event in config.events:
        run_event(config, model, generate, event, device)
    for out_cfg in config.time_ranges:
        run_time_range(config, model, generate, out_cfg, device)

    os.makedirs(config.experiment_dir, exist_ok=True)
    path = os.path.join(config.experiment_dir, "downscaled_predictions.nc")
    arrays = {k: torch.stack(v).cpu().numpy() for k, v in outputs.items()}
    write_h5(path, arrays, {k: ("time", "sample", "lat", "lon")
                            for k in arrays})
    logging.info(f"wrote {path}")
    return path


def run_event(config, model, generate, event: EventConfig, device=None):
    """A large ensemble of one dated snapshot, generated in groups of 8,
    its mean and std streamed (and every sample kept where asked)."""
    from ace_tpu_torch.data.time import parse_datetime_string

    ds = config.coarse_data.build()
    target_us = parse_datetime_string(event.date, ds.all_time.calendar)
    t = int(np.argmin(np.abs(np.asarray(ds.all_time.values, np.int64)
                             - target_us)))
    window, _ = ds.get_window(t, 1, model.config.in_names)
    hc = ds.dataset_info.horizontal_coordinates
    y0, y1, xs, contiguous = _region_indices(
        hc.lat, hc.lon, event.lat_extent, event.lon_extent,
        label=f"event {event.name}")
    coarse = _crop_window(window, y0, y1, xs, contiguous, device)
    static = _crop_static(model, y0, y1, xs, contiguous)
    generator = _seeded(device, _named_seed(config.seed, event.name))
    group, count = 8, 0
    moments: dict[str, StreamingMoments] = {}
    samples = []
    while count < event.n_samples:
        n = min(group, event.n_samples - count)
        gen = generate(coarse, generator, n_samples=n, static=static)
        host = {k: v[0].cpu().numpy() for k, v in gen.items()}  # [n, H, W]
        for k, arr in host.items():
            moments.setdefault(k, StreamingMoments()).update(arr)
        if event.save_generated_samples:
            samples.append(host)
        count += n
        logging.info(f"event {event.name}: {count}/{event.n_samples} samples")
    os.makedirs(config.experiment_dir, exist_ok=True)
    arrays, dims = {}, {}
    for k, mom in moments.items():
        arrays[f"{k}_mean"] = mom.mean.astype(np.float32)
        arrays[f"{k}_std"] = mom.std.astype(np.float32)
        dims[f"{k}_mean"] = dims[f"{k}_std"] = ("lat", "lon")
        if event.save_generated_samples:
            arrays[k] = np.concatenate([s[k] for s in samples],
                                       axis=0).astype(np.float32)
            dims[k] = ("sample", "lat", "lon")
    path = os.path.join(config.experiment_dir, f"{event.name}_event.nc")
    write_h5(path, arrays, dims)
    logging.info(f"wrote {path}")
    return path


def run_time_range(config, model, generate, out_cfg: TimeRangeOutputConfig,
                   device=None):
    """An ensemble over a time segment and region, written to
    ``<experiment_dir>/<name>.zarr``."""
    import datetime

    from ace_tpu_torch.data.store import write_zarr
    from ace_tpu_torch.data.time import TimeCoord

    ds = config.coarse_data.build()
    tr = out_cfg.time_range
    if isinstance(tr, Slice):
        t_indices = np.arange(ds.n_times)[tr.slice]
    elif isinstance(tr, RepeatedInterval):
        step = ds.all_time.timestep_seconds()
        t_indices = tr.indices(
            ds.all_time, datetime.timedelta(seconds=step) if step else None)
    else:
        t_indices = tr.indices(ds.all_time)
    if len(t_indices) == 0:
        raise ValueError(
            f"time range output {out_cfg.name!r} selects no timesteps")
    names = model.config.in_names
    hc = ds.dataset_info.horizontal_coordinates
    y0, y1, xs, contiguous = _region_indices(
        hc.lat, hc.lon, out_cfg.lat_extent, out_cfg.lon_extent,
        label=f"time range {out_cfg.name}")
    static = _crop_static(model, y0, y1, xs, contiguous)
    generator = _seeded(device, _named_seed(config.seed, out_cfg.name))
    save_vars = out_cfg.save_vars or model.config.out_names
    per_time: dict[str, list] = {}
    for t in t_indices:
        window, _ = ds.get_window(int(t), 1, names)
        coarse = _crop_window(window, y0, y1, xs, contiguous, device)
        members: dict[str, list] = {}
        count = 0
        while count < out_cfg.n_samples:
            n = min(out_cfg.max_samples_per_call, out_cfg.n_samples - count)
            gen = generate(coarse, generator, n_samples=n, static=static)
            for k in save_vars:
                members.setdefault(k, []).append(gen[k][0].float())
            count += n
        for k, parts in members.items():
            per_time.setdefault(k, []).append(torch.cat(parts, dim=0))
        logging.info(f"time range {out_cfg.name}: timestep {int(t)} done "
                     f"({out_cfg.n_samples} samples)")
    arrays = {k: torch.stack(v).cpu().numpy() for k, v in per_time.items()}
    dims = {k: ("time", "sample", "lat", "lon") for k in arrays}
    os.makedirs(config.experiment_dir, exist_ok=True)
    path = os.path.join(config.experiment_dir, f"{out_cfg.name}.zarr")
    sel_times = ds.all_time[np.asarray(t_indices)]
    write_zarr(path, arrays, dims,
               coords={"sample": np.arange(out_cfg.n_samples)},
               time=TimeCoord(sel_times.values, sel_times.calendar),
               chunks={k: zarr_output_chunks(v.shape)
                       for k, v in arrays.items()})
    logging.info(f"wrote {path}")
    return path


def main(argv=None, device=None) -> str:
    """The command line; ``device`` (when given) takes the place of
    ``--device``. Returns the path of the predictions file."""
    args = get_parser().parse_args(argv)
    device = entry_device(device if device is not None else args.device)
    data = prepare_config(args.yaml_config, args.override)
    config = from_dict(DownscalerConfig, data)
    prepare_directory(config.experiment_dir, data)
    config.logging.configure(config.experiment_dir)
    return run_downscaler(config, device=device)


if __name__ == "__main__":
    main()
