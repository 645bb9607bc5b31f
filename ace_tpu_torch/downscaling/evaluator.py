"""Downscaling evaluator entry (port of ace_tpu/downscaling/evaluator.py).

    python -m ace_tpu_torch.downscaling.evaluator <config.yaml> [--device cpu]

It reads the YAML of ``python -m ace_tpu.downscaling.evaluator``:
ensembles generated from held-out coarse snapshots (patched over large
domains) are scored against the paired fine truth with
``EnsembleOneStepAggregator`` (CRPS, the ensemble mean's RMSE, the
spread-skill ratio's bias) and ``GenerationMetricsAggregator``, and each
named event's snapshot over its region with its own ensemble. Draws come
from ``torch.Generator``s seeded with ``seed`` (the time loop) and ``seed
+`` the event's time index.
"""

import dataclasses
import logging
import os
from datetime import datetime

import numpy as np
import torch

from ace_tpu_torch.core.cli import get_parser, prepare_config, prepare_directory
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.wandb import DiskMetricLogger
from ace_tpu_torch.data.dataset import XarrayDataConfig
from ace_tpu_torch.data.store import write_h5
from ace_tpu_torch.device import entry_device
from ace_tpu_torch.downscaling.models import (
    CheckpointModelConfig,
    DenoisingMoEBundledConfig,
    DenoisingMoEConfig,
)
from ace_tpu_torch.downscaling.train import ClosedInterval, PairedDataConfig
from ace_tpu_torch.train.trainer import LoggingConfig


@dataclasses.dataclass
class EventConfig:
    """A named snapshot scored over a region with its own ensemble size,
    logged under its name."""

    name: str
    date: str
    lat_extent: ClosedInterval | None = None
    lon_extent: ClosedInterval | None = None
    n_samples: int = 16
    date_format: str = "%Y-%m-%dT%H:%M"
    save_generated_samples: bool = False


@dataclasses.dataclass
class DownscalingEvaluatorConfig:
    """A paired-data block or the explicit coarse/fine pair, and exactly
    one of ``checkpoint_path`` and ``model``."""

    experiment_dir: str
    coarse_data: XarrayDataConfig | None = None
    fine_data: XarrayDataConfig | None = None
    data: PairedDataConfig | None = None
    events: list[EventConfig] | None = None
    checkpoint_path: str | None = None
    model: (DenoisingMoEConfig | DenoisingMoEBundledConfig
            | CheckpointModelConfig | None) = None
    n_samples: int = 4
    n_timesteps: int = 4
    start_index: int = 0
    coarse_patch_extent_lat: int | None = None
    coarse_patch_extent_lon: int | None = None
    coarse_horizontal_overlap: int = 1
    seed: int = 0
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)

    def __post_init__(self):
        if (self.coarse_patch_extent_lat is None) != (
                self.coarse_patch_extent_lon is None):
            raise ValueError(
                "set both or neither of coarse_patch_extent_lat/lon")
        if (self.checkpoint_path is None) == (self.model is None):
            raise ValueError(
                "exactly one of checkpoint_path or model must be set")
        has_pair = self.coarse_data is not None and self.fine_data is not None
        if has_pair == (self.data is not None):
            raise ValueError("set either data (paired block) or both "
                             "coarse_data and fine_data")

    def build_datasets(self, downscale_factor: int):
        if self.data is not None:
            return self.data.build_pair(downscale_factor)
        return self.coarse_data.build(), self.fine_data.build()


def _to_device(window: dict, device) -> dict:
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in window.items()}


def _evaluate_event(config, event, model, coarse_ds, fine_ds, generate,
                    in_names, out_names, device) -> dict[str, float]:
    """Score one event's snapshot (its first time at the date) over its
    region."""
    from ace_tpu_torch.aggregator.one_step import EnsembleOneStepAggregator
    from ace_tpu_torch.core.gridded_ops import LatLonOperations
    from ace_tpu_torch.core.metrics import spherical_area_weights
    from ace_tpu_torch.data.time import parse_datetime_string

    time = coarse_ds.all_time
    stamp = datetime.strptime(event.date, event.date_format).isoformat()
    micros = parse_datetime_string(stamp, time.calendar)
    pos = int(np.searchsorted(time.values, micros))
    if pos >= len(time.values) or time.values[pos] != micros:
        raise ValueError(
            f"event {event.name!r} date {event.date} not in the dataset")
    coarse_window, _ = coarse_ds.get_window(pos, 1, in_names)
    fine_window, _ = fine_ds.get_window(pos, 1, out_names)
    hc = coarse_ds.dataset_info.horizontal_coordinates
    f = model.config.downscale_factor
    lat, lon = np.asarray(hc.lat), np.asarray(hc.lon)
    lat_r = (event.lat_extent.index_range(lat)
             if event.lat_extent is not None else (0, len(lat)))
    lon_r = (event.lon_extent.index_range(lon)
             if event.lon_extent is not None else (0, len(lon)))
    coarse = _to_device({k: v[..., lat_r[0]:lat_r[1], lon_r[0]:lon_r[1]]
                         for k, v in coarse_window.items()}, device)
    fine = _to_device({k: v[..., lat_r[0] * f:lat_r[1] * f,
                            lon_r[0] * f:lon_r[1] * f]
                       for k, v in fine_window.items()}, device)
    generator = torch.Generator(device).manual_seed(config.seed + pos)
    gen = generate(coarse, generator, n_samples=event.n_samples)
    # the weights of the fine grid's latitudes over the event's range
    fine_lat = np.asarray(fine_ds.dataset_info.horizontal_coordinates.lat
                          )[lat_r[0] * f:lat_r[1] * f]
    ops = LatLonOperations(spherical_area_weights(
        fine_lat, (lon_r[1] - lon_r[0]) * f))
    agg = EnsembleOneStepAggregator(ops)
    agg.record_batch(gen, fine)
    if event.save_generated_samples:
        arrays = {k: v.cpu().numpy() for k, v in gen.items()}
        write_h5(os.path.join(config.experiment_dir,
                              f"event_{event.name}_samples.nc"), arrays,
                 dims={k: tuple(f"dim{i}" for i in range(np.ndim(v)))
                       for k, v in arrays.items()})
    logging.info(f"evaluated event {event.name!r} at {event.date}")
    return agg.get_logs(f"event/{event.name}")


def run_downscaling_evaluator(config: DownscalingEvaluatorConfig,
                              device=None) -> dict[str, float]:
    from ace_tpu_torch.aggregator.one_step import EnsembleOneStepAggregator
    from ace_tpu_torch.downscaling.metrics import GenerationMetricsAggregator
    from ace_tpu_torch.downscaling.predict import (
        build_generate,
        load_downscaling_predictor,
    )

    device = entry_device(device)
    model = load_downscaling_predictor(config.checkpoint_path, config.model,
                                       device)
    coarse_ds, fine_ds = config.build_datasets(model.config.downscale_factor)
    in_names, out_names = model.config.in_names, model.config.out_names
    generate = build_generate(model, config)
    agg = EnsembleOneStepAggregator(fine_ds.dataset_info.gridded_operations)
    gen_agg = GenerationMetricsAggregator(model.config.downscale_factor)
    generator = torch.Generator(device).manual_seed(config.seed)
    for t in range(config.start_index,
                   config.start_index + config.n_timesteps):
        coarse = _to_device(coarse_ds.get_window(t, 1, in_names)[0], device)
        fine = _to_device(fine_ds.get_window(t, 1, out_names)[0], device)
        gen = generate(coarse, generator, n_samples=config.n_samples)
        agg.record_batch(gen, fine)
        gen_agg.record_batch(fine, gen, coarse)
        logging.info(f"evaluated downscaling timestep {t}")

    logs = agg.get_logs("downscaling")
    logs.update(gen_agg.get_logs("downscaling"))
    for event in config.events or []:
        logs.update(_evaluate_event(config, event, model, coarse_ds, fine_ds,
                                    generate, in_names, out_names, device))
    os.makedirs(config.experiment_dir, exist_ok=True)
    DiskMetricLogger(os.path.join(config.experiment_dir,
                                  "metrics.jsonl")).log(logs)
    diagnostics = gen_agg.get_diagnostics()
    if diagnostics:
        write_h5(os.path.join(config.experiment_dir,
                              "generation_diagnostics.nc"), diagnostics,
                 dims={k: tuple(f"dim{i}" for i in range(np.ndim(v)))
                       for k, v in diagnostics.items()})
    return logs


def main(argv=None, device=None) -> dict[str, float]:
    """The command line; ``device`` (when given) takes the place of
    ``--device``. Returns the logs."""
    args = get_parser().parse_args(argv)
    device = entry_device(device if device is not None else args.device)
    data = prepare_config(args.yaml_config, args.override)
    config = from_dict(DownscalingEvaluatorConfig, data)
    prepare_directory(config.experiment_dir, data)
    config.logging.configure(config.experiment_dir)
    return run_downscaling_evaluator(config, device=device)


if __name__ == "__main__":
    main()
