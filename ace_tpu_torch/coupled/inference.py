"""Coupled (atmosphere and ocean) inference and evaluation (port of
ace_tpu/coupled/inference.py).

    python -m ace_tpu_torch.coupled.inference <config.yaml>
        [--override a.b=1 ...] [--device cpu]

The coupled rollout runs in windows of ``coupled_steps_in_memory`` outer
(ocean) steps. The predictions go to one netCDF writer per component
(``autoregressive_predictions.nc`` and ``_ocean.nc``) and, with
``evaluate``, to paired RMSE and bias against the target data and each
component's inference aggregators, namespaced by component. It runs on
the CUDA device unless ``--device`` (or ``device=``) asks for another.
Inside the window loop nothing waits for the device unless a writer
wants the predictions: the forcing arrives by non-blocking copies from
pinned memory, and the paired statistics stay on the device until the
end, where they are read in one copy.
"""

import dataclasses
import logging
import os
from typing import Any

import numpy as np
import torch

from ace_tpu_torch.aggregator.inference import InferenceAggregatorConfig
from ace_tpu_torch.core.cli import get_parser, prepare_config, prepare_directory
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.metrics import (
    root_mean_squared_error,
    weighted_mean_bias,
)
from ace_tpu_torch.core.timing import GlobalTimer
from ace_tpu_torch.core.typing_ import TensorMapping
from ace_tpu_torch.core.wandb import DiskMetricLogger
from ace_tpu_torch.coupled.stepper import (
    CoupledComponentConfig,
    CoupledPrognosticState,
    CoupledStepper,
    CoupledStepperConfig,
)
from ace_tpu_torch.coupled.train import (
    CoupledDatasetsConfig,
    stack_to_device,
)
from ace_tpu_torch.data.dataset import (
    ConcatDatasetConfig,
    MergeDatasetConfig,
    XarrayDataConfig,
)
from ace_tpu_torch.data.inference import (
    ExplicitIndices,
    InferenceInitialConditionIndices,
    TimestampList,
)
from ace_tpu_torch.data.time import TimeCoord
from ace_tpu_torch.device import entry_device
from ace_tpu_torch.inference.data_writer import DataWriterConfig, H5DataWriter
from ace_tpu_torch.stepper.checkpoint import (
    build_stepper_from_state,
    load_msgpack,
)
from ace_tpu_torch.stepper.stepper import PrognosticState
from ace_tpu_torch.train.trainer import LoggingConfig


@dataclasses.dataclass
class ComponentCheckpointsConfig:
    """Two standalone component checkpoints."""

    atmosphere: str
    ocean: str


@dataclasses.dataclass
class CoupledDataWriterConfig:
    """Per-component writer options."""

    atmosphere: DataWriterConfig = dataclasses.field(
        default_factory=DataWriterConfig
    )
    ocean: DataWriterConfig = dataclasses.field(
        default_factory=DataWriterConfig
    )


@dataclasses.dataclass
class CoupledInitialConditionConfig:
    """The initial conditions of both components, from the datasets that
    also supply the forcing windows: flat or under a nested ``dataset:
    {atmosphere, ocean}`` block, each a plain, merged or concatenated
    source; ``start_indices`` is an index list or a timestamp or first-n
    selector."""

    atmosphere: (XarrayDataConfig | MergeDatasetConfig | ConcatDatasetConfig
                 | None) = None
    ocean: (XarrayDataConfig | MergeDatasetConfig | ConcatDatasetConfig
            | None) = None
    dataset: CoupledDatasetsConfig | None = None
    start_indices: (list[int] | ExplicitIndices | TimestampList
                    | InferenceInitialConditionIndices) = dataclasses.field(
        default_factory=lambda: [0])
    num_data_workers: int = 2

    def __post_init__(self):
        flat = self.atmosphere is not None and self.ocean is not None
        if flat == (self.dataset is not None):
            raise ValueError(
                "set either dataset: {atmosphere, ocean} or the flat "
                "atmosphere/ocean fields"
            )

    def build_atmosphere(self):
        return (self.dataset.atmosphere if self.dataset is not None
                else self.atmosphere).build()

    def build_ocean(self):
        return (self.dataset.ocean if self.dataset is not None
                else self.ocean).build()

    def resolve_starts(self, ocean_time) -> list[int]:
        """Outer (ocean) step start indices; timestamp selectors are
        resolved on the ocean's time axis."""
        if isinstance(self.start_indices, list):
            return [int(i) for i in self.start_indices]
        return self.start_indices.resolve(ocean_time)


@dataclasses.dataclass
class CoupledInferenceConfig:
    experiment_dir: str
    n_coupled_steps: int
    checkpoint: ComponentCheckpointsConfig | None = None
    # a coupled trainer's output directory holding
    # atmosphere_ckpt.msgpack and ocean_ckpt.msgpack
    checkpoint_path: str | None = None
    initial_condition: CoupledInitialConditionConfig | None = None
    # the evaluator's paired-target loader; implies evaluate=True
    loader: CoupledInitialConditionConfig | None = None
    data_writer: CoupledDataWriterConfig | None = None
    sst_name: str = "sst"
    coupled_steps_in_memory: int = 4
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)
    save_prediction_files: bool = True
    evaluate: bool = False  # paired aggregation against the target data
    # each component's inference aggregators, namespaced by component
    aggregator: InferenceAggregatorConfig = dataclasses.field(
        default_factory=InferenceAggregatorConfig
    )

    def __post_init__(self):
        if self.n_coupled_steps % self.coupled_steps_in_memory != 0:
            raise ValueError(
                "n_coupled_steps must be divisible by coupled_steps_in_memory"
            )
        if (self.checkpoint is None) == (self.checkpoint_path is None):
            raise ValueError(
                "set exactly one of checkpoint or checkpoint_path"
            )
        if (self.initial_condition is None) == (self.loader is None):
            raise ValueError(
                "set exactly one of initial_condition or loader"
            )
        if self.loader is not None:
            self.initial_condition = self.loader
            self.evaluate = True
        if self.data_writer is not None:
            self.save_prediction_files = (
                self.data_writer.atmosphere.save_prediction_files
                or self.data_writer.ocean.save_prediction_files
            )

    def load_coupled_stepper(self, device=None) -> CoupledStepper:
        """Both components from their checkpoints, coupled with the
        default timedeltas and no ``ocean_fraction_prediction`` (as the
        JAX package does: the ocean and sea-ice fractions are then read
        from the data)."""
        ckpt = self.checkpoint
        if ckpt is None:
            ckpt = ComponentCheckpointsConfig(
                atmosphere=os.path.join(self.checkpoint_path,
                                        "atmosphere_ckpt.msgpack"),
                ocean=os.path.join(self.checkpoint_path,
                                   "ocean_ckpt.msgpack"),
            )
        atmos, atmos_cfg = build_stepper_from_state(
            load_msgpack(ckpt.atmosphere)["stepper"], device=device)
        ocean, ocean_cfg = build_stepper_from_state(
            load_msgpack(ckpt.ocean)["stepper"], device=device)
        coupled_config = CoupledStepperConfig(
            atmosphere=CoupledComponentConfig(stepper=atmos_cfg),
            ocean=CoupledComponentConfig(stepper=ocean_cfg),
            sst_name=self.sst_name,
        )
        return CoupledStepper(coupled_config, ocean=ocean, atmosphere=atmos)


class _PairedStats:
    """Streaming per-variable paired RMSE and bias over a rollout: each
    record queues its reductions on the device; :meth:`get_logs` reads
    them all in one copy."""

    def __init__(self, area_weights: torch.Tensor):
        self._weights = area_weights
        self._n: dict[str, int] = {}
        self._pending: list[tuple[list[str], torch.Tensor]] = []

    def record(self, gen: TensorMapping, target: TensorMapping):
        names = [name for name in gen if name in target]
        if not names:
            return
        values = []
        for name in names:
            t = target[name]
            values.append(torch.stack([
                root_mean_squared_error(t, gen[name], self._weights) ** 2,
                weighted_mean_bias(t, gen[name], self._weights)]))
            self._n[name] = self._n.get(name, 0) + 1
        self._pending.append((names, torch.stack(values)))

    def get_logs(self, label: str) -> dict[str, float]:
        sq: dict[str, float] = {}
        bias: dict[str, float] = {}
        if self._pending:
            host = torch.stack([v for _, v in self._pending]).cpu().numpy()
            for (names, _), window in zip(self._pending, host):
                for name, (s, b) in zip(names, window):
                    sq[name] = sq.get(name, 0.0) + float(s)
                    bias[name] = bias.get(name, 0.0) + float(b)
        logs = {}
        for name, n in self._n.items():
            logs[f"{label}/rmse/{name}"] = float(np.sqrt(sq[name] / n))
            logs[f"{label}/bias/{name}"] = bias[name] / n
        return logs


def _window_time(windows) -> TimeCoord:
    return TimeCoord(np.stack([wd[1].values[1:] for wd in windows]),
                     windows[0][1].calendar)


def run_windows(coupled: CoupledStepper, state: CoupledPrognosticState,
                read_window, n_windows: int, writers: dict, stats: dict,
                aggregators: dict | None) -> CoupledPrognosticState:
    """The window loop: read window ``i``'s forcing and targets
    (``read_window(i)`` returns each component's host windows and names),
    roll it out, write and aggregate. Returns the final state; without
    writers nothing here waits for the device."""
    timer = GlobalTimer.get_instance()
    generator = torch.Generator(coupled.device).manual_seed(0)
    for i_win in range(n_windows):
        with timer.context("data_loading"):
            (a_windows, a_names), (o_windows, o_names) = read_window(i_win)
            atmos_forcing = stack_to_device([w[0] for w in a_windows],
                                            coupled.device, a_names)
            ocean_forcing = stack_to_device([w[0] for w in o_windows],
                                            coupled.device, o_names)
        with timer.context("forward_prediction"):
            a_out, o_out, state = coupled.predict(
                state, atmos_forcing, ocean_forcing, generator)
        times = {"atmosphere": _window_time(a_windows),
                 "ocean": _window_time(o_windows)}
        outputs = {"atmosphere": a_out, "ocean": o_out}
        if writers:
            with timer.context("data_writer"):
                for comp, writer in writers.items():
                    host = {k: v.cpu().numpy()
                            for k, v in outputs[comp].items()}
                    writer.append_batch(host, times[comp])
        if aggregators is not None:
            with timer.context("aggregator"):
                for comp, forcing in (("atmosphere", atmos_forcing),
                                      ("ocean", ocean_forcing)):
                    target = {k: v[:, 1:] for k, v in forcing.items()}
                    stats[comp].record(outputs[comp], target)
                    aggregators[comp].record_batch(outputs[comp], target,
                                                   time=times[comp])
        logging.info(f"coupled window {i_win + 1}/{n_windows} complete")
    return state


def run_coupled_inference(config: CoupledInferenceConfig, device=None
                          ) -> dict[str, float]:
    """Run the coupled inference ``config`` describes on ``device`` (CUDA
    by default); returns the logs (empty unless ``evaluate``)."""
    device = entry_device(device)
    coupled = config.load_coupled_stepper(device=device)
    n_inner = coupled.n_inner_steps
    atmos_ds = config.initial_condition.build_atmosphere()
    ocean_ds = config.initial_condition.build_ocean()

    atmos_names = (set(coupled.atmosphere.step.input_names)
                   | set(coupled.atmosphere.step.output_names))
    # the coupling supplies some inputs: read only what the data holds
    atmos_read = sorted((atmos_names | set(
        coupled.atmosphere_forcing_window_names)) & set(atmos_ds.names))
    ocean_read = sorted((set(coupled.ocean.step.input_names)
                         | set(coupled.ocean.step.output_names))
                        & set(ocean_ds.names))

    starts = config.initial_condition.resolve_starts(ocean_ds.all_time)
    w = config.coupled_steps_in_memory
    n_windows = config.n_coupled_steps // w

    atmos_ic = [atmos_ds.get_window(s * n_inner, 1, atmos_read)
                for s in starts]
    ocean_ic = [ocean_ds.get_window(s, 1, ocean_read) for s in starts]
    state = CoupledPrognosticState(
        atmosphere_data=PrognosticState(data=stack_to_device(
            [w[0] for w in atmos_ic], device,
            [n for n in coupled.atmosphere.prognostic_names
             if n in atmos_read])),
        ocean_data=PrognosticState(data=stack_to_device(
            [w[0] for w in ocean_ic], device,
            [n for n in coupled.ocean.prognostic_names
             if n in ocean_read])),
    )

    writers: dict[str, H5DataWriter] = {}
    dw = config.data_writer
    infos = {"atmosphere": atmos_ds.dataset_info,
             "ocean": ocean_ds.dataset_info}
    for comp, filename in (("atmosphere", "autoregressive_predictions.nc"),
                           ("ocean", "autoregressive_predictions_ocean.nc")):
        write = (getattr(dw, comp).save_prediction_files if dw is not None
                 else config.save_prediction_files)
        if write:
            writers[comp] = H5DataWriter(
                os.path.join(config.experiment_dir, filename), infos[comp])

    stats = {comp: _PairedStats(torch.as_tensor(
        info.horizontal_coordinates.area_weights, dtype=torch.float32,
        device=device)) for comp, info in infos.items()}
    aggregators = None
    if config.evaluate:
        aggregators = {
            "atmosphere": config.aggregator.build(
                atmos_ds.dataset_info,
                n_timesteps=config.n_coupled_steps * n_inner),
            "ocean": config.aggregator.build(
                ocean_ds.dataset_info, n_timesteps=config.n_coupled_steps),
        }

    def read_window(i_win):
        o_start = i_win * w
        a_start = o_start * n_inner
        return (
            ([atmos_ds.get_window(s * n_inner + a_start, w * n_inner + 1,
                                  atmos_read) for s in starts], atmos_read),
            ([ocean_ds.get_window(s + o_start, w + 1, ocean_read)
              for s in starts], ocean_read),
        )

    run_windows(coupled, state, read_window, n_windows, writers, stats,
                aggregators)
    for writer in writers.values():
        writer.flush()
    logs: dict[str, Any] = {}
    if config.evaluate:
        logs.update(stats["atmosphere"].get_logs("inference/atmosphere"))
        logs.update(stats["ocean"].get_logs("inference/ocean"))
        for comp, agg in aggregators.items():
            logs.update({f"{comp}/{k}": v for k, v in agg.get_logs().items()})
            agg.flush_diagnostics(os.path.join(config.experiment_dir,
                                               "diagnostics", comp))
            agg.flush_images(os.path.join(config.experiment_dir, "plots",
                                          comp))
        DiskMetricLogger(os.path.join(config.experiment_dir,
                                      "metrics.jsonl")).log(logs)
    GlobalTimer.get_instance().log_durations()
    return logs


def main(argv=None, device=None) -> dict[str, float]:
    """The command line; ``device`` (when given) takes the place of
    ``--device``."""
    args = get_parser().parse_args(argv)
    device = entry_device(device if device is not None else args.device)
    data = prepare_config(args.yaml_config, args.override)
    config = from_dict(CoupledInferenceConfig, data)
    prepare_directory(config.experiment_dir, data)
    config.logging.configure(config.experiment_dir)
    logging.info("Starting coupled inference")
    return run_coupled_inference(config, device=device)


if __name__ == "__main__":
    main()
