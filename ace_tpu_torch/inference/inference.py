"""The inference entry point (port of ace_tpu/inference/inference.py):

    python -m ace_tpu_torch.inference <config.yaml> [--segments N]
        [--override a.b=1 ...] [--device cpu]

It loads an ``ace_tpu`` checkpoint, reads the initial condition and the
forcing from netCDF (or zarr) files, rolls out on the device in windows
of ``forward_steps_in_memory`` steps, and writes the predictions,
``restart.nc`` and the aggregators' diagnostics into ``experiment_dir``.
It runs on the CUDA device unless ``--device`` (or ``device=``) asks for
another; without CUDA it stops rather than fall back to the CPU. With
``mesh: {data_parallel: N}`` over N processes (launched as the training
entry is) the initial conditions and ensemble members are split over
the processes, and only the first writes files.
"""

import copy
import dataclasses
import logging
import os

import numpy as np
import torch

from ace_tpu_torch.aggregator.inference import InferenceAggregatorConfig
from ace_tpu_torch.core.cli import get_parser, prepare_config, prepare_directory
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.timing import GlobalTimer
from ace_tpu_torch.data.inference import (
    ExplicitIndices,
    InferenceDataLoaderConfig,
    InferenceGriddedData,
    InferenceInitialConditionIndices,
    TimestampList,
)
from ace_tpu_torch.data.time import TimeCoord
from ace_tpu_torch.device import entry_device
from ace_tpu_torch.inference.data_writer import (
    DataWriterConfig,
    NullDataWriter,
    save_restart,
)
from ace_tpu_torch.inference.loop import run_inference
from ace_tpu_torch.parallel import distributed as dist
from ace_tpu_torch.parallel.distributed import BatchPlacement
from ace_tpu_torch.parallel.mesh import MeshConfig
from ace_tpu_torch.stepper.checkpoint import load_stepper
from ace_tpu_torch.stepper.insolation import DerivedForcingsConfig
from ace_tpu_torch.stepper.stepper import PrognosticState, StepperOverrideConfig
from ace_tpu_torch.train.trainer import LoggingConfig


def _read_fields(path: str, names: list[str]):
    from ace_tpu_torch.data.store import open_file_dataset

    ds = open_file_dataset(path)
    return ds, {name: np.asarray(ds[name].read(()), dtype=np.float32)
                for name in names}


@dataclasses.dataclass
class InitialConditionConfig:
    """An external initial-condition dataset (port of
    ace_tpu/inference/inference.py:37): each selected time becomes one
    initial condition, and the forcing windows start at the matching
    times of the forcing dataset.

    path: the dataset file (netCDF or zarr; a local path or a URL) of
        ``[time, lat, lon]`` or HEALPix ``[time, face, height, width]``
        fields; for a restart.nc use ``initial_condition_path`` instead.
    engine: accepted for config parity; the store detects the format.
    start_indices: optional subset of the times.
    """

    path: str
    engine: str | None = None
    start_indices: (
        ExplicitIndices | TimestampList
        | InferenceInitialConditionIndices | None
    ) = None

    def load(self, names: list[str]):
        """``({name: [n_ic, 1, *spatial]}, time values, calendar)``."""
        ds, fields = _read_fields(self.path, names)
        time = ds.read_time("time")
        tvals = time.values.reshape(-1)
        if self.start_indices is not None:
            idx = self.start_indices.resolve(TimeCoord(tvals, time.calendar))
        else:
            idx = list(range(len(tvals)))
        data = {}
        for name, arr in fields.items():
            if arr.ndim not in (3, 4):
                raise ValueError(
                    f"initial condition variable {name!r} must be "
                    "[time, lat, lon] or [time, face, height, width]; got "
                    f"shape {arr.shape}"
                )
            data[name] = arr[idx][:, None]
        return data, tvals[idx], time.calendar


@dataclasses.dataclass
class InferenceConfig:
    """(port of ace_tpu/inference/inference.py:87). ``mesh`` splits the
    initial conditions over the processes (data parallel only)."""

    experiment_dir: str
    checkpoint_path: str
    n_forward_steps: int
    forcing_loader: InferenceDataLoaderConfig
    forward_steps_in_memory: int = 10
    data_writer: DataWriterConfig = dataclasses.field(
        default_factory=DataWriterConfig
    )
    aggregator: InferenceAggregatorConfig = dataclasses.field(
        default_factory=InferenceAggregatorConfig
    )
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)
    derived_forcings: DerivedForcingsConfig = dataclasses.field(
        default_factory=DerivedForcingsConfig
    )
    # a restart file as the initial condition (segmented inference)
    initial_condition_path: str | None = None
    # external initial conditions, with the forcing aligned to their times
    initial_condition: InitialConditionConfig | None = None
    stepper_override: StepperOverrideConfig | None = None
    # members per initial condition, tiled member-major; the noise
    # generator differentiates them
    n_ensemble_per_ic: int = 1
    mesh: MeshConfig | None = None

    def __post_init__(self):
        self.data_writer.validate_time_coarsen(
            self.n_forward_steps, self.forward_steps_in_memory
        )
        if self.n_ensemble_per_ic > 1 and self.initial_condition_path:
            # a restart file holds one realized state per initial condition
            raise ValueError(
                "n_ensemble_per_ic > 1 is not supported with "
                "initial_condition_path (restart-seeded runs)"
            )


def load_restart_initial_condition(path: str, names: list[str]):
    """A restart.nc written by ``save_restart`` as an initial-condition
    dict of ``[sample, 1, lat, lon]`` arrays."""
    _, data = _read_fields(path, names)
    return {k: v[:, None] if v.ndim == 3 else v for k, v in data.items()}


def run_inference_from_config(config: InferenceConfig, device=None) -> dict:
    """Run the inference ``config`` describes on ``device`` (CUDA by
    default) and write its outputs; returns the loop's summary with the
    aggregators' ``logs``."""
    device = entry_device(device)
    config.logging.configure(config.experiment_dir)
    placement = (BatchPlacement(config.mesh.build(), device)
                 if config.mesh is not None else None)
    return _run_inference_impl(config, device, placement)


def _forcing_data(config: InferenceConfig, stepper, forcing_names):
    """The forcing windows, and the external initial condition if one is
    configured (its times locate the windows' starts)."""
    loader = config.forcing_loader
    if config.initial_condition is None:
        return loader.build(
            forcing_names=forcing_names,
            prognostic_names=stepper.prognostic_names,
            n_forward_steps=config.n_forward_steps,
            forward_steps_in_memory=config.forward_steps_in_memory,
        ), None
    external_ic, ic_times, _ = config.initial_condition.load(
        stepper.prognostic_names
    )
    forcing_ds = loader.dataset.build()
    forcing_time = forcing_ds.all_time.values.reshape(-1)
    positions = np.searchsorted(forcing_time, ic_times)
    bad = (positions >= len(forcing_time)) | (
        forcing_time[np.minimum(positions, len(forcing_time) - 1)] != ic_times
    )
    if bad.any():
        raise ValueError(
            "initial condition time(s) not present in the forcing "
            f"dataset: {np.asarray(ic_times)[bad]}"
        )
    return InferenceGriddedData(
        dataset=forcing_ds,
        start_indices=ExplicitIndices(list=[int(p) for p in positions]),
        forcing_names=forcing_names,
        prognostic_names=stepper.prognostic_names,
        n_forward_steps=config.n_forward_steps,
        forward_steps_in_memory=config.forward_steps_in_memory,
    ), external_ic


def place_initial_condition(ic_data: dict, device, placement
                            ) -> PrognosticState:
    """The initial condition on ``device``: under a ``placement`` this
    process's rows of it."""
    if placement is not None:
        return PrognosticState(data={
            k: placement.put_global(v) for k, v in ic_data.items()})
    return PrognosticState(data={
        k: torch.as_tensor(np.asarray(v)).to(device)
        for k, v in ic_data.items()
    })


def _run_inference_impl(config: InferenceConfig, device: torch.device,
                        placement: BatchPlacement | None) -> dict:
    stepper = load_stepper(config.checkpoint_path,
                           override=config.stepper_override, device=device)
    deriver = config.derived_forcings.build(stepper.dataset_info)
    forcing_names = [n for n in stepper.forcing_window_names
                     if n not in deriver.provided_names]
    forcing_data, ic_data = _forcing_data(config, stepper, forcing_names)
    stepper.dataset_info.assert_compatible_with(forcing_data.dataset_info)
    if ic_data is None and config.initial_condition_path is not None:
        ic_data = load_restart_initial_condition(
            config.initial_condition_path, stepper.prognostic_names
        )
    elif ic_data is None:
        ic_data = forcing_data.initial_condition(
            stepper.prognostic_names).data
    n_ens = config.n_ensemble_per_ic
    if n_ens > 1:
        # member-major: the members of one initial condition are contiguous
        ic_data = {k: np.repeat(np.asarray(v), n_ens, axis=0)
                   for k, v in ic_data.items()}
    ic = place_initial_condition(ic_data, device, placement)
    info = forcing_data.dataset_info
    aggregator = config.aggregator.build(
        info, n_timesteps=config.n_forward_steps,
        normalizer=getattr(stepper.step, "normalizer", None),
        n_ensemble_per_ic=n_ens,
    )
    # only the root process writes; every process aggregates the
    # gathered outputs
    root = dist.is_root()
    writer = (config.data_writer.build(config.experiment_dir, info) if root
              else NullDataWriter())
    summary = run_inference(
        stepper, ic, forcing_data, writer=writer, aggregator=aggregator,
        forcing_deriver=deriver, n_ensemble=n_ens, placement=placement,
    )
    logs = aggregator.get_logs()
    if root:
        aggregator.flush_diagnostics(
            os.path.join(config.experiment_dir, "diagnostics"))
        aggregator.flush_images(os.path.join(config.experiment_dir, "plots"))
    final_state: PrognosticState = summary["final_state"]
    final_np = (placement.fetch(final_state.data) if placement is not None
                else {k: v.cpu().numpy() for k, v in final_state.data.items()})
    last_time = forcing_data.dataset.all_time[
        [s + config.n_forward_steps
         for s in forcing_data._starts for _ in range(n_ens)]
    ]
    if root:
        save_restart(
            os.path.join(config.experiment_dir, "restart.nc"), final_np,
            TimeCoord(last_time.values[:, None], last_time.calendar),
            info,
        )
    writer.close()
    GlobalTimer.get_instance().log_durations()
    summary["logs"] = logs
    return summary


def run_segmented_inference(config: InferenceConfig, segments: int,
                            device=None):
    """Chain ``segments`` runs through their restart files (port of
    ace_tpu/inference/inference.py:317). A segment whose restart.nc exists
    is skipped, so an interrupted run resumes where it stopped."""
    summary = None
    base_starts = None  # resolved once, for the continuation segments
    for segment in range(segments):
        segment_dir = os.path.join(config.experiment_dir,
                                   f"segment_{segment:04d}")
        if os.path.exists(os.path.join(segment_dir, "restart.nc")):
            logging.info(f"Skipping completed segment {segment}")
            continue
        seg_config = copy.deepcopy(config)
        seg_config.experiment_dir = segment_dir
        if segment > 0:
            prev_dir = os.path.join(config.experiment_dir,
                                    f"segment_{segment - 1:04d}")
            seg_config.initial_condition_path = os.path.join(
                prev_dir, "restart.nc")
            if base_starts is None:
                base_starts = config.forcing_loader.start_indices.resolve(
                    config.forcing_loader.dataset.build().all_time)
            seg_config.forcing_loader.start_indices = ExplicitIndices(
                list=[s + segment * config.n_forward_steps
                      for s in base_starts]
            )
        logging.info(f"Running segment {segment}")
        summary = run_inference_from_config(seg_config, device=device)
        # the next segment reads the restart file the root wrote
        dist.barrier("segment")
    return summary


def main(argv=None, device=None):
    """The command line; ``device`` (when given) takes the place of
    ``--device``."""
    parser = get_parser()
    parser.add_argument(
        "--segments", type=int, default=None,
        help="run in N chained segments via restart files",
    )
    args = parser.parse_args(argv)
    device = device if device is not None else args.device
    dist.initialize(device=device)
    device = entry_device(device)
    data = prepare_config(args.yaml_config, args.override)
    config = from_dict(InferenceConfig, data)
    if dist.is_root():
        prepare_directory(config.experiment_dir, data)
    dist.barrier("prepare_directory")
    logging.info("Starting inference")
    if args.segments is not None:
        return run_segmented_inference(config, args.segments, device=device)
    return run_inference_from_config(config, device=device)
