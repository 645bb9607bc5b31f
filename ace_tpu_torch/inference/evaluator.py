"""The evaluator entry point (port of ace_tpu/inference/evaluator.py):

    python -m ace_tpu_torch.evaluator <config.yaml> [--override a.b=1 ...]
        [--device cpu]

It rolls a checkpoint out over a dataset that also holds the targets,
feeds every window's prediction and target to the inference aggregators,
and writes their logs, diagnostics files and images (and the predictions,
as the data writer asks) into ``experiment_dir``. It runs on the CUDA
device unless ``--device`` (or ``device=``) asks for another; without
CUDA it stops rather than fall back to the CPU. ``run_dataset_comparison``
runs the same aggregators over a prediction dataset and a target dataset,
with no model.
"""

import dataclasses
import logging
import os

import numpy as np
import torch

from ace_tpu_torch.aggregator.inference import InferenceAggregatorConfig
from ace_tpu_torch.core.cli import get_parser, prepare_config, prepare_directory
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.timing import GlobalTimer
from ace_tpu_torch.data.inference import InferenceDataLoaderConfig
from ace_tpu_torch.data.time import TimeCoord
from ace_tpu_torch.device import entry_device
from ace_tpu_torch.inference.data_writer import DataWriterConfig
from ace_tpu_torch.inference.loop import run_inference
from ace_tpu_torch.stepper.checkpoint import load_stepper
from ace_tpu_torch.stepper.insolation import DerivedForcingsConfig
from ace_tpu_torch.stepper.stepper import PrognosticState, StepperOverrideConfig
from ace_tpu_torch.train.trainer import LoggingConfig


@dataclasses.dataclass
class EvaluatorConfig:
    """(port of ace_tpu/inference/evaluator.py:26). ``mesh`` must stay
    None: the port runs on one device."""

    experiment_dir: str
    checkpoint_path: str
    n_forward_steps: int
    loader: InferenceDataLoaderConfig
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
    stepper_override: StepperOverrideConfig | None = None
    # members per initial condition, tiled member-major
    n_ensemble_per_ic: int = 1
    mesh: dict | None = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "mesh: multi-device evaluation is not ported yet (ROADMAP "
                'Queue 1, "Multi-GPU")'
            )
        self.data_writer.validate_time_coarsen(
            self.n_forward_steps, self.forward_steps_in_memory
        )


def run_evaluator_from_config(config: EvaluatorConfig, device=None) -> dict:
    """Run the evaluation ``config`` describes on ``device`` (CUDA by
    default) and write its outputs; returns the loop's summary with the
    aggregators' ``logs``."""
    device = entry_device(device)
    config.logging.configure(config.experiment_dir)
    stepper = load_stepper(config.checkpoint_path,
                           override=config.stepper_override, device=device)
    deriver = config.derived_forcings.build(stepper.dataset_info)
    forcing_names = [n for n in stepper.forcing_window_names
                     if n not in deriver.provided_names]
    data = config.loader.build(
        forcing_names=forcing_names,
        prognostic_names=stepper.prognostic_names,
        n_forward_steps=config.n_forward_steps,
        forward_steps_in_memory=config.forward_steps_in_memory,
    )
    stepper.dataset_info.assert_compatible_with(data.dataset_info)
    ic_data = data.initial_condition(stepper.prognostic_names).data
    n_ens = config.n_ensemble_per_ic
    if n_ens > 1:
        ic_data = {k: np.repeat(np.asarray(v), n_ens, axis=0)
                   for k, v in ic_data.items()}
    ic = PrognosticState(data={
        k: torch.as_tensor(np.asarray(v)).to(device)
        for k, v in ic_data.items()
    })
    info = data.dataset_info
    aggregator = config.aggregator.build(
        info, n_timesteps=config.n_forward_steps,
        normalizer=getattr(stepper.step, "normalizer", None),
        n_ensemble_per_ic=n_ens,
    )
    writer = config.data_writer.build(config.experiment_dir, info)
    # the targets: the model's outputs that the dataset holds
    target_names = [n for n in stepper.out_names if n in data.dataset.names]
    summary = run_inference(
        stepper, ic, data, writer=writer, aggregator=aggregator,
        target_names=target_names, forcing_deriver=deriver,
        n_ensemble=n_ens,
    )
    summary["logs"] = aggregator.get_logs()
    summary["histogram_host_seconds"] = aggregator.histogram_host_seconds
    aggregator.flush_diagnostics(
        os.path.join(config.experiment_dir, "diagnostics"))
    aggregator.flush_images(os.path.join(config.experiment_dir, "plots"))
    writer.close()
    GlobalTimer.get_instance().log_durations()
    return summary


def main(argv=None, device=None):
    """The command line; ``device`` (when given) takes the place of
    ``--device``."""
    args = get_parser().parse_args(argv)
    device = entry_device(device if device is not None else args.device)
    data = prepare_config(args.yaml_config, args.override)
    config = from_dict(EvaluatorConfig, data)
    prepare_directory(config.experiment_dir, data)
    logging.info("Starting evaluator")
    return run_evaluator_from_config(config, device=device)


@dataclasses.dataclass
class DatasetComparisonConfig:
    """Compare a prediction dataset with a target dataset through the
    paired aggregators, with no model (port of
    ace_tpu/inference/evaluator.py:168)."""

    experiment_dir: str
    n_forward_steps: int
    prediction_loader: InferenceDataLoaderConfig
    target_loader: InferenceDataLoaderConfig
    variable_names: list[str]
    forward_steps_in_memory: int = 10
    aggregator: InferenceAggregatorConfig = dataclasses.field(
        default_factory=InferenceAggregatorConfig
    )
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)


def run_dataset_comparison(config: DatasetComparisonConfig,
                           device=None) -> dict:
    """Feed both datasets' windows, on ``device`` (CUDA by default), to the
    aggregators and write their outputs; returns the ``logs`` and the
    number of windows."""
    device = entry_device(device)
    config.logging.configure(config.experiment_dir)
    loaders = [
        loader.build(
            forcing_names=config.variable_names, prognostic_names=[],
            n_forward_steps=config.n_forward_steps,
            forward_steps_in_memory=config.forward_steps_in_memory,
        )
        for loader in (config.prediction_loader, config.target_loader)
    ]
    pred, target = loaders
    aggregator = config.aggregator.build(
        target.dataset_info, n_timesteps=config.n_forward_steps)

    def on_device(batch):
        return {k: torch.as_tensor(np.asarray(v)[:, 1:]).to(device)
                for k, v in batch.data.items() if k in config.variable_names}

    n_windows = 0
    for (pred_batch, _), (tgt_batch, _) in zip(pred.windows(),
                                               target.windows()):
        time = TimeCoord(tgt_batch.time.values[:, 1:],
                         tgt_batch.time.calendar)
        aggregator.record_batch(on_device(pred_batch), on_device(tgt_batch),
                                time=time)
        n_windows += 1
        logging.info(f"dataset comparison window {n_windows} done")
    logs = aggregator.get_logs()
    aggregator.flush_diagnostics(
        os.path.join(config.experiment_dir, "diagnostics"))
    aggregator.flush_images(os.path.join(config.experiment_dir, "plots"))
    return {"logs": logs, "n_windows": n_windows}
