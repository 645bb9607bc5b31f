"""The trainer (port of ace_tpu/train/trainer.py): the epoch loop,
validation with the EMA's weights, inline inference that picks
``best_inference_ckpt``, the checkpoint zoo, and resume after preemption.

The module's weights are updated in place by ``TrainStepper.train_step``;
validation and inline inference run the same module with the EMA's
weights swapped in (``TrainStepper.weights_swapped``, no second copy).
One ``torch.Generator`` on the device, seeded from ``config.seed``, draws
the initial weights and every step's noise; its state is saved with each
checkpoint, so that a resumed run continues the stream where the saved
one was. Inside the batch loop nothing waits for the device: batches
arrive by non-blocking copies from pinned memory, and the per-batch
metrics stay on the device until the epoch's batches are done (unless
``log_train_every_n_batches`` asks for a loss on the host, or
``checkpoint_every_n_batches`` for a mid-epoch checkpoint).
"""

import contextlib
import dataclasses
import logging
import os
import signal

import numpy as np
import torch

from ace_tpu_torch.aggregator.inference import InferenceAggregatorConfig
from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
from ace_tpu_torch.core.timing import GlobalTimer
from ace_tpu_torch.core.training_history import TrainingJob
from ace_tpu_torch.core.typing_ import Slice
from ace_tpu_torch.core.wandb import DiskMetricLogger, WandB
from ace_tpu_torch.data.inference import InferenceDataLoaderConfig
from ace_tpu_torch.data.loading import DataLoaderConfig, GriddedData
from ace_tpu_torch.data.requirements import DataRequirements
from ace_tpu_torch.device import entry_device
from ace_tpu_torch.stepper.checkpoint import (
    read_train_checkpoint,
    save_train_checkpoint,
)
from ace_tpu_torch.stepper.parameter_init import CopyWeightsConfig
from ace_tpu_torch.stepper.stepper import (
    CheckpointStepperConfig,
    PrognosticState,
    StepperConfig,
)
from ace_tpu_torch.stepper.train import (
    StepperTrainConfig,
    TrainStepper,
    deferrable,
    signals_deferred,
)
from ace_tpu_torch.train.lr_tuning import LRTuningConfig, run_lr_tuning_trial


@dataclasses.dataclass
class InlineInferenceConfig:
    """Autoregressive inference run inline each epoch (in ``epochs``) with
    the validation weights; the weighted mean of its time-mean RMSEs picks
    the best-inference checkpoint (port of ace_tpu/train/trainer.py:40)."""

    loader: InferenceDataLoaderConfig
    n_forward_steps: int = 2
    forward_steps_in_memory: int = 2
    epochs: Slice = dataclasses.field(default_factory=Slice)
    # several named entries combine their errors by weight
    name: str | None = None
    weight: float = 1.0
    aggregator: InferenceAggregatorConfig = dataclasses.field(
        default_factory=InferenceAggregatorConfig
    )


@dataclasses.dataclass
class LoggingConfig:
    """Where a run logs (port of ace_tpu/train/trainer.py:63). Weights &
    Biases is not ported: ``log_to_wandb`` must stay false, and its
    fields (``project``, ``entity``, ``watch_log_freq``) are read only so
    that ``ace_tpu``'s configs load."""

    log_to_screen: bool = True
    log_to_file: bool = True
    log_to_wandb: bool = False
    project: str = "ace_tpu"
    entity: str | None = None
    watch_log_freq: int | None = None

    def __post_init__(self):
        if self.log_to_wandb:
            raise NotImplementedError(
                "logging to Weights & Biases is not ported yet"
            )

    def configure(self, experiment_dir: str, resumable: bool = True):
        handlers: list[logging.Handler] = []
        if self.log_to_screen:
            handlers.append(logging.StreamHandler())
        if self.log_to_file:
            os.makedirs(experiment_dir, exist_ok=True)
            handlers.append(
                logging.FileHandler(os.path.join(experiment_dir, "out.log"))
            )
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(levelname)s %(message)s",
            handlers=handlers,
            force=True,
        )
        # a new run logs its own steps from 0
        WandB.reset()
        WandB.get_instance().configure(self.log_to_wandb)


class CheckpointPaths:
    """(port of ace_tpu/train/trainer.py:110)."""

    def __init__(self, experiment_dir: str):
        self.checkpoint_dir = os.path.join(experiment_dir,
                                           "training_checkpoints")

    @property
    def latest_checkpoint_path(self) -> str:
        return os.path.join(self.checkpoint_dir, "ckpt.msgpack")

    @property
    def best_checkpoint_path(self) -> str:
        return os.path.join(self.checkpoint_dir, "best_ckpt.msgpack")

    @property
    def ema_checkpoint_path(self) -> str:
        return os.path.join(self.checkpoint_dir, "ema_ckpt.msgpack")

    @property
    def best_inference_checkpoint_path(self) -> str:
        return os.path.join(self.checkpoint_dir,
                            "best_inference_ckpt.msgpack")

    def epoch_checkpoint_path(self, epoch: int) -> str:
        return os.path.join(self.checkpoint_dir, f"ckpt_{epoch:04d}.msgpack")


@dataclasses.dataclass
class TrainConfig:
    """Top-level training config (port of ace_tpu/train/trainer.py:139,
    the same fields). The port runs on one device: ``mesh`` must stay
    None."""

    train_loader: DataLoaderConfig
    validation_loader: DataLoaderConfig
    stepper: StepperConfig | CheckpointStepperConfig
    optimization: OptimizationConfig
    max_epochs: int
    experiment_dir: str
    stepper_training: StepperTrainConfig = dataclasses.field(
        default_factory=StepperTrainConfig
    )
    ema: EMAConfig = dataclasses.field(default_factory=EMAConfig)
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)
    save_checkpoint: bool = True
    # per-epoch validation and inline-inference diagnostics under
    # output/{val,inference}/epoch_NNNN
    save_per_epoch_diagnostics: bool = False
    validate_using_ema: bool = True
    log_train_every_n_batches: int = 10
    checkpoint_save_epochs: Slice | None = None
    inference: list[InlineInferenceConfig] | InlineInferenceConfig | None = None
    # a restart checkpoint every N batches within an epoch (0: none)
    checkpoint_every_n_batches: int = 0
    # at most this many epochs per invocation; running again resumes
    segment_epochs: int | None = None
    # validation (and inline inference) once before any training
    evaluate_before_training: bool = False
    # after each epoch, the loss (no updates, validation weights) of this
    # many batches of an independent shuffle of the training data
    train_evaluation_batches: int = 0
    # after each optimizer step, reset a wildcard-selected subset of the
    # weights to their values at the start of the run
    copy_weights_after_batch: CopyWeightsConfig | None = None
    lr_tuning: LRTuningConfig = dataclasses.field(
        default_factory=LRTuningConfig
    )
    mesh: dict | None = None
    seed: int = 0

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "mesh: multi-device training is not ported yet (ROADMAP "
                'Queue 1, "Multi-GPU")'
            )
        if self.lr_tuning.enabled and self.optimization.has_lr_schedule:
            raise ValueError(
                "lr_tuning and optimization.scheduler cannot both be "
                "specified; lr_tuning is an alternative form of learning "
                "rate scheduling"
            )

    @property
    def inference_entries(self) -> list[InlineInferenceConfig]:
        if self.inference is None:
            return []
        if isinstance(self.inference, InlineInferenceConfig):
            return [self.inference]
        return list(self.inference)

    @property
    def n_forward_steps(self) -> int:
        # data windows must cover the longest schedulable rollout
        return self.stepper_training.max_n_forward_steps

    def build_trainer(self, device=None) -> "Trainer":
        """The trainer on ``device`` (CUDA by default)."""
        device = entry_device(device)
        if isinstance(self.stepper, CheckpointStepperConfig):
            # resolved once, so that the data requirements and the
            # checkpoints see the whole config
            self.stepper = self.stepper.to_stepper_config()
        step = self.stepper.step.instance
        requirements = DataRequirements(
            # a multi-call step's suffixed outputs are read as targets
            # only when they are in the loss
            names=sorted(set(step.input_names) | set(step.loss_names)),
            n_timesteps=self.n_forward_steps + 1,
            allow_missing_variables=(
                self.stepper.step.allow_missing_variables),
        )
        train_data = self.train_loader.build(
            requirements, train=True, seed=self.seed, device=device
        )
        valid_data = self.validation_loader.build(
            requirements, train=False, seed=self.seed, device=device
        )
        stepper = self.stepper.get_stepper(train_data.dataset_info,
                                           device=device)
        train_stepper = TrainStepper(
            stepper,
            self.stepper_training,
            self.optimization,
            self.ema,
            max_epochs=self.max_epochs,
            steps_per_epoch=max(1, train_data.n_batches),
        )
        return Trainer(self, train_stepper, train_data, valid_data)


def _mean_metrics(pending: list[dict[str, torch.Tensor]], count: int
                  ) -> dict[str, float]:
    """The per-key means over ``count`` batches of device-resident
    metrics, brought to the host in one copy."""
    if not pending:
        return {}
    keys = [k for m in pending for k in m]
    values = torch.stack([m[k].float() for m in pending for k in m])
    totals: dict[str, float] = {}
    for k, v in zip(keys, values.cpu().double().numpy()):
        totals[k] = totals.get(k, 0.0) + float(v)
    return {k: v / max(count, 1) for k, v in totals.items()}


class Trainer:
    def __init__(self, config: TrainConfig, train_stepper: TrainStepper,
                 train_data: GriddedData, valid_data: GriddedData):
        self.config = config
        self.train_stepper = train_stepper
        self.train_data = train_data
        self.valid_data = valid_data
        self.paths = CheckpointPaths(config.experiment_dir)
        self.num_batches_seen = 0
        self._epoch_batches_seen = 0
        self._resume_skip_batches = 0
        self.start_epoch = 0
        self.best_validation_loss = float("inf")
        self.best_inference_error = float("inf")
        self._disk_logger = DiskMetricLogger(
            os.path.join(config.experiment_dir, "metrics.jsonl")
        )
        self.generator = torch.Generator(self.device).manual_seed(
            config.seed)
        self._initialized = False
        self._old_handlers: dict = {}
        self._current_epoch = 0

    @property
    def stepper(self):
        return self.train_stepper.stepper

    @property
    def device(self) -> torch.device:
        return self.stepper.device

    def _install_signal_handlers(self):
        """SIGTERM and SIGINT save a restart checkpoint, then exit with
        128 + the signal's number; the next launch resumes from it. The
        checkpoint holds the training weights and the EMA's even where the
        signal comes while the EMA's are swapped in (validation, inline
        inference, the EMA's and the best-inference files); a train step
        with its counters, and each swap, hold the signal back until they
        are done. A signal in validation or inline inference saves the
        generator where they left it, so such a restart repeats them with
        other noise."""

        def handler(signum, frame):
            logging.warning(
                f"received signal {signum}; saving restart checkpoint"
            )
            with self.train_stepper.training_weights():
                self._save_latest()
            raise SystemExit(128 + signum)

        for sig in (signal.SIGTERM, signal.SIGINT):
            self._old_handlers[sig] = signal.signal(sig, deferrable(handler))

    def _restore_signal_handlers(self):
        # a signal meanwhile is handled once both are restored
        with signals_deferred():
            for sig, old in self._old_handlers.items():
                signal.signal(sig, old)
            self._old_handlers = {}

    def _checkpoint_extra(self, epoch: int) -> dict:
        """The counters ``ace_tpu`` keeps, and the port's generator
        state (``ace_tpu`` ignores it)."""
        ema = self.train_stepper.ema
        return {
            "epoch": epoch,
            "num_batches_seen": self.num_batches_seen,
            "epoch_batches_seen": self._epoch_batches_seen,
            "best_validation_loss": self.best_validation_loss,
            "best_inference_error": self.best_inference_error,
            "ema": ema.get_state() if ema else None,
            "optimization": self.train_stepper.optimization.get_state(),
            "generator_state": self.generator.get_state().tolist(),
        }

    def _ema_state(self) -> dict[str, torch.Tensor] | None:
        ema = self.train_stepper.ema
        if ema is None or ema.ema_params is None:
            return None
        return dict(zip(self.train_stepper.parameter_names(),
                        ema.ema_params))

    def _save(self, path: str, extra: dict, full: bool = False):
        """The stepper (its current weights) with ``extra``; ``full`` adds
        the optimizer state and the EMA's weights."""
        ts = self.train_stepper
        save_train_checkpoint(
            path, self.stepper, self.config.stepper,
            optimization=ts.optimization if full else None,
            parameter_names=ts.parameter_names(),
            ema_state=self._ema_state() if full else None, extra=extra,
        )

    def _save_latest(self):
        if not self._initialized:
            return
        self._save(self.paths.latest_checkpoint_path,
                   self._checkpoint_extra(self._current_epoch), full=True)

    @contextlib.contextmanager
    def _validation_weights(self):
        """The module with the EMA's weights, where validation uses them."""
        ema = self.train_stepper.ema
        if (self.config.validate_using_ema and ema is not None
                and ema.ema_params is not None):
            with self.train_stepper.weights_swapped(ema.ema_params):
                yield
        else:
            yield

    def train(self):
        if not self._initialized:
            if os.path.exists(self.paths.latest_checkpoint_path):
                self.restore(self.paths.latest_checkpoint_path)
            else:
                self.train_stepper.init(self.generator)
                resume = self.config.optimization.resume_optimizer_ckpt_path
                if resume is not None:
                    self._load_optimizer_running_state(resume)
            self._initialized = True
        self.stepper.training_history.append(TrainingJob.from_env())
        copy = self.config.copy_weights_after_batch
        # the subset is pinned to its values at the start of this run
        self.train_stepper.copy_weights = (
            copy.build(self.stepper.module.state_dict())
            if copy is not None else None)
        self._install_signal_handlers()
        try:
            self._train_epochs()
        finally:
            self._restore_signal_handlers()

    def _train_epochs(self):
        timer = GlobalTimer.get_instance()
        if self.config.segment_epochs is None:
            end_epoch = self.config.max_epochs
        else:
            end_epoch = min(self.start_epoch + self.config.segment_epochs,
                            self.config.max_epochs)
        if self.config.evaluate_before_training and self.start_epoch == 0:
            valid_logs = self.validate()
            pre_logs = {f"valid_pre/{k}": v for k, v in valid_logs.items()}
            multiple = len(self.config.inference_entries) > 1
            for i, entry in enumerate(self.config.inference_entries):
                if not entry.epochs.contains(0):
                    continue
                prefix = entry.name or (
                    f"inference_{i}" if multiple else "inference"
                )
                logs = self.inference_one_epoch(entry)
                logs.pop("inference_error", None)
                for k, v in logs.items():
                    pre_logs[f"valid_pre/{prefix}/{k}"] = v
            WandB.get_instance().log(pre_logs, step=self.num_batches_seen)
        for epoch in range(self.start_epoch, end_epoch):
            self._current_epoch = epoch
            if self._resume_skip_batches == 0:
                self._epoch_batches_seen = 0
            logging.info(f"Epoch {epoch} starting")
            if self.config.lr_tuning.enabled:
                self._maybe_tune_lr(epoch)
            with timer.context("train_one_epoch"):
                train_metrics = self.train_one_epoch(epoch)
            diag_root = (
                os.path.join(self.config.experiment_dir, "output")
                if self.config.save_per_epoch_diagnostics else None
            )
            with timer.context("validation"):
                valid_metrics = self.validate(
                    diagnostics_dir=os.path.join(
                        diag_root, "val", f"epoch_{epoch + 1:04d}"
                    ) if diag_root else None
                )
            inference_metrics: dict[str, float] = {}
            entries = [(i, e) for i, e in
                       enumerate(self.config.inference_entries)
                       if e.epochs.contains(epoch)]
            if entries:
                with timer.context("inline_inference"):
                    inference_metrics = self._inline_inference(
                        entries, epoch, diag_root)
            all_metrics = {
                **{f"train/{k}": v for k, v in train_metrics.items()},
                **{f"val/{k}": v for k, v in valid_metrics.items()},
                **{f"inference/{k}": v for k, v in inference_metrics.items()},
                "epoch": epoch,
                "lr": self.train_stepper.optimization.learning_rate,
            }
            self._disk_logger.log(all_metrics, step=self.num_batches_seen)
            WandB.get_instance().log(all_metrics, step=self.num_batches_seen)
            # a run resumed after its epoch's last batch trains none here
            train_loss = train_metrics.get("loss", float("nan"))
            logging.info(
                f"Epoch {epoch}: train loss {train_loss:.5f}, "
                f"valid loss {valid_metrics['loss']:.5f}"
            )
            if self.config.save_checkpoint:
                self.save_all_checkpoints(epoch, float(valid_metrics["loss"]))
                err = inference_metrics.get("inference_error")
                if err is not None and err < self.best_inference_error:
                    self.best_inference_error = err
                    with self._validation_weights():
                        save_train_checkpoint(
                            self.paths.best_inference_checkpoint_path,
                            self.stepper, self.config.stepper,
                        )

    def _inline_inference(self, entries, epoch: int, diag_root
                          ) -> dict[str, float]:
        metrics: dict[str, float] = {}
        weighted_error, have_error = 0.0, False
        multiple = len(self.config.inference_entries) > 1
        for i, entry in entries:
            prefix = entry.name or (f"inference_{i}" if multiple else "")
            logs = self.inference_one_epoch(
                entry,
                diagnostics_dir=os.path.join(
                    diag_root, prefix or "inference", f"epoch_{epoch + 1:04d}"
                ) if diag_root else None,
            )
            err = logs.pop("inference_error", None)
            if err is not None:
                weighted_error += entry.weight * err
                have_error = True
            for k, v in logs.items():
                metrics[f"{prefix}/{k}" if prefix else k] = v
        if have_error:
            metrics["inference_error"] = weighted_error
        return metrics

    def _maybe_tune_lr(self, epoch: int):
        """The per-epoch learning-rate trial; a winning candidate rescales
        the schedule from now on."""
        n = self.config.lr_tuning.num_batches
        batches = []
        for data in (self.train_data, self.valid_data):
            data.set_epoch(epoch)
            taken = []
            for batch in data:
                taken.append(batch.data)
                if len(taken) >= n:
                    break
            batches.append(taken)
        optimization = self.train_stepper.optimization
        current_lr = optimization.learning_rate
        if current_lr <= 0.0 or not all(batches):
            return
        new_lr = run_lr_tuning_trial(
            self.config.lr_tuning, self.train_stepper, current_lr,
            batches[0], batches[1], self.generator,
        )
        if new_lr is not None:
            logging.info(f"LR tuning adopted lr={new_lr:.3e}")
            optimization.scale_lr(new_lr / current_lr)
            WandB.get_instance().log(
                {"lr_tuning/adopted_lr": new_lr}, step=self.num_batches_seen
            )

    def _train_batches(self, epoch: int) -> tuple[list[dict], int]:
        """The epoch's batch loop: the metrics of each step, on the
        device, and the number of steps taken."""
        self.train_data.set_epoch(epoch)
        pending: list[dict] = []
        count = 0
        skip = self._resume_skip_batches
        self._resume_skip_batches = 0
        if skip:
            logging.info(
                f"mid-epoch resume: skipping {skip} already-trained batches"
            )
            # the skipped batches' lengths, so that a resumed run draws the
            # same sequence of lengths; the batches themselves are not read
            for _ in range(skip):
                self.train_stepper.sample_n_forward_steps(epoch)
            self._epoch_batches_seen += skip
        wandb = WandB.get_instance()
        corrector_disabled = (
            epoch < self.train_stepper.corrector_disabled_epochs)
        for batch in self.train_data.iter_batches(skip):
            n_steps = self.train_stepper.sample_n_forward_steps(epoch)
            with signals_deferred():
                metrics = self.train_stepper.train_step(
                    batch.data, self.generator, n_steps,
                    corrector_disabled=corrector_disabled,
                    labels=batch.labels, data_mask=batch.data_mask,
                )
                self.num_batches_seen += 1
                self._epoch_batches_seen += 1
            count += 1
            pending.append(metrics)
            if count % self.config.log_train_every_n_batches == 0:
                wandb.log({"train_batch/loss": float(metrics["loss"])},
                          step=self.num_batches_seen)
            wandb.log_watched(self.num_batches_seen, None)
            if (self.config.checkpoint_every_n_batches > 0
                    and count % self.config.checkpoint_every_n_batches == 0):
                self._save_latest()
        return pending, count

    def train_one_epoch(self, epoch: int) -> dict[str, float]:
        pending, count = self._train_batches(epoch)
        metrics_out = _mean_metrics(pending, count)
        n_eval = self.config.train_evaluation_batches
        if n_eval > 0:
            # an independent shuffle: the epoch seed offset, so that the
            # batches are uncorrelated with the pass just trained
            self.train_data.set_epoch(epoch + 104729)
            losses = []
            with self._validation_weights():
                for i, batch in enumerate(self.train_data):
                    if i >= n_eval:
                        break
                    losses.append(self.train_stepper.valid_step(
                        batch.data, self.generator, labels=batch.labels,
                        data_mask=batch.data_mask)["loss"])
            if losses:
                metrics_out["loss_independent_shuffle"] = float(
                    torch.stack(losses).double().mean())
            self.train_data.set_epoch(epoch)
        return metrics_out

    @torch.no_grad()
    def validate(self, diagnostics_dir: str | None = None
                 ) -> dict[str, float]:
        """The validation loss and one-step metrics, with the validation
        weights."""
        from ace_tpu_torch.aggregator.one_step import OneStepAggregator

        stepper = self.stepper
        one_step = OneStepAggregator(
            self.valid_data.dataset_info.gridded_operations,
            record_snapshots=diagnostics_dir is not None,
            record_mean_maps=diagnostics_dir is not None,
        )
        prognostic = stepper.prognostic_names
        forcing_names = stepper.forcing_window_names
        pending: list[dict] = []
        count = 0
        with self._validation_weights():
            for batch in self.valid_data:
                pending.append(self.train_stepper.valid_step(
                    batch.data, self.generator, labels=batch.labels,
                    data_mask=batch.data_mask))
                count += 1
                ic = {k: batch.data[k][:, :1] for k in prognostic}
                forcing = {k: batch.data[k][:, :2] for k in forcing_names
                           if k in batch.data}
                outputs, _, _ = stepper.predict_fn(
                    ic, forcing,
                    stepper.step.init_stepper_state(
                        {k: v[:, 0] for k, v in ic.items()}),
                    self.generator, n_forward=1,
                )
                target = {k: batch.data[k][:, 1:2] for k in stepper.out_names
                          if k in batch.data}
                one_step.record_batch(outputs, target)
        result = _mean_metrics(pending, count)
        result.update(one_step.get_logs())
        if diagnostics_dir is not None:
            one_step.flush_diagnostics(diagnostics_dir)
        return result

    def inference_one_epoch(self, cfg: InlineInferenceConfig,
                            diagnostics_dir: str | None = None
                            ) -> dict[str, float]:
        """Inline autoregressive inference with the validation weights;
        ``inference_error`` is the mean of its time-mean RMSEs."""
        from ace_tpu_torch.inference.loop import run_inference

        stepper = self.stepper
        data = cfg.loader.build(
            forcing_names=stepper.forcing_window_names,
            prognostic_names=stepper.prognostic_names,
            n_forward_steps=cfg.n_forward_steps,
            forward_steps_in_memory=cfg.forward_steps_in_memory,
        )
        ic = PrognosticState(data=data.initial_condition(
            stepper.prognostic_names).to_device(self.device).data)
        aggregator = cfg.aggregator.build(
            data.dataset_info, n_timesteps=cfg.n_forward_steps,
            normalizer=getattr(stepper.step, "normalizer", None),
        )
        target_names = [n for n in stepper.out_names
                        if n in data.dataset.names]
        with self._validation_weights():
            run_inference(stepper, ic, data, aggregator=aggregator,
                          target_names=target_names)
        if diagnostics_dir is not None:
            aggregator.flush_diagnostics(diagnostics_dir)
        logs = {k: float(v) for k, v in aggregator.get_logs().items()}
        rmses = [v for k, v in logs.items()
                 if k.startswith("time_mean/rmse/")]
        if rmses:
            logs["inference_error"] = float(np.mean(rmses))
        return logs

    def save_all_checkpoints(self, epoch: int, valid_loss: float):
        """The latest checkpoint (with optimizer and EMA), the best by
        validation loss, the EMA's weights, and the epoch's if
        ``checkpoint_save_epochs`` holds it."""
        improved = valid_loss < self.best_validation_loss
        with signals_deferred():
            # the epoch is complete: a restart checkpoint from here on
            # starts the next
            self._current_epoch = epoch + 1
            self._epoch_batches_seen = 0
            self.best_validation_loss = min(self.best_validation_loss,
                                            valid_loss)
        extra = self._checkpoint_extra(epoch + 1)
        self._save(self.paths.latest_checkpoint_path, extra, full=True)
        if improved:
            self._save(self.paths.best_checkpoint_path, extra)
        ema = self.train_stepper.ema
        if ema is not None and ema.ema_params is not None:
            with self.train_stepper.weights_swapped(ema.ema_params):
                self._save(self.paths.ema_checkpoint_path, extra)
        if (self.config.checkpoint_save_epochs is not None
                and self.config.checkpoint_save_epochs.contains(epoch)):
            self._save(self.paths.epoch_checkpoint_path(epoch), extra)

    def _load_optimizer_running_state(self, path: str):
        """Fine-tuning: Adam's moments and count from another run's
        training checkpoint (whatever accumulation or frozen parameters
        either run has), this config's hyperparameters and a fresh
        learning-rate schedule (port of ace_tpu/train/trainer.py:813)."""
        logging.info(f"Loading optimizer running state from {path}")
        out = read_train_checkpoint(path)
        if "optimizer" not in out:
            raise ValueError(
                f"checkpoint {path} has no optimizer state to resume from")
        adam = out["optimizer"]
        names = self.train_stepper.parameter_names()
        if set(adam["mu"]) != set(names):
            raise ValueError(
                "optimizer state in resume_optimizer_ckpt_path does not "
                "match this run's parameters: "
                f"{sorted(set(adam['mu']) ^ set(names))}")
        optimization = self.train_stepper.optimization
        optimization.load_moments(
            adam["count"], [adam["mu"][n] for n in names],
            [adam["nu"][n] for n in names],
            schedule_count=optimization.schedule_count)

    def restore(self, path: str):
        """Resume from a training checkpoint of either package: weights,
        optimizer moments and count, EMA, counters, and (from the port's
        files) the generator's state."""
        logging.info(f"Restoring from {path}")
        out = read_train_checkpoint(path)
        ts = self.train_stepper
        self.stepper.load_state_dict(out["params"])
        params, names = ts.parameters(), ts.parameter_names()
        ts.optimization.init(params)
        if "optimizer" in out:
            adam = out["optimizer"]
            for key in ("mu", "nu"):
                if set(adam[key]) != set(names):
                    raise ValueError(
                        f"optimizer {key} holds other parameters: "
                        f"{sorted(set(adam[key]) ^ set(names))}")
            ts.optimization.load_moments(
                adam["count"], [adam["mu"][n] for n in names],
                [adam["nu"][n] for n in names],
                schedule_count=adam["schedule_count"])
            if (adam["acc"] is None) != (ts.optimization.acc is None):
                raise ValueError("the checkpoint's gradient accumulation "
                                 "differs from the config's")
            if adam["acc"] is not None:
                ts.optimization.load_accumulation(
                    adam["mini_step"], [adam["acc"][n] for n in names])
        if ts.ema is not None:
            if "ema_state" in out:
                ts.ema.ema_params = [
                    out["ema_state"][n].to(p.device, p.dtype)
                    for n, p in zip(names, params)
                ]
            else:
                ts.ema.init(params)
        extra = out.get("extra", {})
        self.start_epoch = extra.get("epoch", 0)
        self.num_batches_seen = extra.get("num_batches_seen", 0)
        # a mid-epoch checkpoint: skip the batches its epoch had trained
        self._resume_skip_batches = extra.get("epoch_batches_seen", 0)
        self.best_validation_loss = extra.get("best_validation_loss",
                                              float("inf"))
        self.best_inference_error = extra.get("best_inference_error",
                                              float("inf"))
        if extra.get("ema") and ts.ema is not None:
            ts.ema.load_state(extra["ema"])
        if extra.get("optimization"):
            ts.optimization.load_state(extra["optimization"])
        if extra.get("generator_state") is not None:
            self.generator.set_state(torch.tensor(extra["generator_state"],
                                                  dtype=torch.uint8))
