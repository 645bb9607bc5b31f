"""Coupled training: the joint atmosphere and ocean loss over coupled
rollouts (port of ace_tpu/coupled/train.py).

    python -m ace_tpu_torch.coupled <config.yaml> [--override a.b=1 ...]
        [--device cpu]

It reads the YAML of ``python -m ace_tpu.coupled.train`` and trains on the
CUDA device unless ``--device`` (or ``device=``) asks for another.

Where the JAX package differentiates the whole coupled rollout with
``jax.value_and_grad``, the port runs it with gradients through
``CoupledStepper.predict_with_grad`` (each component step recomputed in
the backward pass) and ``backward``. Frozen parameters keep their
weights: without ``max_grad_norm`` their gradients reach nothing the
coupled trainer keeps (it saves no optimizer state), so they are not
computed at all (no ``requires_grad``); with it they enter the global norm
as in JAX, and the optimizer zeroes their updates. Nothing in the batch
loop waits for the device: batches arrive by non-blocking copies from
pinned memory and the last batch's metrics are read after the loop. As in
the JAX package, a run on a directory that holds
``training_checkpoints/{atmosphere,ocean}_ckpt.msgpack`` starts from
those weights with a fresh optimizer and runs every epoch again.
"""

import contextlib
import dataclasses
import logging
import os

import numpy as np
import torch

from ace_tpu_torch.core.cli import get_parser, prepare_config, prepare_directory
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.loss import StepLossConfig
from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
from ace_tpu_torch.core.timing import GlobalTimer
from ace_tpu_torch.core.wandb import DiskMetricLogger
from ace_tpu_torch.coupled.stepper import (
    CoupledPrognosticState,
    CoupledStepper,
    CoupledStepperConfig,
)
from ace_tpu_torch.data.dataset import (
    ConcatDatasetConfig,
    MergeDatasetConfig,
    XarrayDataConfig,
)
from ace_tpu_torch.data.loading import WindowDataset
from ace_tpu_torch.data.requirements import DataRequirements
from ace_tpu_torch.device import entry_device
from ace_tpu_torch.stepper.checkpoint import save_stepper
from ace_tpu_torch.stepper.parameter_init import (
    ParameterInitializationConfig,
    read_base_weights,
)
from ace_tpu_torch.stepper.stepper import PrognosticState
from ace_tpu_torch.train.trainer import LoggingConfig

COMPONENTS = ("atmosphere", "ocean")


@dataclasses.dataclass
class CoupledDatasetsConfig:
    """Per-component dataset configs, each a plain, merged or
    concatenated source (the nested ``dataset:`` block of
    ``configs/baselines/cm4-piControl/train-config.yaml``)."""

    atmosphere: XarrayDataConfig | MergeDatasetConfig | ConcatDatasetConfig
    ocean: XarrayDataConfig | MergeDatasetConfig | ConcatDatasetConfig


@dataclasses.dataclass
class CoupledDataConfig:
    """Two time-aligned datasets: the flat ``atmosphere``/``ocean`` fields
    or a nested ``dataset: {atmosphere, ocean}`` block."""

    atmosphere: XarrayDataConfig | None = None
    ocean: XarrayDataConfig | None = None
    dataset: CoupledDatasetsConfig | None = None
    batch_size: int = 1
    num_data_workers: int = 2
    prefetch_factor: int = 2

    def __post_init__(self):
        flat = self.atmosphere is not None and self.ocean is not None
        if flat == (self.dataset is not None):
            raise ValueError(
                "set either dataset: {atmosphere, ocean} or the flat "
                "atmosphere/ocean fields"
            )

    def build_atmosphere(self):
        cfg = (self.dataset.atmosphere if self.dataset is not None
               else self.atmosphere)
        return cfg.build()

    def build_ocean(self):
        cfg = self.dataset.ocean if self.dataset is not None else self.ocean
        return cfg.build()


@dataclasses.dataclass
class ComponentTrainingConfig:
    """One component's training behavior."""

    loss: StepLossConfig = dataclasses.field(default_factory=StepLossConfig)
    # consecutive component steps in the loss, from the first step after
    # the initial condition; None = all
    n_steps: int | None = None
    optimize_last_step_only: bool = False
    loss_weight: float = 1.0
    parameter_init: ParameterInitializationConfig | None = None


@dataclasses.dataclass
class CoupledParameterInitConfig:
    """Fine-tune from a coupled trainer's output directory holding
    ``atmosphere_ckpt.msgpack`` and ``ocean_ckpt.msgpack``."""

    checkpoint_path: str | None = None


@dataclasses.dataclass
class CoupledTrainStepperConfig:
    n_coupled_steps: int
    ocean: ComponentTrainingConfig = dataclasses.field(
        default_factory=ComponentTrainingConfig
    )
    atmosphere: ComponentTrainingConfig = dataclasses.field(
        default_factory=ComponentTrainingConfig
    )
    parameter_init: CoupledParameterInitConfig = dataclasses.field(
        default_factory=CoupledParameterInitConfig
    )

    def __post_init__(self):
        if self.parameter_init.checkpoint_path is not None:
            for comp in (self.atmosphere, self.ocean):
                if (comp.parameter_init is not None
                        and comp.parameter_init.weights_path is not None):
                    raise ValueError(
                        "specify parameter_init.checkpoint_path or "
                        "component weights_path, not both"
                    )


@dataclasses.dataclass
class CoupledTrainConfig:
    experiment_dir: str
    max_epochs: int
    stepper: CoupledStepperConfig
    train_loader: CoupledDataConfig
    optimization: OptimizationConfig = dataclasses.field(
        default_factory=OptimizationConfig
    )
    n_coupled_steps: int = 1
    atmosphere_loss: StepLossConfig = dataclasses.field(
        default_factory=StepLossConfig
    )
    ocean_loss: StepLossConfig = dataclasses.field(
        default_factory=StepLossConfig
    )
    # a weight of 0 removes the component from the objective;
    # optimize_last_step_only restricts a component's loss to its last
    # rollout step
    atmosphere_loss_weight: float = 1.0
    ocean_loss_weight: float = 1.0
    atmosphere_optimize_last_step_only: bool = False
    ocean_optimize_last_step_only: bool = False
    # the nested training block ({n_coupled_steps, ocean, atmosphere});
    # fills the flat fields above and adds per-component n_steps bounds and
    # parameter_init
    stepper_training: CoupledTrainStepperConfig | None = None
    # the coupled validation loss each epoch
    validation_loader: CoupledDataConfig | None = None
    ema: EMAConfig = dataclasses.field(default_factory=EMAConfig)
    save_checkpoint: bool = True
    validate_using_ema: bool = True
    segment_epochs: int | None = None
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)
    seed: int = 0

    def __post_init__(self):
        if self.stepper_training is not None:
            st = self.stepper_training
            self.n_coupled_steps = st.n_coupled_steps
            self.atmosphere_loss = st.atmosphere.loss
            self.ocean_loss = st.ocean.loss
            self.atmosphere_loss_weight = st.atmosphere.loss_weight
            self.ocean_loss_weight = st.ocean.loss_weight
            self.atmosphere_optimize_last_step_only = (
                st.atmosphere.optimize_last_step_only)
            self.ocean_optimize_last_step_only = (
                st.ocean.optimize_last_step_only)

    @property
    def atmosphere_n_steps(self) -> int | None:
        if self.stepper_training is None:
            return None
        return self.stepper_training.atmosphere.n_steps

    @property
    def ocean_n_steps(self) -> int | None:
        if self.stepper_training is None:
            return None
        return self.stepper_training.ocean.n_steps


def stack_to_device(samples: list[dict], device: torch.device,
                    names: list[str] | None = None
                    ) -> dict[str, torch.Tensor]:
    """Stack the samples' fields (``names``, by default all) into a batch
    on ``device``, through pinned memory and non-blocking copies on a
    GPU: nothing waits for the device."""
    out = {}
    for k in samples[0] if names is None else names:
        t = torch.from_numpy(np.stack([s[k] for s in samples]))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


class CoupledTrainer:
    """Joint training over coupled rollouts; the components' losses are
    summed by weight."""

    def __init__(self, config: CoupledTrainConfig, device=None,
                 datasets: tuple | None = None):
        """``datasets``: the (atmosphere, ocean) training datasets in place
        of the train loader's (data a program made, e.g. in memory)."""
        self.config = config
        self.device = entry_device(device)
        # per component (ParameterInitializationConfig, base weights on
        # the device) for the L2-SP term, set by init_weights
        self._l2sp: dict = {}
        self._val_windows = None
        atmos_ds, ocean_ds = datasets or (
            config.train_loader.build_atmosphere(),
            config.train_loader.build_ocean())
        self.coupled: CoupledStepper = config.stepper.get_stepper(
            atmos_ds.dataset_info, ocean_ds.dataset_info, device=self.device)
        self.atmos_window, self.ocean_window = self._windows(atmos_ds,
                                                             ocean_ds)
        self.atmos_loss = self._build_loss(config.atmosphere_loss,
                                           self.coupled.atmosphere,
                                           atmos_ds.dataset_info)
        self.ocean_loss = self._build_loss(config.ocean_loss,
                                           self.coupled.ocean,
                                           ocean_ds.dataset_info)
        self.optimization = config.optimization.build(config.max_epochs)
        self.ema = config.ema.build()
        self.generator = torch.Generator(self.device).manual_seed(
            config.seed + 1)
        self._disk_logger = DiskMetricLogger(
            os.path.join(config.experiment_dir, "metrics.jsonl"))
        self.params: list[torch.Tensor] = []

    def _windows(self, atmos_ds, ocean_ds):
        """The sample windows: ``n_outer * n_inner + 1`` atmosphere times
        and ``n_outer + 1`` ocean times, of each component's names."""
        n_inner = self.coupled.n_inner_steps
        n_outer = self.config.n_coupled_steps
        return (
            WindowDataset(atmos_ds, DataRequirements(
                self.coupled.all_atmosphere_names, n_outer * n_inner + 1)),
            WindowDataset(ocean_ds, DataRequirements(
                self.coupled.all_ocean_names, n_outer + 1)),
        )

    @staticmethod
    def _build_loss(loss_config, stepper, info):
        step_config = stepper.step.config
        return loss_config.build(
            info.gridded_operations,
            out_names=stepper.out_names,
            normalizer=step_config.normalization.build_loss_normalizer(
                step_config._normalize_names),
        )

    def _n_pairs(self, atmos_window, ocean_window) -> int:
        """Sample i pairs ocean window i with the atmosphere window that
        starts at ``i * n_inner``."""
        n_inner = self.coupled.n_inner_steps
        return min(len(ocean_window),
                   (len(atmos_window) + n_inner - 1) // n_inner)

    def _batch(self, indices) -> tuple[dict, dict]:
        n_inner = self.coupled.n_inner_steps
        atmos = [self.atmos_window[int(i) * n_inner][0] for i in indices]
        ocean = [self.ocean_window[int(i)][0] for i in indices]
        return (stack_to_device(atmos, self.device),
                stack_to_device(ocean, self.device))

    def loss_fn(self, atmos_batch: dict, ocean_batch: dict,
                generator: torch.Generator | None
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """The coupled loss of one batch: each component's ``[B, T + 1,
        ...]`` fields (time 0 the initial condition)."""
        coupled = self.coupled
        cfg = self.config
        ic = CoupledPrognosticState(
            atmosphere_data=PrognosticState(data={
                k: atmos_batch[k][:, :1]
                for k in coupled.atmosphere.prognostic_names}),
            ocean_data=PrognosticState(data={
                k: ocean_batch[k][:, :1]
                for k in coupled.ocean.prognostic_names}),
        )
        atmos_forcing = {k: atmos_batch[k]
                         for k in coupled.atmosphere_forcing_window_names
                         if k in atmos_batch}
        ocean_forcing = {k: ocean_batch[k]
                         for k in coupled.ocean_forcing_window_names
                         if k in ocean_batch}
        a_out, o_out, _ = coupled.predict_with_grad(
            ic, atmos_forcing, ocean_forcing, generator)
        losses = {}
        for label, out, batch, stepper, loss, n, last, weight in (
                ("atmosphere", a_out, atmos_batch, coupled.atmosphere,
                 self.atmos_loss, cfg.atmosphere_n_steps,
                 cfg.atmosphere_optimize_last_step_only,
                 cfg.atmosphere_loss_weight),
                ("ocean", o_out, ocean_batch, coupled.ocean, self.ocean_loss,
                 cfg.ocean_n_steps, cfg.ocean_optimize_last_step_only,
                 cfg.ocean_loss_weight)):
            target = {k: batch[k][:, 1:] for k in stepper.out_names
                      if k in batch}
            if n is not None:
                out = {k: v[:, :n] for k, v in out.items()}
                target = {k: v[:, :n] for k, v in target.items()}
            if last:
                out = {k: out[k][:, -1:] for k in target}
                target = {k: v[:, -1:] for k, v in target.items()}
            else:
                out = {k: out[k] for k in target}
            active = (n is None or n > 0) and weight
            losses[label] = (loss(out, target, 0).total if active
                             else torch.zeros((), device=self.device))
        total = (cfg.atmosphere_loss_weight * losses["atmosphere"]
                 + cfg.ocean_loss_weight * losses["ocean"])
        for comp, (pinit, base) in self._l2sp.items():
            module = getattr(coupled, comp).module
            total = total + pinit.regularizer_loss(
                dict(module.named_parameters()), base)
        return total, {"loss": total,
                       "atmosphere_loss": losses["atmosphere"],
                       "ocean_loss": losses["ocean"]}

    def _drop_weight_caches(self):
        for comp in COMPONENTS:
            for m in getattr(self.coupled, comp).module.modules():
                if hasattr(m, "drop_weight_cache"):
                    m.drop_weight_cache()

    @contextlib.contextmanager
    def _weights_swapped(self, tensors: list[torch.Tensor]):
        """The modules with ``tensors`` (in :attr:`params`' order, the
        EMA's) as the trained weights: storages exchanged on entry and
        back on exit, both bit for bit as they went in."""
        def exchange():
            with torch.no_grad():
                for p, t in zip(self.params, tensors):
                    p.data, t.data = t.data, p.data
            self._drop_weight_caches()

        exchange()
        try:
            yield
        finally:
            exchange()

    def _validate(self) -> float:
        """The mean coupled loss over at most 4 validation pairs at batch
        1."""
        config = self.config
        if self._val_windows is None:
            self._val_windows = self._windows(
                config.validation_loader.build_atmosphere(),
                config.validation_loader.build_ocean())
        atmos_w, ocean_w = self._val_windows
        n_inner = self.coupled.n_inner_steps
        n_pairs = self._n_pairs(atmos_w, ocean_w)
        if n_pairs == 0:
            raise ValueError(
                "validation dataset is shorter than one coupled rollout"
                f" window (needs {config.n_coupled_steps} coupled steps"
                " + 1)"
            )
        generator = torch.Generator(self.device).manual_seed(config.seed + 99)
        losses = []
        with torch.no_grad():
            for i in range(min(n_pairs, 4)):
                atmos_batch = stack_to_device([atmos_w[i * n_inner][0]],
                                         self.device)
                ocean_batch = stack_to_device([ocean_w[i][0]], self.device)
                loss, _ = self.loss_fn(atmos_batch, ocean_batch, generator)
                losses.append(loss)
        return float(np.mean(torch.stack(losses).cpu().double().numpy()))

    def _load_components(self, atmosphere_path: str, ocean_path: str):
        for comp, path in zip(COMPONENTS, (atmosphere_path, ocean_path)):
            getattr(self.coupled, comp).load_state_dict(
                read_base_weights(path)[0])

    def init_weights(self):
        """Initial weights (drawn from the seed, then a restart's files, a
        coupled ``checkpoint_path`` or each component's
        ``parameter_init``), the frozen parameters, the optimizer state
        and the EMA."""
        config = self.config
        self.coupled.init_params(
            torch.Generator(self.device).manual_seed(config.seed))
        ckpt_dir = os.path.join(config.experiment_dir, "training_checkpoints")
        restart = [os.path.join(ckpt_dir, f"{c}_ckpt.msgpack")
                   for c in COMPONENTS]
        st = config.stepper_training
        if all(map(os.path.exists, restart)):
            logging.info("resuming coupled training from checkpoints")
            self._load_components(*restart)
        elif st is not None and st.parameter_init.checkpoint_path is not None:
            base = st.parameter_init.checkpoint_path
            self._load_components(*[os.path.join(base, f"{c}_ckpt.msgpack")
                                    for c in COMPONENTS])
            logging.info(f"initialized coupled weights from {base}")
        elif st is not None:
            for comp in COMPONENTS:
                pinit = getattr(st, comp).parameter_init
                if pinit is not None and pinit.weights_path is not None:
                    base = pinit.apply_weights(getattr(self.coupled, comp))
                    if pinit.alpha or pinit.beta:
                        self._l2sp[comp] = (pinit, {
                            k: v.to(self.device) for k, v in base.items()})
                    logging.info(f"initialized {comp} weights from "
                                 f"{pinit.weights_path}")
        clipped = config.optimization.max_grad_norm is not None
        params, frozen = [], []
        for comp in COMPONENTS:
            module = getattr(self.coupled, comp).module
            pinit = (getattr(st, comp).parameter_init if st is not None
                     else None)
            mask = ({} if pinit is None or pinit.frozen_parameters is None
                    else pinit.frozen_parameters.frozen_mask(
                        module.state_dict()))
            for name, p in module.named_parameters():
                if mask.get(name, False) and not clipped:
                    # its gradient would reach nothing the trainer keeps
                    p.requires_grad_(False)
                    continue
                params.append(p)
                frozen.append(mask.get(name, False))
        self.params = params
        self.optimization.init(params)
        self.optimization.set_frozen(frozen if any(frozen) else None)
        self.ema.init(params)

    def train_step(self, atmos_batch: dict, ocean_batch: dict
                   ) -> dict[str, torch.Tensor]:
        """Loss, backward, the optimizer's update and the EMA; returns the
        metrics as detached tensors on the device."""
        for p in self.params:
            p.grad = None
        total, metrics = self.loss_fn(atmos_batch, ocean_batch,
                                      self.generator)
        total.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        self.optimization.step(self.params, grads)
        for p in self.params:
            p.grad = None
        self.ema(self.params)
        return {k: v.detach() for k, v in metrics.items()}

    def _train_batches(self, order: np.ndarray, n_batches: int
                       ) -> tuple[dict[str, torch.Tensor], int]:
        """The batch loop of an epoch; returns the last batch's metrics
        (on the device) and the number of batches."""
        batch_size = self.config.train_loader.batch_size
        metrics = {}
        for b in range(n_batches):
            idx = order[b * batch_size:(b + 1) * batch_size]
            metrics = self.train_step(*self._batch(idx))
        return metrics, n_batches

    def train(self) -> "CoupledTrainer":
        config = self.config
        timer = GlobalTimer.get_instance()
        self.init_weights()
        n_pairs = self._n_pairs(self.atmos_window, self.ocean_window)
        n_batches = max(1, n_pairs // config.train_loader.batch_size)
        shuffle_rng = np.random.RandomState(config.seed + 7)
        end_epoch = (config.max_epochs if config.segment_epochs is None
                     else min(config.segment_epochs, config.max_epochs))
        for epoch in range(end_epoch):
            order = np.arange(n_pairs)
            shuffle_rng.shuffle(order)  # a fresh order each epoch
            with timer.context("train_one_epoch"):
                metrics, _ = self._train_batches(order, n_batches)
                last_metrics = {k: float(v) for k, v in metrics.items()}
            if config.validation_loader is not None:
                use_ema = config.validate_using_ema
                with timer.context("validation"), (
                        self._weights_swapped(self.ema.ema_params) if use_ema
                        else contextlib.nullcontext()):
                    last_metrics["val_loss"] = self._validate()
            logging.info(f"coupled epoch {epoch}: {last_metrics}")
            self._disk_logger.log({**last_metrics, "epoch": epoch})
        if config.save_checkpoint:
            with timer.context("checkpoint"):
                self.save_checkpoints()
        return self

    def save_checkpoints(self):
        """The four component files: the EMA's weights and the trained
        ones, in ``ace_tpu``'s layout."""
        ckpt_dir = os.path.join(self.config.experiment_dir,
                                "training_checkpoints")
        stepper_config = self.config.stepper

        def save(suffix):
            for comp in COMPONENTS:
                save_stepper(os.path.join(ckpt_dir, f"{comp}{suffix}.msgpack"),
                             getattr(self.coupled, comp),
                             getattr(stepper_config, comp).stepper)

        with self._weights_swapped(self.ema.ema_params):
            save("_ema_ckpt")
        save("_ckpt")


def main(argv=None, device=None) -> CoupledTrainer:
    """The command line; ``device`` (when given) takes the place of
    ``--device``. Returns the trainer."""
    args = get_parser().parse_args(argv)
    device = entry_device(device if device is not None else args.device)
    data = prepare_config(args.yaml_config, args.override)
    config = from_dict(CoupledTrainConfig, data)
    prepare_directory(config.experiment_dir, data)
    config.logging.configure(config.experiment_dir)
    logging.info("Starting coupled training")
    trainer = CoupledTrainer(config, device=device).train()
    GlobalTimer.get_instance().log_durations()
    return trainer


if __name__ == "__main__":
    main()
