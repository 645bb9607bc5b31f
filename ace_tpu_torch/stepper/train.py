"""Training stepper: multi-step rollout loss, backward and optimizer update
(port of ace_tpu/stepper/train.py).

Where the JAX package compiles loss, gradient and update into one program,
the port runs them eagerly: ``loss_fn`` is a Python loop over the rollout
steps (the ensemble folded into the batch), ``train_step`` calls
``backward`` and the optimizer (``core/optimization.py``), and nothing in
it waits for the device: the metrics it returns are tensors on the device.
Activation checkpointing: the model's own per-block ``checkpointing`` (the
flagship recipe), and ``CheckpointConfig.after_n_forward_steps`` or
``remat`` as a whole-step ``torch.utils.checkpoint``.
"""

import dataclasses

import torch
import torch.utils.checkpoint

from ace_tpu_torch.core.loss import StepLossConfig, complex_sht
from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
from ace_tpu_torch.core.schedule import (
    TimeLengthProbabilities,
    TimeLengthSchedule,
)
from ace_tpu_torch.core.step import StepArgs
from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping
from ace_tpu_torch.ops.sht import RealSHT
from ace_tpu_torch.stepper.parameter_init import ParameterInitializationConfig
from ace_tpu_torch.stepper.stepper import Stepper


@dataclasses.dataclass
class StepperTrainConfig:
    """Training options of the stepper (the JAX package's fields).

    n_forward_steps: rollout length of the loss: a constant, a stochastic
        TimeLengthProbabilities, or an epoch-milestone TimeLengthSchedule.
    n_ensemble: members per sample for ensemble losses (-1: 2 for
        EnsembleLoss, else 1).
    remat: recompute every rollout step in the backward pass.
    optimize_last_step_only: only the last step's loss is optimized; the
        earlier steps run and their state is detached.
    parameter_init: fine-tuning options (only the defaults are ported).
    """

    loss: StepLossConfig = dataclasses.field(default_factory=StepLossConfig)
    n_forward_steps: int | TimeLengthProbabilities | TimeLengthSchedule = 1
    n_ensemble: int = -1
    remat: bool = False
    optimize_last_step_only: bool = False
    parameter_init: ParameterInitializationConfig = dataclasses.field(
        default_factory=ParameterInitializationConfig
    )

    def __post_init__(self):
        ensemble = self.loss.type in ("EnsembleLoss",)
        if self.n_ensemble == -1:
            self.n_ensemble = 2 if ensemble else 1
        if ensemble and self.n_ensemble < 2:
            raise ValueError(
                "EnsembleLoss requires n_ensemble >= 2 "
                f"(got {self.n_ensemble})"
            )

    @property
    def n_forward_steps_schedule(self) -> TimeLengthSchedule:
        if isinstance(self.n_forward_steps, TimeLengthSchedule):
            return self.n_forward_steps
        return TimeLengthSchedule.from_constant(self.n_forward_steps)

    @property
    def max_n_forward_steps(self) -> int:
        return self.n_forward_steps_schedule.max_n_forward_steps


def _replaying(fn, generator: torch.Generator | None):
    """``fn`` such that a second call (the recompute of a checkpoint) draws
    the same numbers from ``generator`` as the first, and leaves the
    generator where it was."""
    if generator is None:
        return fn
    start = generator.get_state()
    calls = [0]

    def wrapped(*args):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*args)
        resume = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*args)
        finally:
            generator.set_state(resume)

    return wrapped


class TrainStepper:
    """A Stepper with a loss, an optimizer and an EMA of its weights. The
    module's parameters are updated in place."""

    def __init__(
        self,
        stepper: Stepper,
        train_config: StepperTrainConfig,
        optimization_config: OptimizationConfig,
        ema_config: EMAConfig | None = None,
        max_epochs: int = 1,
        steps_per_epoch: int = 1,
    ):
        self.stepper = stepper
        self.train_config = train_config
        step = stepper.step
        info = step.dataset_info
        sht = None
        if train_config.loss.is_ensemble_loss:
            nlat, nlon = info.img_shape
            self.loss_sht = RealSHT(nlat, nlon,
                                    grid=info.horizontal_coordinates.grid,
                                    device=stepper.device)
            sht = complex_sht(self.loss_sht)
        config = step.config
        loss_normalizer = config.normalization.build_loss_normalizer(
            sorted(set(config.in_names) | set(config.out_names)),
            residual_scaled_names=step.prognostic_names,
        )
        self.step_loss = train_config.loss.build(
            info.gridded_operations,
            out_names=step.output_names,
            normalizer=loss_normalizer,
            sht=sht,
        )
        self.optimization = optimization_config.build(
            max_epochs=max_epochs, steps_per_epoch=steps_per_epoch
        )
        self.ema = ema_config.build() if ema_config is not None else None

    @property
    def module(self) -> torch.nn.Module:
        return self.stepper.module

    def parameters(self) -> list[torch.Tensor]:
        return [p for p in self.module.parameters() if p.requires_grad]

    def loss_fn(self, batch: TensorMapping,
                generator: torch.Generator | None,
                n_steps: int | None = None, deterministic: bool = False,
                corrector_disabled: bool = False
                ) -> tuple[torch.Tensor, TensorDict]:
        """Rollout loss over ``n_steps`` (default: the schedule's maximum).

        ``batch`` maps every input, forcing and target variable to ``[B,
        n_forward + 1, ...spatial]`` (index 0 the initial condition);
        ``generator`` draws the model's noise. Returns ``(total, metrics)``
        with ``metrics["loss"]`` and ``metrics["loss_step_<i>"]``.
        """
        step = self.stepper.step
        cfg = self.train_config
        if n_steps is None:
            n_steps = cfg.max_n_forward_steps
        prognostic_names = step.prognostic_names
        input_only = sorted(set(step.input_names) - set(step.output_names))
        nsf = set(step.next_step_forcing_names)
        nsi = step.next_step_input_names
        out_names = step.output_names
        n_ens = cfg.n_ensemble

        def expand_ens(x):
            # fold the ensemble into the batch, member-minor as
            # jnp.repeat: [B, ...] -> [B*E, ...]
            return x if n_ens == 1 else x.repeat_interleave(n_ens, dim=0)

        state = {k: expand_ens(batch[k][:, 0]) for k in prognostic_names}
        stepper_state = step.init_stepper_state(state)

        def body(t, state, stepper_state):
            forcing_t = {
                k: expand_ens(batch[k][:, t + 1 if k in nsf else t])
                for k in input_only
            }
            next_t = {k: expand_ens(batch[k][:, t + 1]) for k in nsi}
            out = step.step(StepArgs(
                input=self.stepper.input_masker({**state, **forcing_t}),
                next_step_input_data=self.stepper.input_masker(next_t),
                stepper_state=stepper_state,
                generator=generator,
                deterministic=deterministic,
                corrector_disabled=corrector_disabled,
            ))
            masked = self.stepper.output_masker(out.output)
            gen = {k: masked[k] for k in out_names}
            target = {k: batch[k][:, t + 1] for k in out_names}
            if n_ens > 1:
                # [B*E, ...] -> [B, E, ...]; the target gets an ensemble
                # axis of 1
                gen = {k: v.reshape(-1, n_ens, *v.shape[1:])
                       for k, v in gen.items()}
                target = {k: v[:, None] for k, v in target.items()}
            step_loss = self.step_loss(gen, target, t).total
            new_state = {k: masked[k] for k in prognostic_names}
            return step_loss, new_state, out.stepper_state

        if cfg.remat:
            split = 0
        else:
            after = self.optimization.config.checkpoint.after_n_forward_steps
            split = n_steps if after >= n_steps else max(int(after), 0)
        per_step = []
        for t in range(n_steps):
            if t >= split and torch.is_grad_enabled():
                step_loss, state, stepper_state = (
                    torch.utils.checkpoint.checkpoint(
                        _replaying(body, generator), t, state, stepper_state,
                        use_reentrant=False, preserve_rng_state=False,
                    )
                )
            else:
                step_loss, state, stepper_state = body(t, state,
                                                       stepper_state)
            if cfg.optimize_last_step_only:
                # only the last step's call sees gradient
                state = {k: v.detach() for k, v in state.items()}
                stepper_state = _detach(stepper_state)
            per_step.append(step_loss)
        total = per_step[-1] if cfg.optimize_last_step_only else sum(per_step)
        metrics = {"loss": total}
        for i, loss in enumerate(per_step):
            metrics[f"loss_step_{i}"] = loss
        return total, metrics

    def train_step(self, batch: TensorMapping,
                   generator: torch.Generator | None,
                   n_steps: int | None = None,
                   corrector_disabled: bool = False) -> TensorDict:
        """Forward, backward, gradient clipping, optimizer update and EMA
        update. Returns the loss metrics and ``grad_norm`` (the global norm
        of the gradients before clipping), detached tensors on the device;
        nothing here waits for the device."""
        params = self.parameters()
        for p in params:
            p.grad = None
        total, metrics = self.loss_fn(batch, generator, n_steps,
                                      corrector_disabled=corrector_disabled)
        total.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = self.optimization.step(params, grads)
        del grads
        for p in params:
            p.grad = None
        if self.ema is not None:
            if self.ema.ema_params is None:
                self.ema.init(params)
            self.ema(params)
        return metrics

    def valid_step(self, batch: TensorMapping,
                   generator: torch.Generator | None,
                   n_steps: int | None = None) -> TensorDict:
        """The loss metrics without gradients or updates."""
        with torch.no_grad():
            _, metrics = self.loss_fn(batch, generator, n_steps,
                                      deterministic=True)
        return metrics

    def init(self, generator: torch.Generator | None = None):
        """Draw the weights with ``generator`` and start the optimizer
        state and the EMA from them."""
        self.stepper.init_params(generator)
        params = self.parameters()
        self.optimization.init(params)
        if self.ema is not None:
            self.ema.init(params)


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return tree
