"""Training stepper: multi-step rollout loss, backward and optimizer update
(port of ace_tpu/stepper/train.py).

Where the JAX package compiles loss, gradient and update into one program,
the port runs them eagerly: ``loss_fn`` is a Python loop over the rollout
steps (the ensemble folded into the batch), ``train_step`` calls
``backward`` and the optimizer (``core/optimization.py``), and nothing in
it waits for the device: the metrics it returns are tensors on the device.
Activation checkpointing: the model's own per-block ``checkpointing`` (the
flagship recipe), and ``CheckpointConfig.after_n_forward_steps`` or
``remat`` as a whole-step ``torch.utils.checkpoint``. With
``optimize_last_step_only`` every step but the last runs under
``torch.no_grad()`` (the JAX package stops the gradient there), so a
20-step sample holds one step's saved activations, not twenty.

Fine-tuning (``parameter_init``): ``init`` loads the base checkpoint's
weights, frozen parameters keep theirs (the optimizer zeroes their
updates), the L2-SP term joins the loss with the base weights held on the
device as constants, and ``copy_weights`` (set by the trainer) resets a
subset of weights after each optimizer step, before the EMA.
"""

import contextlib
import dataclasses

import torch
import torch.utils.checkpoint

from ace_tpu_torch.core.loss import StepLossConfig, complex_sht
from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
from ace_tpu_torch.core.schedule import (
    TimeLengthProbabilities,
    TimeLengthSchedule,
    probabilities_from_time_length,
)
from ace_tpu_torch.core.step import StepArgs
from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping
from ace_tpu_torch.models.layers import replaying
from ace_tpu_torch.ops.sht import RealSHT
from ace_tpu_torch.stepper.parameter_init import (
    ParameterInitializationConfig,
    read_base_weights,
)
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
        earlier steps run without gradient.
    parameter_init: fine-tuning options.
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


# blocks of ``signals_deferred`` open now, and the handler calls that
# wait for their end (Python runs signal handlers in the main thread, so
# these need no lock)
_deferral: dict = {"depth": 0, "pending": []}


@contextlib.contextmanager
def signals_deferred():
    """A handler wrapped by :func:`deferrable` whose signal comes inside the
    block runs at the block's end instead, so that a handler that saves a
    restart checkpoint never sees a state that the block has changed only
    in part. (A signal mask would not do: the process's other threads
    take the signal, and Python runs the handler in the main thread all
    the same.)"""
    _deferral["depth"] += 1
    try:
        yield
    finally:
        _deferral["depth"] -= 1
        if _deferral["depth"] == 0 and _deferral["pending"]:
            handler, signum, frame = _deferral["pending"][0]
            _deferral["pending"].clear()
            handler(signum, frame)


def deferrable(handler):
    """``handler`` as a signal handler that waits for the end of any open
    :func:`signals_deferred` block (the first signal of a block runs)."""

    def run_or_defer(signum, frame):
        if _deferral["depth"]:
            _deferral["pending"].append((handler, signum, frame))
        else:
            handler(signum, frame)

    return run_or_defer


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
            if len(info.img_shape) == 2:
                nlat, nlon = info.img_shape
                self.loss_sht = RealSHT(
                    nlat, nlon, grid=info.horizontal_coordinates.grid,
                    device=stepper.device)
            else:
                # HEALPix: the grid's channels-last SHT
                self.loss_sht = info.gridded_operations.get_real_sht(
                    device=stepper.device)
            sht = complex_sht(self.loss_sht)
        config = step.config
        if hasattr(config, "get_loss_normalizer"):
            # a multi-call step's suffixed outputs share their base
            # variable's statistics
            loss_normalizer = config.get_loss_normalizer(
                residual_scaled_names=step.prognostic_names)
        else:
            loss_normalizer = config.normalization.build_loss_normalizer(
                config._normalize_names,
                residual_scaled_names=step.prognostic_names,
            )
        # the loss's names: a multi-call step's suffixed outputs only with
        # include_multi_call_in_loss (ace_tpu takes every output, and so
        # wants targets for the suffixed names even without it)
        self.step_loss = train_config.loss.build(
            info.gridded_operations,
            out_names=step.loss_names,
            normalizer=loss_normalizer,
            sht=sht,
        )
        self.optimization = optimization_config.build(
            max_epochs=max_epochs, steps_per_epoch=steps_per_epoch
        )
        frozen = train_config.parameter_init.frozen_parameters
        if frozen is not None:
            mask = frozen.frozen_mask(self.module.state_dict())
            self.optimization.set_frozen(
                [mask[n] for n in self.parameter_names()])
        self.ema = ema_config.build() if ema_config is not None else None
        # the base weights of the L2-SP term, on the device (read when
        # first needed: a resumed run does not call init)
        self._base: dict[str, torch.Tensor] | None = None
        # set by the trainer: resets a subset of weights after each update
        self.copy_weights = None
        # set by the trainer under a data-parallel mesh: its
        # ``BatchPlacement``, whose ``mean_`` averages the gradients over
        # the ranks
        self.placement = None
        self._length_sampler: TimeLengthProbabilities | None = None
        self._sampler_epoch: int | None = None
        # the tensors that hold the training weights while
        # ``weights_swapped`` holds, else None
        self._swapped: list[torch.Tensor] | None = None

    @property
    def module(self) -> torch.nn.Module:
        return self.stepper.module

    def parameters(self) -> list[torch.Tensor]:
        return [p for p in self.module.parameters() if p.requires_grad]

    def parameter_names(self) -> list[str]:
        """The ``state_dict`` names of :meth:`parameters`, in their order
        (the order of the optimizer's moments and the EMA's weights)."""
        return [n for n, p in self.module.named_parameters()
                if p.requires_grad]

    def sample_n_forward_steps(self, epoch: int = 0) -> int:
        """The rollout length of one batch in ``epoch``, drawn on the host
        from the schedule's probabilities for that epoch; a constant
        schedule returns its length without drawing."""
        if self._sampler_epoch != epoch:
            self._length_sampler = probabilities_from_time_length(
                self.train_config.n_forward_steps_schedule.get_value(epoch)
            )
            self._sampler_epoch = epoch
        if self._length_sampler.is_constant:
            return self._length_sampler.max_n_forward_steps
        return self._length_sampler.sample()

    @property
    def corrector_disabled_epochs(self) -> int:
        """Initial epochs in which train steps skip the corrector."""
        corrector = getattr(self.stepper.step.config, "corrector", None)
        return int(getattr(corrector, "corrector_disabled_epochs", 0))

    @property
    def effective_loss_scaling(self) -> dict[str, float]:
        """Each output's final loss scale: the loss normalizer's std over
        the variable's weight."""
        weights = self.train_config.loss.weights
        stds = self.step_loss.loss.normalizer.stds
        return {k: stds[k] / weights.get(k, 1.0)
                for k in self.stepper.step.output_names}

    def _drop_weight_caches(self):
        for m in self.module.modules():
            if hasattr(m, "drop_weight_cache"):
                m.drop_weight_cache()

    def _exchange(self, tensors: list[torch.Tensor]):
        """Exchange the parameters' storages with ``tensors``' and drop the
        layers' bf16 weight copies for calls without grad (they follow an
        exchange by their keys anyway; dropped, the other weights' copies
        do not stay in memory)."""
        with torch.no_grad():
            for p, t in zip(self.parameters(), tensors):
                p.data, t.data = t.data, p.data
        self._drop_weight_caches()

    @contextlib.contextmanager
    def weights_swapped(self, tensors: list[torch.Tensor]):
        """Run the module with ``tensors`` (in :meth:`parameters`' order,
        e.g. the EMA's) as its weights, without a second copy of the
        module: the parameters and ``tensors`` exchange their storages on
        entry and exchange them back on exit, so both come out bit for bit
        as they went in. Inside, :meth:`training_weights` undoes the swap
        for its own block."""
        if len(tensors) != len(self.parameters()):
            raise ValueError(f"{len(tensors)} tensors for "
                             f"{len(self.parameters())} parameters")
        if self._swapped is not None:
            raise RuntimeError("the weights are swapped already")
        with signals_deferred():
            self._exchange(tensors)
            self._swapped = tensors
        try:
            yield
        finally:
            with signals_deferred():
                self._swapped = None
                self._exchange(tensors)

    @contextlib.contextmanager
    def training_weights(self):
        """The module with the training weights for the block: inside
        :meth:`weights_swapped` the swap is undone on entry and made again
        on exit (a restart checkpoint saved from a signal handler), and
        both sides hold their own weights meanwhile."""
        tensors = self._swapped
        if tensors is None:
            yield
            return
        with signals_deferred():
            self._swapped = None
            self._exchange(tensors)
        try:
            yield
        finally:
            with signals_deferred():
                self._exchange(tensors)
                self._swapped = tensors

    def loss_fn(self, batch: TensorMapping,
                generator: torch.Generator | None,
                n_steps: int | None = None, deterministic: bool = False,
                corrector_disabled: bool = False,
                labels: torch.Tensor | None = None,
                data_mask: TensorMapping | None = None
                ) -> tuple[torch.Tensor, TensorDict]:
        """Rollout loss over ``n_steps`` (default: the schedule's maximum).

        ``batch`` maps every input, forcing and target variable to ``[B,
        n_forward + 1, ...spatial]`` (index 0 the initial condition);
        ``generator`` draws the model's noise; ``labels`` ``[B, n_labels]``
        and ``data_mask`` (a variable's ``[B]`` presence) are the batch's,
        repeated over the ensemble for the step; the loss reads the mask
        over the batch. Returns ``(total, metrics)`` with
        ``metrics["loss"]`` and ``metrics["loss_step_<i>"]``.
        """
        step = self.stepper.step
        cfg = self.train_config
        if n_steps is None:
            n_steps = cfg.max_n_forward_steps
        prognostic_names = step.prognostic_names
        input_only = sorted(set(step.input_names) - set(step.output_names))
        nsf = set(step.next_step_forcing_names)
        nsi = step.next_step_input_names
        out_names = step.loss_names
        n_ens = cfg.n_ensemble

        def expand_ens(x):
            # fold the ensemble into the batch, member-minor as
            # jnp.repeat: [B, ...] -> [B*E, ...]
            return x if n_ens == 1 else x.repeat_interleave(n_ens, dim=0)

        if labels is not None:
            labels = expand_ens(labels)
        step_mask = (None if data_mask is None else
                     {k: expand_ens(v) for k, v in data_mask.items()})
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
                labels=labels,
                data_mask=step_mask,
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
            step_loss = self.step_loss(gen, target, t,
                                       data_mask=data_mask).total
            new_state = {k: masked[k] for k in prognostic_names}
            return step_loss, new_state, out.stepper_state

        if cfg.remat:
            split = 0
        else:
            after = self.optimization.config.checkpoint.after_n_forward_steps
            split = n_steps if after >= n_steps else max(int(after), 0)
        per_step = []
        for t in range(n_steps):
            # only the last step's call sees gradient: the earlier ones keep
            # no graph (their losses are metrics)
            no_grad = cfg.optimize_last_step_only and t < n_steps - 1
            with torch.no_grad() if no_grad else contextlib.nullcontext():
                if t >= split and torch.is_grad_enabled():
                    step_loss, state, stepper_state = (
                        torch.utils.checkpoint.checkpoint(
                            replaying(body, generator), t, state,
                            stepper_state, use_reentrant=False,
                            preserve_rng_state=False,
                        )
                    )
                else:
                    step_loss, state, stepper_state = body(t, state,
                                                           stepper_state)
            if no_grad and t == n_steps - 2 and torch.is_grad_enabled():
                # the last step casts the weights in its graph and does not
                # read the bf16 copies the calls without grad cached;
                # dropped, they do not add to its peak
                self._drop_weight_caches()
            per_step.append(step_loss)
        total = per_step[-1] if cfg.optimize_last_step_only else sum(per_step)
        pinit = cfg.parameter_init
        if pinit.regularized:
            total = total + pinit.regularizer_loss(
                dict(zip(self.parameter_names(), self.parameters())),
                self.base_weights())
        metrics = {"loss": total}
        for i, loss in enumerate(per_step):
            metrics[f"loss_step_{i}"] = loss
        return total, metrics

    def train_step(self, batch: TensorMapping,
                   generator: torch.Generator | None,
                   n_steps: int | None = None,
                   corrector_disabled: bool = False,
                   labels: torch.Tensor | None = None,
                   data_mask: TensorMapping | None = None) -> TensorDict:
        """Forward, backward, gradient clipping, optimizer update and EMA
        update (``labels`` and ``data_mask`` as :meth:`loss_fn` takes them).
        Under a data-parallel ``placement`` the gradients are averaged over
        the ranks between the backward and the optimizer (once per call,
        so once per micro-step under gradient accumulation, as
        ``ace_tpu``'s psum in its compiled step), and every rank clips and
        updates from the same gradients. Returns this rank's loss metrics
        and ``grad_norm`` (the global norm of the averaged gradients before
        clipping), detached tensors on the device; nothing here waits for
        the device."""
        params = self.parameters()
        for p in params:
            p.grad = None
        total, metrics = self.loss_fn(batch, generator, n_steps,
                                      corrector_disabled=corrector_disabled,
                                      labels=labels, data_mask=data_mask)
        total.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.placement is not None:
            self.placement.mean_(grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = self.optimization.step(params, grads)
        del grads
        for p in params:
            p.grad = None
        if self.copy_weights is not None:
            self.copy_weights.apply(self.module.state_dict())
        if self.ema is not None:
            if self.ema.ema_params is None:
                self.ema.init(params)
            self.ema(params)
        return metrics

    def valid_step(self, batch: TensorMapping,
                   generator: torch.Generator | None,
                   n_steps: int | None = None,
                   labels: torch.Tensor | None = None,
                   data_mask: TensorMapping | None = None) -> TensorDict:
        """The loss metrics without gradients or updates."""
        with torch.no_grad():
            _, metrics = self.loss_fn(batch, generator, n_steps,
                                      deterministic=True, labels=labels,
                                      data_mask=data_mask)
        return metrics

    def base_weights(self) -> dict[str, torch.Tensor] | None:
        """The base checkpoint's weights on the device (None without a
        base), read on first use."""
        path = self.train_config.parameter_init.weights_path
        if self._base is None and path is not None:
            base, _ = read_base_weights(path)
            self._base = {k: v.to(self.stepper.device)
                          for k, v in base.items()}
        return self._base

    def init(self, generator: torch.Generator | None = None):
        """Draw the weights with ``generator``, load the base checkpoint's
        over them when fine-tuning, and start the optimizer state and the
        EMA from them."""
        self.stepper.init_params(generator)
        pinit = self.train_config.parameter_init
        base = pinit.apply_weights(self.stepper)
        if base is not None and pinit.regularized:
            self._base = {k: v.to(self.stepper.device)
                          for k, v in base.items()}
        params = self.parameters()
        self.optimization.init(params)
        if self.ema is not None:
            self.ema.init(params)

