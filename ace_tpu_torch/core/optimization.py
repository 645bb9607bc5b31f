"""Optimizer, learning-rate schedules and EMA (port of
ace_tpu/core/optimization.py, which builds them on optax).

Adam and AdamW are written out in PyTorch with optax's arithmetic
(``scale_by_adam``, ``add_decayed_weights``, ``scale_by_learning_rate``,
``clip_by_global_norm``):

- the first moment is updated in float32 from its stored value, decayed in
  its storage dtype as optax does (``b1 * mu`` rounds to bf16 when ``mu``
  is bf16), and cast to ``first_moment_dtype`` only for storage, which
  ``torch.optim.AdamW`` cannot do;
- ``eps`` sits outside the square root, the bias corrections use the
  update count, and AdamW's weight decay (default 0.01, on every
  parameter) is added after the Adam scaling and before the learning rate;
- clipping by the global norm computes ``(g / norm) * max_norm`` where
  ``norm >= max_norm`` and leaves ``g`` otherwise, with no ``1e-6`` (unlike
  ``torch.nn.utils.clip_grad_norm_``), through ``torch.where``: nothing
  waits for the device.

Schedules are functions of the update count (a host integer), so the
learning rate is a host float and an update needs no device sync.
"""

import dataclasses
import logging
import math
from typing import Any, Callable, Mapping

import numpy as np
import torch

Schedule = Callable[[int], float]


@dataclasses.dataclass
class SchedulerConfig:
    """LR scheduler config, after the torch.optim.lr_scheduler names:
    CosineAnnealingLR, CosineAnnealingWarmRestarts, StepLR, ExponentialLR,
    LinearLR, ConstantLR, OneCycleLR (a subset of kwargs each). Without
    ``step_each_iteration`` the schedule advances once per epoch: the
    update count is floored to epochs."""

    type: str | None = None
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    step_each_iteration: bool = False

    def build(self, base_lr: float, max_epochs: int,
              steps_per_epoch: int = 1) -> Schedule:
        """A function from the update count to the learning rate."""
        kw = dict(self.kwargs)
        per_epoch = not self.step_each_iteration

        def epochs(count):
            return count // steps_per_epoch if per_epoch else count

        if self.type is None:
            return lambda count: base_lr
        if self.type == "CosineAnnealingLR":
            t_max = kw.get("T_max", max_epochs)
            eta_min = kw.get("eta_min", 0.0)

            def schedule(count):
                t = min(epochs(count), t_max)
                return eta_min + (base_lr - eta_min) * 0.5 * (
                    1 + math.cos(math.pi * t / t_max)
                )
            return schedule
        if self.type == "CosineAnnealingWarmRestarts":
            t0 = kw.get("T_0", max_epochs)
            eta_min = kw.get("eta_min", 0.0)

            def schedule(count):
                t = epochs(count) % t0
                return eta_min + (base_lr - eta_min) * 0.5 * (
                    1 + math.cos(math.pi * t / t0)
                )
            return schedule
        if self.type == "StepLR":
            step_size = kw.get("step_size", 1)
            gamma = kw.get("gamma", 0.1)
            return lambda count: base_lr * gamma ** (epochs(count) // step_size)
        if self.type == "ExponentialLR":
            gamma = kw["gamma"]
            return lambda count: base_lr * gamma ** epochs(count)
        if self.type == "LinearLR":
            start = kw.get("start_factor", 1.0 / 3)
            end = kw.get("end_factor", 1.0)
            total = kw.get("total_iters", 5)

            def schedule(count):
                frac = min(epochs(count) / total, 1.0)
                return base_lr * (start + (end - start) * frac)
            return schedule
        if self.type == "ConstantLR":
            factor = kw.get("factor", 1.0 / 3)
            total = kw.get("total_iters", 5)
            return lambda count: base_lr * (
                factor if epochs(count) < total else 1.0
            )
        if self.type == "OneCycleLR":
            max_lr = kw.get("max_lr", base_lr)
            total = kw["total_steps"]
            pct_start = kw.get("pct_start", 0.3)
            div_factor = kw.get("div_factor", 25.0)
            final_div_factor = kw.get("final_div_factor", 1e4)
            initial = max_lr / div_factor
            final = initial / final_div_factor
            up = pct_start * total

            def schedule(count):
                t = epochs(count)
                if t < up:
                    return initial + (max_lr - initial) * 0.5 * (
                        1 - math.cos(math.pi * min(t / up, 1.0))
                    )
                t2 = min(max((t - up) / (total - up), 0.0), 1.0)
                return final + (max_lr - final) * 0.5 * (
                    1 + math.cos(math.pi * t2)
                )
            return schedule
        raise NotImplementedError(f"scheduler type {self.type!r}")


@dataclasses.dataclass
class SequentialSchedulerConfig:
    """Schedulers one after the other. ``milestones[i]`` is the epoch (or
    iteration, with ``step_each_iteration``) at which ``schedulers[i+1]``
    takes over; each restarts its own clock there (optax.join_schedules)."""

    schedulers: list[SchedulerConfig]
    milestones: list[int]
    last_epoch: int = -1

    def __post_init__(self):
        if not self.schedulers:
            raise ValueError("schedulers must be non-empty")
        if len(self.milestones) != len(self.schedulers) - 1:
            raise ValueError(
                "milestones must have one fewer entry than schedulers"
            )
        if any(
            s.step_each_iteration != self.schedulers[0].step_each_iteration
            for s in self.schedulers
        ):
            raise ValueError(
                "All SchedulerConfigs in the SequentialSchedulerConfig "
                "must have identical values for step_each_iteration."
            )

    @property
    def type(self) -> str:
        return "Sequential"

    @property
    def step_each_iteration(self) -> bool:
        return self.schedulers[0].step_each_iteration

    def build(self, base_lr: float, max_epochs: int,
              steps_per_epoch: int = 1) -> Schedule:
        children = [
            s.build(base_lr, max_epochs, steps_per_epoch)
            for s in self.schedulers
        ]
        scale = 1 if self.step_each_iteration else steps_per_epoch
        boundaries = [m * scale for m in self.milestones]

        def schedule(count):
            start = 0
            for child, boundary in zip(children, boundaries):
                if count < boundary:
                    return child(count - start)
                start = boundary
            return children[-1](count - start)
        return schedule


@dataclasses.dataclass
class CheckpointConfig:
    """Activation checkpointing: rollout steps with index >=
    ``after_n_forward_steps`` are recomputed in the backward pass
    (``torch.utils.checkpoint``). ``kwargs`` is accepted for config
    compatibility and ignored, as in the JAX package."""

    after_n_forward_steps: float = float("inf")
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kwargs:
            logging.warning(
                "CheckpointConfig.kwargs %s are ignored", dict(self.kwargs)
            )


_MOMENT_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                  "float16": torch.float16}


@dataclasses.dataclass
class OptimizationConfig:
    """Optimizer config (the JAX package's fields).
    ``enable_automatic_mixed_precision`` is accepted and ignored: bf16
    compute is the model's dtype. Gradient accumulation and resuming the
    optimizer from another checkpoint are not ported yet."""

    optimizer_type: str = "Adam"  # "Adam" | "AdamW" | "FusedAdam"
    lr: float = 0.001
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    enable_automatic_mixed_precision: bool = False
    scheduler: SchedulerConfig | SequentialSchedulerConfig = (
        dataclasses.field(default_factory=SchedulerConfig)
    )
    max_grad_norm: float | None = None
    use_gradient_accumulation: bool = False
    gradient_accumulation_steps: int = 1
    checkpoint: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig
    )
    resume_optimizer_ckpt_path: str | None = None
    # storage dtype of the Adam first moment (e.g. "bfloat16"); the update
    # math runs in float32
    first_moment_dtype: str | None = None

    def __post_init__(self):
        if self.gradient_accumulation_steps > 1:
            raise NotImplementedError(
                "gradient_accumulation_steps > 1 is not ported yet"
            )
        if self.resume_optimizer_ckpt_path is not None:
            raise NotImplementedError(
                "resume_optimizer_ckpt_path is not ported yet"
            )
        if self.optimizer_type not in ("Adam", "AdamW", "FusedAdam"):
            raise NotImplementedError(
                f"optimizer type {self.optimizer_type!r}"
            )
        if (self.first_moment_dtype is not None
                and self.first_moment_dtype not in _MOMENT_DTYPES):
            raise ValueError(
                f"first_moment_dtype {self.first_moment_dtype!r}"
            )

    @property
    def has_lr_schedule(self) -> bool:
        if isinstance(self.scheduler, SequentialSchedulerConfig):
            return True
        return self.scheduler.type is not None

    def build(self, max_epochs: int, steps_per_epoch: int = 1
              ) -> "Optimization":
        return Optimization(
            self, self.scheduler.build(self.lr, max_epochs, steps_per_epoch)
        )


class Optimization:
    """Adam or AdamW state and update over a list of parameters."""

    def __init__(self, config: OptimizationConfig, schedule: Schedule):
        self.config = config
        self.schedule = schedule
        kw = dict(config.kwargs)
        self.b1, self.b2 = kw.pop("betas", (0.9, 0.999))
        self.eps = kw.pop("eps", 1e-8)
        weight_decay = kw.pop("weight_decay", None)
        if config.optimizer_type == "AdamW":
            # optax.adamw's default, on every parameter
            self.weight_decay = 0.01 if weight_decay is None else weight_decay
            self.decay_before_adam = False
        else:
            # Adam: optional L2 added to the gradient before the scaling
            self.weight_decay = weight_decay or 0.0
            self.decay_before_adam = True
        self.mu_dtype = _MOMENT_DTYPES.get(config.first_moment_dtype)
        self._count = 0
        self.mu: list[torch.Tensor] | None = None
        self.nu: list[torch.Tensor] | None = None

    @property
    def learning_rate(self) -> float:
        return self.schedule(self._count)

    def init(self, params: list[torch.Tensor]):
        """Zero moments for ``params`` (the first in ``first_moment_dtype``,
        else in each parameter's dtype)."""
        with torch.no_grad():
            self.mu = [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                       for p in params]
            self.nu = [torch.zeros_like(p) for p in params]
        self._count = 0

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor]):
        """One update of ``params`` in place from ``grads``: clip, Adam or
        AdamW, learning rate. Returns the global norm of ``grads`` before
        clipping, a tensor on the device."""
        if self.mu is None:
            self.init(params)
        norm = global_norm(grads)
        max_norm = self.config.max_grad_norm
        if max_norm is not None:
            trigger = norm < max_norm
        b1, b2 = self.b1, self.b2
        count = self._count + 1
        # 1 - b ** count in float32, as optax's bias_correction
        c1 = float(1 - np.float32(b1) ** np.float32(count))
        c2 = float(1 - np.float32(b2) ** np.float32(count))
        lr = self.learning_rate
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            if max_norm is not None:
                g = torch.where(trigger, g, (g / norm) * max_norm)
            if self.decay_before_adam and self.weight_decay:
                g = g + self.weight_decay * p
            # optax: (1 - b1) g + b1 mu, the second product in mu's dtype
            # (b1 rounded to it first, as JAX's weak-typed scalar is)
            b1_mu = float(torch.tensor(b1, dtype=mu.dtype))
            m = g * (1 - b1) + mu * b1_mu
            nu.mul_(b2).add_(g * g * (1 - b2))
            u = (m / c1) / (torch.sqrt(nu / c2) + self.eps)
            if not self.decay_before_adam and self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(u * -lr)
            mu.copy_(m)
        self._count = count
        return norm


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over all tensors, float32, on the device."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class NullOptimization:
    """No-op optimization used for validation."""

    def init(self, params):
        return None

    def step(self, params, grads):
        return None

    @property
    def learning_rate(self) -> float:
        return float("nan")


@dataclasses.dataclass
class EMAConfig:
    """Exponential moving average of the parameters."""

    decay: float = 0.9999
    use_num_updates: bool = True

    def build(self) -> "EMATracker":
        return EMATracker(
            decay=self.decay, use_num_updates=self.use_num_updates
        )


class EMATracker:
    """EMA with a decay ramp-up: effective decay = min(decay, (1 + n) /
    (10 + n)) after n updates. Keeps float32 copies on the parameters'
    device, updated in place."""

    def __init__(self, decay: float, use_num_updates: bool = True):
        if decay < 0.0 or decay > 1.0:
            raise ValueError("decay must be in [0, 1]")
        self.decay = decay
        self.use_num_updates = use_num_updates
        self.ema_params: list[torch.Tensor] | None = None
        self.num_updates = 0

    @torch.no_grad()
    def init(self, params: list[torch.Tensor]):
        self.ema_params = [p.detach().clone() for p in params]
        self.num_updates = 0

    @torch.no_grad()
    def __call__(self, params: list[torch.Tensor]) -> list[torch.Tensor]:
        """Move the average toward ``params`` (once per optimizer step)."""
        self.num_updates += 1
        if self.use_num_updates:
            decay = min(
                self.decay, (1 + self.num_updates) / (10 + self.num_updates)
            )
        else:
            decay = self.decay
        one_minus = 1.0 - decay
        for e, p in zip(self.ema_params, params):
            e.sub_((e - p) * one_minus)
        return self.ema_params
