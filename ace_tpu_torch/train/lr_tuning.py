"""Per-epoch learning-rate tuning trial (port of
ace_tpu/train/lr_tuning.py).

Before an epoch, the current weights are trained for ``num_batches``
batches twice, with plain Adam: at the current learning rate (the
baseline) and at ``current_lr * lr_factor`` (the candidate). If the
candidate's validation loss beats the baseline's by at least
``improvement_threshold`` (relative), the trainer adopts the candidate
(``Optimization.scale_lr``). The trials train a copy of the weights
swapped into the module (``TrainStepper.weights_swapped``), each from the
starting weights, so the training weights stay untouched, and a restart
checkpoint saved meanwhile holds them.
"""

import dataclasses
import logging

import torch

from ace_tpu_torch.core.optimization import OptimizationConfig


@dataclasses.dataclass
class LRTuningConfig:
    """(port of ace_tpu/train/lr_tuning.py:21)."""

    enabled: bool = False
    lr_factor: float = 0.5
    num_batches: int = 10
    improvement_threshold: float = 0.0


def run_lr_tuning_trial(config: LRTuningConfig, train_stepper,
                        current_lr: float, train_batches, valid_batches,
                        generator: torch.Generator | None) -> float | None:
    """The candidate learning rate if it wins, else None.

    ``train_batches`` and ``valid_batches`` are lists of batch dicts (the
    first batches of the epoch); the losses are ``train_stepper.loss_fn``'s
    at its full rollout length. Reads the validation losses on the host.
    Under the train stepper's data-parallel ``placement`` the batches are
    this rank's rows, and the gradients and losses are averaged over the
    ranks, so that every rank takes the same decision.
    """
    placement = train_stepper.placement
    params = train_stepper.parameters()
    with torch.no_grad():
        trial = [p.detach().clone() for p in params]
    # inside the swap ``params`` are the trial's weights and ``trial``
    # holds the starting ones

    def restore():
        with torch.no_grad():
            for p, s in zip(params, trial):
                p.copy_(s)

    def short_train(lr):
        restore()
        optimization = OptimizationConfig(optimizer_type="Adam",
                                          lr=lr).build(max_epochs=1)
        optimization.init(params)
        for batch in train_batches[: config.num_batches]:
            for p in params:
                p.grad = None
            loss, _ = train_stepper.loss_fn(batch, generator)
            loss.backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            if placement is not None:
                placement.mean_(grads)
            optimization.step(params, grads)
        for p in params:
            p.grad = None

    def validate() -> float:
        losses = []
        with torch.no_grad():
            for batch in valid_batches:
                losses.append(train_stepper.loss_fn(batch, generator)[0])
        if not losses:
            return 0.0
        mean = torch.stack(losses).mean()
        if placement is not None:
            placement.mean_([mean])
        return float(mean)

    candidate_lr = current_lr * config.lr_factor
    with train_stepper.weights_swapped(trial):
        short_train(current_lr)
        baseline_loss = validate()
        short_train(candidate_lr)
        candidate_loss = validate()
    logging.info(
        f"LR trial: baseline(lr={current_lr:.2e})={baseline_loss:.5f}, "
        f"candidate(lr={candidate_lr:.2e})={candidate_loss:.5f}"
    )
    if candidate_loss < baseline_loss * (1.0 - config.improvement_threshold):
        return candidate_lr
    return None
