"""Single-timestep transition contract (port of ace_tpu/core/step/base.py).

A step maps denormalized input fields at time t (plus next-step forcing
data) to denormalized output fields at time t+dt. The module's weights
live in the step's ``nn.Module``; the per-sample stepper state (corrector
references) is threaded through the rollout explicitly.
"""

import dataclasses

import torch

from ace_tpu_torch.core.registry import Registry, Selector
from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping

StepperState = dict


@dataclasses.dataclass
class StepArgs:
    """Arguments to ``step``. ``generator`` draws the model's noise; with
    None the noise is zero (the JAX model without a "noise" rng).
    ``deterministic`` turns off dropout and drop-path (the SFNO's random
    layers, which draw from ``generator``; the noise is drawn either way,
    as in the JAX package);
    ``corrector_disabled`` skips the post-step corrector (the train loop
    sets it during the first ``corrector_disabled_epochs``)."""

    input: TensorMapping
    next_step_input_data: TensorMapping
    stepper_state: StepperState
    generator: torch.Generator | None = None
    deterministic: bool = True
    corrector_disabled: bool = False


@dataclasses.dataclass
class StepOutput:
    output: TensorDict
    stepper_state: StepperState
    corrector_diagnostics: TensorDict = dataclasses.field(default_factory=dict)


class StepSelector(Selector):
    """``{type, config}`` step selection."""

    _registry: Registry = Registry()

    @classmethod
    def get_registry(cls) -> Registry:
        return cls._registry

    @classmethod
    def register(cls, name: str):
        return cls._registry.register(name)

    def get_step(self, dataset_info, device=None):
        return self.instance.get_step(dataset_info, device=device)
