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
from ace_tpu_torch.models.layers import init_weights

StepperState = dict


@dataclasses.dataclass
class StepArgs:
    """Arguments to ``step``. ``generator`` draws the model's noise; with
    None the noise is zero (the JAX model without a "noise" rng).
    ``deterministic`` turns off dropout and drop-path (the SFNO's random
    layers, which draw from ``generator``; the noise is drawn either way,
    as in the JAX package);
    ``corrector_disabled`` skips the post-step corrector (the train loop
    sets it during the first ``corrector_disabled_epochs``); ``labels``
    are one-hot dataset labels ``[batch, n_labels]``, passed to a module
    with ``n_labels`` set (the FCN3 step refuses them, as ``ace_tpu``'s
    does); ``data_mask`` maps a variable some samples lack to its
    ``[batch]`` presence (1 present, 0 missing), None when all are
    present."""

    input: TensorMapping
    next_step_input_data: TensorMapping
    stepper_state: StepperState
    generator: torch.Generator | None = None
    deterministic: bool = True
    corrector_disabled: bool = False
    labels: torch.Tensor | None = None
    data_mask: TensorMapping | None = None


@dataclasses.dataclass
class StepOutput:
    output: TensorDict
    stepper_state: StepperState
    corrector_diagnostics: TensorDict = dataclasses.field(default_factory=dict)


class StepConfigBase:
    """The name sets every step config derives from its input and output
    names (port of ace_tpu/core/step/base.py:StepConfigABC)."""

    @property
    def prognostic_names(self) -> list[str]:
        return sorted(set(self.output_names) & set(self.input_names))

    @property
    def loss_names(self) -> list[str]:
        return self.output_names

    def get_next_step_forcing_names(self) -> list[str]:
        return list(getattr(self, "next_step_forcing_names", []))


class StepBase:
    """A step's name sets, read from its config (port of
    ace_tpu/core/step/base.py:StepABC). ``module`` holds every weight of
    the step: one network, or an ``nn.ModuleDict`` keyed as the JAX
    package keys the parameter tree of a step with several."""

    n_ic_timesteps = 1
    corrector = None

    @property
    def input_names(self) -> list[str]:
        return self.config.input_names

    @property
    def output_names(self) -> list[str]:
        return self.config.output_names

    @property
    def prognostic_names(self) -> list[str]:
        return self.config.prognostic_names

    @property
    def loss_names(self) -> list[str]:
        return self.config.loss_names

    @property
    def next_step_input_names(self) -> list[str]:
        return self.config.next_step_input_names

    @property
    def next_step_forcing_names(self) -> list[str]:
        return self.config.get_next_step_forcing_names()

    def init_params(self, generator: torch.Generator | None = None):
        """Draw the step's weights with ``generator``."""
        init_weights(self.module, generator)

    def init_stepper_state(self, input_data: TensorMapping) -> StepperState:
        """The per-sample state of a rollout: the corrector's references,
        from the initial condition."""
        state: StepperState = {}
        if self.corrector is not None:
            state["corrector"] = self.corrector.init_state(input_data)
        return state


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

    @property
    def allow_missing_variables(self) -> bool:
        """Whether the loader may give presence masks for missing
        variables: True if any of the step's module builders allows it
        (port of ace_tpu/core/step/base.py:169)."""
        for field in ("builder", "radiation_builder", "secondary_builder"):
            builder = getattr(self.instance, field, None)
            if builder is not None and getattr(
                    builder, "allow_missing_variables", False):
                return True
        return False
