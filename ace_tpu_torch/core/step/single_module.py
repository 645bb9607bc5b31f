"""The default single-module step (port of
ace_tpu/core/step/single_module.py).

Per step: normalize inputs -> pack channels -> module forward -> unpack ->
denormalize -> corrector -> ocean SST prescription -> prescribed
prognostic overwrite. Global-mean removal, input dropout, channel-mask
inputs and the secondary decoder are not ported yet: their config fields
are accepted at their defaults and raise otherwise.
"""

import dataclasses
from typing import Any

import torch

from ace_tpu_torch.core.config import to_dict
from ace_tpu_torch.core.corrector.atmosphere import AtmosphereCorrectorConfig
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.normalizer import (
    NetworkAndLossNormalizationConfig,
    StandardNormalizer,
)
from ace_tpu_torch.core.ocean import OceanConfig
from ace_tpu_torch.core.packer import Packer
from ace_tpu_torch.core.step.base import (
    StepArgs,
    StepOutput,
    StepperState,
    StepSelector,
)
from ace_tpu_torch.core.typing_ import TensorMapping
from ace_tpu_torch.device import get_device
from ace_tpu_torch.models.layers import init_weights
from ace_tpu_torch.models.registry import ModuleSelector


def step_with_adjustments(args: StepArgs, network_call, normalizer, corrector,
                          ocean, residual_prediction: bool,
                          prognostic_names: list[str],
                          prescribed_prognostic_names: list[str]) -> StepOutput:
    """The step pipeline around the network call
    ``network_call(input_norm, generator) -> output_norm``."""
    input_data = args.input
    next_step_input_data = args.next_step_input_data
    input_norm = normalizer.normalize(dict(input_data))
    output_norm = network_call(input_norm, args.generator)
    if residual_prediction:
        for name in prognostic_names:
            output_norm[name] = output_norm[name] + input_norm[name]
    output = normalizer.denormalize(output_norm)

    stepper_state = dict(args.stepper_state)
    diagnostics = {}
    if corrector is not None and args.corrector_disabled:
        corrector = None
    if corrector is not None:
        result = corrector(
            input_data, output, next_step_input_data,
            stepper_state.get("corrector", {}),
        )
        output = result.corrected
        diagnostics = result.delta
        stepper_state["corrector"] = result.corrector_state
    if ocean is not None:
        if ocean.surface_temperature_name in diagnostics:
            raise ValueError(
                "ocean-prescribed names overlap corrector-modified names: "
                f"{ocean.surface_temperature_name}"
            )
        output = ocean(input_data, output, next_step_input_data)
    for name in prescribed_prognostic_names:
        if name not in next_step_input_data:
            raise ValueError(
                f"prescribed_prognostic_name {name!r} not in "
                "next_step_input_data"
            )
        output = {**output, name: next_step_input_data[name]}
    if prescribed_prognostic_names:
        diagnostics = {
            k: v for k, v in diagnostics.items()
            if k not in prescribed_prognostic_names
        }
    return StepOutput(output=output, stepper_state=stepper_state,
                      corrector_diagnostics=diagnostics)


@StepSelector.register("single_module")
@StepSelector.register("default")
@dataclasses.dataclass
class SingleModuleStepConfig:
    """Configuration for the single-module step, with the JAX package's
    fields (port of ace_tpu/core/step/single_module.py:173)."""

    builder: ModuleSelector
    in_names: list[str]
    out_names: list[str]
    normalization: NetworkAndLossNormalizationConfig
    ocean: OceanConfig | None = None
    corrector: AtmosphereCorrectorConfig = dataclasses.field(
        default_factory=AtmosphereCorrectorConfig
    )
    next_step_forcing_names: list[str] = dataclasses.field(default_factory=list)
    prescribed_prognostic_names: list[str] = dataclasses.field(
        default_factory=list
    )
    residual_prediction: bool = False
    global_mean_removal: dict | None = None
    include_channel_mask_inputs: bool = False
    input_dropout: dict | None = None
    secondary_decoder: dict | None = None

    def __post_init__(self):
        unported = {
            "global_mean_removal": self.global_mean_removal is not None,
            "include_channel_mask_inputs": self.include_channel_mask_inputs,
            "input_dropout": self.input_dropout is not None,
            "secondary_decoder": self.secondary_decoder is not None,
        }
        for option, requested in unported.items():
            if requested:
                raise NotImplementedError(
                    f"single_module option {option} is not ported yet"
                )
        for name in self.prescribed_prognostic_names:
            if name not in self.out_names:
                raise ValueError(
                    f"prescribed_prognostic_name {name!r} must be in out_names"
                )
        for name in self.next_step_forcing_names:
            if name not in self.in_names:
                raise ValueError(
                    f"next_step_forcing_name {name!r} not in in_names"
                )
            if name in self.out_names:
                raise ValueError(
                    f"next_step_forcing_name {name!r} is an output variable"
                )

    @property
    def input_names(self) -> list[str]:
        if self.ocean is None:
            return list(self.in_names)
        return sorted(set(self.in_names) | set(self.ocean.forcing_names))

    @property
    def output_names(self) -> list[str]:
        return list(self.out_names)

    @property
    def next_step_input_names(self) -> list[str]:
        result = set(self.input_names) - set(self.output_names)
        if self.ocean is not None:
            result |= set(self.ocean.forcing_names)
        result |= set(self.prescribed_prognostic_names)
        return sorted(result)

    @property
    def prognostic_names(self) -> list[str]:
        return sorted(set(self.output_names) & set(self.input_names))

    def get_step(self, dataset_info: DatasetInfo,
                 device=None) -> "SingleModuleStep":
        return SingleModuleStep(self, dataset_info, device=device)

    def get_state(self) -> dict[str, Any]:
        state = to_dict(self)
        state["builder"] = self.builder.get_state()
        return state


class SingleModuleStep:
    n_ic_timesteps = 1

    def __init__(self, config: SingleModuleStepConfig,
                 dataset_info: DatasetInfo, device=None):
        self.config = config
        self.dataset_info = dataset_info
        self.device = get_device(device)
        self.normalizer: StandardNormalizer = (
            config.normalization.build_network_normalizer(
                sorted(set(config.in_names) | set(config.out_names))
            )
        )
        self.module = config.builder.build(
            n_in_channels=len(config.in_names),
            n_out_channels=len(config.out_names),
            dataset_info=dataset_info,
            device=self.device,
        )
        self.in_packer = Packer(config.in_names)
        self.out_packer = Packer(config.out_names)
        self.ocean = None
        if config.ocean is not None:
            if dataset_info.timestep is None:
                raise ValueError("ocean requires dataset_info.timestep")
            self.ocean = config.ocean.build(
                config.in_names, config.out_names, dataset_info.timestep
            )
        self.corrector = None
        if not config.corrector.is_noop:
            if dataset_info.timestep is None:
                raise ValueError("corrector requires dataset_info.timestep")
            self.corrector = config.corrector.build(
                dataset_info.gridded_operations,
                dataset_info.atmosphere_vertical_coordinate,
                dataset_info.timestep,
            )

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
    def next_step_input_names(self) -> list[str]:
        return self.config.next_step_input_names

    @property
    def next_step_forcing_names(self) -> list[str]:
        return self.config.next_step_forcing_names

    def init_params(self, generator: torch.Generator | None = None):
        """Draw the module's weights with ``generator``."""
        init_weights(self.module, generator)

    def init_stepper_state(self, input_data: TensorMapping) -> StepperState:
        state: StepperState = {}
        if self.corrector is not None:
            state["corrector"] = self.corrector.init_state(input_data)
        return state

    def step(self, args: StepArgs) -> StepOutput:
        def network_call(input_norm, generator):
            packed = self.in_packer.pack(input_norm)
            return self.out_packer.unpack(
                self.module(packed, generator=generator,
                            deterministic=args.deterministic)
            )

        return step_with_adjustments(
            args=args,
            network_call=network_call,
            normalizer=self.normalizer,
            corrector=self.corrector,
            ocean=self.ocean,
            residual_prediction=self.config.residual_prediction,
            prognostic_names=self.prognostic_names,
            prescribed_prognostic_names=(
                self.config.prescribed_prognostic_names
            ),
        )
