"""Two-module steps: a separate radiation model, and a secondary module
(port of ace_tpu/core/step/separate_radiation.py).

Both run their modules inside one ``step_with_adjustments`` pipeline. The
step's ``module`` is an ``nn.ModuleDict`` keyed as the JAX package keys
the parameter tree: ``radiation`` and ``main``; ``main``, ``secondary``
and, with a decoder, ``secondary_decoder``.
"""

import dataclasses
from typing import Any

from torch import nn

from ace_tpu_torch.core.config import to_dict
from ace_tpu_torch.core.corrector.atmosphere import AtmosphereCorrectorConfig
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.normalizer import NetworkAndLossNormalizationConfig
from ace_tpu_torch.core.ocean import OceanConfig
from ace_tpu_torch.core.packer import Packer
from ace_tpu_torch.core.step.base import (
    StepArgs,
    StepBase,
    StepConfigBase,
    StepOutput,
    StepSelector,
)
from ace_tpu_torch.core.step.secondary_decoder import SecondaryDecoderConfig
from ace_tpu_torch.core.step.single_module import (
    build_corrector,
    step_with_adjustments,
)
from ace_tpu_torch.device import get_device
from ace_tpu_torch.models.registry import ModuleSelector


def _builder_states(config, state: dict, *fields: str) -> dict:
    for field in fields:
        state[field] = getattr(config, field).get_state()
    return state


@StepSelector.register("separate_radiation")
@dataclasses.dataclass
class SeparateRadiationStepConfig(StepConfigBase):
    """The radiation module predicts ``radiation_diagnostic_names`` from the
    prognostics and all forcings; the main module reads them with the
    prognostics and shared forcings."""

    builder: ModuleSelector
    radiation_builder: ModuleSelector
    main_prognostic_names: list[str]
    shared_forcing_names: list[str]
    radiation_only_forcing_names: list[str]
    radiation_diagnostic_names: list[str]
    main_diagnostic_names: list[str]
    normalization: NetworkAndLossNormalizationConfig
    next_step_forcing_names: list[str] = dataclasses.field(default_factory=list)
    ocean: OceanConfig | None = None
    corrector: AtmosphereCorrectorConfig = dataclasses.field(
        default_factory=AtmosphereCorrectorConfig
    )
    detach_radiation: bool = False
    residual_prediction: bool = False

    def __post_init__(self):
        seen: dict[str, str] = {}
        for names, label in (
            (self.main_prognostic_names, "main_prognostic_names"),
            (self.shared_forcing_names, "shared_forcing_names"),
            (self.radiation_only_forcing_names, "radiation_only_forcing_names"),
            (self.main_diagnostic_names, "main_diagnostic_names"),
            (self.radiation_diagnostic_names, "radiation_diagnostic_names"),
        ):
            for name in names:
                if name in seen:
                    raise ValueError(
                        f"Name {name!r} appears in both {seen[name]} and {label}"
                    )
                seen[name] = label
        for name in self.next_step_forcing_names:
            if name not in self._forcing_names:
                raise ValueError(
                    f"next_step_forcing_name {name!r} not in forcing names"
                )

    @property
    def _forcing_names(self) -> list[str]:
        return (list(self.shared_forcing_names)
                + list(self.radiation_only_forcing_names))

    @property
    def radiation_in_names(self) -> list[str]:
        return (list(self.main_prognostic_names)
                + list(self.shared_forcing_names)
                + list(self.radiation_only_forcing_names))

    @property
    def main_in_names(self) -> list[str]:
        return (list(self.main_prognostic_names)
                + list(self.shared_forcing_names)
                + list(self.radiation_diagnostic_names))

    @property
    def main_out_names(self) -> list[str]:
        return list(self.main_prognostic_names) + list(
            self.main_diagnostic_names)

    @property
    def input_names(self) -> list[str]:
        names = set(self.main_prognostic_names) | set(self._forcing_names)
        if self.ocean is not None:
            names |= set(self.ocean.forcing_names)
        return sorted(names)

    @property
    def output_names(self) -> list[str]:
        return sorted(set(self.main_out_names)
                      | set(self.radiation_diagnostic_names))

    @property
    def prognostic_names(self) -> list[str]:
        return list(self.main_prognostic_names)

    @property
    def next_step_input_names(self) -> list[str]:
        result = set(self.input_names) - set(self.output_names)
        if self.ocean is not None:
            result |= set(self.ocean.forcing_names)
        return sorted(result)

    @property
    def _normalize_names(self) -> list[str]:
        # the modules' names only: the ocean's forcings are prescribed,
        # never normalized
        return sorted(set(self.main_prognostic_names)
                      | set(self.shared_forcing_names)
                      | set(self.radiation_only_forcing_names)
                      | set(self.main_diagnostic_names)
                      | set(self.radiation_diagnostic_names))

    def get_step(self, dataset_info: DatasetInfo,
                 device=None) -> "SeparateRadiationStep":
        return SeparateRadiationStep(self, dataset_info, device=device)

    def get_state(self) -> dict[str, Any]:
        return _builder_states(self, to_dict(self), "builder",
                               "radiation_builder")


class SeparateRadiationStep(StepBase):
    def __init__(self, config: SeparateRadiationStepConfig,
                 dataset_info: DatasetInfo, device=None):
        self.config = config
        self.dataset_info = dataset_info
        self.device = get_device(device)
        self.radiation_module = config.radiation_builder.build(
            len(config.radiation_in_names),
            len(config.radiation_diagnostic_names),
            dataset_info, device=self.device,
        )
        self.network = config.builder.build(
            len(config.main_in_names), len(config.main_out_names),
            dataset_info, device=self.device,
        )
        self.module = nn.ModuleDict({"radiation": self.radiation_module,
                                     "main": self.network})
        self.radiation_in_packer = Packer(config.radiation_in_names)
        self.radiation_out_packer = Packer(config.radiation_diagnostic_names)
        self.in_packer = Packer(config.main_in_names)
        self.out_packer = Packer(config.main_out_names)
        self.normalizer = config.normalization.build_network_normalizer(
            config._normalize_names)
        self.ocean = (
            config.ocean.build(config.input_names, config.output_names,
                               dataset_info.timestep)
            if config.ocean is not None else None
        )
        self.corrector = build_corrector(config.corrector, dataset_info)

    def step(self, args: StepArgs) -> StepOutput:
        config = self.config

        def network_call(input_norm, generator):
            rad_out = self.radiation_module(
                self.radiation_in_packer.pack(input_norm),
                generator=generator, deterministic=args.deterministic)
            rad_norm = self.radiation_out_packer.unpack(rad_out)
            main_extra = ({k: v.detach() for k, v in rad_norm.items()}
                          if config.detach_radiation else rad_norm)
            main_out = self.network(
                self.in_packer.pack({**input_norm, **main_extra}),
                generator=generator, deterministic=args.deterministic)
            return {**rad_norm, **self.out_packer.unpack(main_out)}

        return step_with_adjustments(
            args=args,
            network_call=network_call,
            normalizer=self.normalizer,
            corrector=self.corrector,
            ocean=self.ocean,
            residual_prediction=config.residual_prediction,
            prognostic_names=self.prognostic_names,
            prescribed_prognostic_names=[],
        )


@StepSelector.register("secondary_module")
@dataclasses.dataclass
class SecondaryModuleStepConfig(StepConfigBase):
    """A main module over ``in_names`` -> ``out_names`` and a secondary
    module over the same inputs, whose ``secondary_out_names`` are added
    outputs and whose ``secondary_residual_out_names`` are added to the
    main output (or the input) of that name; optionally a secondary
    decoder of the main module's outputs."""

    builder: ModuleSelector
    in_names: list[str]
    out_names: list[str]
    normalization: NetworkAndLossNormalizationConfig
    secondary_builder: ModuleSelector = None  # type: ignore[assignment]
    secondary_out_names: list[str] = dataclasses.field(default_factory=list)
    secondary_residual_out_names: list[str] = dataclasses.field(
        default_factory=list
    )
    secondary_decoder: SecondaryDecoderConfig | None = None
    ocean: OceanConfig | None = None
    corrector: AtmosphereCorrectorConfig = dataclasses.field(
        default_factory=AtmosphereCorrectorConfig
    )
    next_step_forcing_names: list[str] = dataclasses.field(default_factory=list)
    prescribed_prognostic_names: list[str] = dataclasses.field(
        default_factory=list
    )
    residual_prediction: bool = False

    def __post_init__(self):
        if self.secondary_builder is None:
            raise ValueError("secondary_builder is required")
        for name in self.prescribed_prognostic_names:
            if name not in self.out_names:
                raise ValueError(
                    f"prescribed_prognostic_name {name!r} must be in "
                    f"out_names: {self.out_names}"
                )
        for name in self.next_step_forcing_names:
            if name not in self.in_names:
                raise ValueError(
                    f"next_step_forcing_name {name!r} not in in_names: "
                    f"{self.in_names}"
                )
            if name in self.out_names:
                raise ValueError(
                    f"next_step_forcing_name is an output variable: {name!r}"
                )
        all_secondary_names = (set(self.secondary_out_names)
                               | set(self.secondary_residual_out_names))
        if self.secondary_decoder is not None:
            for name in self.secondary_decoder.secondary_diagnostic_names:
                if name in self.in_names:
                    raise ValueError(
                        f"secondary_diagnostic_name is an input: {name!r}")
                if name in set(self.out_names) | all_secondary_names:
                    raise ValueError(
                        f"secondary_diagnostic_name is an output: {name!r}")
        if (not self.secondary_out_names
                and not self.secondary_residual_out_names):
            raise ValueError(
                "at least one of secondary_out_names or "
                "secondary_residual_out_names must be non-empty"
            )
        overlap = set(self.secondary_out_names) & set(self.out_names)
        if overlap:
            raise ValueError(
                f"secondary_out_names overlap out_names: {sorted(overlap)}")
        overlap = (set(self.secondary_out_names)
                   & set(self.secondary_residual_out_names))
        if overlap:
            raise ValueError(
                "secondary_out_names must not overlap with "
                f"secondary_residual_out_names: {sorted(overlap)}"
            )
        for name in self.secondary_residual_out_names:
            if name not in self.out_names and name not in self.in_names:
                raise ValueError(
                    f"secondary_residual_out_name {name!r} must be in "
                    "out_names or in_names"
                )

    @property
    def secondary_module_out_names(self) -> list[str]:
        return (list(self.secondary_out_names)
                + list(self.secondary_residual_out_names))

    @property
    def input_names(self) -> list[str]:
        names = set(self.in_names)
        if self.ocean is not None:
            names |= set(self.ocean.forcing_names)
        return sorted(names)

    @property
    def output_names(self) -> list[str]:
        decoder_names = (self.secondary_decoder.secondary_diagnostic_names
                         if self.secondary_decoder is not None else [])
        return sorted(set(self.out_names)
                      | set(self.secondary_out_names)
                      | set(self.secondary_residual_out_names)
                      | set(decoder_names))

    @property
    def next_step_input_names(self) -> list[str]:
        result = set(self.input_names) - set(self.output_names)
        if self.ocean is not None:
            result |= set(self.ocean.forcing_names)
        result |= set(self.prescribed_prognostic_names)
        return sorted(result)

    @property
    def _normalize_names(self) -> list[str]:
        # in_names, not input_names: the ocean's forcings are prescribed,
        # never normalized
        return sorted(set(self.in_names) | set(self.output_names))

    def get_step(self, dataset_info: DatasetInfo,
                 device=None) -> "SecondaryModuleStep":
        return SecondaryModuleStep(self, dataset_info, device=device)

    def get_state(self) -> dict[str, Any]:
        state = _builder_states(self, to_dict(self), "builder",
                                "secondary_builder")
        if self.secondary_decoder is not None:
            state["secondary_decoder"]["network"] = (
                self.secondary_decoder.network.get_state())
        return state


class SecondaryModuleStep(StepBase):
    def __init__(self, config: SecondaryModuleStepConfig,
                 dataset_info: DatasetInfo, device=None):
        self.config = config
        self.dataset_info = dataset_info
        self.device = get_device(device)
        self.network = config.builder.build(
            len(config.in_names), len(config.out_names), dataset_info,
            device=self.device)
        self.secondary_module = config.secondary_builder.build(
            len(config.in_names), len(config.secondary_module_out_names),
            dataset_info, device=self.device)
        modules = {"main": self.network, "secondary": self.secondary_module}
        self.in_packer = Packer(config.in_names)
        self.out_packer = Packer(config.out_names)
        self.secondary_out_packer = Packer(config.secondary_module_out_names)
        self.secondary_decoder = None
        if config.secondary_decoder is not None:
            self.secondary_decoder = config.secondary_decoder.build(
                n_in_channels=len(config.out_names),
                dataset_info=dataset_info, device=self.device)
            modules["secondary_decoder"] = self.secondary_decoder.module
        self.module = nn.ModuleDict(modules)
        self.normalizer = config.normalization.build_network_normalizer(
            config._normalize_names)
        # the ocean sees the main module's names
        self.ocean = (
            config.ocean.build(config.in_names, config.out_names,
                               dataset_info.timestep)
            if config.ocean is not None else None
        )
        self.corrector = build_corrector(config.corrector, dataset_info)

    def step(self, args: StepArgs) -> StepOutput:
        config = self.config

        def network_call(input_norm, generator):
            packed = self.in_packer.pack(input_norm)
            main_out = self.network(packed, generator=generator,
                                    deterministic=args.deterministic)
            output = self.out_packer.unpack(main_out)
            sec = self.secondary_out_packer.unpack(self.secondary_module(
                packed, generator=generator,
                deterministic=args.deterministic))
            for name in config.secondary_out_names:
                output[name] = sec[name]
            for name in config.secondary_residual_out_names:
                base = output[name] if name in output else input_norm[name]
                output[name] = base + sec[name]
            if self.secondary_decoder is not None:
                # decoded from the main module's outputs, detached
                output.update(self.secondary_decoder(
                    main_out, deterministic=args.deterministic,
                    generator=generator))
            return output

        return step_with_adjustments(
            args=args,
            network_call=network_call,
            normalizer=self.normalizer,
            corrector=self.corrector,
            ocean=self.ocean,
            residual_prediction=config.residual_prediction,
            prognostic_names=self.prognostic_names,
            prescribed_prognostic_names=config.prescribed_prognostic_names,
        )
