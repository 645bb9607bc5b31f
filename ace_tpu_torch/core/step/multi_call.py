"""Multi-call step: the wrapped step called again with a forcing scaled
(e.g. CO2 quadrupled), its outputs kept under suffixed names: ACE2's
radiative-forcing diagnostics (port of ace_tpu/core/step/multi_call.py).
"""

import dataclasses
import re
from typing import Any

from ace_tpu_torch.core.config import to_dict
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.normalizer import StandardNormalizer
from ace_tpu_torch.core.step.base import (
    StepArgs,
    StepBase,
    StepConfigBase,
    StepOutput,
    StepperState,
    StepSelector,
)

LEVEL_PATTERN = re.compile(r"_(\d+)$")


def get_multi_call_name(name: str, suffix: str) -> str:
    """``name`` with ``suffix``, a vertical level's label kept last:
    ``T_0`` with ``_2xCO2`` is ``T_2xCO2_0``."""
    match = LEVEL_PATTERN.search(name)
    if match:
        return name[: match.start()] + suffix + match.group(0)
    return name + suffix


@dataclasses.dataclass
class MultiCallConfig:
    """forcing_name: the input scaled; forcing_multipliers: suffix ->
    multiplier, one extra call each; output_names: the outputs kept from
    each extra call, under suffixed names."""

    forcing_name: str
    forcing_multipliers: dict[str, float]
    output_names: list[str]

    def get_multi_called_names(self, name: str) -> list[str]:
        return [get_multi_call_name(name, suffix)
                for suffix in self.forcing_multipliers]

    @property
    def names(self) -> list[str]:
        out = []
        for name in self.output_names:
            out.extend(self.get_multi_called_names(name))
        return out

    def validate(self, in_names: list[str], out_names: list[str]):
        if self.forcing_name not in in_names:
            raise ValueError(
                f"forcing name {self.forcing_name} not in input names")
        if self.forcing_name in out_names:
            raise ValueError(
                f"forcing name {self.forcing_name} must not be an output")
        for name in self.output_names:
            if name not in out_names:
                raise ValueError(f"{name} not in output names")
        for mc_name in self.names:
            if mc_name in in_names or mc_name in out_names:
                raise ValueError(
                    f"multi-call output {mc_name} conflicts with existing "
                    "names")


@StepSelector.register("multi_call")
@dataclasses.dataclass
class MultiCallStepConfig(StepConfigBase):
    """A wrapped step, and the multi-call's config (None: the wrapped step
    alone). ``include_multi_call_in_loss``: the suffixed outputs are in the
    loss (``loss_names``)."""

    wrapped_step: StepSelector
    config: MultiCallConfig | None = None
    include_multi_call_in_loss: bool = True

    def __post_init__(self):
        if self.config is not None:
            self.config.validate(self.wrapped_step.instance.input_names,
                                 self.wrapped_step.instance.output_names)
        if self.config is None and self.include_multi_call_in_loss:
            raise ValueError(
                "include_multi_call_in_loss is True, but config is None")

    @property
    def normalization(self):
        return self.wrapped_step.instance.normalization

    @property
    def _normalize_names(self) -> list[str]:
        return self.wrapped_step.instance._normalize_names

    def get_loss_normalizer(self, residual_scaled_names=None
                            ) -> StandardNormalizer:
        """The wrapped step's loss normalizer, each suffixed output given
        its base variable's statistics."""
        base = self.normalization.build_loss_normalizer(
            self._normalize_names,
            residual_scaled_names=residual_scaled_names)
        if self.config is None:
            return base
        means, stds = dict(base.means), dict(base.stds)
        for suffix in self.config.forcing_multipliers:
            for name in self.config.output_names:
                mc = get_multi_call_name(name, suffix)
                means[mc], stds[mc] = means[name], stds[name]
        return StandardNormalizer(means, stds)

    @property
    def input_names(self) -> list[str]:
        return self.wrapped_step.instance.input_names

    @property
    def output_names(self) -> list[str]:
        names = list(self.wrapped_step.instance.output_names)
        if self.config is not None:
            names.extend(self.config.names)
        return names

    @property
    def loss_names(self) -> list[str]:
        if self.config is not None and self.include_multi_call_in_loss:
            return self.output_names
        return self.wrapped_step.instance.output_names

    @property
    def prognostic_names(self) -> list[str]:
        return self.wrapped_step.instance.prognostic_names

    @property
    def next_step_input_names(self) -> list[str]:
        return self.wrapped_step.instance.next_step_input_names

    def get_next_step_forcing_names(self) -> list[str]:
        return self.wrapped_step.instance.get_next_step_forcing_names()

    def get_step(self, dataset_info: DatasetInfo,
                 device=None) -> "MultiCallStep":
        wrapped = self.wrapped_step.get_step(dataset_info, device=device)
        return MultiCallStep(wrapped, self)

    def get_state(self) -> dict[str, Any]:
        return {
            "wrapped_step": self.wrapped_step.get_state(),
            "config": to_dict(self.config) if self.config else None,
            "include_multi_call_in_loss": self.include_multi_call_in_loss,
        }


class MultiCallStep(StepBase):
    """The wrapped step's weights (``module``), device and stepper state;
    no normalizer of its own, as in the JAX package (the aggregators get
    none)."""

    def __init__(self, wrapped_step, config: MultiCallStepConfig):
        self.wrapped = wrapped_step
        self.config = config

    @property
    def dataset_info(self) -> DatasetInfo:
        return self.wrapped.dataset_info

    @property
    def device(self):
        return self.wrapped.device

    @property
    def module(self):
        return self.wrapped.module

    def init_params(self, generator=None):
        self.wrapped.init_params(generator)

    def init_stepper_state(self, input_data) -> StepperState:
        return self.wrapped.init_stepper_state(input_data)

    def step(self, args: StepArgs) -> StepOutput:
        """The wrapped step as given, then once per multiplier with the
        forcing scaled in ``input`` and ``next_step_input_data``; only the
        first call's stepper state and corrector diagnostics are kept.
        Each call draws the same numbers from the generator (the JAX
        package hands each the same key), which is left where the first
        call left it."""
        generator = args.generator
        start = generator.get_state() if generator is not None else None
        wrapped_out = self.wrapped.step(args)
        output = dict(wrapped_out.output)
        mc = self.config.config
        if mc is not None:
            name = mc.forcing_name
            if name not in args.input and name not in args.next_step_input_data:
                raise ValueError(
                    f"multi-call forcing {name!r} not in input or "
                    "next_step_input_data")
            resume = generator.get_state() if generator is not None else None
            for suffix, multiplier in mc.forcing_multipliers.items():
                if generator is not None:
                    generator.set_state(start)
                scaled = [dict(d) for d in (args.input,
                                            args.next_step_input_data)]
                for data in scaled:
                    if name in data:
                        data[name] = multiplier * data[name]
                mc_out = self.wrapped.step(dataclasses.replace(
                    args, input=scaled[0], next_step_input_data=scaled[1]))
                for out_name in mc.output_names:
                    output[get_multi_call_name(out_name, suffix)] = (
                        mc_out.output[out_name])
            if generator is not None:
                generator.set_state(resume)
        return StepOutput(
            output=output,
            stepper_state=wrapped_out.stepper_state,
            corrector_diagnostics=wrapped_out.corrector_diagnostics,
        )
