"""The default single-module step (port of
ace_tpu/core/step/single_module.py).

Per step: global-mean removal (optional) -> normalize inputs -> input
dropout and data presence -> pack channels (with presence channels when
``include_channel_mask_inputs``) -> module forward -> unpack (and the
secondary decoder's diagnostics) -> residual -> denormalize -> restore
the global means -> corrector -> ocean SST (prescribed or slab) ->
prescribed prognostic overwrite.
"""

import dataclasses
from typing import Any

import torch
from torch import nn

from ace_tpu_torch.core.config import to_dict
from ace_tpu_torch.core.corrector.atmosphere import AtmosphereCorrectorConfig
from ace_tpu_torch.core.corrector.registry import CorrectorSelector
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.masking import VariableMaskingConfig
from ace_tpu_torch.core.normalizer import (
    NetworkAndLossNormalizationConfig,
    StandardNormalizer,
)
from ace_tpu_torch.core.ocean import OceanConfig
from ace_tpu_torch.core.packer import Packer
from ace_tpu_torch.core.step.base import (
    StepArgs,
    StepBase,
    StepConfigBase,
    StepOutput,
    StepSelector,
)
from ace_tpu_torch.core.step.global_mean_removal import (
    GlobalMeanRemovalConfig,
    extra_channel_source_field,
)
from ace_tpu_torch.core.step.secondary_decoder import SecondaryDecoderConfig
from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping
from ace_tpu_torch.device import get_device
from ace_tpu_torch.models.registry import ModuleSelector


def apply_input_mask(input_norm: TensorMapping,
                     presence: TensorMapping) -> TensorDict:
    """Zero the masked channels of normalized inputs. ``presence`` maps a
    channel to a 0-d bool (dropout, shared by the batch) or a ``[batch]``
    one; channels it does not name are present."""
    result = dict(input_norm)
    for name, mask in presence.items():
        if name not in result:
            continue
        t = result[name]
        if mask.dim() > 0:
            mask = mask.reshape(-1, *(1,) * (t.dim() - 1))
        result[name] = torch.where(mask, t, torch.zeros((), dtype=t.dtype,
                                                        device=t.device))
    return result


def build_corrector(config, dataset_info: DatasetInfo):
    """The step's corrector, or None when its config does nothing: an
    ``AtmosphereCorrectorConfig``, or a ``CorrectorSelector`` (the
    atmosphere, ocean or ice corrector)."""
    if config.is_noop:
        return None
    if dataset_info.timestep is None:
        raise ValueError("corrector requires dataset_info.timestep")
    if isinstance(config, CorrectorSelector):
        return config.build_from_dataset_info(dataset_info)
    return config.build(
        dataset_info.gridded_operations,
        dataset_info.atmosphere_vertical_coordinate,
        dataset_info.timestep,
    )


def step_with_adjustments(args: StepArgs, network_call, normalizer, corrector,
                          ocean, residual_prediction: bool,
                          prognostic_names: list[str],
                          prescribed_prognostic_names: list[str],
                          global_mean_removal=None) -> StepOutput:
    """The step pipeline around the network call
    ``network_call(input_norm, generator) -> output_norm``: the corrector
    runs before the ocean, so a slab SST reads the corrected fluxes."""
    input_data = args.input
    next_step_input_data = args.next_step_input_data
    gmr_state = None
    if global_mean_removal is not None:
        network_input, gmr_state = global_mean_removal.forward_transform(
            input_data)
        # the extra global-mean channels are normalized already
        input_norm = {**normalizer.normalize(dict(network_input)),
                      **gmr_state.extras}
    else:
        input_norm = normalizer.normalize(dict(input_data))
    output_norm = network_call(input_norm, args.generator)
    if residual_prediction:
        for name in prognostic_names:
            output_norm[name] = output_norm[name] + input_norm[name]
    output = normalizer.denormalize(output_norm)
    if global_mean_removal is not None:
        output = global_mean_removal.inverse_transform(output, gmr_state)

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
class SingleModuleStepConfig(StepConfigBase):
    """Configuration for the single-module step, with the JAX package's
    fields (port of ace_tpu/core/step/single_module.py:173)."""

    builder: ModuleSelector
    in_names: list[str]
    out_names: list[str]
    normalization: NetworkAndLossNormalizationConfig
    ocean: OceanConfig | None = None
    corrector: AtmosphereCorrectorConfig | CorrectorSelector = (
        dataclasses.field(default_factory=AtmosphereCorrectorConfig)
    )
    next_step_forcing_names: list[str] = dataclasses.field(default_factory=list)
    prescribed_prognostic_names: list[str] = dataclasses.field(
        default_factory=list
    )
    residual_prediction: bool = False
    global_mean_removal: GlobalMeanRemovalConfig | None = None
    include_channel_mask_inputs: bool = False
    input_dropout: VariableMaskingConfig | None = None
    secondary_decoder: SecondaryDecoderConfig | None = None

    def __post_init__(self):
        if self.global_mean_removal is not None:
            self.global_mean_removal.validate_names(self.in_names,
                                                    self.out_names)
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
        if self.secondary_decoder is not None:
            for name in self.secondary_decoder.secondary_diagnostic_names:
                if name in self.in_names or name in self.out_names:
                    raise ValueError(
                        f"secondary_diagnostic_name {name!r} is already an "
                        "input or output variable"
                    )

    @property
    def input_names(self) -> list[str]:
        if self.ocean is None:
            return list(self.in_names)
        return sorted(set(self.in_names) | set(self.ocean.forcing_names))

    @property
    def output_names(self) -> list[str]:
        secondary = (self.secondary_decoder.secondary_diagnostic_names
                     if self.secondary_decoder is not None else [])
        return list(self.out_names) + list(secondary)

    @property
    def next_step_input_names(self) -> list[str]:
        result = set(self.input_names) - set(self.output_names)
        if self.ocean is not None:
            result |= set(self.ocean.forcing_names)
        result |= set(self.prescribed_prognostic_names)
        return sorted(result)

    @property
    def _normalize_names(self) -> list[str]:
        return sorted(set(self.in_names) | set(self.output_names))

    def get_step(self, dataset_info: DatasetInfo,
                 device=None) -> "SingleModuleStep":
        return SingleModuleStep(self, dataset_info, device=device)

    def get_state(self) -> dict[str, Any]:
        state = to_dict(self)
        state["builder"] = self.builder.get_state()
        if self.secondary_decoder is not None:
            state["secondary_decoder"]["network"] = (
                self.secondary_decoder.network.get_state())
        return state


class SingleModuleStep(StepBase):
    """``module`` is the network, or with a secondary decoder an
    ``nn.ModuleDict`` of ``main`` (the network) and ``secondary_decoder``,
    as the JAX package keys its parameters."""

    def __init__(self, config: SingleModuleStepConfig,
                 dataset_info: DatasetInfo, device=None):
        self.config = config
        self.dataset_info = dataset_info
        self.device = get_device(device)
        self.normalizer: StandardNormalizer = (
            config.normalization.build_network_normalizer(
                config._normalize_names)
        )
        self.global_mean_removal = (
            config.global_mean_removal.build(self.normalizer)
            if config.global_mean_removal is not None else None
        )
        extra_names = (self.global_mean_removal.extra_channel_names
                       if self.global_mean_removal is not None else [])
        packed_in_names = list(config.in_names) + extra_names
        self.input_masking = (
            config.input_dropout.build(packed_in_names)
            if config.input_dropout is not None else None
        )
        n_in_channels = len(packed_in_names)
        if config.include_channel_mask_inputs:
            # one presence channel for each input channel
            n_in_channels *= 2
        self.network = config.builder.build(
            n_in_channels=n_in_channels,
            n_out_channels=len(config.out_names),
            dataset_info=dataset_info,
            device=self.device,
        )
        self.in_packer = Packer(packed_in_names)
        self.out_packer = Packer(config.out_names)
        self.secondary_decoder = None
        self.module: nn.Module = self.network
        if config.secondary_decoder is not None:
            self.secondary_decoder = config.secondary_decoder.build(
                n_in_channels=len(config.out_names),
                dataset_info=dataset_info, device=self.device,
            )
            self.module = nn.ModuleDict({
                "main": self.network,
                "secondary_decoder": self.secondary_decoder.module,
            })
        self.ocean = None
        if config.ocean is not None:
            if dataset_info.timestep is None:
                raise ValueError("ocean requires dataset_info.timestep")
            self.ocean = config.ocean.build(
                config.in_names, config.out_names, dataset_info.timestep
            )
        self.corrector = build_corrector(config.corrector, dataset_info)

    def draw_input_dropout_presence(self, args: StepArgs
                                    ) -> TensorDict | None:
        """Input dropout's presence of each packed input channel (a 0-d
        bool, one draw shared by the batch), drawn from the step's
        generator; None (nothing drawn) when the step is deterministic or
        has no generator or no input dropout. Tests replace it on the
        instance to pass a presence in."""
        if (self.input_masking is None or args.deterministic
                or args.generator is None):
            return None
        presence = self.input_masking.sample_presence(args.generator)
        return {name: presence[i]
                for i, name in enumerate(self.in_packer.names)}

    def data_presence(self, args: StepArgs) -> TensorDict:
        """The dataset's ``[batch]`` presence of each packed input channel
        that ``args.data_mask`` names, as bool; a global-mean-removal
        channel shares its source field's."""
        if args.data_mask is None:
            return {}
        presence = {}
        for name in self.in_packer.names:
            source = extra_channel_source_field(name)
            lookup = source if source is not None else name
            if lookup in args.data_mask:
                presence[name] = torch.as_tensor(
                    args.data_mask[lookup], device=self.device).bool()
        return presence

    def _channel_masks(self, packed: torch.Tensor,
                       data_presence: TensorMapping,
                       dropout_presence: TensorMapping | None
                       ) -> torch.Tensor:
        """The presence channels, packed as the inputs: the dataset's
        presence of each sample (ones where the data mask does not name
        the channel) and input dropout's, joined."""
        batch, spatial = packed.shape[0], packed.shape[1:-1]
        masks = {}
        for name in self.in_packer.names:
            real = torch.ones(batch, dtype=torch.bool, device=packed.device)
            if name in data_presence:
                real = data_presence[name]
            if dropout_presence is not None and name in dropout_presence:
                real = real & dropout_presence[name]
            masks[name] = real.to(packed.dtype).reshape(
                -1, *(1,) * len(spatial)).expand(batch, *spatial)
        return self.in_packer.pack(masks)

    def step(self, args: StepArgs) -> StepOutput:
        config = self.config
        dropout_presence = self.draw_input_dropout_presence(args)
        data_presence = self.data_presence(args)
        network_kwargs = {}
        if getattr(self.network, "n_labels", 0):
            network_kwargs["labels"] = args.labels

        def network_call(input_norm, generator):
            if data_presence:
                input_norm = apply_input_mask(input_norm, data_presence)
            if dropout_presence is not None:
                input_norm = apply_input_mask(input_norm, dropout_presence)
            packed = self.in_packer.pack(input_norm)
            if config.include_channel_mask_inputs:
                packed = torch.cat(
                    [packed, self._channel_masks(packed, data_presence,
                                                 dropout_presence)],
                    dim=-1)
            out_packed = self.network(packed, generator=generator,
                                      deterministic=args.deterministic,
                                      **network_kwargs)
            output = self.out_packer.unpack(out_packed)
            if self.secondary_decoder is not None:
                output.update(self.secondary_decoder(
                    out_packed, deterministic=args.deterministic,
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
            global_mean_removal=self.global_mean_removal,
        )
