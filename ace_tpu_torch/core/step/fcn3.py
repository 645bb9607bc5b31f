"""The FCN3 step: grouped atmosphere, surface and forcing channels through
FourCastNet3 (port of ace_tpu/core/step/fcn3.py).

The step packs the normalized forcings, the atmosphere's per-level inputs
(level-major, variables fastest: ``{name}_{i}``) and the surface inputs
into three tensors, runs the network, and unpacks its two outputs,
inside the single-module step's pipeline (residual, denormalize,
corrector, ocean, prescribed prognostics).
"""

import dataclasses
from typing import Any, Literal

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
from ace_tpu_torch.core.step.single_module import (
    build_corrector,
    step_with_adjustments,
)
from ace_tpu_torch.device import get_device


@dataclasses.dataclass
class FCN3Config:
    """FourCastNet3's options (port of ace_tpu/core/step/fcn3.py:35).
    Tensor factorization is not implemented (dense weights only), as in
    ``ace_tpu``."""

    model_grid_type: str = "legendre-gauss"
    sht_grid_type: str = "legendre-gauss"
    kernel_width: int = 3
    filter_basis_type: str = "morlet"
    scale_factor: int = 8
    encoder_mlp: bool = False
    upsample_sht: bool = False
    atmo_embed_dim: int = 8
    surf_embed_dim: int = 8
    aux_embed_dim: int = 8
    num_layers: int = 4
    use_mlp: bool = True
    mlp_ratio: float = 2.0
    activation_function: str = "gelu"
    layer_scale: bool = True
    normalization_layer: str = "none"
    max_modes: int | None = None
    hard_thresholding_fraction: float = 1.0
    sfno_block_frequency: int = 2
    bias: bool = False

    def build(self, n_atmo_channels, n_atmo_groups, n_surf_channels,
              n_aux_channels, n_atmo_diagnostic_channels,
              n_surf_diagnostic_channels, dataset_info: DatasetInfo,
              device=None):
        from ace_tpu_torch.models.fcn3 import FourCastNet3

        return FourCastNet3(
            img_shape=dataset_info.img_shape,
            n_atmo_channels=n_atmo_channels,
            n_atmo_groups=n_atmo_groups,
            n_surf_channels=n_surf_channels,
            n_aux_channels=n_aux_channels,
            n_atmo_diagnostic_channels=n_atmo_diagnostic_channels,
            n_surf_diagnostic_channels=n_surf_diagnostic_channels,
            model_grid_type=self.model_grid_type,
            sht_grid_type=self.sht_grid_type,
            kernel_shape=(self.kernel_width, self.kernel_width),
            filter_basis_type=self.filter_basis_type,
            scale_factor=self.scale_factor,
            encoder_mlp=self.encoder_mlp,
            upsample_sht=self.upsample_sht,
            atmo_embed_dim=self.atmo_embed_dim,
            surf_embed_dim=self.surf_embed_dim,
            aux_embed_dim=self.aux_embed_dim,
            num_layers=self.num_layers,
            use_mlp=self.use_mlp,
            mlp_ratio=self.mlp_ratio,
            activation_function=self.activation_function,
            layer_scale=self.layer_scale,
            normalization_layer=self.normalization_layer,
            max_modes=self.max_modes,
            hard_thresholding_fraction=self.hard_thresholding_fraction,
            sfno_block_frequency=self.sfno_block_frequency,
            use_bias=self.bias,
            device=device,
        )


@dataclasses.dataclass
class FCN3Selector:
    type: Literal["FCN3"]
    config: FCN3Config

    def build(self, **kwargs):
        return self.config.build(**kwargs)


@StepSelector.register("FCN3")
@dataclasses.dataclass
class FCN3StepConfig(StepConfigBase):
    """The FCN3 step's names and options (port of
    ace_tpu/core/step/fcn3.py:108). The atmosphere's channels are
    level-major with variables fastest: for level i the inputs are
    ``{name}_{i}`` for each prognostic name. ``forcing_names`` is a plain
    field here: the port's step configs have no property of that name to
    override, as ``ace_tpu``'s base class has."""

    builder: FCN3Selector
    atmosphere_prognostic_names: list[str]
    atmosphere_diagnostic_names: list[str]
    atmosphere_levels: int
    surface_prognostic_names: list[str]
    surface_diagnostic_names: list[str]
    normalization: NetworkAndLossNormalizationConfig
    forcing_names: list[str] = dataclasses.field(default_factory=list)
    ocean: OceanConfig | None = None
    corrector: AtmosphereCorrectorConfig = dataclasses.field(
        default_factory=AtmosphereCorrectorConfig
    )
    next_step_forcing_names: list[str] = dataclasses.field(
        default_factory=list
    )
    prescribed_prognostic_names: list[str] = dataclasses.field(
        default_factory=list
    )
    residual_prediction: bool = False

    def __post_init__(self):
        for name in self.next_step_forcing_names:
            if name not in self.forcing_names:
                raise ValueError(
                    f"next_step_forcing_name {name!r} not in forcing_names"
                )
        atmosphere_in, atmosphere_out = [], []
        for i in range(self.atmosphere_levels):
            for name in self.atmosphere_prognostic_names:
                atmosphere_in.append(f"{name}_{i}")
                atmosphere_out.append(f"{name}_{i}")
            for name in self.atmosphere_diagnostic_names:
                atmosphere_out.append(f"{name}_{i}")
        self.atmosphere_input_names = atmosphere_in
        self.atmosphere_output_names = atmosphere_out
        self.surface_input_names = list(self.surface_prognostic_names)
        self.surface_output_names = (list(self.surface_prognostic_names)
                                     + list(self.surface_diagnostic_names))
        self.in_names = (list(self.forcing_names)
                         + self.atmosphere_input_names
                         + self.surface_input_names)
        self.out_names = (self.atmosphere_output_names
                          + self.surface_output_names)
        for name in self.prescribed_prognostic_names:
            if name not in self.out_names:
                raise ValueError(
                    f"prescribed_prognostic_name {name!r} not in out_names"
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
    def _normalize_names(self) -> list[str]:
        return sorted(set(self.in_names) | set(self.out_names))

    def get_step(self, dataset_info: DatasetInfo,
                 device=None) -> "FCN3Step":
        return FCN3Step(self, dataset_info, device=device)

    def get_state(self) -> dict[str, Any]:
        # the derived name lists are attributes, not fields: to_dict
        # leaves them out, and __post_init__ rebuilds them
        return to_dict(self)


class FCN3Step(StepBase):
    """The FCN3 step (port of ace_tpu/core/step/fcn3.py:221); ``module``
    is the ``FourCastNet3``."""

    def __init__(self, config: FCN3StepConfig, dataset_info: DatasetInfo,
                 device=None):
        self.config = config
        self.dataset_info = dataset_info
        self.device = get_device(device)
        self.forcing_packer = Packer(config.forcing_names)
        self.atmosphere_input_packer = Packer(config.atmosphere_input_names)
        self.atmosphere_output_packer = Packer(config.atmosphere_output_names)
        self.surface_input_packer = Packer(config.surface_input_names)
        self.surface_output_packer = Packer(config.surface_output_names)
        self.normalizer = config.normalization.build_network_normalizer(
            config._normalize_names)
        self.module = config.builder.build(
            n_atmo_channels=(len(config.atmosphere_prognostic_names)
                             + len(config.atmosphere_diagnostic_names)),
            n_atmo_groups=config.atmosphere_levels,
            n_surf_channels=(len(config.surface_prognostic_names)
                             + len(config.surface_diagnostic_names)),
            n_aux_channels=len(config.forcing_names),
            n_atmo_diagnostic_channels=len(
                config.atmosphere_diagnostic_names),
            n_surf_diagnostic_channels=len(config.surface_diagnostic_names),
            dataset_info=dataset_info,
            device=self.device,
        )
        self.ocean = None
        if config.ocean is not None:
            if dataset_info.timestep is None:
                raise ValueError("ocean requires dataset_info.timestep")
            self.ocean = config.ocean.build(
                config.in_names, config.out_names, dataset_info.timestep)
        self.corrector = build_corrector(config.corrector, dataset_info)

    def step(self, args: StepArgs) -> StepOutput:
        config = self.config
        if args.labels is not None:
            raise ValueError("Labels are not supported for FCN3")

        def network_call(input_norm, generator):
            atmo_out, surf_out = self.module(
                self.atmosphere_input_packer.pack(input_norm),
                self.surface_input_packer.pack(input_norm),
                self.forcing_packer.pack(input_norm),
                deterministic=args.deterministic, generator=generator)
            output = self.atmosphere_output_packer.unpack(atmo_out)
            output.update(self.surface_output_packer.unpack(surf_out))
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
