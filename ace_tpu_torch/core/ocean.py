"""Sea-surface temperature: prescribed, or a slab ocean (port of
ace_tpu/core/ocean.py)."""

import dataclasses
import datetime

import torch

from ace_tpu_torch.core.atmosphere_data import AtmosphereData
from ace_tpu_torch.core.constants import (
    DENSITY_OF_WATER,
    SPECIFIC_HEAT_OF_WATER,
)
from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping


def replace_on_mask(original, replacement, mask, mask_value: int):
    """``replacement`` where ``round(mask) == mask_value``, else
    ``original``."""
    return torch.where(torch.round(mask) == mask_value, replacement, original)


@dataclasses.dataclass
class PrescriberConfig:
    """Overwrite predictions of ``prescribed_name`` with target values in a
    masked region."""

    prescribed_name: str
    mask_name: str
    mask_value: int
    interpolate: bool = False

    def __post_init__(self):
        if self.interpolate and self.mask_value != 1:
            raise ValueError(
                "Interpolation requires mask_value to be 1, got "
                f"{self.mask_value}."
            )

    def build(self, in_names: list[str], out_names: list[str]) -> "Prescriber":
        if not (self.prescribed_name in in_names
                and self.prescribed_name in out_names):
            raise ValueError(
                "Prescribed variables must be in in_names and out_names, "
                f"but {self.prescribed_name} is not."
            )
        return Prescriber(self.prescribed_name, self.mask_name,
                          self.mask_value, self.interpolate)


class Prescriber:
    """Overwrite ``prescribed_name`` with target values in a masked region."""

    def __init__(self, prescribed_name, mask_name, mask_value,
                 interpolate=False):
        self.prescribed_name = prescribed_name
        self.mask_name = mask_name
        self.mask_value = mask_value
        self.interpolate = interpolate

    def __call__(self, mask_data: TensorMapping, gen: TensorMapping,
                 target: TensorMapping) -> TensorDict:
        for label, named in [("gen", gen), ("target", target)]:
            if self.prescribed_name not in named:
                raise ValueError(
                    f"Prescribed variable {self.prescribed_name!r} missing "
                    f"from {label}"
                )
        if self.interpolate:
            mask = mask_data[self.mask_name]
            output = (
                mask * target[self.prescribed_name]
                + (1 - mask) * gen[self.prescribed_name]
            )
        else:
            output = replace_on_mask(
                gen[self.prescribed_name], target[self.prescribed_name],
                mask_data[self.mask_name], self.mask_value,
            )
        return {**gen, self.prescribed_name: output}

    @property
    def prescribed_names(self) -> list[str]:
        return [self.prescribed_name]

    @property
    def mask_names(self) -> list[str]:
        return [self.mask_name]


def mixed_layer_temperature_tendency(
    f_net, q_flux, depth,
    density=DENSITY_OF_WATER, specific_heat=SPECIFIC_HEAT_OF_WATER,
):
    """Slab-ocean mixed-layer temperature tendency, K/s: the net surface
    energy flux plus the q-flux over the layer's heat capacity."""
    return (f_net + q_flux) / (density * depth * specific_heat)


@dataclasses.dataclass(frozen=True)
class SlabOceanConfig:
    """The slab ocean's prescribed fields."""

    mixed_layer_depth_name: str
    q_flux_name: str

    @property
    def names(self) -> list[str]:
        return [self.mixed_layer_depth_name, self.q_flux_name]


@dataclasses.dataclass(frozen=True)
class PrescribedSurfaceTemperature:
    """The next step's SST as the forcing data gives it."""

    surface_temperature_name: str

    def __call__(self, input_data, gen_data, target_data):
        return target_data[self.surface_temperature_name]


@dataclasses.dataclass(frozen=True)
class SlabOceanSurfaceTemperature:
    """The next step's SST stepped by the slab ocean from this step's SST
    with the predicted surface fluxes (those the corrector left) and the
    next step's mixed-layer depth and q-flux."""

    surface_temperature_name: str
    q_flux_name: str
    mixed_layer_depth_name: str
    timestep: datetime.timedelta

    def __call__(self, input_data, gen_data, target_data):
        tendency = mixed_layer_temperature_tendency(
            AtmosphereData(gen_data).net_surface_energy_flux_without_frozen_precip,
            target_data[self.q_flux_name],
            target_data[self.mixed_layer_depth_name],
        )
        return (input_data[self.surface_temperature_name]
                + tendency * self.timestep.total_seconds())


@dataclasses.dataclass(frozen=True)
class OceanConfig:
    """Sea-surface-temperature source: prescribed from the forcing data, or
    a slab ocean when ``slab`` is given; applied over the ocean fraction
    (blended by it when ``interpolate``)."""

    surface_temperature_name: str
    ocean_fraction_name: str
    interpolate: bool = False
    slab: SlabOceanConfig | None = None

    def build(self, in_names, out_names, timestep: datetime.timedelta) -> "Ocean":
        if not (
            self.surface_temperature_name in in_names
            and self.surface_temperature_name in out_names
        ):
            raise ValueError(
                "Surface temperature must be in in_names and out_names, but "
                f"{self.surface_temperature_name} is not."
            )
        prescriber = Prescriber(
            prescribed_name=self.surface_temperature_name,
            mask_name=self.ocean_fraction_name,
            mask_value=1,
            interpolate=self.interpolate,
        )
        if self.slab is None:
            surface_temperature = PrescribedSurfaceTemperature(
                self.surface_temperature_name)
        else:
            surface_temperature = SlabOceanSurfaceTemperature(
                surface_temperature_name=self.surface_temperature_name,
                q_flux_name=self.slab.q_flux_name,
                mixed_layer_depth_name=self.slab.mixed_layer_depth_name,
                timestep=timestep,
            )
        return Ocean(surface_temperature, prescriber, self.forcing_names,
                     self.surface_temperature_name, self.ocean_fraction_name)

    @property
    def is_slab(self) -> bool:
        return self.slab is not None

    @property
    def forcing_names(self) -> list[str]:
        """The next-step fields the ocean reads: the ocean fraction, and the
        SST (prescribed) or the slab's depth and q-flux."""
        names = [self.ocean_fraction_name]
        if self.slab is None:
            names.append(self.surface_temperature_name)
        else:
            names.extend(self.slab.names)
        return sorted(set(names))


class Ocean:
    """Overwrite the predicted SST over the ocean with the prescribed or
    slab-ocean SST."""

    def __init__(self, surface_temperature, prescriber: Prescriber,
                 forcing_names, surface_temperature_name, ocean_fraction_name):
        self._surface_temperature = surface_temperature
        self.prescriber = prescriber
        self._forcing_names = forcing_names
        self.surface_temperature_name = surface_temperature_name
        self.ocean_fraction_name = ocean_fraction_name

    def __call__(self, input_data: TensorMapping, gen_data: TensorMapping,
                 target_data: TensorMapping) -> TensorDict:
        next_step_temperature = self._surface_temperature(
            input_data, gen_data, target_data)
        return self.prescriber(
            target_data, gen_data,
            {self.surface_temperature_name: next_step_temperature},
        )

    @property
    def forcing_names(self) -> list[str]:
        return self._forcing_names
