"""Prescribed sea-surface temperature (port of the prescribed-SST path
of ace_tpu/core/ocean.py). The slab ocean is not ported yet."""

import dataclasses
import datetime

import torch

from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping


def replace_on_mask(original, replacement, mask, mask_value: int):
    """``replacement`` where ``round(mask) == mask_value``, else
    ``original``."""
    return torch.where(torch.round(mask) == mask_value, replacement, original)


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


@dataclasses.dataclass(frozen=True)
class OceanConfig:
    """Sea-surface-temperature source configuration. ``slab`` is accepted
    for config compatibility and must be None."""

    surface_temperature_name: str
    ocean_fraction_name: str
    interpolate: bool = False
    slab: dict | None = None

    def __post_init__(self):
        if self.slab is not None:
            raise NotImplementedError("the slab ocean is not ported yet")

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
        return Ocean(prescriber, self.surface_temperature_name)

    @property
    def forcing_names(self) -> list[str]:
        return sorted({self.ocean_fraction_name, self.surface_temperature_name})


class Ocean:
    """Overwrite the predicted SST with the prescribed next-step SST over
    the ocean."""

    def __init__(self, prescriber: Prescriber, surface_temperature_name: str):
        self.prescriber = prescriber
        self.surface_temperature_name = surface_temperature_name

    def __call__(self, input_data: TensorMapping, gen_data: TensorMapping,
                 target_data: TensorMapping) -> TensorDict:
        name = self.surface_temperature_name
        return self.prescriber(
            target_data, gen_data, {name: target_data[name]}
        )
