"""Named-field accessor over a TensorDict with the atmospheric physics
the corrector needs (port of ace_tpu/core/atmosphere_data.py and
ace_tpu/core/stacker.py).

Vertical-level variables (``specific_total_water_{k}``) are stacked on
demand along a trailing axis.
"""

import re

import torch

from ace_tpu_torch.core import metrics
from ace_tpu_torch.core.constants import LATENT_HEAT_OF_VAPORIZATION
from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping

ATMOSPHERE_FIELD_NAME_PREFIXES = {
    "specific_total_water": ["specific_total_water_"],
    "surface_pressure": ["PRESsfc", "PS"],
    "tendency_of_total_water_path_due_to_advection": [
        "tendency_of_total_water_path_due_to_advection"
    ],
    "latent_heat_flux": ["LHTFLsfc", "LHFLX"],
    "precipitation_rate": ["PRATEsfc", "surface_precipitation_rate"],
    "air_temperature": ["air_temperature_", "T_"],
    "frozen_precipitation_rate": ["total_frozen_precipitation_rate"],
}

LEVEL_PATTERN = re.compile(r"_(\d+)$")


def _natural_sort(names: list[str]) -> list[str]:
    def key(name: str):
        match = LEVEL_PATTERN.search(name)
        return (int(match.group(1)) if match else -1, name)

    return sorted(names, key=key)


def get_all_level_names(prefixes: list[str], data: TensorMapping) -> list[str]:
    """Names of a variable's levels ``prefix0, prefix1, ...`` (or the one
    exact name of a 2-D variable), in level order."""
    for prefix in prefixes:
        if prefix in data:
            return [prefix]
        level_names = [
            name for name in data
            if name.startswith(prefix) and name[len(prefix):].isdigit()
        ]
        if level_names:
            level_names = _natural_sort(level_names)
            levels = [int(LEVEL_PATTERN.search(n).group(1)) for n in level_names]
            if levels != list(range(len(levels))):
                raise ValueError(
                    f"missing vertical levels for {prefix}: got {levels}"
                )
            return level_names
    raise KeyError(prefixes[0])


class AtmosphereData:
    def __init__(self, atmosphere_data: TensorMapping, vertical_coordinate=None):
        self._data = dict(atmosphere_data)
        self._prefix_map = ATMOSPHERE_FIELD_NAME_PREFIXES
        self._vertical_coordinate = vertical_coordinate
        self._modified_keys: set[str] = set()

    @property
    def modified_data(self) -> TensorDict:
        return {k: self._data[k] for k in self._modified_keys}

    def _get(self, name):
        for prefix in self._prefix_map[name]:
            if prefix in self._data:
                return self._data[prefix]
        raise KeyError(name)

    def _set(self, name, value):
        for prefix in self._prefix_map[name]:
            if prefix in self._data:
                self._data[prefix] = value
                self._modified_keys.add(prefix)
                return
        raise KeyError(name)

    def _stacked(self, name) -> torch.Tensor:
        names = get_all_level_names(self._prefix_map[name], self._data)
        return torch.stack([self._data[n] for n in names], dim=-1)

    @property
    def specific_total_water(self) -> torch.Tensor:
        return self._stacked("specific_total_water")

    @property
    def surface_pressure(self) -> torch.Tensor:
        return self._get("surface_pressure")

    def set_surface_pressure(self, value):
        self._set("surface_pressure", value)

    @property
    def total_water_path(self) -> torch.Tensor:
        if self._vertical_coordinate is None:
            raise ValueError(
                "Vertical coordinate required to compute total water path."
            )
        return self._vertical_coordinate.vertical_integral(
            self.specific_total_water, self.surface_pressure
        )

    @property
    def surface_pressure_due_to_dry_air(self) -> torch.Tensor:
        if self._vertical_coordinate is None:
            raise ValueError("Vertical coordinate required to compute dry air.")
        return metrics.surface_pressure_due_to_dry_air(
            self.surface_pressure, self.total_water_path
        )

    @property
    def precipitation_rate(self):
        return self._get("precipitation_rate")

    def set_precipitation_rate(self, value):
        self._set("precipitation_rate", value)

    @property
    def evaporation_rate(self):
        return self._get("latent_heat_flux") / LATENT_HEAT_OF_VAPORIZATION

    def set_evaporation_rate(self, value):
        self._set("latent_heat_flux", value * LATENT_HEAT_OF_VAPORIZATION)

    @property
    def frozen_precipitation_rate(self):
        return self._get("frozen_precipitation_rate")

    def set_frozen_precipitation_rate(self, value):
        self._set("frozen_precipitation_rate", value)

    @property
    def tendency_of_total_water_path_due_to_advection(self):
        return self._get("tendency_of_total_water_path_due_to_advection")

    def set_tendency_of_total_water_path_due_to_advection(self, value):
        self._set("tendency_of_total_water_path_due_to_advection", value)
