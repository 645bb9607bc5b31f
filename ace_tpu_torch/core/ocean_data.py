"""Ocean field accessor with depth-level stacking and heat content (port
of ace_tpu/core/ocean_data.py)."""

from collections.abc import Mapping

import torch

from ace_tpu_torch.core.constants import (
    DENSITY_OF_SEA_WATER_CM4,
    SPECIFIC_HEAT_OF_SEA_WATER_CM4,
)
from ace_tpu_torch.core.stacker import Stacker
from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping

OCEAN_FIELD_NAME_PREFIXES = {
    "sea_water_potential_temperature": ["thetao_"],
    "sea_water_salinity": ["so_"],
    "sea_water_x_velocity": ["uo_"],
    "sea_water_y_velocity": ["vo_"],
    "sea_surface_height_above_geoid": ["zos"],
    "sea_surface_temperature": ["sst"],
    "sea_ice_fraction": ["sea_ice_fraction"],
    "sea_ice_thickness": ["HI"],
    "sea_ice_volume": ["sea_ice_volume"],
    "ocean_sea_ice_fraction": ["ocean_sea_ice_fraction"],
    "land_fraction": ["land_fraction"],
    "ocean_fraction": ["ocean_fraction"],
    "net_downward_surface_heat_flux": ["hfds"],
    "net_downward_surface_heat_flux_total_area": ["hfds_total_area"],
    "geothermal_heat_flux": ["hfgeou"],
    "sea_surface_fraction": ["sea_surface_fraction"],
}


class OceanData:
    def __init__(self, ocean_data: TensorMapping, depth_coordinate=None,
                 ocean_field_name_prefixes: Mapping[str, list[str]] | None
                 = None):
        if ocean_field_name_prefixes is None:
            ocean_field_name_prefixes = dict(OCEAN_FIELD_NAME_PREFIXES)
        self._data = dict(ocean_data)
        self._prefix_map = ocean_field_name_prefixes
        self._depth_coordinate = depth_coordinate
        self._stacker = Stacker(ocean_field_name_prefixes)

    @property
    def data(self) -> TensorDict:
        return self._data

    def _get(self, name):
        for prefix in self._prefix_map[name]:
            if prefix in self._data:
                return self._data[prefix]
        raise KeyError(name)

    @property
    def sea_water_potential_temperature(self) -> torch.Tensor:
        return self._stacker("sea_water_potential_temperature", self._data)

    @property
    def sea_surface_temperature(self):
        return self._get("sea_surface_temperature")

    @property
    def sea_surface_height_above_geoid(self):
        return self._get("sea_surface_height_above_geoid")

    @property
    def ocean_heat_content(self) -> torch.Tensor:
        """Column-integrated heat content, J/m**2."""
        if self._depth_coordinate is None:
            raise ValueError(
                "Depth coordinate required to compute ocean heat content."
            )
        return (self._depth_coordinate.depth_integral(
            self.sea_water_potential_temperature)
            * DENSITY_OF_SEA_WATER_CM4 * SPECIFIC_HEAT_OF_SEA_WATER_CM4)

    @property
    def sea_ice_fraction(self):
        return self._get("sea_ice_fraction")

    @property
    def land_fraction(self):
        return self._get("land_fraction")

    @property
    def ocean_fraction(self):
        try:
            return self._get("ocean_fraction")
        except KeyError:
            return 1.0 - self.sea_ice_fraction - self.land_fraction

    @property
    def net_downward_surface_heat_flux(self):
        try:
            return self._get("net_downward_surface_heat_flux")
        except KeyError:
            return (self.net_downward_surface_heat_flux_total_area
                    / self.sea_surface_fraction)

    @property
    def net_downward_surface_heat_flux_total_area(self):
        return self._get("net_downward_surface_heat_flux_total_area")

    @property
    def geothermal_heat_flux(self):
        try:
            return self._get("geothermal_heat_flux")
        except KeyError:
            return torch.zeros_like(torch.as_tensor(self.sea_surface_fraction))

    @property
    def sea_surface_fraction(self):
        try:
            return self._get("sea_surface_fraction")
        except KeyError:
            return 1.0 - self.land_fraction

    @property
    def net_energy_flux_into_ocean(self):
        return ((self.net_downward_surface_heat_flux
                 + self.geothermal_heat_flux) * self.sea_surface_fraction)
