"""Named-field accessor over a TensorDict with the atmospheric physics
the corrector and the derived variables need (port of
ace_tpu/core/atmosphere_data.py and ace_tpu/core/stacker.py).

Vertical-level variables (``specific_total_water_{k}``) are stacked on
demand along a trailing axis.
"""

import re

import torch

from ace_tpu_torch.core import metrics
from ace_tpu_torch.core.constants import (
    GRAVITY,
    LATENT_HEAT_OF_FREEZING,
    LATENT_HEAT_OF_VAPORIZATION,
    RDGAS,
    RVGAS,
    SPECIFIC_HEAT_OF_DRY_AIR_CONST_VOLUME,
)
from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping

ATMOSPHERE_FIELD_NAME_PREFIXES = {
    "specific_total_water": ["specific_total_water_"],
    "surface_pressure": ["PRESsfc", "PS"],
    "surface_height": ["HGTsfc"],
    "surface_geopotential": ["PHIS"],
    "tendency_of_total_water_path_due_to_advection": [
        "tendency_of_total_water_path_due_to_advection"
    ],
    "latent_heat_flux": ["LHTFLsfc", "LHFLX"],
    "sensible_heat_flux": ["SHTFLsfc", "SHFLX"],
    "precipitation_rate": ["PRATEsfc", "surface_precipitation_rate"],
    "sfc_down_sw_radiative_flux": ["DSWRFsfc", "FSDS"],
    "sfc_up_sw_radiative_flux": ["USWRFsfc", "surface_upward_shortwave_flux"],
    "sfc_down_lw_radiative_flux": ["DLWRFsfc", "FLDS"],
    "sfc_up_lw_radiative_flux": ["ULWRFsfc", "surface_upward_longwave_flux"],
    "toa_up_lw_radiative_flux": ["ULWRFtoa", "FLUT"],
    "toa_up_sw_radiative_flux": ["USWRFtoa",
                                 "top_of_atmos_upward_shortwave_flux"],
    "toa_down_sw_radiative_flux": ["DSWRFtoa", "SOLIN"],
    "air_temperature": ["air_temperature_", "T_"],
    "frozen_precipitation_rate": ["total_frozen_precipitation_rate"],
    "eastward_wind_at_10m": ["UGRD10m"],
    "northward_wind_at_10m": ["VGRD10m"],
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
        names = self.get_all_vertical_level_names(name)
        return torch.stack([self._data[n] for n in names], dim=-1)

    def get_all_vertical_level_names(self, name: str) -> list[str]:
        return get_all_level_names(self._prefix_map[name], self._data)

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
    def latent_heat_flux(self):
        return self._get("latent_heat_flux")

    @property
    def evaporation_rate(self):
        return self._get("latent_heat_flux") / LATENT_HEAT_OF_VAPORIZATION

    def set_evaporation_rate(self, value):
        self._set("latent_heat_flux", value * LATENT_HEAT_OF_VAPORIZATION)

    @property
    def frozen_precipitation_rate(self):
        """The frozen precipitation, else the sum of its three parts, else
        zero."""
        try:
            return self._get("frozen_precipitation_rate")
        except KeyError:
            try:
                return (self._data["ICEsfc"] + self._data["GRAUPELsfc"]
                        + self._data["SNOWsfc"])
            except KeyError:
                try:
                    return torch.zeros_like(self.surface_pressure)
                except KeyError:
                    return torch.zeros_like(self.precipitation_rate)

    def set_frozen_precipitation_rate(self, value):
        self._set("frozen_precipitation_rate", value)

    @property
    def tendency_of_total_water_path_due_to_advection(self):
        return self._get("tendency_of_total_water_path_due_to_advection")

    def set_tendency_of_total_water_path_due_to_advection(self, value):
        self._set("tendency_of_total_water_path_due_to_advection", value)

    @property
    def air_temperature(self) -> torch.Tensor:
        return self._stacked("air_temperature")

    @property
    def surface_height(self) -> torch.Tensor:
        try:
            return self._get("surface_height")
        except KeyError:
            # E3SM stores geopotential; convert with its gravity constant
            return self._get("surface_geopotential") / 9.80616

    @property
    def toa_down_sw_radiative_flux(self):
        return self._get("toa_down_sw_radiative_flux")

    @property
    def net_surface_energy_flux_without_frozen_precip(self):
        """Net surface energy flux, W/m^2, positive into the surface, without
        the latent heat of the frozen precipitation (what the slab ocean
        absorbs)."""
        radiative = (
            self._get("sfc_down_sw_radiative_flux")
            - self._get("sfc_up_sw_radiative_flux")
            + self._get("sfc_down_lw_radiative_flux")
            - self._get("sfc_up_lw_radiative_flux")
        )
        turbulent = (-self._get("latent_heat_flux")
                     - self._get("sensible_heat_flux"))
        return radiative + turbulent

    @property
    def net_surface_energy_flux(self):
        """Net surface energy flux, W/m^2, positive into the surface."""
        return (self.net_surface_energy_flux_without_frozen_precip
                - self.frozen_precipitation_rate * LATENT_HEAT_OF_FREEZING)

    @property
    def net_top_of_atmosphere_energy_flux(self):
        """Net TOA energy flux, W/m^2, positive into the atmosphere."""
        return (self._get("toa_down_sw_radiative_flux")
                - self._get("toa_up_sw_radiative_flux")
                - self._get("toa_up_lw_radiative_flux"))

    @property
    def net_energy_flux_into_atmosphere(self):
        return (self.net_top_of_atmosphere_energy_flux
                - self.net_surface_energy_flux)

    @property
    def height_at_midpoint(self) -> torch.Tensor:
        if self._vertical_coordinate is None:
            raise ValueError("height_at_midpoint requires a vertical coordinate")
        interface_pressure = self._vertical_coordinate.interface_pressure(
            self.surface_pressure
        )
        thickness = compute_layer_thickness(
            interface_pressure, self.air_temperature, self.specific_total_water
        )
        height = _height_at_interface(thickness, self.surface_height)
        return 0.5 * (height[..., :-1] + height[..., 1:])

    @property
    def total_energy_ace2(self) -> torch.Tensor:
        """Total energy under ACE2's assumptions: no kinetic energy,
        hydrostatic geopotential, total water as specific humidity."""
        return (
            self.air_temperature * SPECIFIC_HEAT_OF_DRY_AIR_CONST_VOLUME
            + self.specific_total_water * LATENT_HEAT_OF_VAPORIZATION
            + self.height_at_midpoint * GRAVITY
        )

    @property
    def total_energy_ace2_path(self) -> torch.Tensor:
        if self._vertical_coordinate is None:
            # a ValueError, so that the derived-variable pass skips it
            raise ValueError(
                "total_energy_ace2_path requires a vertical coordinate"
            )
        return self._vertical_coordinate.vertical_integral(
            self.total_energy_ace2, self.surface_pressure
        )

    @property
    def windspeed_at_10m(self) -> torch.Tensor:
        return torch.sqrt(self._get("eastward_wind_at_10m") ** 2
                          + self._get("northward_wind_at_10m") ** 2)


def compute_layer_thickness(pressure_at_interface, air_temperature,
                            specific_total_water) -> torch.Tensor:
    """Hydrostatic layer thickness; the interface pressure is clamped to
    at least 1 Pa before the log (ERA5's top interface is 0 Pa)."""
    tv = air_temperature * (1 + (RVGAS / RDGAS - 1.0) * specific_total_water)
    dlogp = torch.diff(torch.log(pressure_at_interface.clamp(min=1.0)), dim=-1)
    return dlogp * RDGAS * tv / GRAVITY


def _height_at_interface(layer_thickness, surface_height) -> torch.Tensor:
    cumulative = torch.flip(
        torch.cumsum(torch.flip(layer_thickness, dims=(-1,)), dim=-1),
        dims=(-1,),
    )
    hsfc = torch.where(surface_height < 0.0, 0.0, surface_height)[..., None]
    return torch.cat(
        [cumulative + hsfc.expand_as(cumulative),
         hsfc.expand(*cumulative.shape[:-1], 1)],
        dim=-1,
    )
