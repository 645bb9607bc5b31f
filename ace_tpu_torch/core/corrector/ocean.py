"""Ocean physics-constraint corrector (port of
ace_tpu/core/corrector/ocean.py).

Corrections, in this order: force-positive clamps, the sea-ice fraction
bounds (with the ocean-fraction rebalance and zero-where-ice-free), the
surface energy flux (hfds) from the atmosphere's fluxes, and the ocean
heat content budget by a uniform scaling of the temperatures.
"""

import dataclasses
from typing import Literal

import torch

from ace_tpu_torch.core.atmosphere_data import AtmosphereData
from ace_tpu_torch.core.constants import (
    FREEZING_TEMPERATURE_KELVIN,
    LATENT_HEAT_OF_VAPORIZATION,
    SPECIFIC_HEAT_OF_SEA_WATER_CM4,
)
from ace_tpu_torch.core.corrector.atmosphere import (
    CorrectorOutput,
    CorrectorState,
    force_positive,
    replace_value_keep_gradient,
)
from ace_tpu_torch.core.ocean_data import OceanData
from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping


@dataclasses.dataclass
class SeaIceFractionConfig:
    """Clamp the sea-ice fraction to [0, 1]; optionally remove the
    negative ocean fraction left by the land fraction, and zero
    ``zero_where_ice_free_names`` where there is no ice."""

    sea_ice_fraction_name: str
    land_fraction_name: str
    zero_where_ice_free_names: list[str] = dataclasses.field(
        default_factory=list
    )
    remove_negative_ocean_fraction: bool = True

    def __call__(self, gen_data: TensorMapping, input_data: TensorMapping,
                 keep_gradient: bool = False) -> TensorDict:
        out: TensorDict = {}
        sif = gen_data[self.sea_ice_fraction_name]
        clamped = torch.clamp(sif, 0.0, 1.0)
        if keep_gradient:
            clamped = replace_value_keep_gradient(sif, clamped)
        out[self.sea_ice_fraction_name] = clamped
        if self.remove_negative_ocean_fraction:
            negative_ocean_fraction = torch.clamp(
                1.0 - out[self.sea_ice_fraction_name]
                - input_data[self.land_fraction_name], max=0.0)
            rebalanced = (out[self.sea_ice_fraction_name]
                          + negative_ocean_fraction)
            if keep_gradient:
                rebalanced = replace_value_keep_gradient(
                    out[self.sea_ice_fraction_name], rebalanced)
            out[self.sea_ice_fraction_name] = rebalanced
        for name in self.zero_where_ice_free_names:
            out[name] = gen_data[name] * (out[self.sea_ice_fraction_name]
                                          > 0.0)
        return out


@dataclasses.dataclass
class OceanHeatContentBudgetConfig:
    method: Literal["scaled_temperature"]
    constant_unaccounted_heating: float = 0.0


@dataclasses.dataclass
class SurfaceEnergyFluxCorrectionConfig:
    method: Literal["residual_prediction", "prescribed"]


def compute_ocean_net_surface_energy_flux(forcing_data, sst):
    """Net surface energy flux into the ocean, with the heat carried by
    the mass flux at the SST."""
    atmos = AtmosphereData(forcing_data)
    mass_heat_flux = SPECIFIC_HEAT_OF_SEA_WATER_CM4 * (
        atmos.precipitation_rate + atmos.frozen_precipitation_rate
        - atmos.latent_heat_flux / LATENT_HEAT_OF_VAPORIZATION
    ) * (sst - FREEZING_TEMPERATURE_KELVIN)
    return atmos.net_surface_energy_flux + mass_heat_flux


def _correct_hfds(input_data, gen_data, forcing_data, method) -> TensorDict:
    inp = OceanData(input_data)
    forcing = OceanData(forcing_data)
    ocean_fraction = inp.ocean_fraction
    net_flux = compute_ocean_net_surface_energy_flux(
        forcing_data, inp.sea_surface_temperature)
    if "hfds" in gen_data:
        hfds_name = "hfds"
    else:
        hfds_name = "hfds_total_area"
        net_flux = net_flux * forcing.sea_surface_fraction
    gen_hfds = gen_data[hfds_name]
    if method == "residual_prediction":
        return {hfds_name: net_flux * ocean_fraction + gen_hfds}
    if method == "prescribed":
        return {hfds_name: net_flux * ocean_fraction
                + gen_hfds * (1 - ocean_fraction)}
    raise NotImplementedError(method)


def _force_conserve_ocean_heat_content(
    input_data, gen_data, forcing_data, area_weighted_mean,
    depth_coordinate, timestep_seconds,
    method="scaled_temperature", unaccounted_heating=0.0,
) -> TensorDict:
    """Scale every level's temperature (and the SST above freezing) so
    that the global heat content changes by the net flux into the ocean
    over the step."""
    if method != "scaled_temperature":
        raise NotImplementedError(method)
    if "hfds" in gen_data and "hfds" in forcing_data:
        raise ValueError(
            "hfds cannot be present in both gen_data and forcing_data"
        )
    inp = OceanData(input_data, depth_coordinate)
    gen = OceanData(gen_data, depth_coordinate)
    forcing = OceanData(forcing_data)
    global_gen_ohc = area_weighted_mean(
        gen.ocean_heat_content, keepdim=True, name="ocean_heat_content")
    global_input_ohc = area_weighted_mean(
        inp.ocean_heat_content, keepdim=True, name="ocean_heat_content")
    try:
        net_flux = (gen.net_downward_surface_heat_flux_total_area
                    + forcing.geothermal_heat_flux
                    * forcing.sea_surface_fraction)
    except KeyError:
        try:
            net_flux = (gen.net_downward_surface_heat_flux
                        + forcing.geothermal_heat_flux
                        ) * forcing.sea_surface_fraction
        except KeyError:
            net_flux = (inp.net_downward_surface_heat_flux
                        + forcing.geothermal_heat_flux
                        ) * forcing.sea_surface_fraction
    flux_gm = area_weighted_mean(net_flux, keepdim=True,
                                 name="ocean_heat_content")
    expected_change = (flux_gm + unaccounted_heating) * timestep_seconds
    ratio = (global_input_ohc + expected_change) / global_gen_ohc
    out: TensorDict = {}
    n_levels = gen.sea_water_potential_temperature.shape[-1]
    for k in range(n_levels):
        name = f"thetao_{k}"
        out[name] = gen.data[name] * ratio
    if "sst" in gen.data:
        out["sst"] = ((gen.data["sst"] - FREEZING_TEMPERATURE_KELVIN) * ratio
                      + FREEZING_TEMPERATURE_KELVIN)
    return out


@dataclasses.dataclass
class OceanCorrectorConfig:
    """The ocean corrector's configuration, with the JAX package's fields
    (port of ace_tpu/core/corrector/ocean.py:184)."""

    sea_ice_fraction_correction: SeaIceFractionConfig | None = None
    surface_energy_flux_correction: (
        SurfaceEnergyFluxCorrectionConfig | None
    ) = None
    ocean_heat_content_correction: OceanHeatContentBudgetConfig | None = None
    force_positive_names: list[str] = dataclasses.field(default_factory=list)
    keep_gradient_through_clamps: bool = False
    corrector_disabled_epochs: int = 0

    def __post_init__(self):
        if self.corrector_disabled_epochs < 0:
            raise ValueError(
                "corrector_disabled_epochs must be non-negative, got "
                f"{self.corrector_disabled_epochs}"
            )

    @property
    def is_noop(self) -> bool:
        return not (
            self.sea_ice_fraction_correction
            or self.surface_energy_flux_correction
            or self.ocean_heat_content_correction
            or self.force_positive_names
        )

    def build(self, gridded_operations, depth_coordinate, timestep):
        return OceanCorrector(
            config=self,
            area_weighted_mean=gridded_operations.area_weighted_mean,
            depth_coordinate=depth_coordinate,
            timestep_seconds=timestep.total_seconds(),
        )


class OceanCorrector:
    def __init__(self, config, area_weighted_mean, depth_coordinate,
                 timestep_seconds):
        self.config = config
        self._awm = area_weighted_mean
        self._dc = depth_coordinate
        self._dt = timestep_seconds

    def init_state(self, input_data: TensorMapping) -> CorrectorState:
        return {}

    def __call__(self, input_data, gen_data, forcing_data,
                 corrector_state) -> CorrectorOutput:
        cfg = self.config
        snapshot = dict(gen_data)
        gen = dict(gen_data)
        modified: set[str] = set()

        def apply(changed: TensorDict):
            gen.update(changed)
            modified.update(changed.keys())

        if cfg.force_positive_names:
            apply(force_positive(gen, cfg.force_positive_names,
                                 cfg.keep_gradient_through_clamps))
        if cfg.sea_ice_fraction_correction is not None:
            apply(cfg.sea_ice_fraction_correction(
                gen, input_data,
                keep_gradient=cfg.keep_gradient_through_clamps))
        if cfg.surface_energy_flux_correction is not None:
            apply(_correct_hfds(input_data, gen, forcing_data,
                                cfg.surface_energy_flux_correction.method))
        if cfg.ocean_heat_content_correction is not None:
            oc = cfg.ocean_heat_content_correction
            apply(_force_conserve_ocean_heat_content(
                input_data, gen, forcing_data, self._awm, self._dc,
                self._dt, method=oc.method,
                unaccounted_heating=oc.constant_unaccounted_heating))
        delta = {k: (gen[k] - snapshot[k]).detach() for k in modified}
        return CorrectorOutput(corrected=gen,
                               corrector_state=dict(corrector_state or {}),
                               delta=delta)
