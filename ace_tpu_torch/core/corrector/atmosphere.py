"""Atmosphere physics-constraint corrector (port of
ace_tpu/core/corrector/atmosphere.py).

Force-positive clamps, global dry-air mass conservation, zero global-mean
moisture advection, the moisture-budget closure (with the
frozen-precipitation clip) and the total-energy budget correction (a
uniform air-temperature change), applied in the JAX package's order; the
per-sample state (the IC's global dry-air mass) is seeded from the
initial condition before the rollout.
"""

import dataclasses
from typing import Literal

import torch

from ace_tpu_torch.core.atmosphere_data import (
    AtmosphereData,
    compute_layer_thickness,
)
from ace_tpu_torch.core.constants import (
    GRAVITY,
    SPECIFIC_HEAT_OF_DRY_AIR_CONST_VOLUME,
)
from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping

CorrectorState = dict


def replace_value_keep_gradient(x: torch.Tensor,
                                new_value: torch.Tensor) -> torch.Tensor:
    """``new_value`` in the forward pass with the gradient of the identity
    on ``x`` (a straight-through estimator)."""
    return x + (new_value - x).detach()


def force_positive(data: TensorMapping, names: list[str],
                   keep_gradient: bool = False) -> TensorDict:
    """``data``'s ``names`` clamped at 0 (with ``keep_gradient``, with the
    identity's gradient)."""
    out: TensorDict = {}
    for name in names:
        clamped = torch.clamp(data[name], min=0.0)
        if keep_gradient:
            clamped = replace_value_keep_gradient(data[name], clamped)
        out[name] = clamped
    return out


@dataclasses.dataclass
class EnergyBudgetConfig:
    """Total energy budget correction (port of
    ace_tpu/core/corrector/atmosphere.py:57)."""

    method: Literal["constant_temperature"]
    constant_unaccounted_heating: float = 0.0


@dataclasses.dataclass
class AtmosphereCorrectorConfig:
    """Post-step corrector configuration, with the JAX package's fields.
    ``keep_gradient_through_clamps`` and ``corrector_disabled_epochs``
    concern training only."""

    conserve_dry_air: bool = False
    zero_global_mean_moisture_advection: bool = False
    moisture_budget_correction: (
        Literal[
            "precipitation",
            "evaporation",
            "advection_and_precipitation",
            "advection_and_evaporation",
        ]
        | None
    ) = None
    force_positive_names: list[str] = dataclasses.field(default_factory=list)
    total_energy_budget_correction: EnergyBudgetConfig | None = None
    keep_gradient_through_clamps: bool = False
    clip_frozen_precipitation: bool = False
    corrector_disabled_epochs: int = 0

    def __post_init__(self):
        if self.corrector_disabled_epochs < 0:
            raise ValueError(
                "corrector_disabled_epochs must be non-negative, got "
                f"{self.corrector_disabled_epochs}"
            )

    def build(self, gridded_operations, vertical_coordinate, timestep):
        return AtmosphereCorrector(
            config=self,
            area_weighted_mean=gridded_operations.area_weighted_mean,
            vertical_coordinate=vertical_coordinate,
            timestep_seconds=timestep.total_seconds(),
        )

    @property
    def is_noop(self) -> bool:
        return not (
            self.conserve_dry_air
            or self.zero_global_mean_moisture_advection
            or self.moisture_budget_correction is not None
            or self.force_positive_names
            or self.total_energy_budget_correction is not None
        )


@dataclasses.dataclass
class CorrectorOutput:
    corrected: TensorDict
    corrector_state: CorrectorState
    delta: TensorDict  # per-variable correction diagnostics


class AtmosphereCorrector:
    def __init__(self, config, area_weighted_mean, vertical_coordinate,
                 timestep_seconds):
        self.config = config
        self._awm = area_weighted_mean
        self._vc = vertical_coordinate
        self._dt = timestep_seconds
        if config.conserve_dry_air and vertical_coordinate is None:
            raise ValueError("conserve_dry_air requires a vertical coordinate")
        if config.moisture_budget_correction and vertical_coordinate is None:
            raise ValueError(
                "moisture budget correction requires a vertical coordinate"
            )

    def init_state(self, input_data: TensorMapping) -> CorrectorState:
        """Per-sample state seeded from the initial condition."""
        state: CorrectorState = {}
        if self.config.conserve_dry_air:
            ic = AtmosphereData(input_data, self._vc)
            state["global_dry_air_mass"] = self._awm(
                ic.surface_pressure_due_to_dry_air, keepdim=True
            )
        return state

    def __call__(self, input_data: TensorMapping, gen_data: TensorMapping,
                 forcing_data: TensorMapping,
                 corrector_state: CorrectorState | None) -> CorrectorOutput:
        cfg = self.config
        state = dict(corrector_state or {})
        snapshot = dict(gen_data)
        gen = dict(gen_data)
        modified: set[str] = set()

        def apply(changed: TensorDict):
            gen.update(changed)
            modified.update(changed.keys())

        if cfg.force_positive_names:
            apply(force_positive(gen, cfg.force_positive_names,
                                 cfg.keep_gradient_through_clamps))
        if cfg.conserve_dry_air:
            if "global_dry_air_mass" not in state:
                state.update(self.init_state(input_data))
            apply(_adjust_gen_dry_air_to_target(
                gen, state["global_dry_air_mass"], self._awm, self._vc
            ))
        if cfg.zero_global_mean_moisture_advection:
            apply(_force_zero_global_mean_moisture_advection(gen, self._awm))
        if cfg.moisture_budget_correction is not None:
            apply(_force_conserve_moisture(
                input_data, gen, self._awm, self._vc, self._dt,
                cfg.moisture_budget_correction,
            ))
            if cfg.clip_frozen_precipitation:
                apply(_clip_frozen_precipitation(gen))
        if cfg.total_energy_budget_correction is not None:
            ec = cfg.total_energy_budget_correction
            apply(_force_conserve_total_energy(
                input_data, gen, forcing_data, self._awm, self._vc, self._dt,
                method=ec.method,
                unaccounted_heating=ec.constant_unaccounted_heating,
            ))
        delta = {k: gen[k] - snapshot[k] for k in modified}
        return CorrectorOutput(corrected=gen, corrector_state=state, delta=delta)


def _adjust_gen_dry_air_to_target(gen_data, target_global_dry_air,
                                  area_weighted_mean, vertical_coordinate):
    """Pin the global-mean dry-air mass to the target by a globally
    constant dry-air pressure offset, solving for the consistent surface
    pressure:

        dry_air = ps - sum_k((ak_diff + bk_diff * ps) * wat_k)
        ps = (dry_air + sum_k(ak_diff * wat_k)) / (1 - sum_k(bk_diff * wat_k))

    The error is averaged in anomaly space, which keeps the float32
    reduction at the scale of the correction.
    """
    gen = AtmosphereData(gen_data, vertical_coordinate)
    gen_dry_air = gen.surface_pressure_due_to_dry_air
    error = area_weighted_mean(gen_dry_air - target_global_dry_air,
                               keepdim=True)
    new_gen_dry_air = gen_dry_air - error
    wat = gen.specific_total_water
    ak_diff = torch.diff(vertical_coordinate.get_ak(wat.device))
    bk_diff = torch.diff(vertical_coordinate.get_bk(wat.device))
    new_pressure = (new_gen_dry_air + (ak_diff * wat).sum(-1)) / (
        1 - (bk_diff * wat).sum(-1)
    )
    gen.set_surface_pressure(new_pressure)
    return gen.modified_data


def _force_zero_global_mean_moisture_advection(gen_data, area_weighted_mean):
    gen = AtmosphereData(gen_data)
    adv = gen.tendency_of_total_water_path_due_to_advection
    mean_adv = area_weighted_mean(adv, keepdim=True)
    gen.set_tendency_of_total_water_path_due_to_advection(adv - mean_adv)
    return gen.modified_data


def _clip_frozen_precipitation(gen_data: TensorMapping) -> TensorDict:
    """Frozen precipitation is part of the total: clip it to the
    (corrected) total rate."""
    if "total_frozen_precipitation_rate" not in gen_data:
        return {}
    gen = AtmosphereData(gen_data)
    gen.set_frozen_precipitation_rate(
        torch.minimum(gen.frozen_precipitation_rate, gen.precipitation_rate)
    )
    return gen.modified_data


def _force_conserve_moisture(input_data, gen_data, area_weighted_mean,
                             vertical_coordinate, timestep_seconds,
                             terms_to_modify):
    """Close the global moisture budget."""
    inp = AtmosphereData(input_data, vertical_coordinate)
    gen = AtmosphereData(gen_data, vertical_coordinate)
    twp_total_tendency = (
        gen.total_water_path - inp.total_water_path
    ) / timestep_seconds
    twp_tendency_gm = area_weighted_mean(twp_total_tendency, keepdim=True)
    evap_gm = area_weighted_mean(gen.evaporation_rate, keepdim=True)
    precip_gm = area_weighted_mean(gen.precipitation_rate, keepdim=True)
    if terms_to_modify.endswith("precipitation"):
        new_precip_gm = evap_gm - twp_tendency_gm
        gen.set_precipitation_rate(
            gen.precipitation_rate * (new_precip_gm / precip_gm)
        )
    elif terms_to_modify.endswith("evaporation"):
        new_evap_gm = twp_tendency_gm + precip_gm
        gen.set_evaporation_rate(
            gen.evaporation_rate * (new_evap_gm / evap_gm)
        )
    if terms_to_modify.startswith("advection"):
        new_advection = twp_total_tendency - (
            gen.evaporation_rate - gen.precipitation_rate
        )
        gen.set_tendency_of_total_water_path_due_to_advection(new_advection)
    return gen.modified_data


def _force_conserve_total_energy(
    input_data, gen_data, forcing_data, area_weighted_mean,
    vertical_coordinate, timestep_seconds,
    method="constant_temperature", unaccounted_heating=0.0,
) -> TensorDict:
    """Conserve the global total energy by one air-temperature change,
    uniform over the globe and the column: the generated energy path's
    global mean is set to the input's plus the net flux into the
    atmosphere (and ``unaccounted_heating``) over the timestep."""
    if method != "constant_temperature":
        raise NotImplementedError(
            f"method {method} not implemented for total energy conservation"
        )
    inp = AtmosphereData(input_data, vertical_coordinate)
    forcing = AtmosphereData(forcing_data)
    atmosphere_data = dict(gen_data)
    atmosphere_data["DSWRFtoa"] = forcing.toa_down_sw_radiative_flux
    atmosphere_data["HGTsfc"] = forcing.surface_height
    gen = AtmosphereData(atmosphere_data, vertical_coordinate)

    gen_energy_gm = area_weighted_mean(gen.total_energy_ace2_path,
                                       keepdim=True)
    input_energy_gm = area_weighted_mean(inp.total_energy_ace2_path,
                                         keepdim=True)
    flux_gm = area_weighted_mean(gen.net_energy_flux_into_atmosphere,
                                 keepdim=True)
    desired_energy_gm = (
        input_energy_gm + (flux_gm + unaccounted_heating) * timestep_seconds
    )
    energy_correction = desired_energy_gm - gen_energy_gm
    factor_gm = area_weighted_mean(
        _energy_correction_factor(gen, vertical_coordinate), keepdim=True
    )
    temperature_correction = energy_correction / factor_gm
    names = gen.get_all_vertical_level_names("air_temperature")
    return {name: gen_data[name] + temperature_correction for name in names}


def _energy_correction_factor(gen: AtmosphereData, vertical_coordinate):
    """The change of the column's total energy per kelvin of a uniform
    temperature change."""
    interface_pressure = vertical_coordinate.interface_pressure(
        gen.surface_pressure
    )
    q_times_dlogp = (
        compute_layer_thickness(
            interface_pressure, gen.air_temperature, gen.specific_total_water
        )
        * GRAVITY
        / gen.air_temperature
    )
    cumulative = torch.flip(
        torch.cumsum(torch.flip(q_times_dlogp, dims=(-1,)), dim=-1),
        dims=(-1,),
    )
    total_integrand = (
        SPECIFIC_HEAT_OF_DRY_AIR_CONST_VOLUME - 0.5 * q_times_dlogp
        + cumulative
    )
    return vertical_coordinate.vertical_integral(
        total_integrand, gen.surface_pressure
    )
