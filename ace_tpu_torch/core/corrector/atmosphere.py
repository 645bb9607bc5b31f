"""Atmosphere physics-constraint corrector (port of
ace_tpu/core/corrector/atmosphere.py).

Ported: force-positive clamps, global dry-air mass conservation, zero
global-mean moisture advection and the moisture-budget closure (with the
frozen-precipitation clip). The total-energy budget correction is not
ported yet and raises. Corrections are applied in the JAX package's
order; the per-sample state (the IC's global dry-air mass) is seeded from
the initial condition before the rollout.
"""

import dataclasses
from typing import Literal

import torch

from ace_tpu_torch.core.atmosphere_data import AtmosphereData
from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping

CorrectorState = dict


@dataclasses.dataclass
class AtmosphereCorrectorConfig:
    """Post-step corrector configuration, with the JAX package's fields.
    ``total_energy_budget_correction`` must be None for now;
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
    total_energy_budget_correction: dict | None = None
    keep_gradient_through_clamps: bool = False
    clip_frozen_precipitation: bool = False
    corrector_disabled_epochs: int = 0

    def __post_init__(self):
        if self.total_energy_budget_correction is not None:
            raise NotImplementedError(
                "the total energy budget correction is not ported yet"
            )
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
            def clamp(x):
                clamped = torch.clamp(x, min=0.0)
                if cfg.keep_gradient_through_clamps:
                    # the clamped value with the gradient of the identity
                    return x + (clamped - x).detach()
                return clamped

            apply({n: clamp(gen[n]) for n in cfg.force_positive_names})
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
