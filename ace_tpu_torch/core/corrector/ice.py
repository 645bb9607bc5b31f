"""Sea-ice budget corrector (port of ace_tpu/core/corrector/ice.py).

Rebuilds the sea-ice concentration, ice mass and snow mass from their
predicted source, sink and transport terms, rebalancing the terms so that
the update stays non-negative (and a concentration at most 1), with the
source kept >= 0 and the sink <= 0 by moving residuals to the transport
term. As in the JAX package, the rebalance is one masked elementwise pass
(zero correction where nothing is violated), so nothing branches on the
data and nothing waits for the device.
"""

import dataclasses

import torch

from ace_tpu_torch.core.corrector.atmosphere import (
    CorrectorOutput,
    CorrectorState,
)
from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping

_SIC_VARS = ("siconc", "sea_ice_fraction", "ocean_sea_ice_fraction")


def _rebalance(s, k, t, mask, mass, sign=1.0):
    """Spread ``mass`` over the nonzero terms where ``mask`` holds (all of
    it to the transport where every term is zero), then move any
    overshoot of the sink above 0 or the source below 0 to the
    transport."""
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    nz_s, nz_k, nz_t = s.abs() > 0, k.abs() > 0, t.abs() > 0
    n_active = nz_s.to(s.dtype) + nz_k.to(s.dtype) + nz_t.to(s.dtype)
    share = torch.where(mask & (n_active > 0),
                        mass / torch.clamp(n_active, min=1.0), zero)
    resid_s = torch.where(mask & nz_s, share, zero)
    resid_k = torch.where(mask & nz_k, share, zero)
    resid_t = torch.where(mask & nz_t, share, zero)
    resid_t = torch.where(mask & (n_active == 0), mass, resid_t)
    # the sink must stay <= 0; an overshoot moves to the transport
    tmp = k + sign * resid_k
    k_overshoot = torch.where(mask & (tmp > 0), tmp, zero)
    resid_k = resid_k - k_overshoot
    resid_t = resid_t + k_overshoot
    # the source must stay >= 0
    tmp = s + sign * resid_s
    s_overshoot = torch.where(mask & (tmp < 0), tmp, zero)
    resid_s = resid_s - sign * s_overshoot
    resid_t = resid_t + sign * s_overshoot
    return s + sign * resid_s, k + sign * resid_k, t + sign * resid_t


def _bounded(x, area_mode, ice_mask):
    """``x`` clamped at 0, at 1 too in ``area_mode``, and 0 where the
    ice mask is 0."""
    target = torch.clamp(x, min=0.0)
    if area_mode:
        target = torch.clamp(target, max=1.0)
    if ice_mask is not None:
        target = torch.where(ice_mask == 0, torch.zeros_like(target), target)
    return target


@dataclasses.dataclass
class IceBudgetCorrectionConfig:
    """``corrected_variables`` orders each variable's budget terms as
    ``{'variable': ['source_term', 'sink_term', 'transport_term']}``."""

    corrected_variables: dict[str, list[str]] | None = None

    def constrain_budgets(self, old_mass, source, sink, transport,
                          timestep: float, area_mode: bool = False,
                          ice_mask=None):
        s, k, t = source * timestep, sink * timestep, transport * timestep
        zero = torch.zeros((), dtype=s.dtype, device=s.device)
        new_mass = old_mass + (s + k + t)
        neg_mask = new_mass < 0
        s, k, t = _rebalance(s, k, t, neg_mask,
                             torch.where(neg_mask, -new_mass, zero), 1.0)
        if area_mode:
            new_mass = old_mass + (s + k + t)
            high_mask = new_mass > 1
            s, k, t = _rebalance(
                s, k, t, high_mask,
                torch.where(high_mask, new_mass - 1.0, zero), -1.0)
        if ice_mask is not None:
            new_mass = old_mass + (s + k + t)
            high_mask = (ice_mask == 0) & (new_mass > 0)
            s, k, t = _rebalance(s, k, t, high_mask,
                                 torch.where(high_mask, new_mass, zero), -1.0)
        # the last projection folds float32 rounding on the bounds into
        # the transport, so the rebuilt state lies exactly within them
        new_mass = old_mass + (s + k + t)
        t = t + (_bounded(new_mass, area_mode, ice_mask) - new_mass)
        return s / timestep, k / timestep, t / timestep

    def __call__(self, gen_data: TensorMapping, input_data: TensorMapping,
                 timestep: float) -> TensorDict:
        """The modified fields only."""
        if self.corrected_variables is None:
            return {}
        work = {k: v.float() for k, v in gen_data.items()}
        x_in = {k: v.float() for k, v in input_data.items()}
        modified: TensorDict = {}
        mask_var = None
        if "simass" in self.corrected_variables:
            mask_var = "simass"
        else:
            sic_in = [v for v in _SIC_VARS if v in self.corrected_variables]
            if sic_in:
                mask_var = sic_in[0]
        order = []
        if "simass" in self.corrected_variables:
            order.append("simass")
        order += [v for v in _SIC_VARS if v in self.corrected_variables]
        if "sisnmass" in self.corrected_variables:
            order.append("sisnmass")
        for key in order:
            area_mode = key in _SIC_VARS
            ice_mask = None
            if key != order[0] and mask_var is not None:
                ice_mask = work[mask_var]
            terms = self.corrected_variables[key]
            s, k, t = self.constrain_budgets(
                x_in[key], work[terms[0]], work[terms[1]], work[terms[2]],
                timestep=timestep, area_mode=area_mode, ice_mask=ice_mask)
            raw = x_in[key] + timestep * (s + k + t)
            target = _bounded(raw, area_mode, ice_mask)
            t = t + (target - raw) / timestep
            work[terms[0]], work[terms[1]], work[terms[2]] = s, k, t
            work[key] = target
            for name in (*terms, key):
                modified[name] = work[name]
        return modified


@dataclasses.dataclass
class IceCorrectorConfig:
    """The ice corrector's configuration (port of
    ace_tpu/core/corrector/ice.py:171)."""

    budget_correction: IceBudgetCorrectionConfig | None = None
    corrector_disabled_epochs: int = 0

    def __post_init__(self):
        if self.corrector_disabled_epochs < 0:
            raise ValueError(
                "corrector_disabled_epochs must be non-negative, got "
                f"{self.corrector_disabled_epochs}"
            )

    @property
    def is_noop(self) -> bool:
        return self.budget_correction is None

    def build(self, gridded_operations, vertical_coordinate,
              timestep) -> "IceCorrector":
        return IceCorrector(self, timestep.total_seconds())


class IceCorrector:
    def __init__(self, config: IceCorrectorConfig, timestep_seconds: float):
        self.config = config
        self._dt = timestep_seconds

    def init_state(self, input_data: TensorMapping) -> CorrectorState:
        return {}

    def __call__(self, input_data, gen_data, forcing_data,
                 corrector_state) -> CorrectorOutput:
        gen = dict(gen_data)
        delta: TensorDict = {}
        if self.config.budget_correction is not None:
            changed = self.config.budget_correction(gen, input_data,
                                                    self._dt)
            for name, value in changed.items():
                delta[name] = (value - gen[name]).detach()
                gen[name] = value
        return CorrectorOutput(corrected=gen,
                               corrector_state=dict(corrector_state or {}),
                               delta=delta)
