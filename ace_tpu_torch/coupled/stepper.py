"""Coupled atmosphere-ocean stepper (port of ace_tpu/coupled/stepper.py).

The atmosphere takes ``n_inner_steps`` fast steps per slow ocean step
(n_inner = ocean_timestep / atmosphere_timestep). The exchange at each
outer step:

- every ocean output the atmosphere needs (the SST, renamed to the
  atmosphere's surface-temperature name, and any other ocean prognostic
  among the atmosphere's inputs) is held constant as atmosphere forcing
  over the inner steps, zeroed on the ocean's dry cells; the ocean's
  current SST is also prescribed onto the atmosphere's initial condition
  at the top of EVERY outer step;
- the atmosphere outputs the ocean needs (surface fluxes) are averaged
  over the inner window and given to the ocean as a 2-step next-step
  forcing window; so are the exogenous forcings both components read,
  taken from the atmosphere's forcing;
- optionally (``ocean_fraction_prediction``) the atmosphere's ocean
  fraction is computed from the ocean's predicted sea ice and the land
  fraction instead of read from data.

The exchange is a few device ops around each component's rollout, and
nothing in the rollout waits for the device. :meth:`CoupledStepper.predict`
runs each component through ``Stepper.predict`` (inference mode);
:meth:`CoupledStepper.predict_with_grad` runs each component step through
``Stepper.predict_fn`` with gradients, recomputed in the backward pass
(``torch.utils.checkpoint``): from the second outer step on the ocean's
loss depends on its own weights through the SST, the atmosphere's steps
and the averaged fluxes, so the gradient passes through every one of
those atmosphere steps, and kept whole their graphs would not fit.

One ``torch.Generator`` draws every component step's noise (the JAX
package splits a key per outer step). Neither the SFNO nor Samudra draws
noise in a deterministic step, so the outputs do not depend on it.
"""

import dataclasses
import datetime
from typing import Any, Callable

import torch
import torch.utils.checkpoint

from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.ocean import Prescriber
from ace_tpu_torch.core.ocean_data import OCEAN_FIELD_NAME_PREFIXES
from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping
from ace_tpu_torch.models.layers import replaying
from ace_tpu_torch.stepper.stepper import (
    PrognosticState,
    Stepper,
    StepperConfig,
)


def _parse_timedelta(value: str) -> datetime.timedelta:
    """ISO 8601 or pandas duration string -> timedelta."""
    import pandas as pd

    return pd.Timedelta(value).to_pytimedelta()


@dataclasses.dataclass
class CoupledComponentConfig:
    """One coupled component.

    timedelta: ISO 8601 duration of this component's step (e.g. "PT6H",
        "1D"). Optional: when omitted it is taken from the component's
        dataset; when given it is checked against the dataset.
    """

    stepper: StepperConfig
    timedelta: str | None = None


@dataclasses.dataclass
class CoupledOceanFractionConfig:
    """Compute the atmosphere's ocean fraction at run time from the
    ocean-predicted sea-ice fraction and the (atmosphere-data) land
    fraction."""

    sea_ice_fraction_name: str
    land_fraction_name: str
    sea_ice_fraction_name_in_atmosphere: str | None = None

    def __post_init__(self):
        self._canonical_sea_ice_fraction_name()

    def _canonical_sea_ice_fraction_name(self) -> str:
        name = self.sea_ice_fraction_name
        if name in OCEAN_FIELD_NAME_PREFIXES["sea_ice_fraction"]:
            return "sea_ice_fraction"
        if name in OCEAN_FIELD_NAME_PREFIXES["ocean_sea_ice_fraction"]:
            return "ocean_sea_ice_fraction"
        raise ValueError(
            f"CoupledOceanFractionConfig expected {name} to be registered "
            "in OCEAN_FIELD_NAME_PREFIXES as a sea ice fraction."
        )

    def validate_ocean_prognostic_names(self, prognostic_names):
        if self.sea_ice_fraction_name not in prognostic_names:
            raise ValueError(
                f"CoupledOceanFractionConfig expected "
                f"{self.sea_ice_fraction_name} to be a prognostic variable "
                "of the ocean model, but it is not."
            )

    def validate_atmosphere_forcing_names(self, forcing_names):
        if self.land_fraction_name not in forcing_names:
            raise ValueError(
                f"CoupledOceanFractionConfig expected "
                f"{self.land_fraction_name} to be an ML forcing of the "
                "atmosphere model, but it is not."
            )

    def filter_atmosphere_forcing_names(
        self, unfiltered_names, ocean_fraction_name: str
    ) -> list[str]:
        """The atmosphere forcing names without the ocean fraction and the
        (atmosphere-side) sea-ice fraction: both are computed at run
        time."""
        sea_ice_name = (self.sea_ice_fraction_name_in_atmosphere
                        or self.sea_ice_fraction_name)
        return [n for n in unfiltered_names
                if n not in (ocean_fraction_name, sea_ice_name)]

    def compute(self, sea_ice_fraction: torch.Tensor,
                land_fraction: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """(sea_ice_fraction, land_fraction) -> (sea_ice, ocean_fraction):
        the sea ice with NaN as 0, and ``1 - land - sea_ice`` clipped at
        0."""
        sea_ice = torch.nan_to_num(sea_ice_fraction)
        ocean = torch.clamp(1.0 - land_fraction - sea_ice, min=0)
        return sea_ice, ocean


@dataclasses.dataclass
class CoupledPrognosticState:
    atmosphere_data: PrognosticState
    ocean_data: PrognosticState


@dataclasses.dataclass
class CoupledStepperConfig:
    atmosphere: CoupledComponentConfig
    ocean: CoupledComponentConfig
    sst_name: str = "sst"
    ocean_fraction_prediction: CoupledOceanFractionConfig | None = None

    def get_stepper(self, atmosphere_info: DatasetInfo,
                    ocean_info: DatasetInfo, device=None
                    ) -> "CoupledStepper":
        """Both components on ``device`` (CUDA by default); a configured
        timedelta must match its dataset's timestep."""
        for cfg, info, label in ((self.atmosphere, atmosphere_info,
                                  "atmosphere"),
                                 (self.ocean, ocean_info, "ocean")):
            if cfg.timedelta is not None and info.timestep is not None:
                configured = _parse_timedelta(cfg.timedelta)
                if configured != info.timestep:
                    raise ValueError(
                        f"{label} config timedelta {cfg.timedelta} does "
                        f"not match the dataset timestep {info.timestep}"
                    )
        atmos = self.atmosphere.stepper.get_stepper(atmosphere_info,
                                                    device=device)
        ocean = self.ocean.stepper.get_stepper(ocean_info, device=device)
        return CoupledStepper(self, ocean=ocean, atmosphere=atmos)


# a component's rollout: (stepper, state, forcing window, generator,
# n_forward) -> (outputs [B, n_forward, ...], final state)
Rollout = Callable[..., tuple[TensorDict, PrognosticState]]


class CoupledStepper:
    def __init__(self, config: CoupledStepperConfig, ocean: Stepper,
                 atmosphere: Stepper):
        self._config = config
        self.ocean = ocean
        self.atmosphere = atmosphere
        self._validate()
        a_dt = self._component_timestep(config.atmosphere, atmosphere)
        o_dt = self._component_timestep(config.ocean, ocean)
        if a_dt > o_dt:
            raise ValueError(
                "Atmosphere timedelta must not be larger than ocean's."
            )
        ratio = o_dt.total_seconds() / a_dt.total_seconds()
        if ratio != int(ratio) or ratio < 1:
            raise ValueError(
                f"ocean timestep {o_dt} must be an integer multiple of the "
                f"atmosphere timestep {a_dt}"
            )
        self._n_inner = int(ratio)
        ocean_cfg = atmosphere.step.config.ocean
        self._prescriber = Prescriber(
            prescribed_name=self.surface_temperature_name,
            mask_name=self.ocean_fraction_name,
            mask_value=1,
            interpolate=ocean_cfg.interpolate,
        )

    @staticmethod
    def _component_timestep(cfg: CoupledComponentConfig,
                            stepper: Stepper) -> datetime.timedelta:
        if cfg.timedelta is not None:
            return _parse_timedelta(cfg.timedelta)
        dt = stepper.dataset_info.timestep
        if dt is None:
            raise ValueError(
                "coupled components need a timestep (from the component "
                "config timedelta or the dataset)"
            )
        return dt

    def _validate(self):
        """The components' compatibility rules."""
        config = self._config
        ocean_cfg = self.atmosphere.step.config.ocean
        if ocean_cfg is None:
            raise ValueError(
                "The atmosphere stepper 'ocean' config is missing but must "
                "be set for coupled emulation."
            )
        if ocean_cfg.is_slab:
            raise ValueError(
                "The atmosphere stepper 'ocean' config cannot use 'slab' "
                "for coupled emulation."
            )
        duplicates = set(self.ocean.out_names) & set(self.atmosphere.out_names)
        if duplicates:
            raise ValueError(
                "Output variable names of CoupledStepper components cannot "
                f"overlap. Found the following duplicated names: "
                f"{sorted(duplicates)}"
            )
        # ocean diagnostics cannot force the atmosphere: only ocean
        # prognostics persist across the coupled window
        ocean_diags_as_forcings = sorted(
            (self._atmosphere_input_only & set(self.ocean.out_names))
            - set(self.ocean.step.input_names)
        )
        if ocean_diags_as_forcings:
            raise ValueError(
                "CoupledStepper only supports ocean prognostic variables "
                "as atmosphere forcings, but the following ocean diagnostic "
                "variables are inputs to the atmosphere: "
                f"{ocean_diags_as_forcings}."
            )
        # atmosphere-supplied ocean forcings are window averages aligned
        # to the END of the ocean step, so they must be next-step forcings
        # on the ocean side
        missing_next_step = sorted(
            set(self._atmosphere_to_ocean_forcing_names)
            - set(self.ocean.step.next_step_forcing_names)
        )
        if missing_next_step:
            raise ValueError(
                "The following variables which are atmosphere component "
                "outputs and ocean component inputs were not found among "
                f"the ocean's next_step_forcing_names: {missing_next_step}."
            )
        if config.sst_name not in self.ocean.out_names:
            raise ValueError(
                f"The variable {config.sst_name} is not in the ocean's "
                "output names but is required for coupling with the "
                "atmosphere."
            )
        if config.ocean_fraction_prediction is not None:
            config.ocean_fraction_prediction.validate_ocean_prognostic_names(
                self.ocean.prognostic_names
            )
            config.ocean_fraction_prediction.validate_atmosphere_forcing_names(
                self._atmosphere_input_only
            )

    @property
    def config(self) -> CoupledStepperConfig:
        return self._config

    @property
    def device(self) -> torch.device:
        return self.atmosphere.device

    @property
    def sst_name(self) -> str:
        return self._config.sst_name

    @property
    def n_inner_steps(self) -> int:
        return self._n_inner

    @property
    def surface_temperature_name(self) -> str:
        """The atmosphere's SST name (from its ocean config)."""
        return self.atmosphere.step.config.ocean.surface_temperature_name

    @property
    def ocean_fraction_name(self) -> str:
        return self.atmosphere.step.config.ocean.ocean_fraction_name

    @property
    def _atmosphere_input_only(self) -> set[str]:
        return (set(self.atmosphere.step.input_names)
                - set(self.atmosphere.out_names))

    @property
    def _ocean_input_only(self) -> set[str]:
        return set(self.ocean.step.input_names) - set(self.ocean.out_names)

    @property
    def _ocean_to_atmosphere_forcing_names(self) -> list[str]:
        """Every ocean output the atmosphere needs, the SST, and the
        ocean-side sea-ice fraction when the ocean fraction is
        predicted."""
        names = self._atmosphere_input_only & set(self.ocean.out_names)
        names.add(self.sst_name)
        ofrac = self._config.ocean_fraction_prediction
        if ofrac is not None:
            names.add(ofrac.sea_ice_fraction_name)
        return sorted(names)

    @property
    def _atmosphere_to_ocean_forcing_names(self) -> list[str]:
        """Ocean forcings the atmosphere produces (surface fluxes)."""
        return sorted(self._ocean_input_only & set(self.atmosphere.out_names))

    @property
    def _ocean_forcing_exogenous_names(self) -> list[str]:
        return sorted(self._ocean_input_only - set(self.atmosphere.out_names))

    @property
    def _atmosphere_forcing_exogenous_names(self) -> list[str]:
        names = sorted(self._atmosphere_input_only - set(self.ocean.out_names))
        ofrac = self._config.ocean_fraction_prediction
        if ofrac is not None:
            names = ofrac.filter_atmosphere_forcing_names(
                names, self.ocean_fraction_name)
        return names

    @property
    def _shared_forcing_exogenous_names(self) -> list[str]:
        """Exogenous forcings of both components (read from the
        atmosphere's data)."""
        return sorted(set(self._ocean_forcing_exogenous_names)
                      & set(self._atmosphere_forcing_exogenous_names))

    @property
    def atmosphere_forcing_window_names(self) -> list[str]:
        """The names read from the atmosphere's forcing data: exogenous
        and prescribed prognostics (ocean-supplied fields come from the
        ocean's state)."""
        prescribed = getattr(self.atmosphere.step.config,
                             "prescribed_prognostic_names", [])
        return sorted(set(self._atmosphere_forcing_exogenous_names)
                      | set(prescribed))

    @property
    def ocean_forcing_window_names(self) -> list[str]:
        """The names read from the ocean's forcing data."""
        prescribed = getattr(self.ocean.step.config,
                             "prescribed_prognostic_names", [])
        return sorted((set(self._ocean_forcing_exogenous_names)
                       - set(self._shared_forcing_exogenous_names))
                      | set(prescribed))

    @property
    def all_atmosphere_names(self) -> list[str]:
        """What the atmosphere's dataset must hold."""
        names = ((set(self.atmosphere.step.input_names)
                  | set(self.atmosphere.out_names))
                 - set(self.ocean.out_names))
        ofrac = self._config.ocean_fraction_prediction
        if ofrac is not None:
            names = set(ofrac.filter_atmosphere_forcing_names(
                names, self.ocean_fraction_name))
        return sorted(names)

    @property
    def all_ocean_names(self) -> list[str]:
        """What the ocean's dataset must hold; the shared forcings come
        from the atmosphere's data."""
        names = ((set(self.ocean.step.input_names)
                  | set(self.ocean.out_names))
                 - set(self.all_atmosphere_names))
        ofrac = self._config.ocean_fraction_prediction
        if ofrac is not None:
            # the land fraction that the ocean fraction needs comes from
            # the atmosphere's data
            names -= {ofrac.land_fraction_name}
        return sorted(names)

    def init_params(self, generator: torch.Generator | None = None):
        self.atmosphere.init_params(generator)
        self.ocean.init_params(generator)

    def _mask_ocean_fields(self, fields: TensorDict) -> TensorDict:
        """Zero the ocean-supplied forcings on the cells the ocean
        dataset's masks mark dry."""
        provider = self.ocean.dataset_info.mask_provider
        if provider is None:
            return fields
        out = dict(fields)
        for name, tensor in fields.items():
            key = provider.mask_key_for(name)
            if key is not None:
                wet = provider.on_device(key, "wet", tensor.device)
                out[name] = torch.where(wet, tensor, 0.0)
        return out

    def _forcings_from_ocean(self, ocean_state_data: TensorMapping,
                             atmosphere_forcing_window: TensorMapping,
                             n_inner: int) -> TensorDict:
        """Atmosphere forcings taken from the ocean's state, constant over
        the window."""
        sst_atmos_name = self.surface_temperature_name
        fields: TensorDict = {}
        for k in self._ocean_to_atmosphere_forcing_names:
            name = sst_atmos_name if k == self.sst_name else k
            v = ocean_state_data[k]  # [B, 1, ...]
            fields[name] = v.expand(v.shape[0], n_inner + 1, *v.shape[2:])
        ofrac_cfg = self._config.ocean_fraction_prediction
        if ofrac_cfg is not None:
            sea_ice_atmos_name = (ofrac_cfg.sea_ice_fraction_name_in_atmosphere
                                  or ofrac_cfg.sea_ice_fraction_name)
            sea_ice = fields.pop(ofrac_cfg.sea_ice_fraction_name)
            land = atmosphere_forcing_window[ofrac_cfg.land_fraction_name]
            sea_ice, ocean_frac = ofrac_cfg.compute(sea_ice, land)
            fields[sea_ice_atmos_name] = sea_ice
            fields[self.ocean_fraction_name] = ocean_frac
        return self._mask_ocean_fields(fields)

    def exchange_pre(self, ocean_data: TensorMapping,
                     atmos_window: TensorMapping, atmos_ic: TensorMapping
                     ) -> tuple[TensorDict, TensorDict]:
        """The atmosphere's forcing window with the ocean's fields, and
        its initial condition with the ocean's SST prescribed over the
        ocean fraction."""
        sst = self.surface_temperature_name
        win = dict(atmos_window)
        win.update(self._forcings_from_ocean(ocean_data, win, self._n_inner))
        new_ic = dict(atmos_ic)
        if sst in new_ic:
            ic_ts = new_ic[sst]
            n_ic = ic_ts.shape[1]
            new_ic[sst] = self._prescriber(
                {self.ocean_fraction_name:
                 win[self.ocean_fraction_name][:, :n_ic]},
                {sst: ic_ts},
                {sst: win[sst][:, :n_ic]},
            )[sst]
        return win, new_ic

    def exchange_post(self, a_out: TensorMapping,
                      shared_window: TensorMapping,
                      ocean_window: TensorMapping) -> TensorDict:
        """The ocean's forcing window: the atmosphere's fluxes and the
        shared forcings averaged over the inner steps, as a constant
        2-step window."""
        win = dict(ocean_window)
        for k in self._atmosphere_to_ocean_forcing_names:
            avg = a_out[k].mean(dim=1, keepdim=True)
            win[k] = torch.cat([avg, avg], dim=1)
        for k in self._shared_forcing_exogenous_names:
            avg = shared_window[k][:, 1:].mean(dim=1, keepdim=True)
            win[k] = torch.cat([avg, avg], dim=1)
        return win

    def predict(self, initial_condition: CoupledPrognosticState,
                atmosphere_forcing: TensorMapping,
                ocean_forcing: TensorMapping,
                generator: torch.Generator | None = None,
                ) -> tuple[TensorDict, TensorDict, CoupledPrognosticState]:
        """Coupled rollout in inference mode.

        atmosphere_forcing: [B, n_outer*n_inner + 1, ...] fields from the
            atmosphere's dataset.
        ocean_forcing: [B, n_outer + 1, ...] ocean-exogenous fields.

        Returns (atmosphere outputs [B, n_outer*n_inner, ...], ocean
        outputs [B, n_outer, ...], final state), on the device; nothing
        here waits for it.
        """
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        with torch.inference_mode():
            return self._predict_impl(initial_condition, atmosphere_forcing,
                                      ocean_forcing, generator,
                                      _inference_rollout)

    def predict_with_grad(
        self, initial_condition: CoupledPrognosticState,
        atmosphere_forcing: TensorMapping, ocean_forcing: TensorMapping,
        generator: torch.Generator | None = None,
    ) -> tuple[TensorDict, TensorDict, CoupledPrognosticState]:
        """:meth:`predict` for a training caller: gradients reach both
        components' weights and inputs, and each component step is
        recomputed in the backward pass (the values are the same)."""
        return self._predict_impl(initial_condition, atmosphere_forcing,
                                  ocean_forcing, generator, _grad_rollout)

    def _predict_impl(self, initial_condition: CoupledPrognosticState,
                      atmosphere_forcing: TensorMapping,
                      ocean_forcing: TensorMapping,
                      generator: torch.Generator | None,
                      rollout: Rollout,
                      ) -> tuple[TensorDict, TensorDict,
                                 CoupledPrognosticState]:
        n_inner = self._n_inner
        n_total = next(iter(atmosphere_forcing.values())).shape[1] - 1
        if n_total % n_inner != 0:
            raise ValueError(
                f"atmosphere forcing covers {n_total} steps, not a multiple "
                f"of n_inner_steps={n_inner}"
            )
        n_outer = n_total // n_inner
        if ocean_forcing:
            n_ocean = next(iter(ocean_forcing.values())).shape[1] - 1
            if n_ocean != n_outer:
                raise ValueError(
                    f"ocean forcing covers {n_ocean} steps but atmosphere "
                    f"forcing implies {n_outer}"
                )
        atmos_state = self.atmosphere.get_initial_state(
            initial_condition.atmosphere_data)
        ocean_state = self.ocean.get_initial_state(
            initial_condition.ocean_data)
        sst = self.surface_temperature_name
        atmos_names = set(self.atmosphere_forcing_window_names)
        ocean_names = set(self.ocean_forcing_window_names)
        atmos_outputs: list[TensorDict] = []
        ocean_outputs: list[TensorDict] = []
        for i_outer in range(n_outer):
            sl = slice(i_outer * n_inner, (i_outer + 1) * n_inner + 1)
            atmos_window_raw = {k: v[:, sl]
                                for k, v in atmosphere_forcing.items()
                                if k in atmos_names}
            atmos_window, new_ic = self.exchange_pre(
                ocean_state.data, atmos_window_raw, atmos_state.data)
            if sst in atmos_state.data:
                atmos_state = dataclasses.replace(atmos_state, data=new_ic)
            a_out, atmos_state = rollout(self.atmosphere, atmos_state,
                                         atmos_window, generator, None)
            atmos_outputs.append(a_out)

            ocean_window_raw = {k: v[:, i_outer:i_outer + 2]
                                for k, v in ocean_forcing.items()
                                if k in ocean_names}
            shared_window = {k: atmosphere_forcing[k][:, sl]
                             for k in self._shared_forcing_exogenous_names}
            ocean_window = self.exchange_post(a_out, shared_window,
                                              ocean_window_raw)
            o_out, ocean_state = rollout(self.ocean, ocean_state,
                                         ocean_window, generator, 1)
            ocean_outputs.append(o_out)

        def stacked(outputs):
            return {k: torch.cat([o[k] for o in outputs], dim=1)
                    for k in outputs[0]}

        return (stacked(atmos_outputs), stacked(ocean_outputs),
                CoupledPrognosticState(atmosphere_data=atmos_state,
                                       ocean_data=ocean_state))

    def get_state(self) -> dict[str, Any]:
        return {
            "atmosphere": self.atmosphere.step.get_state(),
            "ocean": self.ocean.step.get_state(),
            "sst_name": self.sst_name,
        }


def _inference_rollout(stepper: Stepper, state: PrognosticState,
                       window: TensorMapping, generator, n_forward):
    return stepper.predict(state, window, generator=generator,
                           n_forward=n_forward)


def _grad_rollout(stepper: Stepper, state: PrognosticState,
                  window: TensorMapping, generator, n_forward):
    """``Stepper.predict`` with gradients: one ``predict_fn`` call a step,
    each recomputed in the backward pass when gradients are on."""
    missing = set(stepper.forcing_window_names) - set(window)
    if missing:
        raise ValueError(f"forcing data missing variables {sorted(missing)}")
    forcing = {k: window[k] for k in stepper.forcing_window_names}
    if n_forward is None:
        n_forward = next(iter(forcing.values())).shape[1] - 1
    state = stepper.get_initial_state(state)
    data, stepper_state = state.data, state.stepper_state
    n_ic = stepper.n_ic_timesteps
    outputs: dict[str, list[torch.Tensor]] = {}
    for t in range(n_forward):
        forcing_t = {k: v[:, t:t + 2] for k, v in forcing.items()}
        if torch.is_grad_enabled():
            out, _, stepper_state = torch.utils.checkpoint.checkpoint(
                replaying(stepper.predict_fn, generator), data, forcing_t,
                stepper_state, generator, 1, use_reentrant=False,
                preserve_rng_state=False)
        else:
            out, _, stepper_state = stepper.predict_fn(
                data, forcing_t, stepper_state, generator, 1)
        data = {k: out[k][:, -n_ic:] for k in stepper.prognostic_names}
        for k, v in out.items():
            outputs.setdefault(k, []).append(v)
    outputs = {k: torch.cat(v, dim=1) for k, v in outputs.items()}
    return outputs, PrognosticState(data=data, stepper_state=stepper_state)
