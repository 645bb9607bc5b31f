"""Registries of derived variables computed after the rollout (port of
ace_tpu/core/derived_variables.py): the atmosphere's from
``AtmosphereData``, the ocean's from ``OceanData``; a depth coordinate
selects the ocean registry.

Each function takes the fields of a window (``[batch, time, lat, lon]``
tensors, on whatever device they are) and the timestep, and returns a
derived field; a variable is computed only when the data lack it and have
what it needs.
"""

import datetime
import logging
from collections.abc import Callable, MutableMapping

import torch

from ace_tpu_torch.core.atmosphere_data import AtmosphereData
from ace_tpu_torch.core.coordinates import DepthCoordinate
from ace_tpu_torch.core.dataset_info import VariableMetadata
from ace_tpu_torch.core.ocean_data import OceanData
from ace_tpu_torch.core.typing_ import TensorDict

DerivedVariableFunc = Callable[[AtmosphereData, datetime.timedelta],
                               torch.Tensor]

_DERIVED_VARIABLE_REGISTRY: MutableMapping[
    str, tuple[DerivedVariableFunc, VariableMetadata]
] = {}


def get_derived_variable_metadata() -> dict[str, VariableMetadata]:
    return {
        label: metadata
        for label, (_, metadata) in _DERIVED_VARIABLE_REGISTRY.items()
    }


def register(metadata: VariableMetadata):
    def decorator(func: DerivedVariableFunc):
        label = func.__name__
        if label in _DERIVED_VARIABLE_REGISTRY:
            raise ValueError(f"{label} already registered")
        _DERIVED_VARIABLE_REGISTRY[label] = (func, metadata)
        return func

    return decorator


def _with_zero_first_step(x: torch.Tensor, tendency: torch.Tensor
                          ) -> torch.Tensor:
    """A tendency over time steps, with 0 at the first step of the window."""
    return torch.cat([torch.zeros_like(x[:, :1]), tendency], dim=1)


@register(VariableMetadata("Pa", "Surface pressure due to dry air only"))
def surface_pressure_due_to_dry_air(data, timestep):
    return data.surface_pressure_due_to_dry_air


@register(
    VariableMetadata("Pa/s", "Absolute value of tendency of dry air surface pressure")
)
def surface_pressure_due_to_dry_air_absolute_tendency(data, timestep):
    ps_dry = data.surface_pressure_due_to_dry_air
    return _with_zero_first_step(ps_dry, torch.diff(ps_dry, dim=1).abs())


@register(VariableMetadata("kg/m**2", "Total water path"))
def total_water_path(data, timestep):
    return data.total_water_path


@register(VariableMetadata("kg/m**2/s", "Total water path budget residual"))
def total_water_path_budget_residual(data, timestep):
    twp = data.total_water_path
    tendency = (twp[:, 1:] - twp[:, :-1]) / timestep.total_seconds()
    residual = tendency - (
        data.evaporation_rate[:, 1:]
        - data.precipitation_rate[:, 1:]
        + data.tendency_of_total_water_path_due_to_advection[:, 1:]
    )
    return _with_zero_first_step(twp, residual)


@register(VariableMetadata("W/m**2", "Net TOA radiative flux into atmosphere"))
def net_energy_flux_toa_into_atmosphere(data, timestep):
    return data.net_top_of_atmosphere_energy_flux


@register(VariableMetadata("W/m**2", "Net surface energy flux into atmosphere"))
def net_energy_flux_sfc_into_atmosphere(data, timestep):
    return -data.net_surface_energy_flux


@register(
    VariableMetadata("W/m**2", "Net energy flux into atmospheric column")
)
def net_energy_flux_into_atmospheric_column(data, timestep):
    return data.net_energy_flux_into_atmosphere


@register(
    VariableMetadata("J/m**2", "Total energy path following ACE2 assumptions")
)
def total_energy_ace2_path(data, timestep):
    return data.total_energy_ace2_path


def _total_energy_ace2_path_tendency(data, timestep):
    path = data.total_energy_ace2_path
    tendency = (path[:, 1:] - path[:, :-1]) / timestep.total_seconds()
    return _with_zero_first_step(path, tendency)


@register(
    VariableMetadata("W/m**2", "Tendency of ACE2 total energy path")
)
def total_energy_ace2_path_tendency(data, timestep):
    return _total_energy_ace2_path_tendency(data, timestep)


@register(
    VariableMetadata(
        "W/m**2",
        "Implied advective tendency of total energy path assuming "
        "closed budget",
    )
)
def implied_tendency_of_total_energy_ace2_path_due_to_advection(
    data, timestep
):
    """The residual of the column total-energy budget."""
    return (_total_energy_ace2_path_tendency(data, timestep)
            - data.net_energy_flux_into_atmosphere)


@register(VariableMetadata("m/s", "Windspeed at 10m above surface"))
def windspeed_at_10m(data, timestep):
    return data.windspeed_at_10m


def compute_derived_quantities(
    data: TensorDict,
    vertical_coordinate,
    timestep: datetime.timedelta,
    forcing_data: TensorDict | None = None,
) -> TensorDict:
    """Every registered derived variable that ``data`` lacks and that its
    fields (with ``forcing_data`` filling gaps) allow."""
    out = dict(data)
    merged = dict(data)
    if forcing_data is not None:
        for k, v in forcing_data.items():
            merged.setdefault(k, v)
    atm = AtmosphereData(merged, vertical_coordinate)
    for label, (func, _) in _DERIVED_VARIABLE_REGISTRY.items():
        if label in out:
            continue
        try:
            out[label] = func(atm, timestep)
        except (KeyError, ValueError):
            logging.debug(f"cannot compute derived variable {label}")
    return out


# ----- the ocean registry -----

_OCEAN_DERIVED_VARIABLE_REGISTRY: dict = {}


def ocean_register(metadata: VariableMetadata, exists_ok: bool = False):
    def decorator(func):
        _OCEAN_DERIVED_VARIABLE_REGISTRY[func.__name__] = (
            func, metadata, exists_ok)
        return func

    return decorator


def get_ocean_derived_variable_metadata() -> dict[str, VariableMetadata]:
    return {label: meta for label, (_, meta, _)
            in _OCEAN_DERIVED_VARIABLE_REGISTRY.items()}


@ocean_register(
    VariableMetadata("J/m**2", "Column-integrated ocean heat content")
)
def ocean_heat_content(data, timestep):
    return data.ocean_heat_content


@ocean_register(VariableMetadata(
    "W/m**2", "Tendency of column-integrated ocean heat content"
))
def ocean_heat_content_tendency(data, timestep):
    ohc = data.ocean_heat_content
    return _with_zero_first_step(
        ohc, torch.diff(ohc, dim=1) / timestep.total_seconds())


@ocean_register(VariableMetadata(
    "W/m**2",
    "Implied advective tendency of ocean heat content assuming closed "
    "budget",
))
def implied_tendency_of_ocean_heat_content_due_to_advection(data, timestep):
    return (ocean_heat_content_tendency(data, timestep)
            - data.net_energy_flux_into_ocean)


@ocean_register(VariableMetadata(
    "W/m**2", "Net energy flux through surface and sea floor into ocean"
))
def net_energy_flux_into_ocean_column(data, timestep):
    return data.net_energy_flux_into_ocean


@ocean_register(
    VariableMetadata("[0-1]", "sea ice concentration"), exists_ok=True
)
def sea_ice_fraction(data, timestep):
    return data.sea_ice_fraction


def compute_ocean_derived_quantities(
    data: TensorDict,
    depth_coordinate,
    timestep: datetime.timedelta,
    forcing_data: TensorDict | None = None,
) -> TensorDict:
    """Every registered ocean variable that ``data`` lacks and that its
    fields (with ``forcing_data`` filling gaps) allow; a variable of the
    data that collides with one not registered ``exists_ok`` raises."""
    out = dict(data)
    merged = dict(data)
    if forcing_data is not None:
        for k, v in forcing_data.items():
            merged.setdefault(k, v)
    ocean = OceanData(merged, depth_coordinate)
    for label, (func, _, exists_ok) in (
            _OCEAN_DERIVED_VARIABLE_REGISTRY.items()):
        if label in out:
            if exists_ok:
                continue
            raise ValueError(
                f"variable {label} already exists; derived variables may "
                "not collide with dataset variables unless registered with "
                "exists_ok=True"
            )
        try:
            out[label] = func(ocean, timestep)
        except (KeyError, ValueError):
            logging.debug(f"cannot compute ocean derived {label}")
    return out


def compute_derived_for(
    data: TensorDict,
    vertical_coordinate,
    timestep: datetime.timedelta,
    forcing_data: TensorDict | None = None,
) -> TensorDict:
    """The derived variables for the data's vertical coordinate: a
    ``DepthCoordinate`` selects the ocean registry, anything else the
    atmosphere's (port of ace_tpu/core/derived_variables.py:270)."""
    if isinstance(vertical_coordinate, DepthCoordinate):
        return compute_ocean_derived_quantities(
            data, vertical_coordinate, timestep, forcing_data)
    return compute_derived_quantities(data, vertical_coordinate, timestep,
                                      forcing_data)
