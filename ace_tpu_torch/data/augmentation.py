"""Training-time data augmentation and forcing perturbations (a copy of
ace_tpu/data/augmentation.py: numpy on the host, applied before the batch
reaches the device; tests hold it equal to the original).

Rotation augmentation flips both spatial axes (pole swap) and the sign of
directional wind variables; SST perturbations (constant, or a
Green's-function patch) modify ocean-masked forcing for sensitivity runs.
"""

import abc
import dataclasses
import re
from typing import Any

import numpy as np

from ace_tpu_torch.core.registry import Registry, Selector


@dataclasses.dataclass
class AugmentationConfig:
    """(reference: augmentation.py:11)."""

    rotate_probability: float = 0.0
    additional_directional_names: list[str] = dataclasses.field(
        default_factory=list
    )

    def __post_init__(self):
        if not 0.0 <= self.rotate_probability <= 1.0:
            raise ValueError("rotate_probability must be in [0, 1]")

    def build_modifier(self, seed: int = 0):
        if self.rotate_probability == 0.0:
            return NullModifier()
        return RotateModifier(
            self.rotate_probability,
            self.additional_directional_names,
            seed=seed,
        )


class BatchModifierABC(abc.ABC):
    @abc.abstractmethod
    def __call__(self, data: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        ...


class NullModifier(BatchModifierABC):
    def __call__(self, data):
        return data


class RotateModifier(BatchModifierABC):
    """Pole-swap rotation with wind sign flips
    (reference: augmentation.py:46).
    """

    FLIP_NAMES = [
        "eastward_wind", "northward_wind", "UGRD", "VGRD", "U", "V",
    ]

    def __init__(self, rotate_probability: float,
                 additional_directional_names: list[str], seed: int = 0):
        self.rotate_probability = rotate_probability
        self._pattern = re.compile(
            r"({})(_?[0-9]+m?)?$".format(
                "|".join(self.FLIP_NAMES + additional_directional_names)
            )
        )
        self._rng = np.random.RandomState(seed)

    def __call__(self, data: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        example = next(iter(data.values()))
        apply = self._rng.rand(example.shape[0]) < self.rotate_probability
        apply = apply.reshape((-1,) + (1,) * (example.ndim - 1))
        out = {}
        for name, value in data.items():
            flipped = np.flip(value, axis=(-2, -1))
            if self._pattern.match(name):
                flipped = -flipped
            out[name] = np.where(apply, flipped, value)
        return out


class PerturbationConfig(abc.ABC):
    @abc.abstractmethod
    def apply_perturbation(self, data, lat, lon, ocean_fraction): ...


def _ocean_mask(ocean_fraction, cutoff: float = 0.5):
    return ocean_fraction > cutoff


class PerturbationSelector(Selector):
    _registry: Registry = Registry()

    @classmethod
    def get_registry(cls) -> Registry:
        return cls._registry

    @classmethod
    def register(cls, name: str):
        return cls._registry.register(name)

    def build(self) -> PerturbationConfig:
        return self.instance


@PerturbationSelector.register("constant")
@dataclasses.dataclass
class ConstantConfig(PerturbationConfig):
    """(reference: perturbation.py:91)."""

    amplitude: float = 1.0

    def apply_perturbation(self, data, lat, lon, ocean_fraction):
        mask = _ocean_mask(ocean_fraction)
        return np.where(mask, data + self.amplitude, data)


@PerturbationSelector.register("greens_function")
@dataclasses.dataclass
class GreensFunctionConfig(PerturbationConfig):
    """Sinusoidal SST patch (reference: perturbation.py:111;
    Bloch-Johnson et al. 2024 eq. 1).
    """

    amplitude: float = 1.0
    lat_center: float = 0.0
    lon_center: float = 0.0
    lat_width: float = 10.0
    lon_width: float = 10.0

    def _wrap_lon(self, lon):
        lon_min = self.lon_center - self.lon_width / 2.0
        lon_max = self.lon_center + self.lon_width / 2.0
        if lon_min < 0:
            lon_shifted = ((lon + 180) % 360) - 180
            in_patch = (lon_shifted > lon_min) & (lon_shifted < lon_max)
        elif lon_max > 360:
            in_patch = (lon > lon_min) | (lon < lon_max % 360)
            lon_shifted = ((lon + 180) % 360) + 180
        else:
            in_patch = (lon > lon_min) & (lon < lon_max)
            lon_shifted = lon
        return in_patch, lon_shifted

    def apply_perturbation(self, data, lat, lon, ocean_fraction):
        lat_in = np.abs(lat - self.lat_center) < self.lat_width / 2.0
        lon_in, lon_shifted = self._wrap_lon(lon)
        mask = lat_in & lon_in & _ocean_mask(ocean_fraction)
        perturbation = self.amplitude * (
            np.cos(
                np.pi / 2 * (np.deg2rad(lat) - np.deg2rad(self.lat_center))
                / (np.deg2rad(self.lat_width) / 2.0)
            ) ** 2
            * np.cos(
                np.pi / 2
                * (np.deg2rad(lon_shifted) - np.deg2rad(self.lon_center))
                / (np.deg2rad(self.lon_width) / 2.0)
            ) ** 2
        )
        return np.where(mask, data + perturbation, data)


@dataclasses.dataclass
class SSTPerturbation:
    """SST perturbations applied to forcing data
    (reference: perturbation.py:67).
    """

    sst: list[PerturbationSelector] = dataclasses.field(default_factory=list)

    def apply(self, data: dict[str, np.ndarray], lat2d, lon2d,
              sst_name: str = "surface_temperature",
              ocean_fraction_name: str = "ocean_fraction"):
        if not self.sst or sst_name not in data:
            return data
        out = dict(data)
        sst = out[sst_name]
        ocean_fraction = out.get(ocean_fraction_name, np.ones_like(sst))
        for selector in self.sst:
            sst = selector.build().apply_perturbation(
                sst, lat2d, lon2d, ocean_fraction
            )
        out[sst_name] = sst
        return out
