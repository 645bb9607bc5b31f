"""Horizontal and vertical coordinates (port of the lat-lon and hybrid
sigma-pressure parts of ace_tpu/core/coordinates.py).

Coordinates hold numpy arrays on the host; the tensors that device math
needs are made once per device and cached.
"""

import dataclasses

import numpy as np
import torch

from ace_tpu_torch.core.constants import GRAVITY
from ace_tpu_torch.core.metrics import spherical_area_weights
from ace_tpu_torch.device import cached_on_device


@dataclasses.dataclass(eq=False)
class HybridSigmaPressureCoordinate:
    """Interface pressures ``p(k) = ak + bk * ps``."""

    ak: np.ndarray
    bk: np.ndarray

    def __post_init__(self):
        self.ak = np.asarray(self.ak, dtype=np.float32)
        self.bk = np.asarray(self.bk, dtype=np.float32)
        if self.ak.ndim != 1 or self.bk.ndim != 1:
            raise ValueError("ak and bk must be 1-dimensional")
        if len(self.ak) != len(self.bk):
            raise ValueError("ak and bk must have the same length")
        self._device_cache: dict = {}

    def __len__(self):
        return len(self.ak)

    def __eq__(self, other):
        if not isinstance(other, HybridSigmaPressureCoordinate):
            return False
        return np.allclose(self.ak, other.ak) and np.allclose(self.bk, other.bk)

    def get_ak(self, device) -> torch.Tensor:
        return cached_on_device(self._device_cache, "ak", self.ak, device)

    def get_bk(self, device) -> torch.Tensor:
        return cached_on_device(self._device_cache, "bk", self.bk, device)

    def as_dict(self) -> dict:
        return {"ak": self.ak.tolist(), "bk": self.bk.tolist()}

    @classmethod
    def from_dict(cls, d: dict) -> "HybridSigmaPressureCoordinate":
        return cls(ak=np.asarray(d["ak"]), bk=np.asarray(d["bk"]))

    def interface_pressure(self, surface_pressure: torch.Tensor) -> torch.Tensor:
        """Pressure at layer interfaces; appends a trailing vertical axis."""
        device = surface_pressure.device
        return (
            self.get_ak(device)
            + self.get_bk(device) * surface_pressure[..., None]
        )

    def vertical_integral(self, integrand: torch.Tensor,
                          surface_pressure: torch.Tensor) -> torch.Tensor:
        """(1/g) ∫ x dp over the column; removes the trailing vertical axis."""
        if len(self.ak) != integrand.shape[-1] + 1:
            raise ValueError(
                f"integrand has {integrand.shape[-1]} layers but coordinate "
                f"has {len(self.ak) - 1}"
            )
        thickness = torch.diff(self.interface_pressure(surface_pressure), dim=-1)
        return (integrand * thickness).sum(-1) / GRAVITY


@dataclasses.dataclass(eq=False)
class LatLonCoordinates:
    """A lat-lon (possibly Gaussian) grid."""

    lat: np.ndarray
    lon: np.ndarray

    def __post_init__(self):
        self.lat = np.asarray(self.lat, dtype=np.float64)
        self.lon = np.asarray(self.lon, dtype=np.float64)

    def __eq__(self, other):
        if not isinstance(other, LatLonCoordinates):
            return False
        return (
            self.lat.shape == other.lat.shape
            and self.lon.shape == other.lon.shape
            and np.allclose(self.lat, other.lat)
            and np.allclose(self.lon, other.lon)
        )

    @property
    def shape(self) -> tuple[int, int]:
        return (len(self.lat), len(self.lon))

    @property
    def area_weights(self) -> np.ndarray:
        return spherical_area_weights(self.lat, len(self.lon))

    @property
    def grid(self) -> str:
        """The latitude grid: "legendre-gauss" where the latitudes are
        the Gauss grid's, else "equiangular"."""
        gauss = gaussian_latitudes(len(self.lat))
        if np.allclose(np.sort(self.lat), gauss, atol=1e-2):
            return "legendre-gauss"
        return "equiangular"

    def as_dict(self) -> dict:
        return {"lat": self.lat.tolist(), "lon": self.lon.tolist()}

    def get_gridded_operations(self):
        from ace_tpu_torch.core.gridded_ops import LatLonOperations

        return LatLonOperations(self.area_weights)


def gaussian_latitudes(nlat: int) -> np.ndarray:
    """Gaussian (Legendre) latitudes in degrees, south-to-north ascending."""
    from ace_tpu_torch.ops.quadrature import legendre_gauss_weights

    cost, _ = legendre_gauss_weights(nlat)
    return np.rad2deg(np.arcsin(cost))


def serialize_vertical_coordinate(vc) -> dict:
    if isinstance(vc, HybridSigmaPressureCoordinate):
        return {"type": "hybrid_sigma_pressure", "data": vc.as_dict()}
    raise NotImplementedError(f"vertical coordinate {type(vc).__name__}")


def deserialize_vertical_coordinate(state: dict):
    if state["type"] == "hybrid_sigma_pressure":
        return HybridSigmaPressureCoordinate.from_dict(state["data"])
    if state["type"] == "null":
        return None
    raise NotImplementedError(
        f"vertical coordinate {state['type']!r} is not ported yet"
    )
