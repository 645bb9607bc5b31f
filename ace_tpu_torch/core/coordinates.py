"""Horizontal and vertical coordinates (port of the lat-lon, HEALPix,
hybrid sigma-pressure and depth parts of ace_tpu/core/coordinates.py). A dataset
with no vertical coordinate has ``None`` (the JAX package's
``NullVerticalCoordinate``).

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


def dz_from_idepth(idepth: np.ndarray, mask: np.ndarray,
                   deptho: np.ndarray | None = None) -> np.ndarray:
    """Layer thicknesses from interface depths, with partial bottom cells
    where the sea-floor depth ``deptho`` is given (port of
    ace_tpu/core/coordinates.py:99)."""
    z_top = idepth[..., :-1]
    z_bot = idepth[..., 1:]
    if deptho is None:
        deptho_exp = np.max(mask * z_bot, axis=-1, keepdims=True)
    else:
        deptho_exp = np.asarray(deptho)[..., None]
    dz = np.clip(deptho_exp, z_top, z_bot) - z_top
    return np.nan_to_num(dz) * mask


@dataclasses.dataclass(eq=False)
class DepthCoordinate:
    """Ocean depth coordinate: interface depths ``idepth`` (1-D, positive
    down), a per-layer wet mask ``[..., n_layers]`` (1 wet, 0 dry) and
    optionally the sea-floor depth ``deptho`` for partial bottom cells
    (port of ace_tpu/core/coordinates.py:119)."""

    idepth: np.ndarray
    mask: np.ndarray
    deptho: np.ndarray | None = None

    def __post_init__(self):
        self.idepth = np.asarray(self.idepth, dtype=np.float32)
        self.mask = np.asarray(self.mask, dtype=np.float32)
        if self.deptho is not None:
            self.deptho = np.asarray(self.deptho, dtype=np.float32)
        if self.idepth.ndim != 1:
            raise ValueError("idepth must be 1-dimensional")
        if self.mask.shape[-1] != len(self.idepth) - 1:
            raise ValueError(
                "mask last dim must equal len(idepth) - 1 "
                f"({self.mask.shape[-1]} vs {len(self.idepth) - 1})"
            )
        self._dz = dz_from_idepth(self.idepth, self.mask, self.deptho)
        # the wet columns: those whose surface layer is wet
        self._wet = (self.mask[..., 0] if self.mask.ndim > 1
                     else self.mask[:1]) > 0
        self._device_cache: dict = {}

    def __len__(self):
        return len(self.idepth)

    @property
    def dz(self) -> np.ndarray:
        return self._dz

    def as_dict(self) -> dict:
        d = {"idepth": self.idepth.tolist(), "mask": self.mask.tolist()}
        if self.deptho is not None:
            d["deptho"] = np.nan_to_num(self.deptho).tolist()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DepthCoordinate":
        return cls(idepth=np.asarray(d["idepth"]), mask=np.asarray(d["mask"]),
                   deptho=(np.asarray(d["deptho"])
                           if d.get("deptho") is not None else None))

    def depth_integral(self, integrand: torch.Tensor) -> torch.Tensor:
        """∫ x dz over the wet layers; removes the trailing vertical axis.
        NaNs in the integrand count as zero; dry columns (surface mask 0)
        are NaN."""
        device = integrand.device
        dz = cached_on_device(self._device_cache, "dz", self._dz, device)
        wet = cached_on_device(self._device_cache, "wet", self._wet, device)
        integral = torch.nan_to_num(integrand * dz).sum(-1)
        return torch.where(wet, integral, float("nan"))


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


@dataclasses.dataclass(eq=False)
class HEALPixCoordinates:
    """A HEALPix (face, height, width) grid in flat-XY pixel order (port
    of ace_tpu/core/coordinates.py:274). Its pixels are equal-area, so it
    has no area weights."""

    face: np.ndarray
    height: np.ndarray
    width: np.ndarray

    def __post_init__(self):
        self.face = np.asarray(self.face)
        self.height = np.asarray(self.height)
        self.width = np.asarray(self.width)
        if len(self.face) != 12:
            raise ValueError("HEALPixCoordinates must have 12 faces")
        if len(self.height) != len(self.width):
            raise ValueError("HEALPix faces must be square")
        nside = len(self.width)
        if 2 ** int(np.log2(nside)) != nside:
            raise ValueError("HEALPix nside must be a power of 2")
        self.nside = nside

    @classmethod
    def from_nside(cls, nside: int) -> "HEALPixCoordinates":
        return cls(face=np.arange(12), height=np.arange(nside),
                   width=np.arange(nside))

    def __eq__(self, other):
        return (isinstance(other, HEALPixCoordinates)
                and other.nside == self.nside)

    @property
    def shape(self) -> tuple[int, int, int]:
        return (12, self.nside, self.nside)

    @property
    def grid(self) -> str:
        return "healpix"

    @property
    def area_weights(self) -> None:
        return None

    def meshgrid(self) -> tuple[np.ndarray, np.ndarray]:
        """(lat, lon) in degrees of each pixel, ``[12, nside, nside]``,
        from the ring geometry and the ring to xy reorder."""
        from ace_tpu_torch.ops.hpx import (
            ring_decomposition,
            ring_to_xy_indices,
        )

        nphi, start, theta, phi0 = ring_decomposition(self.nside)
        npix = 12 * self.nside**2
        lat_ring = np.zeros(npix)
        lon_ring = np.zeros(npix)
        for t in range(len(nphi)):
            p = np.arange(nphi[t])
            lat_ring[start[t]:start[t] + nphi[t]] = 90.0 - np.rad2deg(
                theta[t])
            lon_ring[start[t]:start[t] + nphi[t]] = np.rad2deg(
                phi0[t] + 2.0 * np.pi * p / nphi[t])
        idx = ring_to_xy_indices(self.nside)
        return (lat_ring[idx].reshape(self.shape),
                lon_ring[idx].reshape(self.shape))

    @property
    def xyz(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        lat, lon = self.meshgrid()
        lat_r, lon_r = np.deg2rad(lat), np.deg2rad(lon)
        return (np.cos(lat_r) * np.cos(lon_r),
                np.cos(lat_r) * np.sin(lon_r),
                np.sin(lat_r))

    def as_dict(self) -> dict:
        return {"nside": int(self.nside)}

    @classmethod
    def from_dict(cls, d: dict) -> "HEALPixCoordinates":
        return cls.from_nside(d["nside"])

    def get_gridded_operations(self):
        from ace_tpu_torch.core.gridded_ops import HEALPixOperations

        return HEALPixOperations(self.nside)


def gaussian_latitudes(nlat: int) -> np.ndarray:
    """Gaussian (Legendre) latitudes in degrees, south-to-north ascending."""
    from ace_tpu_torch.ops.quadrature import legendre_gauss_weights

    cost, _ = legendre_gauss_weights(nlat)
    return np.rad2deg(np.arcsin(cost))


def serialize_vertical_coordinate(vc) -> dict:
    if isinstance(vc, HybridSigmaPressureCoordinate):
        return {"type": "hybrid_sigma_pressure", "data": vc.as_dict()}
    if isinstance(vc, DepthCoordinate):
        return {"type": "depth", "data": vc.as_dict()}
    if vc is None:
        return {"type": "null", "data": {}}
    raise NotImplementedError(f"vertical coordinate {type(vc).__name__}")


def deserialize_vertical_coordinate(state: dict):
    if state["type"] == "hybrid_sigma_pressure":
        return HybridSigmaPressureCoordinate.from_dict(state["data"])
    if state["type"] == "depth":
        return DepthCoordinate.from_dict(state["data"])
    if state["type"] == "null":
        return None
    raise ValueError(f"unknown vertical coordinate {state['type']!r}")
