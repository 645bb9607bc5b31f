"""Bilinear resampling between spherical lat-lon grids, channels-last
(port of ace_tpu/ops/resample.py; torch_harmonics' ``ResampleS2`` with
``mode="bilinear"``).

Latitudes interpolate linearly in colatitude between the bracketing input
rows (clamped at the poles); longitudes interpolate circularly on the
uniform grid. Two precomputed gather-and-lerp passes.
"""

import numpy as np
import torch
from torch import nn

from ace_tpu_torch.ops.sht import quadrature_for_grid


def grid_colatitudes(nlat: int, grid: str) -> np.ndarray:
    """Ascending colatitudes matching the SHT/DISCO row ordering
    (north-to-south rows = theta ascending)."""
    cost, _, _ = quadrature_for_grid(grid, nlat)
    return np.flip(np.arccos(cost)).copy()


def _lat_interp_weights(theta_in: np.ndarray, theta_out: np.ndarray):
    """Bracketing indices + weights for 1D linear interp (ascending)."""
    idx_hi = np.searchsorted(theta_in, theta_out)
    idx_hi = np.clip(idx_hi, 1, len(theta_in) - 1)
    idx_lo = idx_hi - 1
    denom = theta_in[idx_hi] - theta_in[idx_lo]
    w_hi = np.where(denom > 0, (theta_out - theta_in[idx_lo]) / denom, 0.0)
    w_hi = np.clip(w_hi, 0.0, 1.0)
    return idx_lo.astype(np.int32), idx_hi.astype(np.int32), w_hi


class ResampleS2(nn.Module):
    """Channels-last bilinear regridding ``[..., H_in, W_in, C] -> [...,
    H_out, W_out, C]`` float32 (port of ace_tpu/ops/resample.py:35); the
    indices and weights are buffers, not saved with the weights."""

    def __init__(self, nlat_in: int, nlon_in: int, nlat_out: int,
                 nlon_out: int, grid_in: str = "equiangular",
                 grid_out: str = "equiangular", device=None):
        super().__init__()
        theta_in = grid_colatitudes(nlat_in, grid_in)
        theta_out = grid_colatitudes(nlat_out, grid_out)
        lo, hi, w_hi = _lat_interp_weights(theta_in, theta_out)
        # circular longitude interpolation on uniform grids
        pos = np.arange(nlon_out) * (nlon_in / nlon_out)
        lon_lo = np.floor(pos).astype(np.int32) % nlon_in
        lon_hi = (lon_lo + 1) % nlon_in
        buffers = {
            "lat_lo": torch.from_numpy(lo.astype(np.int64)),
            "lat_hi": torch.from_numpy(hi.astype(np.int64)),
            "lat_w": torch.as_tensor(w_hi, dtype=torch.float32)[:, None,
                                                                None],
            "lon_lo": torch.from_numpy(lon_lo.astype(np.int64)),
            "lon_hi": torch.from_numpy(lon_hi.astype(np.int64)),
            "lon_w": torch.as_tensor((pos - np.floor(pos)).astype(
                np.float32))[:, None],
        }
        for name, value in buffers.items():
            self.register_buffer(name, value.to(device), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        lo = x[..., self.lat_lo, :, :]
        hi = x[..., self.lat_hi, :, :]
        x = lo * (1.0 - self.lat_w) + hi * self.lat_w
        lo = x[..., self.lon_lo, :]
        hi = x[..., self.lon_hi, :]
        return lo * (1.0 - self.lon_w) + hi * self.lon_w
