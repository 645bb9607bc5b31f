"""Weighted statistics and physics helpers used by the step layer
(port of the parts of ace_tpu/core/metrics.py the corrector needs)."""

import numpy as np
import torch

from ace_tpu_torch.core.constants import GRAVITY


def spherical_area_weights(lats, num_lon: int) -> np.ndarray:
    """Area weights ``[..., num_lat, num_lon]`` for a regular lat-lon grid
    (latitudes in degrees), normalized to sum to 1. Computed in float32 on
    the host, as the JAX package does."""
    lats = np.asarray(lats, dtype=np.float32)
    weights = np.cos(np.deg2rad(lats))[..., None]
    weights = np.broadcast_to(weights, (*weights.shape[:-1], num_lon))
    return weights / np.sum(weights, axis=(-1, -2), keepdims=True)


def weighted_mean(tensor, weights=None, dim=(), keepdim=False):
    """Weighted mean over ``dim``; points of zero weight are excluded
    even where the data are NaN."""
    dim = (dim,) if isinstance(dim, int) else tuple(dim)
    if weights is None:
        return tensor.mean(dim=dim, keepdim=keepdim)
    weights = torch.broadcast_to(weights, tensor.shape)
    tensor = torch.where(weights != 0.0, tensor, 0.0)
    return (tensor * weights).sum(dim=dim, keepdim=keepdim) / weights.sum(
        dim=dim, keepdim=keepdim
    )


def surface_pressure_due_to_dry_air(surface_pressure, total_water_path):
    """Surface pressure due to dry-air mass only, Pa."""
    return surface_pressure - GRAVITY * total_water_path
