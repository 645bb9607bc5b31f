"""Weighted statistics and physics helpers (port of the parts of
ace_tpu/core/metrics.py that the corrector and the aggregators need)."""

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


def weighted_sum(tensor, weights=None, dim=(), keepdim=False):
    """Weighted sum over ``dim``; points of zero weight are excluded even
    where the data are NaN."""
    dim = (dim,) if isinstance(dim, int) else tuple(dim)
    if weights is None:
        return tensor.sum(dim=dim, keepdim=keepdim)
    weights = torch.broadcast_to(weights, tensor.shape)
    tensor = torch.where(weights != 0.0, tensor, 0.0)
    return (tensor * weights).sum(dim=dim, keepdim=keepdim)


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


def weighted_nanmean(tensor, weights=None, dim=(), keepdim=False):
    """Weighted mean over ``dim`` that leaves NaN points out."""
    dim = (dim,) if isinstance(dim, int) else tuple(dim)
    valid = ~torch.isnan(tensor)
    if weights is None:
        weights = torch.ones_like(tensor)
    weights = torch.broadcast_to(weights, tensor.shape) * valid
    tensor = torch.where(valid & (weights != 0.0), tensor, 0.0)
    return (tensor * weights).sum(dim=dim, keepdim=keepdim) / weights.sum(
        dim=dim, keepdim=keepdim
    )


def gradient_magnitude(tensor, dim=(-2, -1)):
    """The magnitude of the gradient over the two spatial dims: central
    differences inside, one-sided at the edges, unit spacing."""
    dy, dx = torch.gradient(tensor, dim=dim)
    return torch.sqrt(dx**2 + dy**2)


def gradient_magnitude_percent_diff(truth, predicted, weights=None,
                                    dim=(-2, -1)):
    """How much larger (in percent) the prediction's mean gradient
    magnitude is than the truth's."""
    truth_grad = weighted_nanmean(gradient_magnitude(truth, dim), weights,
                                  dim)
    pred_grad = weighted_nanmean(gradient_magnitude(predicted, dim), weights,
                                 dim)
    return 100.0 * (pred_grad - truth_grad) / truth_grad


def _all_dims_if_empty(tensor, dim):
    """``dim`` as a tuple; ``()`` means every dim, as the JAX package's
    reductions read it."""
    dim = (dim,) if isinstance(dim, int) else tuple(dim)
    return dim or tuple(range(tensor.dim()))


def weighted_mean_bias(truth, predicted, weights=None, dim=()):
    """The weighted mean of ``predicted - truth`` over ``dim`` (every dim
    by default)."""
    diff = predicted - truth
    return weighted_mean(diff, weights=weights,
                         dim=_all_dims_if_empty(diff, dim))


def root_mean_squared_error(truth, predicted, weights=None, dim=()):
    """The square root of the weighted mean squared error over ``dim``
    (every dim by default)."""
    sq = (predicted - truth) ** 2
    return torch.sqrt(weighted_mean(sq, weights=weights,
                                    dim=_all_dims_if_empty(sq, dim)))
