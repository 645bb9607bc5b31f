"""Grid-aware reductions (port of ace_tpu/core/gridded_ops.py: the
helpers of its base class, :17-106, ``LatLonOperations`` :129 and
``HEALPixOperations`` :225). Lat-lon reductions run over the last two
(lat, lon) axes with cos-lat area weights, held on the device of the data
they reduce. With masks (exact-name ``spatial_masks``, or a dataset's
``MaskProvider``), a named variable's masked cells get zero weight, so its
means are over the wet cells only. HEALPix reductions run over the last
three (face, height, width) axes without weights: its pixels are
equal-area."""

import numpy as np
import torch

from ace_tpu_torch.core import metrics
from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping
from ace_tpu_torch.device import cached_on_device

HORIZONTAL_DIMS = (-2, -1)


class GriddedOperations:
    """The reductions every grid shares, over its ``area_weighted_mean``
    and ``area_weighted_sum``."""

    def area_weighted_mean_channels_last(self, data: torch.Tensor
                                         ) -> torch.Tensor:
        """Area-weighted spatial mean of a channels-last tensor
        ``[..., *spatial, C] -> [..., C]`` (the packed layout the losses
        see)."""
        return self.area_weighted_mean(data.movedim(-1, 0)).movedim(0, -1)

    def area_weighted_sum_dict(self, data: TensorMapping) -> TensorDict:
        return {k: self.area_weighted_sum(v, name=k) for k, v in data.items()}

    def area_weighted_mean_dict(self, data: TensorMapping) -> TensorDict:
        return {k: self.area_weighted_mean(v, name=k) for k, v in data.items()}

    def area_weighted_mean_bias(self, truth, predicted, name=None):
        return self.area_weighted_mean(predicted - truth, name=name)

    def area_weighted_mean_bias_dict(self, truth: TensorMapping,
                                     predicted: TensorMapping) -> TensorDict:
        return {k: self.area_weighted_mean_bias(truth[k], predicted[k], name=k)
                for k in truth}

    def area_weighted_rmse(self, truth, predicted, name=None):
        return torch.sqrt(
            self.area_weighted_mean((predicted - truth) ** 2, name=name)
        )

    def area_weighted_rmse_dict(self, truth: TensorMapping,
                                predicted: TensorMapping) -> TensorDict:
        return {k: self.area_weighted_rmse(truth[k], predicted[k], name=k)
                for k in truth}

    def area_weighted_std(self, data, name=None):
        mean = self.area_weighted_mean(data, keepdim=True, name=name)
        return torch.sqrt(
            self.area_weighted_mean((data - mean) ** 2, name=name)
        )

    def area_weighted_std_dict(self, data: TensorMapping) -> TensorDict:
        return {k: self.area_weighted_std(v, name=k) for k, v in data.items()}


class LatLonOperations(GriddedOperations):
    def __init__(self, area_weights, spatial_masks=None, mask_provider=None):
        self._area_weights = np.asarray(area_weights, dtype=np.float32)
        self._spatial_masks = (
            {k: np.asarray(v, dtype=np.float32)
             for k, v in spatial_masks.items()} if spatial_masks else None)
        self._mask_provider = mask_provider
        # each name's masked weights on the host (None: unmasked)
        self._masked_weights: dict = {}
        self._device_cache: dict = {}

    @property
    def area_weights_host(self) -> np.ndarray:
        return self._area_weights

    def area_weights(self, device) -> torch.Tensor:
        return cached_on_device(self._device_cache, "area_weights",
                                self._area_weights, device)

    def _weights_for(self, name: str | None, device) -> torch.Tensor:
        """The area weights of variable ``name``: zero where its mask
        (``spatial_masks`` by exact name first, then the mask provider's)
        is 0."""
        if name is None:
            return self.area_weights(device)
        if name not in self._masked_weights:
            mask = None
            if self._spatial_masks is not None and name in self._spatial_masks:
                mask = self._spatial_masks[name]
            elif self._mask_provider is not None:
                mask = self._mask_provider.get_mask_for(name)
            self._masked_weights[name] = (
                None if mask is None
                else (self._area_weights * mask).astype(np.float32))
        weights = self._masked_weights[name]
        if weights is None:
            return self.area_weights(device)
        return cached_on_device(self._device_cache, f"masked/{name}",
                                weights, device)

    @staticmethod
    def zonal_mean(data: torch.Tensor) -> torch.Tensor:
        return data.mean(dim=-1)

    def area_weighted_sum(self, data: torch.Tensor, keepdim: bool = False,
                          name: str | None = None) -> torch.Tensor:
        return metrics.weighted_sum(
            data, self._weights_for(name, data.device), dim=HORIZONTAL_DIMS,
            keepdim=keepdim,
        )

    def area_weighted_mean(self, data: torch.Tensor, keepdim: bool = False,
                           name: str | None = None) -> torch.Tensor:
        return metrics.weighted_mean(
            data, self._weights_for(name, data.device), dim=HORIZONTAL_DIMS,
            keepdim=keepdim,
        )

    def area_weighted_gradient_magnitude_percent_diff(self, truth, predicted,
                                                      name=None):
        return metrics.gradient_magnitude_percent_diff(
            truth, predicted, self._weights_for(name, truth.device),
            dim=HORIZONTAL_DIMS,
        )


class HEALPixOperations(GriddedOperations):
    """Plain means and sums over ``(face, height, width)``; the SHT pair
    of the grid at ``lmax = mmax = 2 nside - 1`` on flat-XY data (port of
    ace_tpu/core/gridded_ops.py:225)."""

    HORIZONTAL_DIMS = (-3, -2, -1)
    zonal_mean = None

    def __init__(self, nside: int | None = None):
        self.nside = nside

    def area_weighted_sum(self, data: torch.Tensor, keepdim: bool = False,
                          name: str | None = None) -> torch.Tensor:
        return data.sum(dim=self.HORIZONTAL_DIMS, keepdim=keepdim)

    def area_weighted_mean(self, data: torch.Tensor, keepdim: bool = False,
                           name: str | None = None) -> torch.Tensor:
        return data.mean(dim=self.HORIZONTAL_DIMS, keepdim=keepdim)

    def regional_area_weighted_mean(self, data, regional_mask,
                                    keepdim=False, name=None):
        raise NotImplementedError(
            "regional means are not implemented for HEALPix")

    def area_weighted_gradient_magnitude_percent_diff(self, truth, predicted,
                                                      name=None):
        return metrics.gradient_magnitude_percent_diff(
            truth, predicted, None, dim=(-2, -1))

    def _lmax(self) -> int:
        if self.nside is None:
            raise ValueError("nside must be specified for SHT")
        return 2 * self.nside - 1

    def get_real_sht(self, device=None):
        """The forward SHT of flat-XY ``[..., 12, nside, nside, C]`` data
        to complex ``[..., lmax, mmax, C]`` coefficients (its
        ``forward_pair`` gives the real and imaginary parts)."""
        from ace_tpu_torch.ops.hpx import HealpixSHT

        lmax = self._lmax()
        return HealpixSHT(self.nside, lmax=lmax, mmax=lmax, xy_order=True,
                          device=device)

    def get_real_isht(self, device=None):
        """The inverse of :meth:`get_real_sht`, to flat-XY data."""
        from ace_tpu_torch.ops.hpx import HealpixISHT

        lmax = self._lmax()
        return HealpixISHT(self.nside, lmax=lmax, mmax=lmax, xy_order=True,
                           device=device)

    def get_state(self) -> dict:
        return {"type": type(self).__name__, "state": {"nside": self.nside}}
