"""Grid-aware reductions (port of ace_tpu/core/gridded_ops.py:129
LatLonOperations). Reductions run over the last two (lat, lon) axes with
cos-lat area weights, held on the device of the data they reduce."""

import numpy as np
import torch

from ace_tpu_torch.core import metrics
from ace_tpu_torch.device import cached_on_device

HORIZONTAL_DIMS = (-2, -1)


class LatLonOperations:
    def __init__(self, area_weights):
        self._area_weights = np.asarray(area_weights, dtype=np.float32)
        self._device_cache: dict = {}

    def area_weights(self, device) -> torch.Tensor:
        return cached_on_device(self._device_cache, "area_weights",
                                self._area_weights, device)

    def area_weighted_mean(self, data: torch.Tensor, keepdim: bool = False,
                           name: str | None = None) -> torch.Tensor:
        return metrics.weighted_mean(
            data, self.area_weights(data.device), dim=HORIZONTAL_DIMS,
            keepdim=keepdim,
        )

    def area_weighted_mean_channels_last(self, data: torch.Tensor
                                         ) -> torch.Tensor:
        """Area-weighted spatial mean of a channels-last tensor
        ``[..., lat, lon, C] -> [..., C]`` (the packed layout the losses
        see)."""
        return self.area_weighted_mean(data.movedim(-1, 0)).movedim(0, -1)
