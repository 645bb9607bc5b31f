"""Seasonal-mean and near-zero-fraction aggregators (port of
ace_tpu/aggregator/seasonal.py). Both keep their running reductions on the
device and bring them to the host when read."""

import numpy as np
import torch

from ace_tpu_torch.core.typing_ import TensorMapping
from ace_tpu_torch.data.time import TimeCoord

SEASON_OF_MONTH = {
    12: "DJF", 1: "DJF", 2: "DJF",
    3: "MAM", 4: "MAM", 5: "MAM",
    6: "JJA", 7: "JJA", 8: "JJA",
    9: "SON", 10: "SON", 11: "SON",
}
SEASONS = ("DJF", "MAM", "JJA", "SON")
_SEASON_INDEX = {s: i for i, s in enumerate(SEASONS)}


class SeasonalAggregator:
    """Mean maps per meteorological season (DJF/MAM/JJA/SON). Each sample
    bins by its own calendar month; a window's four season sums of each
    variable are one masked contraction on the device."""

    def __init__(self):
        self._sums: dict[str, dict[str, np.ndarray]] = {}
        self._counts: dict[str, int] = {s: 0 for s in SEASONS}
        self._pending: list = []

    def record_batch(self, gen: TensorMapping, time: TimeCoord,
                     target=None):
        months = np.atleast_2d(time.components()["month"])
        season_idx = np.vectorize(
            lambda m: _SEASON_INDEX[SEASON_OF_MONTH[int(m)]])(months)
        masks = np.stack([season_idx == i for i in range(len(SEASONS))]
                         ).astype(np.float32)  # [4, B, T]
        device = next(iter(gen.values())).device
        masks_dev = torch.as_tensor(masks).to(device, non_blocking=True)
        sums4 = {name: torch.einsum("sbt,bt...->s...", masks_dev,
                                    value.float())
                 for name, value in gen.items()}  # {name: [4, lat, lon]}
        counts = masks.sum(axis=(1, 2)).astype(np.int64)
        for i, season in enumerate(SEASONS):
            self._counts[season] += int(counts[i])
        self._pending.append((counts, sums4))

    def _drain(self):
        for counts, sums4 in self._pending:
            for name, s4 in sums4.items():
                s4 = s4.cpu().numpy()
                sums = self._sums.setdefault(name, {})
                for i, season in enumerate(SEASONS):
                    if counts[i] == 0:
                        continue
                    sums[season] = (sums[season] + s4[i] if season in sums
                                    else s4[i])
        self._pending = []

    def get_diagnostics(self) -> dict[str, np.ndarray]:
        self._drain()
        out = {}
        for name, sums in self._sums.items():
            for season, total in sums.items():
                out[f"seasonal_mean-{season}-{name}"] = (
                    total / max(self._counts[season], 1))
        return out

    def get_logs(self, label: str = "seasonal") -> dict[str, float]:
        self._drain()
        logs = {}
        for name, sums in self._sums.items():
            for season, total in sums.items():
                logs[f"{label}/{season}/global_mean/{name}"] = float(
                    (total / max(self._counts[season], 1)).mean())
        return logs


class NearZeroFractionAggregator:
    """Area-weighted fraction of values at or below a small threshold (a
    collapsing field, e.g. precipitation shutting off). One-sided: a field
    collapsing negative counts as near zero."""

    def __init__(self, threshold: float = 1e-9,
                 area_weights: np.ndarray | None = None):
        self._threshold = threshold
        self._weights = (None if area_weights is None
                         else np.asarray(area_weights))
        self._on_device: dict = {}
        self._near_zero: dict[str, list] = {}
        self._total: dict[str, float] = {}

    def record_batch(self, gen: TensorMapping, target=None, time=None):
        for name, value in gen.items():
            near = (value <= self._threshold).float()
            if self._weights is not None:
                key = str(value.device)
                if key not in self._on_device:
                    self._on_device[key] = torch.as_tensor(
                        self._weights / self._weights.mean(),
                        dtype=torch.float32).to(value.device,
                                                non_blocking=True)
                near = near * self._on_device[key]
            # each [sample, step] partial holds one grid's count (< 2^24),
            # exact in float32; the partials are summed in float64 on the
            # host
            self._near_zero.setdefault(name, []).append(
                near.sum(dim=tuple(range(2, near.dim()))))
            self._total[name] = (self._total.get(name, 0.0)
                                 + float(np.prod(value.shape)))

    def get_logs(self, label: str = "near_zero_fraction") -> dict[str, float]:
        logs = {}
        for name, chunks in self._near_zero.items():
            total = torch.cat([c.reshape(-1) for c in chunks]).cpu().double()
            logs[f"{label}/{name}"] = float(total.sum()) / self._total[name]
        return logs
