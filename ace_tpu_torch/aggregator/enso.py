"""ENSO (Nino3.4) and IPO index aggregators (port of
ace_tpu/aggregator/enso.py).

The regional mean of each window's SST is one contraction on the device;
the small ``[batch, time]`` series stay there until the index is read, and
then come to the host at once. The index itself (monthly climatology
anomalies, a running monthly mean) is host numpy, as in the JAX package.
"""

import numpy as np
import torch

from ace_tpu_torch.core.coordinates import LatLonCoordinates
from ace_tpu_torch.core.typing_ import TensorMapping

NINO34 = dict(lat=(-5.0, 5.0), lon=(190.0, 240.0))  # 170W-120W
IPO_REGIONS = [
    dict(lat=(25.0, 45.0), lon=(140.0, 215.0), weight=-0.5),
    dict(lat=(-10.0, 10.0), lon=(170.0, 270.0), weight=1.0),
    dict(lat=(-50.0, -15.0), lon=(150.0, 200.0), weight=-0.5),
]


def _region_mask(coords: LatLonCoordinates, lat, lon) -> np.ndarray:
    lat_bounds, lon_bounds = lat, lon
    lat = np.asarray(coords.lat)
    lon = np.asarray(coords.lon) % 360.0
    lat_in = (lat >= lat_bounds[0]) & (lat <= lat_bounds[1])
    lo, hi = lon_bounds[0] % 360.0, lon_bounds[1] % 360.0
    if lo <= hi:
        lon_in = (lon >= lo) & (lon <= hi)
    else:
        lon_in = (lon >= lo) | (lon <= hi)
    mask = lat_in[:, None] & lon_in[None, :]
    weights = np.cos(np.deg2rad(lat))[:, None] * mask
    return weights / max(weights.sum(), 1e-12)


def _contract(x: torch.Tensor, weights: np.ndarray, cache: dict
              ) -> torch.Tensor:
    """``x [..., lat, lon]`` contracted with ``weights`` over the grid, in
    float32 on ``x``'s device (the weights copied there once, without
    waiting)."""
    key = str(x.device)
    if key not in cache:
        cache[key] = torch.as_tensor(weights, dtype=torch.float32).to(
            x.device, non_blocking=True)
    return torch.tensordot(x.float(), cache[key], dims=([-2, -1], [0, 1]))


def _host_series(chunks: list) -> list[np.ndarray]:
    """The device series as host arrays, in one transfer."""
    if not chunks or isinstance(chunks[0], np.ndarray):
        return chunks
    flat = torch.cat([c.reshape(-1) for c in chunks]).cpu().numpy()
    out, start = [], 0
    for c in chunks:
        out.append(flat[start:start + c.numel()].reshape(c.shape))
        start += c.numel()
    return out


class EnsoIndexAggregator:
    """Regional-mean SST over Nino3.4; the index is its anomaly against
    the per-calendar-month climatology, then a running monthly mean."""

    def __init__(self, coords: LatLonCoordinates,
                 sst_name: str = "surface_temperature",
                 running_mean_n_months: int = 5):
        self._weights = _region_mask(coords, **NINO34)
        self._on_device: dict = {}
        self._sst_name = sst_name
        self._running_mean_n_months = running_mean_n_months
        self._gen: list = []
        self._target: list = []
        self._years: list[np.ndarray] = []
        self._months: list[np.ndarray] = []

    def record_batch(self, gen: TensorMapping,
                     target: TensorMapping | None = None, time=None):
        if self._sst_name not in gen:
            return
        self._gen.append(_contract(gen[self._sst_name], self._weights,
                                   self._on_device))
        if time is not None:
            comps = time.components()
            self._years.append(np.atleast_2d(comps["year"])[0])
            self._months.append(np.atleast_2d(comps["month"])[0])
        if target is not None and self._sst_name in target:
            self._target.append(_contract(target[self._sst_name],
                                          self._weights, self._on_device))

    def _drain(self):
        self._gen = _host_series(self._gen)
        self._target = _host_series(self._target)

    def _index(self, chunks):
        """Anomalies against the per-calendar-month climatology, then a
        trailing running mean of the monthly means; without recorded times,
        the series less its mean."""
        series = np.concatenate(chunks, axis=-1)  # [B, T_total]
        if not self._months:
            return series - series.mean(axis=-1, keepdims=True)
        months = np.concatenate(self._months)[: series.shape[-1]]
        years = np.concatenate(self._years)[: series.shape[-1]]
        series = series[..., : len(months)].astype(np.float64)
        anom = series.copy()
        for m in range(1, 13):
            sel = months == m
            if sel.any():
                anom[..., sel] -= series[..., sel].mean(axis=-1,
                                                        keepdims=True)
        keys = years * 12 + (months - 1)
        uniq = np.unique(keys)
        monthly = np.stack(
            [anom[..., keys == k].mean(axis=-1) for k in uniq], axis=-1)
        n = self._running_mean_n_months
        if monthly.shape[-1] < n:
            return monthly
        return np.stack(
            [monthly[..., i - n + 1: i + 1].mean(axis=-1)
             for i in range(n - 1, monthly.shape[-1])], axis=-1)

    def get_logs(self, label: str = "enso") -> dict[str, float]:
        if not self._gen:
            return {}
        self._drain()
        logs = {}
        gen_idx = self._index(self._gen)
        logs[f"{label}/index_std"] = float(gen_idx.std())
        if self._target:
            tgt_idx = self._index(self._target)
            n = min(gen_idx.shape[-1], tgt_idx.shape[-1])
            g, t = gen_idx[..., :n].ravel(), tgt_idx[..., :n].ravel()
            denom = g.std() * t.std()
            if denom > 0:
                logs[f"{label}/index_correlation"] = float(
                    np.mean((g - g.mean()) * (t - t.mean())) / denom)
        return logs

    def get_diagnostics(self) -> dict[str, np.ndarray]:
        self._drain()
        out = {}
        if self._gen:
            out["gen_index"] = self._index(self._gen)
        if self._target:
            out["target_index"] = self._index(self._target)
        return out


class IpoIndexAggregator:
    """The IPO tripole index from three Pacific SST regions."""

    def __init__(self, coords: LatLonCoordinates,
                 sst_name: str = "surface_temperature"):
        self._weights = [(_region_mask(coords, r["lat"], r["lon"]),
                          r["weight"]) for r in IPO_REGIONS]
        self._on_device = [{} for _ in IPO_REGIONS]
        self._sst_name = sst_name
        self._gen: list = []

    def record_batch(self, gen: TensorMapping, target=None, time=None):
        if self._sst_name not in gen:
            return
        sst = gen[self._sst_name]
        self._gen.append(sum(
            w * _contract(sst, mask, cache)
            for (mask, w), cache in zip(self._weights, self._on_device)))

    def get_diagnostics(self) -> dict[str, np.ndarray]:
        if not self._gen:
            return {}
        self._gen = _host_series(self._gen)
        series = np.concatenate(self._gen, axis=-1)
        return {"ipo_index": series - series.mean(axis=-1, keepdims=True)}
