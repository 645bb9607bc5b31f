"""Per-grid-cell linear trend maps (port of ace_tpu/aggregator/trend.py):
the least-squares slope of each variable against time in years, from
running sums, so that memory does not grow with the rollout.

A window's partial sums are float32 on the device, over its few (sample,
step) pairs, with the times centred on the window's mean (the slope's
numerator is a small difference of large terms); they come to the host
when read and are summed there in float64, the centring undone.
"""

import numpy as np
import torch

from ace_tpu_torch.core.typing_ import TensorMapping
from ace_tpu_torch.data.time import TimeCoord, parse_datetime_string

SECONDS_PER_YEAR = 365.25 * 24 * 60 * 60


class TrendAggregator:
    """slope = (n*sum(t*y) - sum(t)*sum(y)) / (n*sum(t^2) - sum(t)^2)."""

    def __init__(self):
        self._n = 0
        self._sum_t = 0.0
        self._sum_t2 = 0.0
        self._sum_y: dict[str, np.ndarray] = {}
        self._sum_ty: dict[str, np.ndarray] = {}
        self._target_sum_y: dict[str, np.ndarray] = {}
        self._target_sum_ty: dict[str, np.ndarray] = {}
        # a fixed epoch keeps the running sums consistent across windows
        self._ref_us = int(parse_datetime_string("2000-01-01T00:00"))
        self._pending: list = []

    def _years(self, time: TimeCoord) -> np.ndarray:
        seconds = (np.asarray(time.values, np.float64) - self._ref_us) / 1e6
        return seconds / SECONDS_PER_YEAR

    def record_batch(self, gen: TensorMapping, time: TimeCoord,
                     target: TensorMapping | None = None):
        t = self._years(time)  # [B, T]
        self._n += t.size
        self._sum_t += float(t.sum())
        self._sum_t2 += float((t ** 2).sum())
        t_mean = float(t.mean())
        device = next(iter(gen.values())).device
        dt = torch.as_tensor(np.asarray(t - t_mean, np.float32)).to(
            device, non_blocking=True)[..., None, None]
        window = {"gen": {}, "target": {}}
        for name, value in gen.items():
            window["gen"][name] = (value.sum(dim=(0, 1)),
                                   (value * dt).sum(dim=(0, 1)))
            if target is not None and name in target:
                tv = target[name]
                window["target"][name] = (tv.sum(dim=(0, 1)),
                                          (tv * dt).sum(dim=(0, 1)))
        self._pending.append((t_mean, window))

    def _drain(self):
        for t_mean, window in self._pending:
            for kind, sum_y, sum_ty in (
                    ("gen", self._sum_y, self._sum_ty),
                    ("target", self._target_sum_y, self._target_sum_ty)):
                for name, (y, dty) in window[kind].items():
                    # sum(t*y) = sum(dt*y) + t_mean * sum(y), in float64
                    y64 = y.cpu().numpy().astype(np.float64)
                    sum_y[name] = sum_y.get(name, 0.0) + y64
                    sum_ty[name] = (sum_ty.get(name, 0.0)
                                    + dty.cpu().numpy().astype(np.float64)
                                    + t_mean * y64)
        self._pending = []

    def _slope(self, sum_y, sum_ty):
        denom = self._n * self._sum_t2 - self._sum_t ** 2
        if denom == 0:
            return np.zeros_like(np.asarray(sum_y))
        return (self._n * sum_ty - self._sum_t * sum_y) / denom

    def get_diagnostics(self) -> dict[str, np.ndarray]:
        self._drain()
        out = {}
        for name in self._sum_y:
            out[f"trend-gen-{name}"] = self._slope(
                self._sum_y[name], self._sum_ty[name]).astype(np.float32)
            if name in self._target_sum_y:
                out[f"trend-target-{name}"] = self._slope(
                    self._target_sum_y[name], self._target_sum_ty[name]
                ).astype(np.float32)
        return out

    def get_logs(self, label: str = "trend") -> dict[str, float]:
        return {
            f"{label}/global_mean/{k.removeprefix('trend-')}": float(v.mean())
            for k, v in self.get_diagnostics().items()
        }
