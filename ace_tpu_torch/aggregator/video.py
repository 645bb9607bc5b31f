"""Video aggregator (port of ace_tpu/aggregator/video.py): per-step
batch-mean maps of each variable over the rollout, for prediction and
target, and in extended mode the bias, RMSE, smallest and largest error
and the variance of the prediction.

A window is reduced over the batch on the device; its ``[steps, lat,
lon]`` partials wait there and are added into float64 host arrays when
read, or as soon as those waiting pass ``DRAIN_BYTES`` (or
``DRAIN_EVERY`` windows), which bounds the device memory they hold. Each
such drain copies to the host and so waits for the device: at a full grid
in extended mode a window's partials pass ``DRAIN_BYTES`` alone, and every
window drains.
"""

import time

import numpy as np

from ace_tpu_torch.core.typing_ import TensorMapping


class VideoAggregator:

    DRAIN_BYTES = 256 * 1024 * 1024
    DRAIN_EVERY = 32

    def __init__(self, n_timesteps: int,
                 enable_extended_videos: bool = False):
        self._n_timesteps = n_timesteps
        self._extended = enable_extended_videos
        self._i_time = 0
        self._gen_sum: dict[str, np.ndarray] = {}
        self._target_sum: dict[str, np.ndarray] = {}
        self._count: np.ndarray | None = None
        self._sq_err_sum: dict[str, np.ndarray] = {}
        self._gen_sq_sum: dict[str, np.ndarray] = {}
        self._min_err: dict[str, np.ndarray] = {}
        self._max_err: dict[str, np.ndarray] = {}
        self._pending: list = []
        self._pending_bytes = 0
        # the drains forced by DRAIN_BYTES or DRAIN_EVERY, and the host's
        # seconds in all drains (the waits for the device included)
        self.forced_drains = 0
        self.drain_seconds = 0.0

    def _ensure(self, store, name, spatial, fill=0.0):
        if name not in store:
            store[name] = np.full((self._n_timesteps, *spatial), fill,
                                  np.float64)
        return store[name]

    def _partials(self, gen: TensorMapping, target, n_keep: int) -> dict:
        out = {}
        for name, value in gen.items():
            arr = value[:, :n_keep]
            entry = {"gen_sum": arr.sum(dim=0)}
            if self._extended:
                entry["gen_sq_sum"] = (arr * arr).sum(dim=0)
            if target is not None and name in target:
                tgt = target[name][:, :n_keep]
                entry["target_sum"] = tgt.sum(dim=0)
                if self._extended:
                    err = arr - tgt
                    entry["sq_err_sum"] = (err * err).sum(dim=0)
                    entry["min_err"] = err.amin(dim=0)
                    entry["max_err"] = err.amax(dim=0)
            out[name] = entry
        return out

    def record_batch(self, gen: TensorMapping,
                     target: TensorMapping | None = None,
                     i_time_start: int | None = None):
        first = next(iter(gen.values()))
        n_batch, n_time = first.shape[:2]
        start = self._i_time if i_time_start is None else i_time_start
        end = min(start + n_time, self._n_timesteps)
        n_keep = end - start
        if n_keep <= 0:
            return
        window = {"start": start, "n_keep": n_keep, "n_batch": n_batch,
                  "vars": self._partials(gen, target, n_keep)}
        self._pending.append(window)
        self._pending_bytes += sum(a.numel() * a.element_size()
                                   for entry in window["vars"].values()
                                   for a in entry.values())
        if i_time_start is None:
            self._i_time += n_time
        if (len(self._pending) >= self.DRAIN_EVERY
                or self._pending_bytes >= self.DRAIN_BYTES):
            self.forced_drains += 1
            self._drain()

    def _drain(self):
        t0 = time.perf_counter()
        for window in self._pending:
            sl = slice(window["start"], window["start"] + window["n_keep"])
            if self._count is None:
                self._count = np.zeros((self._n_timesteps,), np.int64)
            self._count[sl] += window["n_batch"]
            for name, entry in window["vars"].items():
                entry = {k: v.cpu().numpy() for k, v in entry.items()}
                spatial = entry["gen_sum"].shape[1:]
                self._ensure(self._gen_sum, name, spatial)[sl] += (
                    entry["gen_sum"].astype(np.float64))
                if "gen_sq_sum" in entry:
                    self._ensure(self._gen_sq_sum, name, spatial)[sl] += (
                        entry["gen_sq_sum"].astype(np.float64))
                if "target_sum" in entry:
                    self._ensure(self._target_sum, name, spatial)[sl] += (
                        entry["target_sum"].astype(np.float64))
                if "sq_err_sum" in entry:
                    self._ensure(self._sq_err_sum, name, spatial)[sl] += (
                        entry["sq_err_sum"].astype(np.float64))
                    mn = self._ensure(self._min_err, name, spatial,
                                      fill=np.inf)
                    mx = self._ensure(self._max_err, name, spatial,
                                      fill=-np.inf)
                    mn[sl] = np.minimum(mn[sl], entry["min_err"])
                    mx[sl] = np.maximum(mx[sl], entry["max_err"])
        self._pending = []
        self._pending_bytes = 0
        self.drain_seconds += time.perf_counter() - t0

    def get_diagnostics(self) -> dict[str, np.ndarray]:
        self._drain()
        if self._count is None:
            return {}
        first = next(iter(self._gen_sum.values()))
        n = np.maximum(self._count, 1).reshape(
            (-1,) + (1,) * (first.ndim - 1))
        out: dict[str, np.ndarray] = {}
        for name, s in self._gen_sum.items():
            gen_mean = (s / n).astype(np.float32)
            out[f"video-gen-{name}"] = gen_mean
            if name in self._target_sum:
                tgt_mean = (self._target_sum[name] / n).astype(np.float32)
                out[f"video-target-{name}"] = tgt_mean
                if self._extended:
                    out[f"video-bias-{name}"] = gen_mean - tgt_mean
            if self._extended and name in self._sq_err_sum:
                out[f"video-rmse-{name}"] = np.sqrt(
                    self._sq_err_sum[name] / n).astype(np.float32)
                out[f"video-min_err-{name}"] = self._min_err[name].astype(
                    np.float32)
                out[f"video-max_err-{name}"] = self._max_err[name].astype(
                    np.float32)
            if self._extended and name in self._gen_sq_sum:
                var = (self._gen_sq_sum[name] / n
                       - (self._gen_sum[name] / n) ** 2)
                out[f"video-gen_var-{name}"] = np.maximum(var, 0.0).astype(
                    np.float32)
        return out

    def get_logs(self, label: str = "video") -> dict[str, float]:
        # videos are array diagnostics; the logs carry only their number
        return {f"{label}/n_videos": float(len(self.get_diagnostics()))}
