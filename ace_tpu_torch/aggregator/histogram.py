"""Dynamic histograms and annual means (port of
ace_tpu/aggregator/histogram.py).

``DynamicHistogram`` works on the host in numpy, as the JAX package's does,
so that the counts and edges of the two packages are equal. The values
reach the host without the loop waiting for them: ``HistogramAggregator``
copies each window's fields from the device into pinned buffers with
copies that do not block, closed by a CUDA event, and fills the histograms
one window behind, when the next window is recorded (or when the logs are
read), by which time the device has moved on to the next rollout. A
device histogram would be faster still, but its f32 edges could count a
value at a bin's boundary into the other bin.
"""

import time

import numpy as np
import torch

from ace_tpu_torch.core.gridded_ops import GriddedOperations
from ace_tpu_torch.core.typing_ import TensorMapping
from ace_tpu_torch.data.time import TimeCoord

EPSILON = 1e-8


class DynamicHistogram:
    """Fixed-bin-count histogram that doubles its range to cover new
    values."""

    def __init__(self, n_bins: int = 300):
        self._n_bins = n_bins
        self.bin_edges: np.ndarray | None = None
        self.counts = np.zeros(n_bins, dtype=np.int64)

    def add(self, value: np.ndarray):
        value = np.asarray(value).ravel()
        value = value[np.isfinite(value)]
        if value.size == 0:
            return
        vmin = float(value.min()) - EPSILON
        vmax = float(value.max()) + EPSILON
        if self.bin_edges is None:
            self.bin_edges = np.linspace(vmin, vmax, self._n_bins + 1)
        else:
            while vmin < self.bin_edges[0]:
                self._double_size_left()
            while vmax > self.bin_edges[-1]:
                self._double_size_right()
        counts, _ = np.histogram(value, bins=self.bin_edges)
        self.counts += counts

    def _combine_bins(self):
        """Halve resolution: pairwise-sum counts into n_bins/2 bins."""
        return self.counts[: 2 * (self._n_bins // 2)].reshape(-1, 2).sum(1)

    def _double_size_left(self):
        width = self.bin_edges[-1] - self.bin_edges[0]
        new_edges = np.linspace(
            self.bin_edges[0] - width, self.bin_edges[-1], self._n_bins + 1
        )
        new_counts = np.zeros(self._n_bins, dtype=np.int64)
        new_counts[self._n_bins // 2:] = self._combine_bins()
        self.bin_edges, self.counts = new_edges, new_counts

    def _double_size_right(self):
        width = self.bin_edges[-1] - self.bin_edges[0]
        new_edges = np.linspace(
            self.bin_edges[0], self.bin_edges[-1] + width, self._n_bins + 1
        )
        new_counts = np.zeros(self._n_bins, dtype=np.int64)
        new_counts[: self._n_bins // 2] = self._combine_bins()
        self.bin_edges, self.counts = new_edges, new_counts

    def percentile(self, q: float) -> float:
        """Value at percentile q (0-100), linearly interpolated within the
        bin that holds it."""
        if self.bin_edges is None or self.counts.sum() == 0:
            return float("nan")
        target = q / 100.0
        cdf = np.cumsum(self.counts) / self.counts.sum()
        idx = int(np.searchsorted(cdf, target))
        idx = min(idx, self._n_bins - 1)
        p1 = cdf[idx]
        p0 = cdf[idx - 1] if idx > 0 else 0.0
        c0, c1 = self.bin_edges[idx], self.bin_edges[idx + 1]
        if p1 <= p0:
            return float(c1)
        return float(c0 + (c1 - c0) * (target - p0) / (p1 - p0))


def _start_host_copy(fields: TensorMapping):
    """Pinned host copies of ``fields`` that do not wait for the device,
    and the event that closes them (None for fields on the CPU)."""
    if next(iter(fields.values())).device.type != "cuda":
        return dict(fields), None
    host = {}
    for k, v in fields.items():
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host[k].copy_(v, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


class HistogramAggregator:
    """Per-variable dynamic histograms of the prediction (and the target,
    when given) with tail percentiles and, with targets, the
    ``prediction_frac_of_target`` ratios. ``host_seconds`` sums the host's
    time filling them, once the copies have arrived."""

    def __init__(self, n_bins: int = 300,
                 percentiles: list[float] | None = None,
                 two_tailed_variables: list[str] | None = None,
                 left_tailed_variables: list[str] | None = None,
                 default_tail: str = "upper"):
        self._hists: dict[str, DynamicHistogram] = {}
        self._target_hists: dict[str, DynamicHistogram] = {}
        self._n_bins = n_bins
        self._percentiles = percentiles or [99.9999]
        self._two_tailed = set(two_tailed_variables or [])
        self._left_tailed = set(left_tailed_variables or [])
        self._default_tail = default_tail
        # the window whose host copies are under way
        self._pending = None
        self.host_seconds = 0.0

    def record_batch(self, gen: TensorMapping, target=None):
        paired = {k: v for k, v in (target or {}).items() if k in gen}
        copies = _start_host_copy({**{("gen", k): v for k, v in gen.items()},
                                   **{("target", k): v
                                      for k, v in paired.items()}})
        self._fill()
        self._pending = copies

    def _fill(self):
        """Fill the histograms from the pending window's host copies."""
        if self._pending is None:
            return
        host, event = self._pending
        self._pending = None
        if event is not None:
            event.synchronize()
        t0 = time.perf_counter()
        for (kind, name), value in host.items():
            hists = self._hists if kind == "gen" else self._target_hists
            if name not in hists:
                hists[name] = DynamicHistogram(self._n_bins)
            hists[name].add(value.numpy())
        self.host_seconds += time.perf_counter() - t0

    def _tail_percentiles(self, name: str) -> list[float]:
        if name in self._two_tailed:
            tails = ("upper", "lower")
        elif name in self._left_tailed:
            tails = ("lower",)
        else:
            tails = ((self._default_tail,) if self._default_tail != "both"
                     else ("upper", "lower"))
        qs = []
        for q in self._percentiles:
            if "upper" in tails:
                qs.append(q)
            if "lower" in tails:
                qs.append(100.0 - q)
        return qs

    def get_logs(self, label: str = "histogram") -> dict[str, float]:
        self._fill()
        logs = {}
        for name, hist in self._hists.items():
            for q in self._tail_percentiles(name):
                key = f"{label}/{q:g}th-percentile/{name}"
                logs[key] = hist.percentile(q)
                tgt = self._target_hists.get(name)
                if tgt is not None:
                    tval = tgt.percentile(q)
                    logs[f"{label}/prediction_frac_of_target/"
                         f"{q:g}th-percentile/{name}"] = (
                        logs[key] / tval if tval != 0 else float("nan"))
        return logs

    def get_diagnostics(self) -> dict[str, np.ndarray]:
        self._fill()
        out = {}
        for name, hist in self._hists.items():
            if hist.bin_edges is not None:
                out[f"counts-{name}"] = hist.counts
                out[f"bin_edges-{name}"] = hist.bin_edges
        for name, hist in self._target_hists.items():
            if hist.bin_edges is not None:
                out[f"target_counts-{name}"] = hist.counts
                out[f"target_bin_edges-{name}"] = hist.bin_edges
        return out


class GlobalMeanAnnualAggregator:
    """Area-weighted global means by calendar year. Years with fewer than
    ~350 days of samples are left out of the logged means; paired targets
    give an annual RMSE, and a monthly reference an R2. A window's global
    means stay on the device until they are read."""

    MIN_COMPLETE_YEAR_DAYS = 350.0

    def __init__(self, ops: GriddedOperations,
                 timestep_seconds: float | None = None,
                 monthly_reference: "dict[str, dict[int, float]] | None"
                 = None):
        self._ops = ops
        self._timestep_seconds = timestep_seconds
        self._sums: dict[str, dict[int, float]] = {}
        self._counts: dict[str, dict[int, int]] = {}
        self._target_sums: dict[str, dict[int, float]] = {}
        # per window: the years (host) and the [batch, time] global means
        # (device), bucketed by year when read
        self._pending: list = []
        self._reference = monthly_reference or {}

    def record_batch(self, gen: TensorMapping, time: TimeCoord, target=None):
        years = time.components()["year"]  # [batch, n_time]
        if self._timestep_seconds is None and time.values.shape[-1] > 1:
            self._timestep_seconds = float(
                (time.values[..., 1] - time.values[..., 0]).ravel()[0] / 1e6)
        self._pending.append({
            "years": np.asarray(years),
            "gen": {k: self._ops.area_weighted_mean(v, name=k)
                    for k, v in gen.items()},
            "target": {k: self._ops.area_weighted_mean(v, name=k)
                       for k, v in (target or {}).items() if k in gen},
        })

    def _drain(self):
        for window in self._pending:
            years = window["years"]
            for name, gm in window["gen"].items():
                gm = gm.cpu().numpy()
                sums = self._sums.setdefault(name, {})
                counts = self._counts.setdefault(name, {})
                for year in np.unique(years):
                    mask = years == year
                    sums[int(year)] = sums.get(int(year), 0.0) + float(
                        gm[mask].sum())
                    counts[int(year)] = counts.get(int(year), 0) + int(
                        mask.sum())
            for name, gm in window["target"].items():
                gm = gm.cpu().numpy()
                tsums = self._target_sums.setdefault(name, {})
                for year in np.unique(years):
                    mask = years == year
                    tsums[int(year)] = tsums.get(int(year), 0.0) + float(
                        gm[mask].sum())
        self._pending = []

    def _complete_years(self, name: str) -> list[int]:
        min_samples = (0.0 if not self._timestep_seconds else
                       self.MIN_COMPLETE_YEAR_DAYS * 86400.0
                       / self._timestep_seconds)
        return sorted(y for y, c in self._counts[name].items()
                      if c > min_samples)

    def get_diagnostics(self) -> dict[str, np.ndarray]:
        self._drain()
        out = {}
        for name, sums in self._sums.items():
            years = sorted(sums)
            out[f"annual_mean-{name}"] = np.asarray(
                [sums[y] / self._counts[name][y] for y in years])
            out[f"annual_mean_years-{name}"] = np.asarray(years)
            if name in self._target_sums:
                tsums = self._target_sums[name]
                out[f"annual_mean_target-{name}"] = np.asarray([
                    tsums.get(y, np.nan) / self._counts[name][y]
                    for y in years])
        return out

    def get_logs(self, label: str = "annual") -> dict[str, float]:
        self._drain()
        logs = {}
        for name, sums in self._sums.items():
            years = self._complete_years(name)
            if not years:
                continue
            counts = self._counts[name]
            logs[f"{label}/mean/{name}"] = float(
                np.mean([sums[y] / counts[y] for y in years]))
            tsums = self._target_sums.get(name)
            if tsums:
                paired = [y for y in years if y in tsums]
                if paired:
                    diffs = [(sums[y] - tsums[y]) / counts[y] for y in paired]
                    logs[f"{label}/rmse/{name}"] = float(
                        np.sqrt(np.mean(np.square(diffs))))
            ref = self._reference.get(name)
            if ref:
                r2 = _get_r2({y: sums[y] / counts[y] for y in years}, ref)
                if r2 is not None:
                    logs[f"{label}/r2/{name}_gen"] = r2
                if tsums:
                    r2_t = _get_r2({y: tsums[y] / counts[y] for y in years
                                    if y in tsums}, ref)
                    if r2_t is not None:
                        logs[f"{label}/r2/{name}_target"] = r2_t
        return logs


def _get_r2(series: dict[int, float],
            reference: dict[int, float]) -> float | None:
    """R2 of an annual series against the reference over shared years."""
    years = sorted(set(series) & set(reference))
    if len(years) < 2:
        return None
    pred = np.asarray([series[y] for y in years], dtype=np.float64)
    ref = np.asarray([reference[y] for y in years], dtype=np.float64)
    ss_ref = np.sum((ref - ref.mean()) ** 2)
    if ss_ref == 0.0:
        return None
    return float(1.0 - np.sum((ref - pred) ** 2) / ss_ref)
