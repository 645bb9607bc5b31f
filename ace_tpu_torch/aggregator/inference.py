"""Streaming inference aggregators (port of ace_tpu/aggregator/inference.py:
time-mean maps, per-step mean series, ensemble spread and skill, global
mean series, zonal means, spherical power spectra, and the multiplexer
that adds the histograms, annual means, ENSO index, seasonal means,
near-zero fractions, videos and trends of the modules beside it).

Aggregators take paired (prediction, target) windows and keep running
reductions on the device of the data. ``record_batch`` never waits for the
device: it queues eager torch operations on running sums (where the JAX
package dispatches one jitted program per window), and nothing leaves the
device until ``get_logs`` or ``get_diagnostics``, which fetch what they
report in few transfers. So the windowed inference loop can queue window
N+1's rollout behind window N's reductions. Two exceptions: the histograms
fill on the host one window behind, from copies that do not block
(``histogram.py``), and the video's partials are drained by bytes
(``video.py``).
"""

import dataclasses
import functools
import logging
from typing import Any

import numpy as np
import torch

from ace_tpu_torch.aggregator.enso import EnsoIndexAggregator
from ace_tpu_torch.aggregator.histogram import (
    GlobalMeanAnnualAggregator,
    HistogramAggregator,
)
from ace_tpu_torch.aggregator.seasonal import (
    NearZeroFractionAggregator,
    SeasonalAggregator,
)
from ace_tpu_torch.aggregator.trend import TrendAggregator
from ace_tpu_torch.aggregator.video import VideoAggregator
from ace_tpu_torch.core.gridded_ops import GriddedOperations
from ace_tpu_torch.core.loss import get_crps
from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping
from ace_tpu_torch.ops.sht import RealSHT

_COORD_NAMES = ("lat", "lon", "latitude", "longitude", "time", "valid_time",
                "counts", "init_time")


def _fetch(values: dict[str, torch.Tensor]) -> dict[str, float]:
    """Python floats of 0-d tensors, fetched from the device at once."""
    if not values:
        return {}
    stacked = torch.stack([v.double() for v in values.values()]).cpu()
    return dict(zip(values, stacked.tolist()))


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def load_time_mean_reference(path: str) -> dict[str, np.ndarray]:
    """A time-mean reference netCDF as per-variable ``[lat, lon]`` maps
    (port of ace_tpu/aggregator/inference.py:45); leading dims are
    averaged out."""
    from ace_tpu_torch.data.store import open_file_dataset

    ds = open_file_dataset(path)
    out = {}
    for name in ds.keys():
        if name in _COORD_NAMES:
            continue
        arr = np.asarray(ds[name].read(()), dtype=np.float32)
        while arr.ndim > 2:
            arr = arr.mean(axis=0)
        if arr.ndim == 2:
            out[name] = arr
    return out


def load_monthly_reference(path: str, ops: GriddedOperations
                           ) -> dict[str, dict[int, float]]:
    """A monthly-means reference netCDF (``[sample, month, lat, lon]``
    variables, ``counts`` and ``valid_time``) as per-variable ``{year:
    annual global mean}``, sample-averaged (port of
    ace_tpu/aggregator/inference.py:71)."""
    from ace_tpu_torch.data.store import open_file_dataset

    ds = open_file_dataset(path)
    years = ds.read_time("valid_time").components()["year"]
    counts = np.asarray(ds["counts"].read(()), dtype=np.float64)
    if years.ndim == 1:
        years = years[None]
    if counts.ndim == 1:
        counts = np.broadcast_to(counts[None], years.shape)
    out: dict[str, dict[int, float]] = {}
    for name in ds.keys():
        if name in _COORD_NAMES:
            continue
        arr = np.asarray(ds[name].read(()), dtype=np.float32)
        if arr.ndim < 3:
            continue
        if arr.ndim == 3:
            arr = arr[None]
        gm = _numpy(ops.area_weighted_mean(torch.from_numpy(arr), name=name))
        per_year: dict[int, float] = {}
        for year in np.unique(years):
            mask = years == year
            num = np.sum(gm * counts * mask, axis=1)
            den = np.sum(counts * mask, axis=1)
            valid = den > 0
            if valid.any():
                per_year[int(year)] = float(np.mean(num[valid] / den[valid]))
        out[name] = per_year
    return out


class TimeMeanAggregator:
    """Running time-mean maps of prediction and target; the bias and RMSE
    of the time mean, and against an offline reference time mean when one
    is given (port of ace_tpu/aggregator/inference.py:125)."""

    def __init__(self, ops: GriddedOperations,
                 reference_means: dict[str, np.ndarray] | None = None):
        self._ops = ops
        self._gen_sum: TensorDict = {}
        self._target_sum: TensorDict = {}
        self._reference_means = reference_means or {}
        self._n = 0

    def record_batch(self, gen: TensorMapping, target: TensorMapping | None):
        self._n += next(iter(gen.values())).shape[1]
        for k, v in gen.items():
            s = v.sum(dim=1)
            self._gen_sum[k] = self._gen_sum[k] + s if k in self._gen_sum else s
        for k, v in (target or {}).items():
            if k in gen:
                s = v.sum(dim=1)
                self._target_sum[k] = (self._target_sum[k] + s
                                       if k in self._target_sum else s)

    def _gen_mean(self, k):
        return (self._gen_sum[k] / self._n).mean(dim=0)

    def get_logs(self, label: str = "time_mean") -> dict[str, float]:
        logs = {}
        for k in self._gen_sum:
            # the RMSE of the sample-mean time-mean maps, as the JAX
            # package and the reference take it
            gen_mean = self._gen_mean(k)[None]
            if k in self._target_sum:
                target_mean = (self._target_sum[k] / self._n).mean(dim=0)[None]
                logs[f"{label}/rmse/{k}"] = self._ops.area_weighted_rmse(
                    target_mean, gen_mean, name=k).mean()
                logs[f"{label}/bias/{k}"] = self._ops.area_weighted_mean_bias(
                    target_mean, gen_mean, name=k).mean()
            if k in self._reference_means:
                ref = torch.as_tensor(self._reference_means[k],
                                      device=gen_mean.device)[None]
                logs[f"{label}/ref_rmse/{k}"] = self._ops.area_weighted_rmse(
                    ref, gen_mean, name=k).mean()
                logs[f"{label}/ref_bias/{k}"] = (
                    self._ops.area_weighted_mean_bias(ref, gen_mean, name=k)
                    .mean())
        return _fetch(logs)

    def get_diagnostics(self) -> dict[str, np.ndarray]:
        out = {}
        for k in self._gen_sum:
            gen_mean = _numpy(self._gen_mean(k))
            out[f"gen_map-{k}"] = gen_mean
            if k in self._target_sum:
                out[f"bias_map-{k}"] = _numpy(
                    ((self._gen_sum[k] - self._target_sum[k]) / self._n)
                    .mean(dim=0))
            if k in self._reference_means:
                out[f"ref_bias_map-{k}"] = gen_mean - self._reference_means[k]
        return out


@dataclasses.dataclass
class StepMeanEntry:
    """Log per-variable mean metrics at one rollout step (port of
    ace_tpu/aggregator/inference.py:218)."""

    step: int
    name: str | None = None

    def get_name(self) -> str:
        return self.name or f"mean_step_{self.step}"


class StepMeanSeriesAggregator:
    """Per-forward-step series of area-weighted RMSE, bias and global mean
    over the rollout, with selected steps logged as scalars (port of
    ace_tpu/aggregator/inference.py:231). With a normalizer, the metrics
    are taken on normalized fields. The series are float64 tensors on the
    data's device; the counts depend on shapes only and stay on the
    host."""

    def __init__(self, ops: GriddedOperations, n_timesteps: int,
                 entries: "list[StepMeanEntry] | None" = None,
                 normalizer=None):
        self._ops = ops
        self._n_timesteps = n_timesteps
        self._entries = [e for e in (entries or []) if e.step <= n_timesteps]
        for e in entries or []:
            if e.step > n_timesteps:
                logging.warning(
                    "log_step_means entry step=%d exceeds "
                    "n_forward_steps=%d; skipping it", e.step, n_timesteps
                )
        self._normalizer = normalizer
        self._series: dict[str, dict[str, torch.Tensor]] = {
            "gen_mean": {}, "rmse": {}, "bias": {}}
        self._counts: dict[str, np.ndarray] = {}

    def _add(self, metric: str, name: str, sl: slice, value: torch.Tensor):
        store = self._series[metric]
        if name not in store:
            store[name] = torch.zeros(self._n_timesteps, dtype=torch.float64,
                                      device=value.device)
        store[name][sl] += value

    def record_batch(self, gen: TensorMapping,
                     target: TensorMapping | None, i_time_start: int):
        if self._normalizer is not None:
            # only variables with statistics belong in a normalized series
            names = self._normalizer.names
            gen = self._normalizer.normalize(
                {k: v for k, v in gen.items() if k in names})
            if target is not None:
                target = self._normalizer.normalize(
                    {k: v for k, v in target.items() if k in names})
        for k, v in gen.items():
            n_time = v.shape[1]
            sl = slice(i_time_start, i_time_start + n_time)
            self._add("gen_mean", k, sl,
                      self._ops.area_weighted_mean(v, name=k).mean(dim=0))
            if k not in self._counts:
                self._counts[k] = np.zeros(self._n_timesteps, np.float64)
            self._counts[k][sl] += 1
            if target is not None and k in target:
                t = target[k]
                self._add("rmse", k, sl, self._ops.area_weighted_rmse(
                    t, v, name=k).mean(dim=0))
                self._add("bias", k, sl, self._ops.area_weighted_mean_bias(
                    t, v, name=k).mean(dim=0))

    def get_logs(self, label: str = "mean_step") -> dict[str, float]:
        logs: dict[str, torch.Tensor] = {}
        for entry in self._entries:
            idx = entry.step - 1
            name = entry.get_name()
            for k, counts in self._counts.items():
                if counts[idx] == 0:
                    continue
                n = counts[idx]
                logs[f"{name}/weighted_mean_gen/{k}"] = (
                    self._series["gen_mean"][k][idx] / n)
                if k in self._series["rmse"]:
                    logs[f"{name}/weighted_rmse/{k}"] = (
                        self._series["rmse"][k][idx] / n)
                    logs[f"{name}/weighted_bias/{k}"] = (
                        self._series["bias"][k][idx] / n)
        return _fetch(logs)

    def get_diagnostics(self) -> dict[str, np.ndarray]:
        out = {}
        for k, counts in self._counts.items():
            n = np.where(counts == 0, 1, counts)
            out[f"weighted_mean_gen_series-{k}"] = (
                _numpy(self._series["gen_mean"][k]) / n)
            if k in self._series["rmse"]:
                out[f"weighted_rmse_series-{k}"] = (
                    _numpy(self._series["rmse"][k]) / n)
                out[f"weighted_bias_series-{k}"] = (
                    _numpy(self._series["bias"][k]) / n)
        return out


class InferenceEnsembleAggregator:
    """Ensemble spread, skill and CRPS over the rollout when inference runs
    several members per initial condition (port of
    ace_tpu/aggregator/inference.py:354). Batches arrive member-major:
    the members of one initial condition are contiguous."""

    def __init__(self, ops: GriddedOperations, n_ensemble: int):
        self._ops = ops
        self._n_ens = n_ensemble
        self._sums: dict[str, dict[str, torch.Tensor]] = {
            "crps": {}, "spread_sq": {}, "skill_sq": {}}
        self._n: dict[str, int] = {}

    def _add(self, metric: str, name: str, value: torch.Tensor):
        store = self._sums[metric]
        value = value.double()
        store[name] = store[name] + value if name in store else value

    def record_batch(self, gen: TensorMapping,
                     target: TensorMapping | None):
        e = self._n_ens
        for k, v in gen.items():
            if v.shape[0] % e:
                continue
            b, n_time = v.shape[0] // e, v.shape[1]
            g = v.reshape(b, e, *v.shape[1:])
            spread_sq = self._ops.area_weighted_mean(
                g.var(dim=1, correction=1), name=k).mean()
            self._add("spread_sq", k, spread_sq * n_time)
            self._n[k] = self._n.get(k, 0) + n_time
            if target is not None and k in target:
                t = target[k].reshape(b, e, *target[k].shape[1:])[:, 0]
                crps = self._ops.area_weighted_mean(
                    get_crps(g, t[:, None], alpha=0.95), name=k).mean()
                err = g.mean(dim=1) - t
                mse = self._ops.area_weighted_mean(err * err, name=k).mean()
                self._add("crps", k, crps * n_time)
                # the MSE of the ensemble mean, less its unbiased share of
                # the spread
                self._add("skill_sq", k, torch.clamp(
                    mse.double() - spread_sq.double() / e, min=0.0) * n_time)

    def get_logs(self, label: str = "ensemble") -> dict[str, float]:
        sums = {f"{metric}/{k}": v for metric, store in self._sums.items()
                for k, v in store.items()}
        sums = _fetch(sums)
        logs: dict[str, float] = {}
        for k, n in self._n.items():
            spread = float(np.sqrt(sums[f"spread_sq/{k}"] / n))
            logs[f"{label}/spread/{k}"] = spread
            if f"crps/{k}" in sums:
                logs[f"{label}/crps/{k}"] = sums[f"crps/{k}"] / n
                skill = float(np.sqrt(sums[f"skill_sq/{k}"] / n))
                logs[f"{label}/rmse_of_ensemble_mean/{k}"] = skill
                if skill > 0:
                    logs[f"{label}/spread_skill_ratio/{k}"] = spread / skill
        return logs


class GlobalMeanTimeSeriesAggregator:
    """Area-weighted global-mean series of every variable (port of
    ace_tpu/aggregator/inference.py:456); one ``[time]`` chunk per window
    stays on the device until it is read."""

    def __init__(self, ops: GriddedOperations):
        self._ops = ops
        self._gen: dict[str, list] = {}
        self._target: dict[str, list] = {}

    def record_batch(self, gen: TensorMapping, target: TensorMapping | None):
        for k, v in gen.items():
            self._gen.setdefault(k, []).append(
                self._ops.area_weighted_mean(v, name=k).mean(dim=0))
        for k, v in (target or {}).items():
            if k in gen:
                self._target.setdefault(k, []).append(
                    self._ops.area_weighted_mean(v, name=k).mean(dim=0))

    @staticmethod
    def _series(chunks: dict[str, list]) -> dict[str, np.ndarray]:
        return {k: _numpy(torch.cat(c)) for k, c in chunks.items()}

    def get_logs(self, label: str = "mean") -> dict[str, float]:
        gen, target = self._series(self._gen), self._series(self._target)
        logs = {}
        for k, series in gen.items():
            logs[f"{label}/final/{k}"] = float(series[-1])
            if k in target:
                logs[f"{label}/series_rmse/{k}"] = float(
                    np.sqrt(np.mean((series - target[k]) ** 2)))
        return logs

    def get_diagnostics(self) -> dict[str, np.ndarray]:
        out = {f"gen_series-{k}": v for k, v in self._series(self._gen).items()}
        out.update({f"target_series-{k}": v
                    for k, v in self._series(self._target).items()})
        return out


class ZonalMeanAggregator:
    """Zonal-mean (Hovmoller) fields over latitude and time, batch
    averaged, for prediction and target (port of
    ace_tpu/aggregator/inference.py:517)."""

    def __init__(self):
        self._gen: dict[str, list] = {}
        self._target: dict[str, list] = {}
        self._n = 0

    def record_batch(self, gen: TensorMapping, target=None):
        self._n += next(iter(gen.values())).shape[1]
        # mean over lon, then over the batch: [time, lat]
        for k, v in gen.items():
            self._gen.setdefault(k, []).append(v.mean(dim=-1).mean(dim=0))
        for k, v in (target or {}).items():
            if k in gen:
                self._target.setdefault(k, []).append(
                    v.mean(dim=-1).mean(dim=0))

    def get_diagnostics(self) -> dict[str, np.ndarray]:
        out = {}
        for k, chunks in self._gen.items():
            hov = _numpy(torch.cat(chunks, dim=0))  # [time, lat]
            out[f"gen_hovmoller-{k}"] = hov.T
            out[f"zonal_mean-{k}"] = hov.mean(axis=0)
            if k in self._target:
                thov = _numpy(torch.cat(self._target[k], dim=0))
                out[f"error_hovmoller-{k}"] = (hov - thov).T
        return out


class SpectrumAggregator:
    """Mean spherical power spectrum over time (port of
    ace_tpu/aggregator/inference.py:567).

    A window's variables go through one transform together, as the
    channels of the port's channels-last ``RealSHT``, after one flood fill
    of all of them (``SmoothFloodFill.fill_stacked``). On HEALPix the
    transform is the grid's (``HEALPixOperations.get_real_sht``), with no
    flood fill (it is lat-lon only), as in the JAX package."""

    def __init__(self, make_sht, spatial_rank: int = 2, nan_fill=None):
        # ``make_sht()`` makes the transform's tables on the host; they are
        # copied without waiting for the device: the first window must not
        # synchronize
        self._make_sht, self._spatial_rank = make_sht, spatial_rank
        self._nan_fill = nan_fill
        self._sht = None
        self._gen_sum: TensorDict = {}
        self._target_sum: TensorDict = {}
        self._n = 0

    @classmethod
    def for_dataset_info(cls, dataset_info) -> "SpectrumAggregator":
        img = dataset_info.img_shape
        if len(img) == 2:
            from ace_tpu_torch.core.fill import SmoothFloodFill

            return cls(functools.partial(
                RealSHT, *img, grid=dataset_info.horizontal_coordinates.grid,
                device="cpu"), 2, SmoothFloodFill(num_steps=4))
        return cls(functools.partial(
            dataset_info.gridded_operations.get_real_sht, device="cpu"), 3)

    def _power_sums(self, data: TensorMapping, prefix: str
                    ) -> dict[str, torch.Tensor]:
        """Per-degree power of each variable, summed over the leading
        (batch, time) axes. The reference sums raw ``|c|^2`` over m with no
        Hermitian doubling."""
        names = list(data)
        x = torch.stack([data[k] for k in names])  # [V, ..., *spatial]
        if self._nan_fill is not None:
            x = self._nan_fill.fill_stacked(x, [prefix + k for k in names])
        if self._sht is None or next(self._sht.buffers()).device != x.device:
            self._sht = self._make_sht().to(x.device, non_blocking=True)
        cr, ci = self._sht.forward_pair(x.movedim(0, -1))  # [..., L, M, V]
        power = (cr * cr + ci * ci).sum(dim=-2)  # [..., L, V]
        power = power.reshape(-1, *power.shape[-2:]).sum(dim=0)
        return dict(zip(names, power.unbind(dim=-1)))

    def record_batch(self, gen: TensorMapping, target: TensorMapping | None):
        first = next(iter(gen.values()))
        self._n += int(np.prod(first.shape[:-self._spatial_rank]))
        for k, p in self._power_sums(gen, "").items():
            self._gen_sum[k] = self._gen_sum[k] + p if k in self._gen_sum else p
        paired = {k: v for k, v in (target or {}).items() if k in gen}
        if paired:
            for k, p in self._power_sums(paired, "target/").items():
                self._target_sum[k] = (self._target_sum[k] + p
                                       if k in self._target_sum else p)

    def get_logs(self, label: str = "spectrum") -> dict[str, float]:
        logs = {}
        for k in self._gen_sum:
            if k not in self._target_sum:
                continue
            gen_s = _numpy(self._gen_sum[k] / self._n)
            tgt_s = _numpy(self._target_sum[k] / self._n)
            # log-space mean absolute error over the resolved wavenumbers
            eps = 1e-20
            logs[f"{label}/log_error/{k}"] = float(np.mean(np.abs(
                np.log(gen_s[1:] + eps) - np.log(tgt_s[1:] + eps))))
            ratio = gen_s / np.where(tgt_s == 0.0, np.nan, tgt_s) - 1.0
            n_modes = ratio.shape[0]
            pos = float(np.nansum(np.where(ratio > 0, ratio, 0.0)) / n_modes)
            neg = float(np.nansum(np.where(ratio < 0, ratio, 0.0)) / n_modes)
            logs[f"{label}/positive_norm_bias/{k}"] = pos
            logs[f"{label}/negative_norm_bias/{k}"] = neg
            logs[f"{label}/mean_abs_norm_bias/{k}"] = abs(pos) + abs(neg)
            logs[f"{label}/smallest_scale_norm_bias/{k}"] = (
                float(ratio[-1]) if np.isfinite(ratio[-1]) else 0.0)
        return logs

    def get_diagnostics(self) -> dict[str, np.ndarray]:
        out = {f"gen_power-{k}": _numpy(v / self._n)
               for k, v in self._gen_sum.items()}
        out.update({f"target_power-{k}": _numpy(v / self._n)
                    for k, v in self._target_sum.items()})
        return out


@dataclasses.dataclass
class InferenceAggregatorConfig:
    """Which aggregators an inference run keeps (port of
    ace_tpu/aggregator/inference.py:705)."""

    log_global_mean_time_series: bool = True
    log_zonal_mean_images: bool = True
    log_spectra: bool = True
    log_histograms: bool = False
    log_annual_means: bool = True
    monthly_reference_data: str | None = None
    time_mean_reference_data: str | None = None
    log_enso_index: bool = False
    enso_sst_name: str = "surface_temperature"
    log_seasonal_means: bool = False
    log_near_zero_fraction: bool = False
    log_step_means: list[StepMeanEntry] = dataclasses.field(
        default_factory=lambda: [StepMeanEntry(step=20)]
    )
    log_global_mean_norm_time_series: bool = True
    log_video: bool = False
    log_extended_video: bool = False
    log_trends: bool = False

    def build(self, dataset_info, n_timesteps: int,
              normalizer=None, n_ensemble_per_ic: int = 1,
              ) -> "InferenceEvaluatorAggregator":
        return InferenceEvaluatorAggregator(
            dataset_info=dataset_info,
            config=self,
            n_timesteps=n_timesteps,
            normalizer=normalizer,
            n_ensemble_per_ic=n_ensemble_per_ic,
        )


class InferenceEvaluatorAggregator:
    """Multiplexes the inference aggregators (port of
    ace_tpu/aggregator/inference.py:752)."""

    def __init__(self, dataset_info, config=None, n_timesteps: int = 0,
                 normalizer=None, n_ensemble_per_ic: int = 1):
        config = config or InferenceAggregatorConfig()
        ops = dataset_info.gridded_operations
        is_latlon = len(dataset_info.img_shape) == 2
        time_mean_ref = (
            load_time_mean_reference(config.time_mean_reference_data)
            if config.time_mean_reference_data is not None else None
        )
        self._aggregators: dict[str, Any] = {
            "time_mean": TimeMeanAggregator(ops,
                                            reference_means=time_mean_ref),
        }
        if config.log_global_mean_time_series:
            self._aggregators["mean"] = GlobalMeanTimeSeriesAggregator(ops)
        self._step_mean = None
        if config.log_step_means and n_timesteps:
            self._step_mean = StepMeanSeriesAggregator(
                ops, n_timesteps, entries=list(config.log_step_means))
        if n_ensemble_per_ic > 1:
            self._aggregators["ensemble"] = InferenceEnsembleAggregator(
                ops, n_ensemble_per_ic)
        self._mean_norm = None
        if (config.log_global_mean_norm_time_series
                and normalizer is not None and n_timesteps):
            self._mean_norm = StepMeanSeriesAggregator(
                ops, n_timesteps, entries=[], normalizer=normalizer)
        if config.log_zonal_mean_images and is_latlon:
            self._aggregators["zonal_mean"] = ZonalMeanAggregator()
        if config.log_spectra:
            self._aggregators["spectrum"] = (
                SpectrumAggregator.for_dataset_info(dataset_info))
        if config.log_histograms:
            self._aggregators["histogram"] = HistogramAggregator()
        if config.log_enso_index:
            self._aggregators["enso"] = EnsoIndexAggregator(
                dataset_info.horizontal_coordinates,
                sst_name=config.enso_sst_name)
        if config.log_near_zero_fraction:
            self._aggregators["near_zero_fraction"] = (
                NearZeroFractionAggregator())
        self._trend = TrendAggregator() if config.log_trends else None
        self._seasonal = (SeasonalAggregator() if config.log_seasonal_means
                          else None)
        if (config.log_video or config.log_extended_video) and n_timesteps:
            self._aggregators["video"] = VideoAggregator(
                n_timesteps, enable_extended_videos=config.log_extended_video)
        self._annual = None
        if config.log_annual_means:
            monthly_ref = (
                load_monthly_reference(config.monthly_reference_data, ops)
                if config.monthly_reference_data is not None else None
            )
            self._annual = GlobalMeanAnnualAggregator(
                ops, monthly_reference=monthly_ref)
        self._n_steps = 0

    def record_batch(self, gen: TensorMapping,
                     target: TensorMapping | None = None, time=None):
        n_time = next(iter(gen.values())).shape[1]
        self._n_steps += n_time
        for name, agg in self._aggregators.items():
            if name == "enso":
                # the index takes its monthly climatology by the times
                agg.record_batch(gen, target, time=time)
            else:
                agg.record_batch(gen, target)
        if time is not None:
            for agg in (self._annual, self._seasonal, self._trend):
                if agg is not None:
                    agg.record_batch(gen, time, target)
        i_start = self._n_steps - n_time
        if self._step_mean is not None:
            self._step_mean.record_batch(gen, target, i_start)
        if self._mean_norm is not None:
            self._mean_norm.record_batch(gen, target, i_start)

    def get_logs(self) -> dict[str, float]:
        logs: dict[str, float] = {"n_forward_steps": self._n_steps}
        for label, agg in self._aggregators.items():
            if hasattr(agg, "get_logs"):
                logs.update(agg.get_logs(label))
        for label, agg in (("annual", self._annual),
                           ("seasonal", self._seasonal),
                           ("trend", self._trend)):
            if agg is not None:
                logs.update(agg.get_logs(label))
        if self._step_mean is not None:
            logs.update(self._step_mean.get_logs())
        return logs

    @property
    def histogram_host_seconds(self) -> float:
        """The host's seconds filling the histograms (0 without them)."""
        hist = self._aggregators.get("histogram")
        return hist.host_seconds if hist is not None else 0.0

    def _with_diagnostics(self, extra: bool) -> dict[str, Any]:
        items = dict(self._aggregators)
        for label, agg in (("annual", self._annual),
                           ("trend", self._trend),
                           ("seasonal", self._seasonal)):
            if agg is not None:
                items[label] = agg
        if extra:
            if self._step_mean is not None:
                items["mean_step"] = self._step_mean
            if self._mean_norm is not None:
                items["mean_norm"] = self._mean_norm
        return {k: v for k, v in items.items()
                if hasattr(v, "get_diagnostics")}

    def get_diagnostics(self) -> dict[str, dict[str, np.ndarray]]:
        """Every aggregator's diagnostics, by label, as host arrays."""
        return {label: agg.get_diagnostics()
                for label, agg in self._with_diagnostics(True).items()}

    def flush_diagnostics(self, output_dir: str):
        """Write each aggregator's diagnostics to
        ``<output_dir>/<label>_diagnostics.nc``."""
        import os

        from ace_tpu_torch.data.store import write_h5

        os.makedirs(output_dir, exist_ok=True)
        for label, diags in self.get_diagnostics().items():
            if not diags:
                continue
            dims = {k: tuple(f"dim{i}" for i in range(np.ndim(v)))
                    for k, v in diags.items()}
            write_h5(
                os.path.join(output_dir, f"{label}_diagnostics.nc"),
                {k: np.asarray(v) for k, v in diags.items()},
                dims,
            )

    def flush_images(self, output_dir: str):
        """Render the diagnostic maps to PNG files and the videos to GIF
        files (port of ace_tpu/aggregator/inference.py:906, without the
        Weights & Biases mirror). A map that fails to render is logged and
        skipped."""
        import os

        from ace_tpu_torch.aggregator import plotting

        os.makedirs(output_dir, exist_ok=True)
        for label, agg in self._with_diagnostics(False).items():
            for key, arr in agg.get_diagnostics().items():
                arr = np.asarray(arr)
                safe = f"{label}.{key}".replace("/", "_")
                diverging = any(
                    t in key for t in ("bias", "err", "anomaly", "trend"))
                try:
                    if key.startswith("video-"):
                        plotting.save_video_gif(
                            os.path.join(output_dir, safe + ".gif"), arr,
                            diverging=diverging)
                    elif arr.ndim == 2 or (arr.ndim == 3
                                           and arr.shape[0] == 12):
                        vmin, vmax = plotting.get_cmap_limits(arr, diverging)
                        # the lon roll is for maps only: Hovmoller and
                        # series arrays have time on the last axis
                        is_map = not any(
                            t in key for t in
                            ("hovmoller", "series", "index", "spectrum"))
                        fig = plotting.plot_imshow(
                            arr, vmin=vmin, vmax=vmax,
                            cmap="RdBu_r" if diverging else None,
                            roll_lon=is_map,
                        )
                        plotting.save_figure(
                            fig, os.path.join(output_dir, safe + ".png"))
                except Exception:  # rendering must never fail a run
                    logging.exception("failed to render %s", safe)
