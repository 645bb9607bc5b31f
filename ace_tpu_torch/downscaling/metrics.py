"""Downscaling generation-quality metrics (port of
ace_tpu/downscaling/metrics.py): CRPS, MAE, PSNR, SSIM, the zonal power
spectrum, the rank histogram, the bicubic baseline, and the streaming
``GenerationMetricsAggregator``.

All functions take torch tensors. SSIM's sliding window is a valid
depthwise ``F.conv2d``; the bicubic baseline is ``jax.image.resize``'s
(``resize.py``), not ``F.interpolate``'s. The aggregator keeps its sums on
the device and reads them once, at ``get_logs`` or ``get_diagnostics``.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ace_tpu_torch.downscaling.resize import resize

_EPS = 1e-8


def min_max_normalization(x, min_, max_):
    """Normalize to [0, 1]; a constant input gives 0.5."""
    return torch.where(min_ == max_, torch.full_like(x, 0.5),
                       (x - min_) / (max_ - min_))


def _normalize_pair(x, y):
    # both tensors normalized by their joint min and max
    min_ = torch.minimum(x.min(), y.min())
    max_ = torch.maximum(x.max(), y.max())
    return (min_max_normalization(x, min_, max_),
            min_max_normalization(y, min_, max_))


def get_sample_mae_estimate(prediction, sample_dim: int = 1):
    """E|X - X'| over all cyclic sample pairings."""
    n_samples = prediction.shape[sample_dim]
    if n_samples == 1:
        shape = list(prediction.shape)
        shape.pop(sample_dim)
        return torch.full(shape, float("nan"), dtype=prediction.dtype,
                          device=prediction.device)
    est = 0.0
    for i in range(1, n_samples):
        est = est + (prediction - torch.roll(prediction, shifts=i,
                                             dims=sample_dim)
                     ).abs().mean(dim=sample_dim)
    return est / (n_samples - 1)


def compute_crps(target, prediction, sample_dim: int = 1):
    """CRPS(F, x) = E|X - x| - 1/2 E|X - X'|; ``target`` has no sample
    axis."""
    target = target.unsqueeze(sample_dim)
    truth_mae = (target - prediction).abs().mean(dim=sample_dim)
    return truth_mae - 0.5 * get_sample_mae_estimate(prediction, sample_dim)


def compute_mae_error(target, prediction, sample_dim: int = 1):
    """E|X - x| - E|X - X'|: zero for a sharp, centred forecast."""
    target = target.unsqueeze(sample_dim)
    truth_mae = (target - prediction).abs().mean(dim=sample_dim)
    return truth_mae - get_sample_mae_estimate(prediction, sample_dim)


def psnr(x, y, data_range: float = 1.0):
    """Peak signal-to-noise over ``[N, C, H, W]``, the batch's mean."""
    x, y = x / data_range, y / data_range
    mse = ((x - y) ** 2).mean(dim=(1, 2, 3))
    return (-10.0 * torch.log10(mse + _EPS)).mean()


def compute_psnr(prediction, target, add_channel_dim: bool):
    """PSNR of the pair min-max-normalized to [0, 1]."""
    prediction, target = _normalize_pair(prediction, target)
    if add_channel_dim:
        prediction = prediction[..., None, :, :]
        target = target[..., None, :, :]
    return psnr(prediction, target)


def _gaussian_kernel2d(kernel_size: int, sigma: float) -> np.ndarray:
    coords = np.arange(kernel_size, dtype=np.float64)
    coords -= (kernel_size - 1) / 2.0
    g = coords ** 2
    g = np.exp(-(g[None, :] + g[:, None]) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def ssim(x, y, kernel_size: int = 11, kernel_sigma: float = 1.5,
         data_range: float = 1.0, downsample: bool = True, k1: float = 0.01,
         k2: float = 0.03):
    """Structural similarity over ``[N, C, H, W]`` (average-pool
    pre-downsampling, a valid sliding Gaussian window), the mean."""
    if kernel_size % 2 != 1:
        raise ValueError(f"Kernel size must be odd, got {kernel_size}")
    x, y = x / data_range, y / data_range
    f = max(1, round(min(x.shape[-2:]) / 256))
    if f > 1 and downsample:
        x, y = F.avg_pool2d(x, f), F.avg_pool2d(y, f)
    c = x.shape[1]
    kern = torch.as_tensor(_gaussian_kernel2d(kernel_size, kernel_sigma),
                           device=x.device, dtype=x.dtype)
    kern = kern.expand(c, 1, kernel_size, kernel_size)

    def conv(v):
        return F.conv2d(v, kern, groups=c)

    c1, c2 = k1 ** 2, k2 ** 2
    mu_x, mu_y = conv(x), conv(y)
    mu_xx, mu_yy, mu_xy = mu_x ** 2, mu_y ** 2, mu_x * mu_y
    sigma_xx = conv(x ** 2) - mu_xx
    sigma_yy = conv(y ** 2) - mu_yy
    sigma_xy = conv(x * y) - mu_xy
    cs = (2.0 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ss = (2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1) * cs
    return ss.mean(dim=(-1, -2)).mean(dim=1).mean()


def compute_ssim(prediction, target, add_channel_dim: bool, **kwargs):
    """SSIM of the pair min-max-normalized to [0, 1]."""
    prediction, target = _normalize_pair(prediction, target)
    if add_channel_dim:
        prediction = prediction[..., None, :, :]
        target = target[..., None, :, :]
    return ssim(prediction, target, **kwargs)


def compute_zonal_power_spectrum(x):
    """rFFT power along longitude (the negative wavenumbers folded in),
    averaged over latitude."""
    if x.dim() < 2:
        raise ValueError(
            f"Input must have at least 2 dims (lat, lon); got {x.shape}")
    uhat = torch.fft.rfft(x.float(), dim=-1)
    power = (uhat * uhat.conj()).real
    doubling = torch.full((power.shape[-1],), 2.0, device=x.device)
    doubling[0] = 1.0
    return (power * doubling).mean(dim=-2)


def compute_rank(target, prediction, sample_dim: int = 1):
    """The target's rank in the ensemble: the members <= it."""
    return (prediction <= target.unsqueeze(sample_dim)).sum(dim=sample_dim)


def interpolate_bicubic(x, scale_factor: int):
    """``[..., h, w]`` upsampled bicubically by ``scale_factor``, with
    ``jax.image.resize``'s weights (the relative metrics' baseline)."""
    h, w = x.shape[-2:]
    return resize(x, (h * scale_factor, w * scale_factor), "bicubic")


class GenerationMetricsAggregator:
    """Streaming generation-quality metrics: CRPS and its ratio to the
    bicubic baseline's MAE, RMSE and its ratio to the baseline's, PSNR,
    SSIM, zonal spectra and rank histograms.

    ``record_batch(target [B, H, W], prediction [B, S, H, W], coarse [B,
    h, w])`` by variable.
    """

    def __init__(self, downscale_factor: int):
        self._factor = downscale_factor
        self._n = 0
        self._device: dict[tuple, torch.Tensor] = {}
        self._sums: dict[str, dict[str, float]] = {}
        self._maps: dict[str, dict[str, np.ndarray]] = {}
        self._spectra: dict[str, dict[str, np.ndarray]] = {}
        self._ranks: dict[str, np.ndarray] = {}

    def _add(self, key, value):
        self._device[key] = (self._device[key] + value
                             if key in self._device else value)

    @torch.no_grad()
    def record_batch(self, target, prediction, coarse):
        self._n += 1
        for k, pred in prediction.items():
            if k not in target:
                continue
            tgt, pred = target[k].float(), pred.float()
            n_samples = pred.shape[1]
            self._add((k, "map", "crps"),
                      compute_crps(tgt, pred).mean(dim=0))
            if k in coarse:
                interp = interpolate_bicubic(coarse[k].float(), self._factor)
                self._add((k, "map", "interp_mae"),
                          (tgt - interp).abs().mean(dim=0))
                self._add((k, "sum", "interp_mse"),
                          ((tgt - interp) ** 2).mean())
                self._add((k, "spectrum", "coarse"),
                          compute_zonal_power_spectrum(interp).mean(dim=0))
            folded = pred.reshape(-1, *pred.shape[2:])
            tgt_rep = tgt.repeat_interleave(n_samples, dim=0)
            self._add((k, "sum", "mse"), ((folded - tgt_rep) ** 2).mean())
            self._add((k, "sum", "psnr"), compute_psnr(folded, tgt_rep, True))
            if min(folded.shape[-2:]) >= 11:
                self._add((k, "sum", "ssim"),
                          compute_ssim(folded, tgt_rep, True))
            self._add((k, "spectrum", "prediction"),
                      compute_zonal_power_spectrum(folded).mean(dim=0))
            self._add((k, "spectrum", "target"),
                      compute_zonal_power_spectrum(tgt).mean(dim=0))
            ranks = compute_rank(tgt, pred).reshape(-1)
            counts = torch.zeros(n_samples + 1, dtype=torch.int64,
                                 device=ranks.device)
            self._add((k, "ranks", ""),
                      counts.scatter_add_(0, ranks, torch.ones_like(ranks)))

    def _drain(self):
        if not self._device:
            return
        host = {key: v.cpu().double().numpy()
                for key, v in self._device.items()}
        self._device = {}
        for (k, kind, metric), value in host.items():
            if kind == "map":
                maps = self._maps.setdefault(k, {})
                maps[metric] = maps.get(metric, 0.0) + value
                sums = self._sums.setdefault(k, {})
                sums[metric] = sums.get(metric, 0.0) + float(value.mean())
            elif kind == "sum":
                sums = self._sums.setdefault(k, {})
                sums[metric] = sums.get(metric, 0.0) + float(value)
            elif kind == "spectrum":
                sp = self._spectra.setdefault(k, {})
                sp[metric] = sp.get(metric, 0.0) + value
            else:
                self._ranks[k] = self._ranks.get(k, 0) + value.astype(
                    np.int64)

    def get_logs(self, label: str = "generation") -> dict[str, float]:
        self._drain()
        logs = {}
        for k, d in self._sums.items():
            logs[f"{label}/metrics/crps/{k}"] = d.get("crps", np.nan) / self._n
            logs[f"{label}/metrics/rmse/{k}"] = float(
                np.sqrt(d.get("mse", np.nan) / self._n))
            logs[f"{label}/metrics/psnr/{k}"] = (
                d.get("psnr", np.nan) / self._n)
            if "ssim" in d:
                logs[f"{label}/metrics/ssim/{k}"] = d["ssim"] / self._n
            if "interp_mae" in d:
                # the mean of the per-pixel CRPS / MAE ratio map
                maps = self._maps[k]
                ratio_map = maps["crps"] / np.maximum(maps["interp_mae"],
                                                      1e-30)
                logs[f"{label}/metrics/relative_crps_bicubic/{k}"] = float(
                    ratio_map.mean())
                logs[f"{label}/metrics/relative_mse_bicubic/{k}"] = (
                    (d["mse"] / self._n) / (d["interp_mse"] / self._n))
        return logs

    def get_diagnostics(self) -> dict[str, np.ndarray]:
        self._drain()
        out = {}
        for k, sp in self._spectra.items():
            for src, v in sp.items():
                out[f"zonal_power_spectrum_{src}-{k}"] = np.asarray(
                    v / self._n, np.float32)
        for k, counts in self._ranks.items():
            out[f"rank_histogram-{k}"] = np.asarray(counts)
        return out
