"""Loss library (port of ace_tpu/core/loss.py).

All losses operate on packed channels-last tensors (``[batch, (ensemble,)
lat, lon, channel]``), reduce to per-channel ``(batch, channel)`` tensors,
and combine as the channel-mean of batch-means. Variable weights multiply
the normalized inputs before the loss.

Ensemble scores: almost-fair CRPS and the spectral energy score over SHT
coefficients. The energy score takes the port's ``RealSHT`` (float32
einsums) and the magnitude of complex differences through ``torch.abs``,
whose gradient is 0 at 0 as JAX's is: the l < m triangle of the
coefficients is exactly zero, where ``sqrt(r² + i²)`` would give NaN.
"""

import dataclasses
from typing import Any, Callable, Literal, Mapping

import numpy as np
import torch

from ace_tpu_torch.core.normalizer import StandardNormalizer
from ace_tpu_torch.core.typing_ import TensorMapping
from ace_tpu_torch.device import cached_on_device


@dataclasses.dataclass
class LossOutput:
    """Total loss and per-channel breakdown: ``per_channel`` maps each
    output name to its (batch-reduced) scalar, ``total`` is the mean over
    channels."""

    total: torch.Tensor
    per_channel: dict[str, torch.Tensor]

    def scale(self, weight) -> "LossOutput":
        return LossOutput(
            total=self.total * weight,
            per_channel={k: v * weight for k, v in self.per_channel.items()},
        )


def _reduce_to_channel(loss_elem: torch.Tensor) -> torch.Tensor:
    """Reduce ``[B, ..., C]`` elementwise loss to ``(B, C)``."""
    if loss_elem.dim() <= 2:
        return loss_elem
    return loss_elem.mean(dim=tuple(range(1, loss_elem.dim() - 1)))


class MSELoss:
    def __call__(self, x, y):
        return _reduce_to_channel((x - y) ** 2)


class L1Loss:
    def __call__(self, x, y):
        return _reduce_to_channel((x - y).abs())


class AreaWeightedMSELoss:
    """MSE with an area-weighted spatial mean."""

    def __init__(self, area_weighted_mean_channels_last):
        self._awm = area_weighted_mean_channels_last

    def __call__(self, x, y):
        return _reduce_to_channel(self._awm((x - y) ** 2))


class LpLoss:
    """Relative Lp-norm loss per (batch, channel)."""

    def __init__(self, p: int = 2):
        self.p = p

    def __call__(self, x, y):
        dims = tuple(range(1, x.dim() - 1))

        def total(t):
            # over no axes (a [B, C] input) the sum is the value itself;
            # torch's sum(dim=()) would sum everything
            return t.sum(dim=dims) if dims else t

        diff = total((x - y).abs() ** self.p) ** (1.0 / self.p)
        norm = total(y.abs() ** self.p) ** (1.0 / self.p)
        return diff / norm


class GlobalMeanLoss:
    """Loss applied to the area-weighted global mean of each sample."""

    def __init__(self, area_weighted_mean_channels_last, loss):
        self._awm = area_weighted_mean_channels_last
        self._loss = loss

    def __call__(self, x, y):
        return self._loss(self._awm(x), self._awm(y))


def get_crps(gen, target, alpha: float = 1.0):
    """Almost-fair CRPS over the ensemble axis (axis 1).

    gen: ``[B, E, ...]``; target: ``[B, 1, ...]``. Returns ``[B, ...]``.
    """
    n_ens = gen.shape[1]
    epsilon = (1.0 - alpha) / 2.0
    target_term = (gen - target).abs().mean(dim=1)
    if n_ens == 1:
        internal_term = torch.zeros_like(target_term)
    else:
        pairs = [
            (gen[:, i] - gen[:, j]).abs()
            for i in range(n_ens)
            for j in range(i + 1, n_ens)
        ]
        internal_term = -0.5 * sum(pairs) / len(pairs)
    return target_term + (1.0 - epsilon) * internal_term


def get_energy_score(gen, target):
    """Energy score over complex coefficients, 2 ensemble members."""
    if gen.shape[1] != 2:
        raise NotImplementedError(
            f"energy score requires exactly 2 ensemble members, got {gen.shape[1]}"
        )
    target_term = (gen - target).abs().mean(dim=1)
    internal_term = -0.5 * (gen[:, 0] - gen[:, 1]).abs()
    return target_term + internal_term


class CRPSLoss:
    def __init__(self, alpha: float = 1.0):
        self.alpha = alpha

    def __call__(self, x, y):
        # x: [B, E, lat, lon, C]; y: [B, 1, lat, lon, C]
        return _reduce_to_channel(get_crps(x, y, alpha=self.alpha))


def _avg_pool2(x):
    """2x2 average pool over the (lat, lon) axes (-3, -2), ceil mode."""
    h, w = x.shape[-3], x.shape[-2]
    pad_h, pad_w = h % 2, w % 2
    if pad_h:
        x = torch.cat([x, x[..., -1:, :, :]], dim=-3)
    if pad_w:
        x = torch.cat([x, x[..., -1:, :]], dim=-2)
    h, w = h + pad_h, w + pad_w
    x = x.reshape(*x.shape[:-3], h // 2, 2, w // 2, 2, x.shape[-1])
    return x.mean(dim=(-4, -2))


class FiniteDifferenceCRPSLoss:
    """CRPS of spatial finite differences on ``[B, E, lat, lon, C]``."""

    def __init__(self, alpha: float = 1.0, levels: int = 1):
        if levels < 1:
            raise ValueError(f"levels must be at least 1, got {levels}")
        self.alpha = alpha
        self.levels = levels

    def _level(self, x, y, levels):
        x_dlat = x[..., 1:, :, :] - x[..., :-1, :, :]
        y_dlat = y[..., 1:, :, :] - y[..., :-1, :, :]
        crps_lat = _reduce_to_channel(get_crps(x_dlat, y_dlat, self.alpha))
        x_dlon = torch.roll(x, shifts=-1, dims=-2) - x
        y_dlon = torch.roll(y, shifts=-1, dims=-2) - y
        crps_lon = _reduce_to_channel(get_crps(x_dlon, y_dlon, self.alpha))
        out = 0.5 * (crps_lat + crps_lon)
        if levels > 1:
            out = out + self._level(_avg_pool2(x), _avg_pool2(y), levels - 1)
        return out

    def __call__(self, x, y):
        return self._level(x, y, self.levels) / self.levels


@dataclasses.dataclass
class SpectralWhiteningConfig:
    """Per-sample spectral whitening of the energy score."""

    kind: Literal["none", "per_sample"] = "none"
    eps_frac: float | None = None
    exponent: float | None = None

    def __post_init__(self):
        if self.kind == "none":
            if self.eps_frac is not None or self.exponent is not None:
                raise ValueError(
                    "spectral whitening kind='none' accepts no "
                    "eps_frac/exponent parameters"
                )
            return
        if self.exponent is not None and not 0.0 < self.exponent <= 1.0:
            raise ValueError(
                f"whitening exponent must be in (0, 1]: {self.exponent}"
            )
        if self.eps_frac is not None and self.eps_frac <= 0.0:
            raise ValueError(
                f"whitening eps_frac must be > 0: {self.eps_frac}"
            )

    def build(self):
        if self.kind == "none":
            return None
        return SpectralWhitening(
            eps_frac=self.eps_frac if self.eps_frac is not None else 0.02,
            exponent=self.exponent if self.exponent is not None else 0.5,
        )


def _mode_weights(n_l, n_m, device):
    """2 for m > 0 (Hermitian symmetry), 1 at m = 0: ``[L, M]``."""
    w = torch.full((n_l, n_m), 2.0, device=device)
    w[:, 0] = 1.0
    return w


class SpectralWhitening:
    """Per-sample per-degree reweighting ``(1/amp_l)**exponent`` with
    magnitude preservation, on coefficients ``[B, 1(ens), L, M, C]``;
    returns a factor ``[B, L, 1, C]`` broadcast over the order m."""

    def __init__(self, eps_frac: float = 0.02, exponent: float = 0.5):
        self.eps_frac = eps_frac
        self.exponent = exponent

    def factor(self, y_hat):
        amp_mode = y_hat.detach()[:, 0].abs()  # (B, L, M, C)
        n_l, n_m = amp_mode.shape[-3], amp_mode.shape[-2]
        l_idx = torch.arange(n_l, device=amp_mode.device)[:, None]
        m_idx = torch.arange(n_m, device=amp_mode.device)[None, :]
        valid = (m_idx <= l_idx).to(amp_mode.dtype)
        w = (_mode_weights(n_l, n_m, amp_mode.device) * valid)[..., None]
        tiny = torch.finfo(amp_mode.dtype).tiny
        meanpow_l = (amp_mode ** 2 * w).sum(dim=-2) / torch.clamp(
            w.sum(dim=-2), min=tiny
        )  # (B, L, C)
        amp_l = torch.sqrt(meanpow_l)
        mean_amp = amp_l.mean(dim=-2, keepdim=True)
        f = 1.0 / torch.maximum(amp_l, self.eps_frac * mean_amp)
        if self.exponent != 1.0:
            f = f ** self.exponent
        f_m = f[:, :, None, :]  # (B, L, 1, C)
        num = (w * amp_mode).sum(dim=(-3, -2), keepdim=True)
        den = (w * f_m * amp_mode).sum(dim=(-3, -2), keepdim=True)
        return num / (den + tiny) * f_m


class EnergyScoreLoss:
    """Energy score over SHT coefficients. ``sht`` maps ``[..., lat, lon,
    C]`` to the complex coefficients ``[..., l, m, C]``."""

    def __init__(self, sht: Callable, whitening=None):
        self.sht = sht
        self._whitening = whitening

    def __call__(self, x, y):
        x_hat = self.sht(x)
        y_hat = self.sht(y)
        n_l, n_m = x_hat.shape[-3], x_hat.shape[-2]
        scaling = 2.0 * (n_l * n_m) ** 0.5
        mode_weights = _mode_weights(n_l, n_m, x.device)[..., None]
        es = get_energy_score(x_hat, y_hat) * mode_weights
        if self._whitening is not None:
            es = es * self._whitening.factor(y_hat)
        # sum over modes / scaling, as per-channel (B, C)
        return es.sum(dim=(-3, -2)) / scaling


def complex_sht(sht) -> Callable:
    """A channels-last ``RealSHT`` as a function to complex coefficients."""
    def transform(x):
        return torch.complex(*sht.forward_pair(x))

    return transform


class EnsembleLoss:
    """crps_weight * CRPS + energy_score_weight * EnergyScore (+ optional
    finite-difference CRPS), the ACE2 training loss."""

    def __init__(self, crps_weight, energy_score_weight, sht,
                 finite_difference_crps_weight=0.0,
                 finite_difference_crps_levels=1,
                 almost_fair_crps_alpha=1.0,
                 energy_score_whitening=None):
        if crps_weight < 0 or energy_score_weight < 0:
            raise ValueError("weights must be non-negative")
        if crps_weight + energy_score_weight == 0:
            raise ValueError("crps+energy weights must be positive")
        self.crps_loss = CRPSLoss(alpha=almost_fair_crps_alpha)
        self.energy_score_loss = EnergyScoreLoss(
            sht, whitening=energy_score_whitening
        )
        self.diff_crps_loss = (
            FiniteDifferenceCRPSLoss(
                alpha=almost_fair_crps_alpha,
                levels=finite_difference_crps_levels,
            )
            if finite_difference_crps_weight > 0
            else None
        )
        self.crps_weight = crps_weight
        self.energy_score_weight = energy_score_weight
        self.diff_crps_weight = finite_difference_crps_weight

    def __call__(self, x, y):
        total = 0.0
        if self.crps_weight > 0:
            total = total + self.crps_weight * self.crps_loss(x, y)
        if self.energy_score_weight > 0:
            total = total + self.energy_score_weight * self.energy_score_loss(
                x, y
            )
        if self.diff_crps_loss is not None:
            total = total + self.diff_crps_weight * self.diff_crps_loss(x, y)
        return total


class WeightedMappingLoss:
    """Normalize and pack dicts, apply per-variable weights, compute the
    inner loss, return a LossOutput. ``data_mask`` maps a variable to a
    ``[batch]`` presence mask: masked samples leave the per-channel
    average and fully masked channels the total."""

    def __init__(self, loss, weights: dict[str, float], out_names: list[str],
                 normalizer: StandardNormalizer, ensemble: bool = False):
        self.loss = loss
        self.out_names = list(out_names)
        self.weights = np.asarray(
            [weights.get(k, 1.0) for k in out_names], dtype=np.float32
        )
        self.normalizer = normalizer
        self.ensemble = ensemble
        self._device_cache: dict = {}

    def __call__(self, predict_dict: TensorMapping,
                 target_dict: TensorMapping,
                 data_mask: TensorMapping | None = None) -> LossOutput:
        pred_norm = self.normalizer.normalize(dict(predict_dict))
        targ_norm = self.normalizer.normalize(dict(target_dict))
        pred = torch.stack([pred_norm[k] for k in self.out_names], dim=-1)
        targ = torch.stack([targ_norm[k] for k in self.out_names], dim=-1)
        nan_mask = torch.isnan(targ)
        pred = torch.where(nan_mask, 0.0, pred)
        targ = torch.where(nan_mask, 0.0, targ)
        # made once per device: a copy from the host each call would wait
        # for the device
        weights = cached_on_device(self._device_cache, "weights",
                                   self.weights, pred.device)
        per_bc = self.loss(weights * pred, weights * targ)  # (B, C)
        if data_mask is None:
            per_channel = per_bc.mean(dim=0)
            return LossOutput(
                total=per_channel.mean(),
                per_channel={
                    k: per_channel[i] for i, k in enumerate(self.out_names)
                },
            )
        ones = torch.ones(per_bc.shape[0], device=per_bc.device)
        mask = torch.stack(
            [
                torch.as_tensor(data_mask[k], device=per_bc.device).float()
                if k in data_mask else ones
                for k in self.out_names
            ],
            dim=-1,
        )  # (B, C)
        counts = mask.sum(dim=0)
        per_channel = (per_bc * mask).sum(dim=0) / torch.clamp(counts, min=1.0)
        active = (counts > 0).float()
        total = (per_channel * active).sum() / torch.clamp(active.sum(),
                                                           min=1.0)
        return LossOutput(
            total=total,
            per_channel={
                k: per_channel[i] for i, k in enumerate(self.out_names)
            },
        )


class WeightedSum:
    def __init__(self, losses: list, weights: list[float]):
        if len(losses) != len(weights):
            raise ValueError("losses and weights must have the same length")
        self.losses = losses
        self.weights = weights

    def __call__(self, x, y):
        total = 0.0
        for w, loss in zip(self.weights, self.losses):
            total = total + w * loss(x, y)
        return total


class StepLoss:
    """Per-rollout-step loss with optional sqrt step decay."""

    def __init__(self, loss: WeightedMappingLoss,
                 sqrt_loss_decay_constant: float = 0.0):
        self.loss = loss
        self.sqrt_loss_decay_constant = sqrt_loss_decay_constant

    def __call__(self, predict_dict, target_dict, step: int,
                 data_mask=None) -> LossOutput:
        step_weight = (1.0 + self.sqrt_loss_decay_constant * step) ** (-0.5)
        return self.loss(
            predict_dict, target_dict, data_mask=data_mask
        ).scale(step_weight)


@dataclasses.dataclass
class LossConfig:
    """Which loss to build, with its options."""

    type: Literal[
        "LpLoss", "L1", "MSE", "AreaWeightedMSE", "NaN", "EnsembleLoss"
    ] = "MSE"
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    global_mean_type: Literal["LpLoss"] | None = None
    global_mean_kwargs: Mapping[str, Any] = dataclasses.field(
        default_factory=dict
    )
    global_mean_weight: float = 1.0

    def build(self, gridded_operations, sht: Callable | None = None):
        if self.type == "LpLoss":
            main_loss: Any = LpLoss(**self.kwargs)
        elif self.type == "L1":
            main_loss = L1Loss()
        elif self.type == "MSE":
            main_loss = MSELoss()
        elif self.type == "AreaWeightedMSE":
            main_loss = AreaWeightedMSELoss(
                gridded_operations.area_weighted_mean_channels_last
            )
        elif self.type == "EnsembleLoss":
            if sht is None:
                raise ValueError("EnsembleLoss requires an SHT transform")
            kwargs = dict(self.kwargs)
            kwargs.setdefault("crps_weight", 1.0)
            kwargs.setdefault("energy_score_weight", 0.0)
            whitening_cfg = kwargs.pop("energy_score_whitening", None)
            whitening = None
            if isinstance(whitening_cfg, dict):
                from ace_tpu_torch.core.config import from_dict

                whitening = from_dict(
                    SpectralWhiteningConfig, whitening_cfg
                ).build()
            elif isinstance(whitening_cfg, SpectralWhiteningConfig):
                whitening = whitening_cfg.build()
            main_loss = EnsembleLoss(
                sht=sht, energy_score_whitening=whitening, **kwargs
            )
        elif self.type == "NaN":
            def main_loss(x, y):
                return torch.full((x.shape[0], x.shape[-1]), float("nan"),
                                  device=x.device)
        else:
            raise NotImplementedError(self.type)

        if self.global_mean_type is not None:
            gm = GlobalMeanLoss(
                gridded_operations.area_weighted_mean_channels_last,
                LpLoss(**self.global_mean_kwargs),
            )
            return WeightedSum([main_loss, gm], [1.0, self.global_mean_weight])
        return main_loss


@dataclasses.dataclass
class StepLossConfig:
    """The step loss to build, with per-variable weights."""

    type: Literal["LpLoss", "MSE", "AreaWeightedMSE", "EnsembleLoss"] = "MSE"
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    global_mean_type: Literal["LpLoss"] | None = None
    global_mean_kwargs: Mapping[str, Any] = dataclasses.field(
        default_factory=dict
    )
    global_mean_weight: float = 1.0
    sqrt_loss_step_decay_constant: float = 0.0
    weights: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def is_ensemble_loss(self) -> bool:
        return self.type == "EnsembleLoss"

    def build(self, gridded_ops, out_names: list[str],
              normalizer: StandardNormalizer,
              sht: Callable | None = None) -> StepLoss:
        loss_config = LossConfig(
            type=self.type,
            kwargs=self.kwargs,
            global_mean_type=self.global_mean_type,
            global_mean_kwargs=self.global_mean_kwargs,
            global_mean_weight=self.global_mean_weight,
        )
        inner = loss_config.build(gridded_ops, sht=sht)
        return StepLoss(
            WeightedMappingLoss(
                loss=inner,
                weights=dict(self.weights),
                out_names=out_names,
                normalizer=normalizer,
                ensemble=self.is_ensemble_loss,
            ),
            sqrt_loss_decay_constant=self.sqrt_loss_step_decay_constant,
        )
