"""Diffusion downscaling model: the config surface, the EDM loss,
generation, the mixture of denoising experts, patched generation and the
deterministic models (port of ace_tpu/downscaling/models.py).

A model holds its network (``net``, an ``nn.Module`` on the model's
device) and computes with the network's current weights: the trainer
swaps the EMA weights in for validation. Fields are ``[B, h, w]`` tensors
by name; the networks see channels-last ``[B, H, W, C]`` at the fine
resolution, the conditioning upsampled with ``jax.image.resize``'s
bilinear weights (``resize.py``). Random draws come from the caller's
``torch.Generator``; ``loss_fn`` and ``generate`` also take pre-drawn
noise (``ace_tpu``'s draws in the parity tests).
"""

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from ace_tpu_torch.core.config import from_dict, to_dict
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.normalizer import (
    NormalizationConfig,
    StandardNormalizer,
)
from ace_tpu_torch.core.packer import Packer
from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping
from ace_tpu_torch.device import get_device
from ace_tpu_torch.downscaling.diffusion import (
    LogNormalNoiseDistribution,
    LogUniformNoiseDistribution,
    edm_loss,
    edm_precondition,
    make_moe_denoiser,
    stochastic_sampler,
    validate_sigma_ranges,
)
from ace_tpu_torch.downscaling.resize import resize
from ace_tpu_torch.models.layers import init_weights
from ace_tpu_torch.utils.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class PairedNormalizationConfig:
    """Separate normalization of the coarse (input) and fine (output)
    fields."""

    fine: NormalizationConfig
    coarse: NormalizationConfig


@dataclasses.dataclass
class UNetConfig:
    base_channels: int = 64
    channel_mults: list[int] = dataclasses.field(
        default_factory=lambda: [1, 2, 2]
    )
    num_res_blocks: int = 2
    attn_levels: list[int] = dataclasses.field(default_factory=list)
    bottleneck_attention: bool = True
    num_heads: int = 4
    compute_dtype: str = "float32"


@dataclasses.dataclass
class SongUNetV2Config:
    """SongUNet v2 backbone options."""

    model_channels: int = 128
    channel_mult: list[int] = dataclasses.field(
        default_factory=lambda: [1, 2, 2, 2]
    )
    channel_mult_emb: int = 4
    num_blocks: int = 4
    attn_resolutions: list[int] = dataclasses.field(
        default_factory=lambda: [16]
    )
    dropout: float = 0.10
    label_dropout: float = 0.0
    embedding_type: str = "positional"
    channel_mult_noise: int = 1
    encoder_type: str = "standard"
    decoder_type: str = "standard"
    resample_filter: list[int] = dataclasses.field(
        default_factory=lambda: [1, 1]
    )
    act: str = "silu"
    # accepted for config compatibility: the group norm always runs fused
    use_apex_gn: bool = True
    bottleneck_attention: bool = True
    # >= 1: every UNet block recomputed in the backward pass
    checkpointing: int = 0
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.act != "silu":
            raise ValueError("only act='silu' is supported")


@dataclasses.dataclass
class DiffusionModuleSelector:
    """``{type, config}`` backbone selection: "unet_diffusion_song",
    "unet_diffusion_song_v2" (both SongUNetV2Config) or "unet" (the
    compact UNetConfig)."""

    type: str
    config: dict = dataclasses.field(default_factory=dict)
    expects_interpolated_input: bool | None = None

    def __post_init__(self):
        if self.type in ("unet_diffusion_song", "unet_diffusion_song_v2"):
            self.instance = from_dict(SongUNetV2Config, self.config)
        elif self.type == "unet":
            self.instance = from_dict(UNetConfig, self.config)
        else:
            raise ValueError(
                f"unknown diffusion module type {self.type!r}; known: "
                "['unet', 'unet_diffusion_song', 'unet_diffusion_song_v2']"
            )
        if self.expects_interpolated_input is None:
            self.expects_interpolated_input = True


def build_net(module_cfg, out_channels: int, cond_channels: int,
              fine_shape: tuple[int, int], device=None):
    """The raw denoiser network of a ``UNetConfig`` or a
    ``DiffusionModuleSelector``."""
    cfg = getattr(module_cfg, "instance", module_cfg)
    dtype = _DTYPES[cfg.compute_dtype]
    if isinstance(cfg, SongUNetV2Config):
        from ace_tpu_torch.downscaling.song_unet import SongUNetV2

        return SongUNetV2(
            img_resolution=min(fine_shape),
            in_channels=out_channels + cond_channels,
            out_channels=out_channels,
            model_channels=cfg.model_channels,
            channel_mult=tuple(cfg.channel_mult),
            channel_mult_emb=cfg.channel_mult_emb,
            num_blocks=cfg.num_blocks,
            attn_resolutions=tuple(cfg.attn_resolutions),
            dropout=cfg.dropout,
            label_dropout=cfg.label_dropout,
            embedding_type=cfg.embedding_type,
            channel_mult_noise=cfg.channel_mult_noise,
            encoder_type=cfg.encoder_type,
            decoder_type=cfg.decoder_type,
            resample_filter=tuple(cfg.resample_filter),
            bottleneck_attention=cfg.bottleneck_attention,
            checkpointing=cfg.checkpointing,
            dtype=dtype, device=device,
        )
    from ace_tpu_torch.downscaling.unet import DiffusionUNet

    return DiffusionUNet(
        in_channels=out_channels + cond_channels,
        out_channels=out_channels,
        base_channels=cfg.base_channels,
        channel_mults=tuple(cfg.channel_mults),
        num_res_blocks=cfg.num_res_blocks,
        attn_levels=tuple(cfg.attn_levels),
        bottleneck_attention=cfg.bottleneck_attention,
        num_heads=cfg.num_heads,
        dtype=dtype, device=device,
    )


@dataclasses.dataclass
class LossWeightsConfig:
    """Per-variable multiplicative loss weights (missing ones 1) and the
    exponent on the EDM noise-level weight."""

    output_channels: dict[str, float] = dataclasses.field(
        default_factory=dict
    )
    noise_weight_exponent: float = 1.0


@dataclasses.dataclass
class DiffusionModelConfig:
    """The diffusion downscaling model's config (``ace_tpu``'s fields)."""

    in_names: list[str]
    out_names: list[str]
    normalization: PairedNormalizationConfig
    module: UNetConfig | DiffusionModuleSelector = dataclasses.field(
        default_factory=UNetConfig
    )
    downscale_factor: int = 1
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    sigma_data: float = 1.0
    churn: float = 0.0
    num_diffusion_generation_steps: int = 18
    predict_residual: bool = False
    use_fine_topography: bool = False
    loss_weights: LossWeightsConfig = dataclasses.field(
        default_factory=LossWeightsConfig
    )
    training_noise_distribution: (
        LogNormalNoiseDistribution | LogUniformNoiseDistribution | None
    ) = None
    loss: dict | None = None
    # the deprecated spelling of the log-normal training distribution
    p_mean: float | None = None
    p_std: float | None = None

    def __post_init__(self):
        if self.loss is not None:
            loss_type = (self.loss or {}).get("type", "MSE")
            if loss_type != "MSE":
                raise NotImplementedError(
                    f"diffusion loss type {loss_type!r}; the EDM "
                    "objective supports MSE only"
                )
        if self.p_mean is not None or self.p_std is not None:
            folded = LogNormalNoiseDistribution(
                p_mean=self.p_mean if self.p_mean is not None else -1.2,
                p_std=self.p_std if self.p_std is not None else 1.2,
            )
            # a saved config holds both spellings, the second folded from
            # the first (ace_tpu refuses to read its own such checkpoint)
            if self.training_noise_distribution not in (None, folded):
                raise ValueError(
                    "specify training_noise_distribution only; "
                    "p_mean/p_std are deprecated"
                )
            self.training_noise_distribution = folded

    def build(self, dataset_info: DatasetInfo, static_inputs=None,
              device=None) -> "DiffusionModel":
        return DiffusionModel(self, dataset_info,
                              static_inputs=static_inputs, device=device)


def _upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``[B, h, w, C]`` bilinearly to ``[B, h f, w f, C]``."""
    if factor == 1:
        return x
    h, w = x.shape[1:3]
    return resize(x, (h * factor, w * factor), "bilinear",
                  channels_last=True)


class DiffusionModel:
    """EDM training and generation over named coarse and fine fields."""

    def __init__(self, config: DiffusionModelConfig,
                 dataset_info: DatasetInfo, static_inputs=None, device=None):
        self.config = config
        self.dataset_info = dataset_info
        self.device = get_device(device)
        if config.use_fine_topography and (
            static_inputs is None or static_inputs.shape[-1] == 0
        ):
            raise ValueError(
                "use_fine_topography is enabled but no static input "
                "fields were provided."
            )
        self.static_inputs = (
            torch.as_tensor(np.asarray(static_inputs, np.float32),
                            device=self.device)
            if static_inputs is not None else None
        )
        self.in_packer = Packer(config.in_names)
        self.out_packer = Packer(config.out_names)
        self.coarse_normalizer: StandardNormalizer = (
            config.normalization.coarse.build(config.in_names)
        )
        self.fine_normalizer: StandardNormalizer = (
            config.normalization.fine.build(config.out_names)
        )
        nlat, nlon = dataset_info.img_shape
        f = config.downscale_factor
        n_static = (self.static_inputs.shape[-1]
                    if config.use_fine_topography else 0)
        self.net = build_net(
            config.module, out_channels=len(config.out_names),
            cond_channels=len(config.in_names) + n_static,
            fine_shape=(nlat * f, nlon * f), device=self.device,
        )
        self._noise_dist = (config.training_noise_distribution
                            or LogNormalNoiseDistribution())

    def init_params(self, generator: torch.Generator | None = None):
        """Draw the network's weights (``ace_tpu``'s distributions)."""
        init_weights(self.net, generator)
        return self.net

    def _denoiser(self, generator=None):
        net = self.net
        # dropout where the network has it and a generator is given
        train = generator is not None and getattr(net, "dropout", 0.0) > 0

        def raw(x, cond, c_noise):
            if train:
                return net(x, cond, c_noise, deterministic=False,
                           generator=generator)
            return net(x, cond, c_noise)

        return edm_precondition(raw, sigma_data=self.config.sigma_data)

    def _normalized(self, normalizer, packer, fields: TensorMapping):
        return packer.pack(normalizer.normalize(
            {k: torch.as_tensor(v, device=self.device).float()
             for k, v in fields.items()}))

    def _pack(self, coarse: TensorMapping, fine: TensorMapping | None,
              static=None):
        cond = self._normalized(self.coarse_normalizer, self.in_packer,
                                coarse)
        cond = _upsample(cond, self.config.downscale_factor)
        if self.config.use_fine_topography:
            static = static if static is not None else self.static_inputs
            static = torch.as_tensor(static, device=self.device).float()
            if tuple(static.shape[:2]) != tuple(cond.shape[1:3]):
                raise ValueError(
                    f"static input shape {tuple(static.shape[:2])} does "
                    f"not match the fine spatial shape "
                    f"{tuple(cond.shape[1:3])}"
                )
            cond = torch.cat(
                [cond, static[None].expand(cond.shape[0], *static.shape)],
                dim=-1)
        target = None
        if fine is not None:
            target = self._normalized(self.fine_normalizer, self.out_packer,
                                      fine)
        return cond, target

    def _residual_base(self, coarse: TensorMapping):
        """The coarse-normalized output fields bilinearly upsampled: the
        base the network predicts a residual against."""
        missing = [k for k in self.config.out_names if k not in coarse]
        if missing:
            raise ValueError(
                "predict_residual requires every output variable in the "
                f"coarse data; missing {missing}"
            )
        base = self._normalized(
            self.coarse_normalizer, self.out_packer,
            {k: coarse[k] for k in self.config.out_names})
        return _upsample(base, self.config.downscale_factor)

    def loss_fn(self, coarse: TensorMapping, fine: TensorMapping,
                generator: torch.Generator | None = None, static=None,
                sigma=None, noise=None):
        """The EDM training loss on normalized fields (dropout on where
        the network has it, as in ``ace_tpu``, for validation too)."""
        cond, target = self._pack(coarse, fine, static=static)
        if self.config.predict_residual:
            target = target - self._residual_base(coarse)
        lw = self.config.loss_weights
        channel_weights = None
        if lw.output_channels:
            channel_weights = [lw.output_channels.get(n, 1.0)
                               for n in self.config.out_names]
        return edm_loss(
            self._denoiser(generator), target, cond, generator=generator,
            noise_distribution=self._noise_dist,
            sigma_data=self.config.sigma_data,
            loss_weight_exponent=lw.noise_weight_exponent,
            channel_weights=channel_weights, sigma=sigma, noise=noise,
        )

    def _sample(self, latents, cond, generator, eps):
        return stochastic_sampler(
            self._denoiser(), latents, cond, generator,
            num_steps=self.config.num_diffusion_generation_steps,
            sigma_min=self.config.sigma_min,
            sigma_max=self.config.sigma_max,
            S_churn=self.config.churn, eps=eps,
        )

    @torch.no_grad()
    def generate(self, coarse: TensorMapping,
                 generator: torch.Generator | None = None,
                 n_samples: int = 1, static=None, latents=None,
                 eps=None) -> TensorDict:
        """Fine fields ``[B, n_samples, H, W]`` (denormalized) conditioned
        on coarse ones. ``latents`` (one ``[B, H, W, C]`` standard normal
        per sample) and ``eps`` (per sample, a list of one per step) are
        drawn from ``generator`` unless given."""
        return _generate(self, self._sample, coarse, generator, n_samples,
                         static, latents, eps)

    def get_state(self) -> dict:
        return {"config": to_dict(self.config)}


def _generate(model, sample, coarse, generator, n_samples, static,
              latents, eps) -> TensorDict:
    cond, _ = model._pack(coarse, None, static=static)
    batch, h, w = cond.shape[:3]
    c_out = len(model.config.out_names)
    base = (model._residual_base(coarse)
            if model.config.predict_residual else None)
    outs = []
    for s in range(n_samples):
        lat = (latents[s] if latents is not None else torch.randn(
            (batch, h, w, c_out), generator=generator, device=cond.device))
        out = sample(torch.as_tensor(lat, device=cond.device), cond,
                     generator, None if eps is None else eps[s])
        outs.append(out + base if base is not None else out)
    stacked = torch.stack(outs, dim=1)  # [B, S, H, W, C]
    result = {name: stacked[..., i]
              for i, name in enumerate(model.config.out_names)}
    return model.fine_normalizer.denormalize(result)


def model_state(model) -> dict:
    """The fields ``ace_tpu`` keeps of a model in a checkpoint (config,
    type, dataset info, the flax parameter tree)."""
    return {
        "config": json.dumps(to_dict(model.config)),
        "model_type": type(model.config).__name__,
        "dataset_info": json.dumps(model.dataset_info.get_state()),
        "params": params_tree(model),
    }


def params_tree(model) -> dict:
    """The model's weights as ``ace_tpu``'s flax variables."""
    if model.net is None:
        return {}
    return {"params": state_dict_to_flax_params(model.net.state_dict())}


def load_params_tree(model, params: dict):
    """Copy ``ace_tpu``'s flax variables (a checkpoint's ``params``) into
    the model's network; every tensor must be there."""
    if model.net is None:
        return
    state = flax_params_to_state_dict(params or {})
    model.net.load_state_dict(state, strict=True)


@dataclasses.dataclass
class DenoisingExpertCheckpointConfig:
    """One expert checkpoint and the inclusive sigma interval it serves."""

    checkpoint_path: str
    sigma_min: float
    sigma_max: float


@dataclasses.dataclass
class DenoisingMoEConfig:
    """A mixture of denoising experts over contiguous, non-overlapping
    sigma ranges; the sampler's schedule spans their union."""

    denoising_expert_configs: list[DenoisingExpertCheckpointConfig]
    num_diffusion_generation_steps: int
    churn: float = 0.0

    def __post_init__(self):
        self.denoising_expert_configs = sorted(
            self.denoising_expert_configs, key=lambda c: c.sigma_min
        )

    def build(self, device=None) -> "DenoisingMoEPredictor":
        from ace_tpu_torch.downscaling.train import load_downscaling_model

        experts = [load_downscaling_model(c.checkpoint_path, device=device)
                   for c in self.denoising_expert_configs]
        return DenoisingMoEPredictor(
            experts=experts,
            sigma_ranges=[(c.sigma_min, c.sigma_max)
                          for c in self.denoising_expert_configs],
            num_diffusion_generation_steps=(
                self.num_diffusion_generation_steps),
            churn=self.churn,
        )


@dataclasses.dataclass
class CheckpointModelConfig:
    """A model loaded from a training checkpoint."""

    checkpoint_path: str

    def build(self, device=None):
        from ace_tpu_torch.downscaling.train import load_downscaling_model

        return load_downscaling_model(self.checkpoint_path, device=device)


@dataclasses.dataclass
class DenoisingMoEBundledConfig:
    """A mixture of experts from one bundle of
    ``DenoisingMoEPredictor.save``."""

    mixture_of_experts_path: str

    def build(self, device=None) -> "DenoisingMoEPredictor":
        return DenoisingMoEPredictor.load(self.mixture_of_experts_path,
                                          device=device)


def _validate_experts_compatible(experts: list[DiffusionModel]) -> None:
    primary = experts[0]

    def key(m):
        return (tuple(m.config.in_names), tuple(m.config.out_names),
                m.config.downscale_factor, m.config.sigma_data,
                m.config.predict_residual)

    for m in experts[1:]:
        if key(m) != key(primary):
            raise ValueError(
                "All experts must share the same variable names, "
                f"downscale factor, and preconditioning; got {key(m)} "
                f"vs {key(primary)}."
            )


class DenoisingMoEPredictor:
    """Diffusion experts, each denoising its part of the sigma schedule;
    generates like a ``DiffusionModel`` (routing on the host's noise
    level)."""

    def __init__(self, experts: list[DiffusionModel],
                 sigma_ranges: list[tuple[float, float]],
                 num_diffusion_generation_steps: int, churn: float = 0.0):
        if not experts:
            raise ValueError("experts must be non-empty.")
        if len(experts) != len(sigma_ranges):
            raise ValueError(
                "experts and sigma_ranges must have the same length."
            )
        validate_sigma_ranges(sigma_ranges)
        _validate_experts_compatible(experts)
        self._experts = experts
        self._primary = experts[0]
        self._sigma_ranges = [tuple(r) for r in sigma_ranges]
        self._num_steps = num_diffusion_generation_steps
        self._churn = churn

    @property
    def config(self):
        return self._primary.config

    @property
    def dataset_info(self):
        return self._primary.dataset_info

    @property
    def static_inputs(self):
        return self._primary.static_inputs

    @property
    def experts(self) -> list[DiffusionModel]:
        return list(self._experts)

    def _sample(self, latents, cond, generator, eps):
        moe = make_moe_denoiser(self._sigma_ranges,
                                [e._denoiser() for e in self._experts])
        return stochastic_sampler(
            moe, latents, cond, generator, num_steps=self._num_steps,
            sigma_min=self._sigma_ranges[0][0],
            sigma_max=self._sigma_ranges[-1][1], S_churn=self._churn,
            eps=eps,
        )

    @torch.no_grad()
    def generate(self, coarse: TensorMapping,
                 generator: torch.Generator | None = None,
                 n_samples: int = 1, static=None, latents=None,
                 eps=None) -> TensorDict:
        """As ``DiffusionModel.generate``."""
        return _generate(self._primary, self._sample, coarse, generator,
                         n_samples, static, latents, eps)

    def save(self, path: str):
        """Every expert and the routing and sampler settings in one file
        (``ace_tpu``'s bundle)."""
        from ace_tpu_torch.stepper.checkpoint import save_msgpack

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        payload: dict[str, Any] = {
            "moe_meta": json.dumps({
                "sigma_ranges": [list(r) for r in self._sigma_ranges],
                "num_diffusion_generation_steps": self._num_steps,
                "churn": self._churn,
                "n_experts": len(self._experts),
            }),
        }
        for i, expert in enumerate(self._experts):
            payload[f"expert_{i}"] = model_state(expert)
        save_msgpack(path, payload)

    @classmethod
    def load(cls, path: str, device=None) -> "DenoisingMoEPredictor":
        from ace_tpu_torch.stepper.checkpoint import load_msgpack

        payload = load_msgpack(path)
        meta = json.loads(payload["moe_meta"])
        experts = []
        for i in range(meta["n_experts"]):
            blob = payload[f"expert_{i}"]
            config = from_dict(DiffusionModelConfig,
                               json.loads(blob["config"]))
            info = DatasetInfo.from_state(json.loads(blob["dataset_info"]))
            model = config.build(info, device=device)
            load_params_tree(model, blob["params"])
            experts.append(model)
        return cls(
            experts=experts,
            sigma_ranges=[(float(lo), float(hi))
                          for lo, hi in meta["sigma_ranges"]],
            num_diffusion_generation_steps=int(
                meta["num_diffusion_generation_steps"]),
            churn=float(meta["churn"]),
        )


class PatchPredictor:
    """Full-extent generation from overlapping coarse patches, composited
    (overlaps averaged)."""

    def __init__(self, model, coarse_patch_shape: tuple[int, int],
                 coarse_horizontal_overlap: int = 1):
        self.model = model
        self.coarse_patch_shape = coarse_patch_shape
        self.overlap = coarse_horizontal_overlap

    def generate(self, coarse: TensorMapping,
                 generator: torch.Generator | None = None,
                 n_samples: int = 1, static=None, draws=None) -> TensorDict:
        """``static`` is the fine static stack over the same extent as
        ``coarse`` (the model's full grid by default); each patch takes
        its window. ``draws`` (one ``{"latents", "eps"}`` per patch) stand
        in for the generator's."""
        from ace_tpu_torch.downscaling.patching import (
            composite_patch_predictions,
            get_patches,
            scale_patch,
        )

        extent = next(iter(coarse.values())).shape[-2:]
        patches = get_patches(yx_extent=extent,
                              yx_patch_extent=self.coarse_patch_shape,
                              overlap=self.overlap,
                              drop_partial_patches=False)
        factor = self.model.config.downscale_factor
        full_static = (static if static is not None
                       else getattr(self.model, "static_inputs", None))
        use_static = (getattr(self.model.config, "use_fine_topography",
                              False) and full_static is not None)
        predictions = []
        for i, patch in enumerate(patches):
            sl_y, sl_x = patch.input_slice.y, patch.input_slice.x
            coarse_patch = {k: v[..., sl_y, sl_x] for k, v in coarse.items()}
            patch_static = None
            if use_static:
                patch_static = full_static[
                    sl_y.start * factor:sl_y.stop * factor,
                    sl_x.start * factor:sl_x.stop * factor]
            kw = draws[i] if draws is not None else {}
            predictions.append(self.model.generate(
                coarse_patch, generator, n_samples=n_samples,
                static=patch_static, **kw))
        fine_patches = [scale_patch(p, factor) for p in patches]
        return composite_patch_predictions(predictions, fine_patches)


@dataclasses.dataclass
class DeterministicModelConfig:
    """A deterministic (regression) downscaling model: "SwinIR" or the
    "interpolate" bilinear baseline, with ``DiffusionModel``'s
    ``loss_fn``/``generate``."""

    in_names: list[str]
    out_names: list[str]
    normalization: PairedNormalizationConfig
    loss: str = "MSE"
    module: str = "SwinIR"
    downscale_factor: int = 1
    embed_dim: int = 96
    depths: list[int] = dataclasses.field(default_factory=lambda: [4, 4, 4])
    num_heads: int = 4
    window_size: list[int] = dataclasses.field(
        default_factory=lambda: [4, 8]
    )

    def build(self, dataset_info: DatasetInfo,
              device=None) -> "DeterministicModel":
        return DeterministicModel(self, dataset_info, device=device)


class DeterministicModel:
    def __init__(self, config: DeterministicModelConfig,
                 dataset_info: DatasetInfo, device=None):
        self.config = config
        self.dataset_info = dataset_info
        self.device = get_device(device)
        self.static_inputs = None
        self.in_packer = Packer(config.in_names)
        self.out_packer = Packer(config.out_names)
        self.coarse_normalizer: StandardNormalizer = (
            config.normalization.coarse.build(config.in_names))
        self.fine_normalizer: StandardNormalizer = (
            config.normalization.fine.build(config.out_names))
        if config.module == "SwinIR":
            from ace_tpu_torch.downscaling.swinir import SwinIR

            self.net = SwinIR(
                in_channels=len(config.in_names),
                out_channels=len(config.out_names),
                upscale_factor=config.downscale_factor,
                embed_dim=config.embed_dim, depths=tuple(config.depths),
                num_heads=config.num_heads,
                window_size=tuple(config.window_size), device=self.device,
            )
        elif config.module == "interpolate":
            self.net = None  # the bilinear baseline: no parameters
        else:
            raise ValueError(f"unknown module {config.module!r}")

    def init_params(self, generator: torch.Generator | None = None):
        if self.net is not None:
            init_weights(self.net, generator)
        return self.net

    def _cond(self, coarse):
        return self.in_packer.pack(self.coarse_normalizer.normalize(
            {k: torch.as_tensor(v, device=self.device).float()
             for k, v in coarse.items()}))

    def _predict_norm(self, cond):
        if self.net is None:
            up = _upsample(cond, self.config.downscale_factor)
            idx = [self.config.in_names.index(n)
                   for n in self.config.out_names]
            return up[..., idx]
        return self.net(cond)

    def loss_fn(self, coarse: TensorMapping, fine: TensorMapping,
                generator=None, static=None, sigma=None, noise=None):
        target = self.out_packer.pack(self.fine_normalizer.normalize(
            {k: torch.as_tensor(v, device=self.device).float()
             for k, v in fine.items()}))
        pred = self._predict_norm(self._cond(coarse))
        if self.config.loss == "MSE":
            return ((pred - target) ** 2).mean()
        if self.config.loss == "L1":
            return (pred - target).abs().mean()
        raise ValueError(f"unknown loss {self.config.loss!r}")

    @torch.no_grad()
    def generate(self, coarse: TensorMapping, generator=None,
                 n_samples: int = 1, static=None, latents=None,
                 eps=None) -> TensorDict:
        pred = self._predict_norm(self._cond(coarse))
        stacked = pred[:, None].expand(-1, n_samples, *pred.shape[1:])
        result = {name: stacked[..., i]
                  for i, name in enumerate(self.config.out_names)}
        return self.fine_normalizer.denormalize(result)
