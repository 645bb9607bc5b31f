"""Module (architecture) registry (port of ace_tpu/models/registry.py).

A registered builder turns channel counts and dataset info into an
``nn.Module`` with the contract ``module(x, noise=None, generator=None,
deterministic=True)`` on ``[batch, *spatial, n_in] -> [batch, *spatial,
n_out]``, the spatial axes ``[nlat, nlon]`` or, on HEALPix, ``[12, nside,
nside]`` (``deterministic`` False turns on dropout, drawn from
``generator``). Each
builder keeps the JAX package's field surface, so a config dict (or the
config embedded in an ``ace_tpu`` checkpoint) builds both packages;
options the port does not implement yet raise ``NotImplementedError``.
A conditional module's ``n_labels`` tells the step to pass it the batch's
labels.
"""

import abc
import dataclasses
from typing import Any, ClassVar

import numpy as np
import torch
from torch import nn

from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.registry import Registry, Selector
from ace_tpu_torch.models.layers import Linear

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise NotImplementedError(f"compute_dtype {name!r}; ported: {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass
class ModuleConfig(abc.ABC):
    @abc.abstractmethod
    def build(self, n_in_channels: int, n_out_channels: int,
              dataset_info: DatasetInfo, device=None) -> nn.Module: ...


# builders that take label conditioning (the JAX package's
# CONDITIONAL_BUILDERS, ace_tpu/models/registry.py:37)
CONDITIONAL_BUILDERS = (
    "NoiseConditionedSFNO",
    "LocalNet",
    "SwinTransformer",
    "NoiseConditionedSwinTransformer",
)


@dataclasses.dataclass
class ModuleSelector(Selector):
    """``{type, config}`` module selection (port of
    ace_tpu/models/registry.py:46).

    conditional: condition predictions on the batch's labels; the builder
        must be one of ``CONDITIONAL_BUILDERS`` and the dataset must have
        labels. When False the module is built as if the dataset had none.
    allow_missing_variables: the loader may give NaN-filled placeholders
        and presence masks for variables a dataset lacks (read through
        ``StepSelector.allow_missing_variables``).
    """

    conditional: bool = False
    allow_missing_variables: bool = False

    _registry: ClassVar[Registry] = Registry()

    def __post_init__(self):
        if self.conditional and self.type not in CONDITIONAL_BUILDERS:
            raise ValueError(
                "Conditional predictions require a conditional builder, "
                f"got {self.type} (available: {CONDITIONAL_BUILDERS})"
            )
        super().__post_init__()

    @classmethod
    def get_registry(cls) -> Registry:
        return cls._registry

    @classmethod
    def register(cls, name: str):
        return cls._registry.register(name)

    def get_state(self) -> dict:
        state = super().get_state()
        state["conditional"] = self.conditional
        state["allow_missing_variables"] = self.allow_missing_variables
        return state

    def build(self, n_in_channels, n_out_channels, dataset_info,
              device=None) -> nn.Module:
        if self.conditional and len(dataset_info.all_labels) == 0:
            raise ValueError("Conditional predictions require labels")
        if not self.conditional and dataset_info.all_labels:
            # unconditional models ignore the dataset's labels
            dataset_info = dataclasses.replace(dataset_info, all_labels=())
        return self.instance.build(
            n_in_channels, n_out_channels, dataset_info, device=device
        )


@ModuleSelector.register("SphericalFourierNeuralOperatorNet")
@dataclasses.dataclass
class SphericalFourierNeuralOperatorBuilder(ModuleConfig):
    """SFNO builder with the JAX package's fields and defaults (port of
    ace_tpu/models/registry.py:97). As there, ``factorization``, ``rank``
    and the makani fields are accepted and not passed to the network."""

    spectral_transform: str = "sht"
    filter_type: str = "linear"
    operator_type: str = "diagonal"
    scale_factor: int = 1
    residual_filter_factor: int = 1
    embed_dim: int = 256
    num_layers: int = 12
    hard_thresholding_fraction: float = 1.0
    normalization_layer: str = "instance_norm"
    use_mlp: bool = True
    mlp_ratio: float = 2.0
    activation_function: str = "gelu"
    encoder_layers: int = 1
    pos_embed: bool = True
    big_skip: bool = True
    rank: float = 1.0
    factorization: str | None = None
    separable: bool = False
    complex_network: bool = True
    complex_activation: str = "real"
    spectral_layers: int = 1
    checkpointing: int = 0
    drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    data_grid: str = "legendre-gauss"
    # "default" | "high" | "highest": accepted; the port computes float32
    # (see SphericalFourierNeuralOperatorNet)
    spectral_precision: str = "high"
    compute_dtype: str = "float32"

    def build(self, n_in_channels, n_out_channels, dataset_info, device=None):
        from ace_tpu_torch.models.sfno import SphericalFourierNeuralOperatorNet

        if self.filter_type != "linear":
            raise NotImplementedError("only filter_type='linear' is supported")
        return SphericalFourierNeuralOperatorNet(
            img_shape=dataset_info.img_shape,
            in_chans=n_in_channels,
            out_chans=n_out_channels,
            spectral_transform=self.spectral_transform,
            spectral_precision=self.spectral_precision,
            embed_dim=self.embed_dim,
            num_layers=self.num_layers,
            operator_type=self.operator_type,
            scale_factor=self.scale_factor,
            residual_filter_factor=self.residual_filter_factor,
            hard_thresholding_fraction=self.hard_thresholding_fraction,
            normalization_layer=self.normalization_layer,
            use_mlp=self.use_mlp,
            mlp_ratio=self.mlp_ratio,
            activation_function=self.activation_function,
            encoder_layers=self.encoder_layers,
            pos_embed=self.pos_embed,
            big_skip=self.big_skip,
            separable=self.separable,
            drop_rate=self.drop_rate,
            drop_path_rate=self.drop_path_rate,
            data_grid=self.data_grid,
            checkpointing=self.checkpointing,
            dtype=compute_dtype(self.compute_dtype),
            device=device,
        )


@ModuleSelector.register("SFNO-v0.1.0")
@dataclasses.dataclass
class SFNO_V0_1_0(ModuleConfig):
    """SFNO at the makani-0.1.0 config surface, with the JAX package's
    fields and defaults (port of ace_tpu/models/registry.py:164)."""

    spectral_transform: str = "sht"
    filter_type: str = "linear"
    operator_type: str = "dhconv"
    scale_factor: int = 16
    embed_dim: int = 256
    num_layers: int = 12
    repeat_layers: int = 1
    hard_thresholding_fraction: float = 1.0
    normalization_layer: str = "instance_norm"
    use_mlp: bool = True
    mlp_ratio: float = 2.0
    activation_function: str = "gelu"
    encoder_layers: int = 1
    pos_embed: str = "direct"
    big_skip: bool = True
    rank: float = 1.0
    factorization: str | None = None
    separable: bool = False
    complex_activation: str = "real"
    spectral_layers: int = 1
    checkpointing: int = 0
    data_grid: str = "legendre-gauss"
    compute_dtype: str = "float32"

    def build(self, n_in_channels, n_out_channels, dataset_info, device=None):
        from ace_tpu_torch.models.sfno import SphericalFourierNeuralOperatorNet

        return SphericalFourierNeuralOperatorNet(
            img_shape=dataset_info.img_shape,
            in_chans=n_in_channels,
            out_chans=n_out_channels,
            spectral_transform=self.spectral_transform,
            embed_dim=self.embed_dim,
            num_layers=self.num_layers,
            operator_type=self.operator_type,
            scale_factor=self.scale_factor,
            hard_thresholding_fraction=self.hard_thresholding_fraction,
            normalization_layer=self.normalization_layer,
            use_mlp=self.use_mlp,
            mlp_ratio=self.mlp_ratio,
            activation_function=self.activation_function,
            encoder_layers=self.encoder_layers,
            pos_embed=self.pos_embed,
            repeat_layers=self.repeat_layers,
            big_skip=self.big_skip,
            separable=self.separable,
            factorization=self.factorization,
            rank=self.rank,
            data_grid=self.data_grid,
            checkpointing=self.checkpointing,
            dtype=compute_dtype(self.compute_dtype),
            device=device,
        )


_PREBUILT: dict[str, nn.Module] = {}


def register_prebuilt_module(key: str, module: nn.Module):
    """Make ``module`` (built outside the registry, with the registry's
    module contract) the one that ``{type: prebuilt, config: {module_key:
    key}}`` selects."""
    _PREBUILT[key] = module


@ModuleSelector.register("prebuilt")
@dataclasses.dataclass
class PreBuiltBuilder(ModuleConfig):
    """A module registered with :func:`register_prebuilt_module` (port of
    ace_tpu/models/registry.py:238), moved to ``device``."""

    module_key: str = "default"

    def build(self, n_in_channels, n_out_channels, dataset_info, device=None):
        return _PREBUILT[self.module_key].to(device)


class LinearModule(nn.Module):
    """Per-point linear net (port of ace_tpu/models/registry.py:255):
    flax's ``Dense`` named ``linear``, default-initialized."""

    def __init__(self, in_channels, out_channels, device=None):
        super().__init__()
        self.linear = Linear(in_channels, out_channels, device=device,
                             init="lecun_normal")

    def forward(self, x, noise=None, generator=None, deterministic=True):
        return self.linear(x)


class MLPModule(nn.Module):
    """Small per-point MLP (port of ace_tpu/models/registry.py:266):
    ``hidden_{i}`` denses with the erf GELU, then ``out``."""

    def __init__(self, in_channels, hidden_channels, out_channels,
                 num_hidden_layers=1, device=None):
        super().__init__()
        self.num_hidden_layers = num_hidden_layers
        width = in_channels
        for i in range(num_hidden_layers):
            self.add_module(f"hidden_{i}", Linear(
                width, hidden_channels, device=device, init="lecun_normal"))
            width = hidden_channels
        self.out = Linear(width, out_channels, device=device,
                          init="lecun_normal")

    def forward(self, x, noise=None, generator=None, deterministic=True):
        for i in range(self.num_hidden_layers):
            x = torch.nn.functional.gelu(getattr(self, f"hidden_{i}")(x))
        return self.out(x)


@ModuleSelector.register("MLP")
@dataclasses.dataclass
class MLPBuilder(ModuleConfig):
    hidden_channels: int = 32
    num_hidden_layers: int = 1

    def build(self, n_in_channels, n_out_channels, dataset_info, device=None):
        return MLPModule(n_in_channels, self.hidden_channels, n_out_channels,
                         num_hidden_layers=self.num_hidden_layers,
                         device=device)


@ModuleSelector.register("Linear")
@dataclasses.dataclass
class LinearBuilder(ModuleConfig):
    def build(self, n_in_channels, n_out_channels, dataset_info, device=None):
        return LinearModule(n_in_channels, n_out_channels, device=device)


@ModuleSelector.register("Samudra")
@dataclasses.dataclass
class SamudraBuilder(ModuleConfig):
    """Samudra builder with the JAX package's fields and defaults (port of
    ace_tpu/models/registry.py:390). As there, ``n_layers`` and ``pad``
    are accepted and not passed to the network (one block a level,
    circular longitude padding)."""

    ch_width: list[int] = dataclasses.field(
        default_factory=lambda: [200, 250, 300, 400]
    )
    n_layers: list[int] = dataclasses.field(
        default_factory=lambda: [1, 1, 1, 1]
    )
    dilation: list[int] = dataclasses.field(
        default_factory=lambda: [1, 2, 4, 8]
    )
    pad: str = "circular"
    norm: str = "instance"
    upscale_factor: int = 4
    zonally_periodic_upsample: bool = False
    compute_dtype: str = "float32"

    def build(self, n_in_channels, n_out_channels, dataset_info, device=None):
        from ace_tpu_torch.models.samudra import Samudra

        return Samudra(
            in_channels=n_in_channels,
            out_channels=n_out_channels,
            ch_width=tuple(self.ch_width),
            dilation=tuple(self.dilation),
            norm=self.norm,
            upscale_factor=self.upscale_factor,
            zonally_periodic_upsample=self.zonally_periodic_upsample,
            dtype=compute_dtype(self.compute_dtype),
            device=device,
        )


@ModuleSelector.register("NoiseConditionedSFNO")
@dataclasses.dataclass
class NoiseConditionedSFNOBuilder(ModuleConfig):
    """Noise-conditioned SFNO config with the JAX package's field surface
    (port of ace_tpu/models/registry.py:294). Fields the JAX builder
    accepts but does not read are accepted and ignored here too."""

    spectral_transform: str = "sht"
    filter_type: str = "linear"
    operator_type: str = "dhconv"
    residual_filter_factor: int = 1
    embed_dim: int = 256
    noise_embed_dim: int = 256
    context_pos_embed_dim: int = 0
    label_embed_dim: int = 0
    noise_type: str = "gaussian"  # "gaussian" | "isotropic"
    global_layer_norm: bool = False
    num_layers: int = 12
    use_mlp: bool = True
    mlp_ratio: float = 2.0
    activation_function: str = "gelu"
    encoder_layers: int = 1
    pos_embed: bool = True
    big_skip: bool = True
    rank: float = 1.0
    factorization: None = None
    separable: bool = False
    complex_network: bool = True
    complex_activation: str = "real"
    spectral_layers: int = 1
    checkpointing: int = 0
    data_grid: str = "legendre-gauss"
    filter_residual: bool = False
    filter_output: bool = False
    normalize_big_skip: bool = False
    affine_norms: bool = False
    filter_num_groups: int = 1
    local_blocks: list[int] | None = None
    kernel_shape: tuple[int, int] = (3, 3)
    basis_type: str = "morlet"
    spectral_ratio: float = 1.0
    lora_rank: int = 0
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.operator_type != "dhconv":
            raise ValueError(
                "Only 'dhconv' operator_type is supported for "
                "NoiseConditionedSFNO models."
            )
        if self.separable:
            raise ValueError("'separable' is not supported")
        compute_dtype(self.compute_dtype)

    def build(self, n_in_channels, n_out_channels, dataset_info, device=None):
        from ace_tpu_torch.models.conditional_sfno import NoiseConditionedSFNO

        return NoiseConditionedSFNO(
            img_shape=dataset_info.img_shape,
            in_chans=n_in_channels,
            out_chans=n_out_channels,
            embed_dim=self.embed_dim,
            noise_embed_dim=self.noise_embed_dim,
            noise_type=self.noise_type,
            num_layers=self.num_layers,
            mlp_ratio=self.mlp_ratio,
            activation_function=self.activation_function,
            encoder_layers=self.encoder_layers,
            use_mlp=self.use_mlp,
            pos_embed=self.pos_embed,
            big_skip=self.big_skip,
            normalize_big_skip=self.normalize_big_skip,
            affine_norms=self.affine_norms,
            global_layer_norm=self.global_layer_norm,
            filter_residual=self.filter_residual,
            filter_output=self.filter_output,
            residual_filter_factor=self.residual_filter_factor,
            local_blocks=(tuple(self.local_blocks)
                          if self.local_blocks is not None else None),
            kernel_shape=tuple(self.kernel_shape),
            basis_type=self.basis_type,
            spectral_ratio=self.spectral_ratio,
            lora_rank=self.lora_rank,
            n_labels=len(dataset_info.all_labels),
            label_embed_dim=self.label_embed_dim,
            data_grid=self.data_grid,
            checkpointing=self.checkpointing,
            dtype=compute_dtype(self.compute_dtype),
            device=device,
        )


@ModuleSelector.register("LocalNet")
@dataclasses.dataclass
class LocalNetBuilder(ModuleConfig):
    """LocalNet builder with the JAX package's fields and defaults (port
    of ace_tpu/models/registry.py:715). The data grid is the dataset's;
    the network computes in float32 and takes no labels."""

    embed_dim: int = 256
    kernel_shape: tuple[int, int] = (3, 3)
    basis_type: str = "piecewise linear"
    noise_embed_dim: int = 256
    noise_type: str = "gaussian"
    block_types: list[str] = dataclasses.field(
        default_factory=lambda: [
            "disco", "disco", "disco", "disco",
            "conv1x1", "conv1x1", "conv1x1", "conv1x1",
        ]
    )
    global_layer_norm: bool = False
    use_mlp: bool = True
    mlp_ratio: float = 2.0
    activation_function: str = "gelu"
    encoder_layers: int = 1
    pos_embed: bool = True
    big_skip: bool = True
    normalize_big_skip: bool = True
    affine_norms: bool = True
    lora_rank: int = 0
    lora_alpha: float | None = None

    def build(self, n_in_channels, n_out_channels, dataset_info, device=None):
        from ace_tpu_torch.models.localnet import LocalNet

        return LocalNet(
            img_shape=dataset_info.img_shape,
            in_chans=n_in_channels,
            out_chans=n_out_channels,
            embed_dim=self.embed_dim,
            kernel_shape=tuple(self.kernel_shape),
            basis_type=self.basis_type,
            noise_embed_dim=self.noise_embed_dim,
            noise_type=self.noise_type,
            block_types=tuple(self.block_types),
            global_layer_norm=self.global_layer_norm,
            use_mlp=self.use_mlp,
            mlp_ratio=self.mlp_ratio,
            activation_function=self.activation_function,
            encoder_layers=self.encoder_layers,
            pos_embed=self.pos_embed,
            big_skip=self.big_skip,
            normalize_big_skip=self.normalize_big_skip,
            affine_norms=self.affine_norms,
            lora_rank=self.lora_rank,
            lora_alpha=self.lora_alpha,
            data_grid=dataset_info.horizontal_coordinates.grid,
            device=device,
        )


@ModuleSelector.register("AnkurLocalNet")
@dataclasses.dataclass
class AnkurLocalNetBuilder(ModuleConfig):
    """AnkurLocalNet builder with the JAX package's fields and defaults
    (port of ace_tpu/models/registry.py:643); the data grid is the
    dataset's."""

    embed_dim: int = 256
    use_disco_encoder: bool = True
    disco_kernel_size: int = 3
    pos_embed: bool = False
    activation_function: str = "gelu"

    def build(self, n_in_channels, n_out_channels, dataset_info, device=None):
        from ace_tpu_torch.models.localnet import AnkurLocalNet

        return AnkurLocalNet(
            img_shape=dataset_info.img_shape,
            in_chans=n_in_channels,
            out_chans=n_out_channels,
            embed_dim=self.embed_dim,
            use_disco_encoder=self.use_disco_encoder,
            disco_kernel_size=self.disco_kernel_size,
            pos_embed=self.pos_embed,
            activation_function=self.activation_function,
            data_grid=dataset_info.horizontal_coordinates.grid,
            device=device,
        )


@ModuleSelector.register("HEALPixUNet")
@dataclasses.dataclass
class HEALPixUNetBuilder(ModuleConfig):
    """DLWP-style HEALPix UNet builder with the JAX package's fields (port
    of ace_tpu/models/registry.py:427): ``encoder`` and ``decoder`` are
    ``UNetEncoderConfig``/``UNetDecoderConfig`` dicts (``block_type``
    selects each block), ``None`` for the defaults. Takes no labels."""

    encoder: Any = None
    decoder: Any = None
    compute_dtype: str = "float32"

    def __post_init__(self):
        from ace_tpu_torch.core.config import from_dict
        from ace_tpu_torch.models.healpix import (
            UNetDecoderConfig,
            UNetEncoderConfig,
        )

        if isinstance(self.encoder, dict):
            self.encoder = from_dict(UNetEncoderConfig, self.encoder)
        if isinstance(self.decoder, dict):
            self.decoder = from_dict(UNetDecoderConfig, self.decoder)

    def build(self, n_in_channels, n_out_channels, dataset_info, device=None):
        from ace_tpu_torch.models.healpix import HEALPixUNet

        if len(dataset_info.all_labels) > 0:
            raise ValueError("HEALPixUNet does not support labels")
        return HEALPixUNet(
            n_in_channels, n_out_channels, encoder=self.encoder,
            decoder=self.decoder, dtype=compute_dtype(self.compute_dtype),
            device=device,
        )


def _swin_lat_coords(dataset_info, use_cpb_scaling: bool):
    """1D latitudes for the cos-lat position bias, or None when disabled
    (port of ace_tpu/models/registry.py:468)."""
    if not use_cpb_scaling:
        return None
    lat = getattr(dataset_info.horizontal_coordinates, "lat", None)
    if lat is None:
        raise ValueError(
            "SwinTransformer requires 1D latitude coordinates for "
            "cos-lat CPB scaling (set use_cpb_scaling=False to disable)"
        )
    return tuple(np.asarray(lat, np.float64).tolist())


def _swin_padding_kwargs(padding_conf):
    if not padding_conf or not padding_conf.get("activate", False):
        return {}
    return {
        "padding_mode": padding_conf.get("mode", "earth"),
        "pad_lat": tuple(padding_conf.get("pad_lat", [40, 40])),
        "pad_lon": tuple(padding_conf.get("pad_lon", [40, 40])),
    }


@ModuleSelector.register("NoiseConditionedSwinTransformer")
@dataclasses.dataclass
class NoiseConditionedSwinTransformerBuilder(ModuleConfig):
    """Stochastic Swin U-Net: a fresh Gaussian noise field each forward
    conditions every block's ConditionalLayerNorm (port of
    ace_tpu/models/registry.py:497)."""

    embed_dim: int = 96
    depth_multiplier: int = 1
    num_heads: list[int] = dataclasses.field(
        default_factory=lambda: [3, 6, 6, 3]
    )
    window_size: list[int] = dataclasses.field(default_factory=lambda: [4, 8])
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.2
    use_skip: bool = True
    mlp_layer: str = "mlp"
    noise_embed_dim: int = 256
    label_embed_dim: int = 0
    cpb_hidden_dim: int = 64
    padding_conf: dict | None = None
    use_cpb_scaling: bool = True
    compute_dtype: str = "float32"

    def build(self, n_in_channels, n_out_channels, dataset_info, device=None):
        from ace_tpu_torch.models.swin import SwinTransformerNet

        return SwinTransformerNet(
            n_in_channels, n_out_channels, tuple(dataset_info.img_shape),
            embed_dim=self.embed_dim,
            depth_multiplier=self.depth_multiplier,
            num_heads=tuple(self.num_heads),
            window_size=(self.window_size[0], self.window_size[1]),
            mlp_ratio=self.mlp_ratio,
            drop_path_rate=self.drop_path_rate,
            use_skip=self.use_skip,
            mlp_layer=self.mlp_layer,
            conditioning="cln",
            n_labels=len(dataset_info.all_labels),
            label_embed_dim=self.label_embed_dim,
            noise_embed_dim=self.noise_embed_dim,
            cpb_hidden_dim=self.cpb_hidden_dim,
            lat_coords=_swin_lat_coords(dataset_info, self.use_cpb_scaling),
            dtype=compute_dtype(self.compute_dtype),
            device=device,
            **_swin_padding_kwargs(self.padding_conf),
        )


@ModuleSelector.register("SwinTransformer")
@dataclasses.dataclass
class SwinTransformerBuilder(ModuleConfig):
    """Deterministic Swin U-Net, AdaLN label conditioning when the dataset
    has labels (port of ace_tpu/models/registry.py:546)."""

    embed_dim: int = 96
    depth_multiplier: int = 1
    num_heads: list[int] = dataclasses.field(
        default_factory=lambda: [3, 6, 6, 3]
    )
    window_size: list[int] = dataclasses.field(default_factory=lambda: [4, 8])
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.2
    use_skip: bool = True
    mlp_layer: str = "mlp"
    embed_dim_scalar: int = 0
    cpb_hidden_dim: int = 64
    padding_conf: dict | None = None
    use_cpb_scaling: bool = True
    compute_dtype: str = "float32"

    def build(self, n_in_channels, n_out_channels, dataset_info, device=None):
        from ace_tpu_torch.models.swin import SwinTransformerNet

        return SwinTransformerNet(
            n_in_channels, n_out_channels, tuple(dataset_info.img_shape),
            embed_dim=self.embed_dim,
            depth_multiplier=self.depth_multiplier,
            num_heads=tuple(self.num_heads),
            window_size=(self.window_size[0], self.window_size[1]),
            mlp_ratio=self.mlp_ratio,
            drop_path_rate=self.drop_path_rate,
            use_skip=self.use_skip,
            mlp_layer=self.mlp_layer,
            conditioning="adaln",
            embed_dim_scalar=self.embed_dim_scalar,
            n_labels=len(dataset_info.all_labels),
            cpb_hidden_dim=self.cpb_hidden_dim,
            lat_coords=_swin_lat_coords(dataset_info, self.use_cpb_scaling),
            dtype=compute_dtype(self.compute_dtype),
            device=device,
            **_swin_padding_kwargs(self.padding_conf),
        )


class LandNetModule(nn.Module):
    """Per-column MLP land-surface net (port of
    ace_tpu/models/registry.py:592): ``hidden_{i}`` denses with ReLU, a
    learned ``pos_embed`` ``[1, H, W, dim]`` (standard normal) added after
    the first hidden layer when asked for, then ``out``."""

    def __init__(self, img_shape, in_channels, hidden_dims, out_channels,
                 use_positional_embedding=False, device=None):
        super().__init__()
        self.n_hidden = len(hidden_dims)
        width = in_channels
        for i, dim in enumerate(hidden_dims):
            self.add_module(f"hidden_{i}", Linear(
                width, dim, device=device, init="lecun_normal"))
            width = dim
        self.pos_embed = None
        if use_positional_embedding and hidden_dims:
            self.pos_embed = nn.Parameter(torch.empty(
                1, *img_shape, hidden_dims[0], device=device))
            self.reset_parameters()
        self.out = Linear(width, out_channels, device=device,
                          init="lecun_normal")

    def reset_parameters(self, generator=None):
        if self.pos_embed is not None:
            with torch.no_grad():
                self.pos_embed.normal_(0.0, 1.0, generator=generator)

    def forward(self, x, noise=None, generator=None, deterministic=True):
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"hidden_{i}")(x))
            if i == 0 and self.pos_embed is not None:
                x = x + self.pos_embed
        return self.out(x)


@ModuleSelector.register("LandNet")
@dataclasses.dataclass
class LandNetBuilder(ModuleConfig):
    """(port of ace_tpu/models/registry.py:626)."""

    hidden_dims: list[int] = dataclasses.field(
        default_factory=lambda: [64, 64]
    )
    network_type: str = "MLP"
    use_positional_embedding: bool = False

    def build(self, n_in_channels, n_out_channels, dataset_info, device=None):
        if self.network_type != "MLP":
            raise ValueError("network_type must be MLP")
        return LandNetModule(
            tuple(dataset_info.img_shape), n_in_channels,
            tuple(self.hidden_dims), n_out_channels,
            use_positional_embedding=self.use_positional_embedding,
            device=device,
        )


@ModuleSelector.register("FloeNet")
@ModuleSelector.register("GraphCast")
@dataclasses.dataclass
class FloeNetBuilder(ModuleConfig):
    """GraphCast-backbone sea-ice and ocean emulator (port of
    ace_tpu/models/registry.py:670). As there, ``is_ocean`` is accepted
    and no mask is passed: the full grid is used."""

    latent_dimension: int = 256
    activation: str = "silu"
    meshes: int = 6
    M0: int = 4
    bias: bool = True
    radius_fraction: float = 1.0
    layernorm: bool = True
    processor_steps: int = 4
    residual: bool = True
    is_ocean: bool = False

    def build(self, n_in_channels, n_out_channels, dataset_info, device=None):
        from ace_tpu_torch.models.graphcast import GraphCast

        hc = dataset_info.horizontal_coordinates
        lat2d, lon2d = np.meshgrid(hc.lat, hc.lon, indexing="ij")
        return GraphCast(
            img_shape=dataset_info.img_shape,
            in_chans=n_in_channels,
            out_chans=n_out_channels,
            lat2d=lat2d,
            lon2d=lon2d,
            latent_dimension=self.latent_dimension,
            activation=self.activation.lower(),
            meshes=self.meshes,
            M0=self.M0,
            use_bias=self.bias,
            radius_fraction=self.radius_fraction,
            layernorm=self.layernorm,
            processor_steps=self.processor_steps,
            residual=self.residual,
            device=device,
        )
