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
# the JAX package's builders that the port has not yet
_UNPORTED = ("SwinTransformer", "NoiseConditionedSwinTransformer",
             "LandNet", "FloeNet", "GraphCast")


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
        if self.type in _UNPORTED:
            raise NotImplementedError(
                f"{self.type} is not ported yet (ROADMAP Queue 1, "
                '"Other models")')
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
