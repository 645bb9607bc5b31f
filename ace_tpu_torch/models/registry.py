"""Module (architecture) registry (port of ace_tpu/models/registry.py).

A registered builder turns channel counts and dataset info into an
``nn.Module`` with the contract ``module(x, noise=None, generator=None)``
on ``[batch, nlat, nlon, n_in] -> [batch, nlat, nlon, n_out]``. Each
builder keeps the JAX package's field surface, so a config dict (or the
config embedded in an ``ace_tpu`` checkpoint) builds both packages;
options the port does not implement yet raise ``NotImplementedError``.
"""

import abc
import dataclasses
from typing import ClassVar

import torch
from torch import nn

from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.registry import Registry, Selector

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


@dataclasses.dataclass
class ModuleSelector(Selector):
    """``{type, config}`` module selection (port of
    ace_tpu/models/registry.py:46). Label-conditioned models and
    missing-variable masks are not ported yet."""

    conditional: bool = False
    allow_missing_variables: bool = False

    _registry: ClassVar[Registry] = Registry()

    def __post_init__(self):
        if self.conditional:
            raise NotImplementedError("conditional (label) models are not ported yet")
        if self.allow_missing_variables:
            raise NotImplementedError("allow_missing_variables is not ported yet")
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
        return self.instance.build(
            n_in_channels, n_out_channels, dataset_info, device=device
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
        unported = {
            "local_blocks": bool(self.local_blocks),
            "lora_rank > 0": self.lora_rank > 0,
            "spectral_ratio < 1": self.spectral_ratio < 1.0,
            "global_layer_norm": self.global_layer_norm,
        }
        for option, requested in unported.items():
            if requested:
                raise NotImplementedError(
                    f"NoiseConditionedSFNO option {option} is not ported yet"
                )
        compute_dtype(self.compute_dtype)

    def build(self, n_in_channels, n_out_channels, dataset_info, device=None):
        from ace_tpu_torch.models.conditional_sfno import NoiseConditionedSFNO

        # unconditional models ignore dataset labels, as in ace_tpu
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
            filter_residual=self.filter_residual,
            filter_output=self.filter_output,
            residual_filter_factor=self.residual_filter_factor,
            data_grid=self.data_grid,
            checkpointing=self.checkpointing,
            dtype=compute_dtype(self.compute_dtype),
            device=device,
        )
