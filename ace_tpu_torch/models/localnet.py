"""LocalNet and AnkurLocalNet: local (DISCO and 1x1) neural operators,
channels-last (port of ace_tpu/models/localnet.py).

``LocalNet`` is noise-conditioned like ``NoiseConditionedSFNO``: its
blocks' layer norms read per-pixel noise (gaussian, or SHT-synthesized
isotropic), zero when no generator is given. ``DiscoFilterLayer`` is also
the local filter of ``NoiseConditionedSFNO``'s ``local_blocks``. Every
DISCO convolution is built through ``ops/distributed_disco.py:build_disco``
and computes in float32, whatever the activation dtype. Parameter names
follow the flax tree (``LoRADense``'s ``base``, ``lora_a``, ``lora_b``;
a DISCO filter's ``weight``), so ``utils/convert.py`` maps them one to one.
"""

import math

import torch
from torch import nn

from ace_tpu_torch.models.conditional_sfno import (
    ConditionalLayerNorm,
    isotropic_noise,
)
from ace_tpu_torch.models.layers import MLP, Linear, trunc_normal_init
from ace_tpu_torch.models.sfno import _ACTIVATIONS
from ace_tpu_torch.ops.distributed_disco import build_disco
from ace_tpu_torch.ops.sht import build_isht


def compute_cutoff_radius(nlat: int, kernel_shape, basis_type: str) -> float:
    """The DISCO filter's cutoff radius for a grid of ``nlat`` latitudes
    (port of ace_tpu/models/localnet.py:25)."""
    factor = {
        "piecewise linear": 0.5,
        "morlet": 0.5,
        "isotropic morlet": 0.5,
        "zernike": math.sqrt(2.0),
    }[basis_type]
    return (kernel_shape[0] + 1) * factor * math.pi / float(nlat - 1)


class LoRADense(nn.Module):
    """Dense layer with an optional low-rank adapter (port of
    ace_tpu/models/localnet.py:36): ``base(x)``, plus ``(alpha / rank) *
    lora_b(lora_a(x))`` when ``lora_rank > 0``, ``lora_b`` zero-initialized
    so that the adapter starts inert."""

    def __init__(self, in_features, features, use_bias=True, lora_rank=0,
                 lora_alpha=None, dtype=torch.float32, device=None):
        super().__init__()
        self.base = Linear(in_features, features, bias=use_bias, dtype=dtype,
                           device=device)
        self.lora_rank = lora_rank
        if lora_rank > 0:
            alpha = lora_alpha if lora_alpha is not None else float(lora_rank)
            self.lora_scale = alpha / lora_rank
            self.lora_a = Linear(in_features, lora_rank, bias=False,
                                 dtype=dtype, device=device)
            self.lora_b = Linear(lora_rank, features, bias=False, dtype=dtype,
                                 device=device, init="zeros")

    def forward(self, x):
        y = self.base(x)
        if self.lora_rank > 0:
            y = y + self.lora_scale * self.lora_b(self.lora_a(x))
        return y


class DiscoFilterLayer(nn.Module):
    """A learned DISCO convolution (port of
    ace_tpu/models/localnet.py:74): the fixed-geometry contraction at twice
    ``compute_cutoff_radius`` and a ``[K, C, C]`` float32 weight over
    (kernel, channel), both in float32; the output is cast back to the
    input's dtype. The weight is applied before the inverse longitude DFT
    (``DiscoConvS2.mixed``): the same linear map as ``ace_tpu``'s
    contraction followed by the weight, over C rather than K x C channels."""

    def __init__(self, img_shape, channels, kernel_shape=(3, 3),
                 basis_type="piecewise linear", data_grid="equiangular",
                 device=None):
        super().__init__()
        theta_cutoff = 2 * compute_cutoff_radius(img_shape[0], kernel_shape,
                                                 basis_type)
        self.conv = build_disco(
            in_shape=tuple(img_shape), out_shape=tuple(img_shape),
            kernel_shape=tuple(kernel_shape), grid_in=data_grid,
            grid_out=data_grid, theta_cutoff=theta_cutoff,
            basis_type=basis_type, device=device,
        )
        k = self.conv.kernel_size
        self.init_std = math.sqrt(1.0 / (k * channels))
        self.weight = nn.Parameter(torch.empty(k, channels, channels,
                                               device=device))

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            nn.init.normal_(self.weight, std=self.init_std,
                            generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv.mixed(x, self.weight).to(x.dtype)


class GroupedDiscoConv(nn.Module):
    """The DISCO contraction and the grouped ``[K, G, Cin/G, Cout/G]``
    weight mixing (port of ace_tpu/models/fcn3.py:33), FourCastNet3's
    encoders, decoders and local blocks."""

    def __init__(self, in_shape, out_shape, in_chans, out_chans,
                 kernel_shape=(3, 3), grid_in="equiangular",
                 grid_out="legendre-gauss", groups=1, use_bias=False,
                 theta_cutoff_factor=1.0, weight_gain=1.0,
                 basis_type="piecewise linear", device=None):
        super().__init__()
        theta_cutoff = theta_cutoff_factor * compute_cutoff_radius(
            in_shape[0], kernel_shape, basis_type)
        self.conv = build_disco(
            in_shape=in_shape, out_shape=out_shape,
            kernel_shape=tuple(kernel_shape), grid_in=grid_in,
            grid_out=grid_out, theta_cutoff=theta_cutoff,
            basis_type=basis_type, device=device,
        )
        self.groups, self.out_chans = groups, out_chans
        self.cin_g, cout_g = in_chans // groups, out_chans // groups
        k = self.conv.kernel_size
        self.init_std = weight_gain * math.sqrt(1.0 / (k * self.cin_g))
        self.weight = nn.Parameter(torch.empty(
            k, groups, self.cin_g, cout_g, device=device))
        self.bias = (nn.Parameter(torch.empty(out_chans, device=device))
                     if use_bias else None)

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            nn.init.normal_(self.weight, std=self.init_std,
                            generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x.float())  # [..., H, W, K, Cin]
        y = y.reshape(*y.shape[:-1], self.groups, self.cin_g)
        out = torch.einsum("...jkgc,kgco->...jgo", y, self.weight)
        out = out.reshape(*out.shape[:-2], self.out_chans)
        if self.bias is not None:
            out = out + self.bias
        return out.to(x.dtype)


class GroupedDiscoFilterLayer(GroupedDiscoConv):
    """AnkurLocalNet's DISCO encoder (port of
    ace_tpu/models/localnet.py:404): one grid in and out, ``gcd(in, out)``
    groups, the single (not doubled) cutoff radius, no bias."""

    def __init__(self, img_shape, in_chans, out_chans, kernel_shape=(3, 3),
                 basis_type="morlet", data_grid="equiangular", device=None):
        super().__init__(
            tuple(img_shape), tuple(img_shape), in_chans, out_chans,
            kernel_shape=kernel_shape, grid_in=data_grid, grid_out=data_grid,
            groups=math.gcd(in_chans, out_chans), basis_type=basis_type,
            device=device,
        )


class LocalBlock(nn.Module):
    """norm0 -> local filter (``disco`` or ``conv1x1``) -> linear inner
    skip -> activation (``conv1x1`` only) -> norm1 -> MLP -> identity outer
    skip (port of ace_tpu/models/localnet.py:117, with the skips LocalNet
    builds it with)."""

    def __init__(self, img_shape, embed_dim, embed_dim_noise,
                 filter_type="disco", kernel_shape=(3, 3),
                 basis_type="piecewise linear", data_grid="equiangular",
                 global_layer_norm=False, mlp_ratio=2.0, activation="gelu",
                 use_mlp=True, affine_norms=True, lora_rank=0,
                 lora_alpha=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.act = _ACTIVATIONS[activation]
        self.filter_type = filter_type
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha, dtype=dtype,
                    device=device)
        norm = dict(global_layer_norm=global_layer_norm,
                    elementwise_affine=affine_norms, device=device)
        self.norm0 = ConditionalLayerNorm(embed_dim, embed_dim_noise, **norm)
        if filter_type == "disco":
            self.filter = DiscoFilterLayer(
                img_shape, embed_dim, kernel_shape=kernel_shape,
                basis_type=basis_type, data_grid=data_grid, device=device)
        elif filter_type == "conv1x1":
            self.filter = LoRADense(embed_dim, embed_dim, **lora)
        else:
            raise ValueError(f"unknown filter type {filter_type!r}")
        self.inner_skip = LoRADense(embed_dim, embed_dim, **lora)
        self.norm1 = ConditionalLayerNorm(embed_dim, embed_dim_noise, **norm)
        self.mlp = (MLP(embed_dim, int(embed_dim * mlp_ratio), embed_dim,
                        act=self.act, dtype=dtype, device=device)
                    if use_mlp else None)

    def forward(self, x, noise):
        x_norm = self.norm0(x, noise)
        h = self.filter(x_norm) + self.inner_skip(x_norm)
        if self.filter_type == "conv1x1":
            h = self.act(h)
        h = self.norm1(h, noise)
        if self.mlp is not None:
            h = self.mlp(h)
        return h + x_norm


class LocalNet(nn.Module):
    """(port of ace_tpu/models/localnet.py:204). ``forward(x, noise=None,
    generator=None, deterministic=True)`` maps ``[B, nlat, nlon,
    in_chans]`` to ``[B, nlat, nlon, out_chans]`` float32. The noise is
    ``noise`` when given, else drawn with ``generator`` (gaussian or
    isotropic), else zero; with ``noise_embed_dim`` 0 there is none. It
    takes no labels: a conditional LocalNet ignores them, as in JAX."""

    def __init__(self, img_shape, in_chans, out_chans, embed_dim=256,
                 kernel_shape=(3, 3), basis_type="piecewise linear",
                 noise_embed_dim=0, noise_type="gaussian",
                 block_types=("disco",) * 4 + ("conv1x1",) * 4,
                 global_layer_norm=False, use_mlp=True, mlp_ratio=2.0,
                 activation_function="gelu", encoder_layers=1,
                 pos_embed=True, big_skip=True, normalize_big_skip=True,
                 affine_norms=True, lora_rank=0, lora_alpha=None,
                 data_grid="equiangular", dtype=torch.float32, device=None):
        super().__init__()
        if noise_type not in ("gaussian", "isotropic"):
            raise ValueError(f"unknown noise_type {noise_type!r}")
        nlat, nlon = img_shape
        self.img_shape = (nlat, nlon)
        self.noise_embed_dim, self.noise_type = noise_embed_dim, noise_type
        self.dtype = dtype
        self.act = _ACTIVATIONS[activation_function]
        self.big_skip, self.normalize_big_skip = big_skip, normalize_big_skip
        self.isht = (build_isht(nlat, nlon, grid=data_grid, device=device)
                     if noise_type == "isotropic" else None)
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha, dtype=dtype,
                    device=device)
        if big_skip and normalize_big_skip:
            self.norm_big_skip = ConditionalLayerNorm(
                in_chans, noise_embed_dim,
                global_layer_norm=global_layer_norm,
                elementwise_affine=affine_norms, device=device)
        self.encoder_layers = encoder_layers
        width = in_chans
        for i in range(encoder_layers):
            self.add_module(f"encoder_{i}",
                            LoRADense(width, embed_dim, **lora))
            width = embed_dim
        self.encoder_out = LoRADense(width, embed_dim, use_bias=False, **lora)
        self.pos_embed = (
            nn.Parameter(torch.empty(1, nlat, nlon, embed_dim, device=device))
            if pos_embed else None
        )
        self.num_layers = len(block_types)
        for i, block_type in enumerate(block_types):
            self.add_module(f"block_{i}", LocalBlock(
                self.img_shape, embed_dim, noise_embed_dim,
                filter_type=block_type, kernel_shape=kernel_shape,
                basis_type=basis_type, data_grid=data_grid,
                global_layer_norm=global_layer_norm, mlp_ratio=mlp_ratio,
                activation=activation_function, use_mlp=use_mlp,
                affine_norms=affine_norms, lora_rank=lora_rank,
                lora_alpha=lora_alpha, dtype=dtype, device=device,
            ))
        width = embed_dim + (in_chans if big_skip else 0)
        for i in range(encoder_layers):
            self.add_module(f"decoder_{i}",
                            LoRADense(width, embed_dim, **lora))
            width = embed_dim
        self.decoder_out = LoRADense(width, out_chans, use_bias=False, **lora)

    def reset_parameters(self, generator=None):
        if self.pos_embed is not None:
            with torch.no_grad():
                trunc_normal_init(self.pos_embed, generator=generator)

    def make_noise(self, batch: int, generator: torch.Generator | None):
        """The noise ``[batch, nlat, nlon, noise_embed_dim]`` float32 drawn
        with ``generator`` (zero without one), or None without noise
        channels."""
        if self.noise_embed_dim == 0:
            return None
        nlat, nlon = self.img_shape
        device = self.encoder_out.base.weight.device
        shape = (batch, nlat, nlon, self.noise_embed_dim)
        if generator is None:
            return torch.zeros(shape, device=device)
        if self.noise_type == "gaussian":
            return torch.randn(shape, generator=generator, device=device)
        return isotropic_noise(self.isht, batch, self.noise_embed_dim,
                               generator)

    def forward(self, x, noise=None, generator=None, deterministic=True):
        # the model has no dropout: ``deterministic`` changes nothing
        if noise is None:
            noise = self.make_noise(x.shape[0], generator)
        act = self.act
        if self.big_skip:
            residual = x
            if self.normalize_big_skip:
                residual = self.norm_big_skip(residual, noise)
        h = x.to(self.dtype)
        for i in range(self.encoder_layers):
            h = act(getattr(self, f"encoder_{i}")(h))
        h = self.encoder_out(h)
        if self.pos_embed is not None:
            h = h + self.pos_embed.to(h.dtype)
        for i in range(self.num_layers):
            h = getattr(self, f"block_{i}")(h, noise)
        if self.big_skip:
            h = torch.cat([h, residual.to(h.dtype)], dim=-1)
        for i in range(self.encoder_layers):
            h = act(getattr(self, f"decoder_{i}")(h))
        return self.decoder_out(h).float()


class AnkurLocalNet(nn.Module):
    """A local diagnostic network of three hidden layers, the first
    optionally a grouped DISCO convolution, with an optional position
    embedding (port of ace_tpu/models/localnet.py:347)."""

    def __init__(self, img_shape, in_chans, out_chans, embed_dim=256,
                 use_disco_encoder=True, disco_kernel_size=3, pos_embed=False,
                 activation_function="gelu", basis_type="morlet",
                 data_grid="equiangular", dtype=torch.float32, device=None):
        super().__init__()
        self.act = _ACTIVATIONS[activation_function]
        self.dtype = dtype
        self.use_disco_encoder = use_disco_encoder
        if use_disco_encoder:
            self.disco_encoder = GroupedDiscoFilterLayer(
                img_shape, in_chans, embed_dim,
                kernel_shape=(disco_kernel_size, disco_kernel_size),
                basis_type=basis_type, data_grid=data_grid, device=device)
        for i in range(1 if use_disco_encoder else 0, 3):
            self.add_module(f"hidden_{i}", Linear(
                in_chans if i == 0 else embed_dim, embed_dim, dtype=dtype,
                device=device))
        self.pos_embed = (
            nn.Parameter(torch.empty(1, *img_shape, embed_dim, device=device))
            if pos_embed else None
        )
        self.out = Linear(embed_dim, out_chans, bias=False, dtype=dtype,
                          device=device)

    def reset_parameters(self, generator=None):
        if self.pos_embed is not None:
            with torch.no_grad():
                trunc_normal_init(self.pos_embed, generator=generator)

    def forward(self, x, noise=None, generator=None, deterministic=True):
        h = x.to(self.dtype)
        for i in range(3):
            if i == 0 and self.use_disco_encoder:
                h = self.disco_encoder(h)
            else:
                h = getattr(self, f"hidden_{i}")(h)
            if i == 0 and self.pos_embed is not None:
                h = h + self.pos_embed.to(h.dtype)
            h = self.act(h)
        return self.out(h).float()
