"""FourCastNet3, channels-last (port of ace_tpu/models/fcn3.py): a grouped
spherical neural operator with DISCO encoders and decoders and a
processor that alternates global (dhconv) and local (DISCO) blocks.

- DISCO convolutions are ``ops/disco.py``'s contraction; the grouped
  channel mixing is an einsum over the weight ``[K, G, Cin/G, Cout/G]``.
- The atmosphere's levels share one encoder and one decoder: the level
  (group) axis is folded into the batch.
- The decoder upsamples with a bilinear sphere resample
  (``ops/resample.py``) or an SHT round trip.
- Every processor block re-appends the auxiliary (forcing) embedding.

Submodules and parameters carry flax's names (``atmo_encoder.conv.weight``,
``block_0.global_conv.weight``, ``block_1.local_conv.weight``, ...), so
``utils/convert.py`` maps ``ace_tpu``'s trees. Everything computes in
float32, as ``ace_tpu``'s FCN3 does (its config has no compute dtype):
the global blocks take the spectral filter's float32 einsums, never the
kernels.
"""

import functools
import math

import torch
from torch import nn

from ace_tpu_torch.models.layers import MLP, LayerNorm
from ace_tpu_torch.models.localnet import GroupedDiscoConv
from ace_tpu_torch.models.sfno import _ACTIVATIONS, SpectralConvS2
from ace_tpu_torch.ops.resample import ResampleS2
from ace_tpu_torch.ops.sht import build_isht, build_sht


class DiscoEncoder(nn.Module):
    """A grouped DISCO convolution, then optionally the activation and an
    MLP (port of ace_tpu/models/fcn3.py:91)."""

    def __init__(self, inp_shape, out_shape, inp_chans, out_chans, grid_in,
                 grid_out, kernel_shape=(3, 3), groups=1, use_mlp=False,
                 mlp_ratio=2.0, activation="gelu", use_bias=False,
                 basis_type="piecewise linear", device=None):
        super().__init__()
        self.conv = GroupedDiscoConv(
            inp_shape, out_shape, inp_chans, out_chans,
            kernel_shape=kernel_shape, grid_in=grid_in, grid_out=grid_out,
            groups=groups, use_bias=use_bias,
            weight_gain=math.sqrt(2.0) if use_mlp else 1.0,
            basis_type=basis_type, device=device,
        )
        self.act = _ACTIVATIONS[activation]
        self.mlp = (MLP(out_chans, int(mlp_ratio * out_chans), out_chans,
                        act=self.act, device=device)
                    if use_mlp else None)

    def forward(self, x, deterministic: bool = True, generator=None):
        h = self.conv(x)
        if self.mlp is not None:
            h = self.mlp(self.act(h), deterministic, generator)
        return h


class DiscoDecoder(nn.Module):
    """Optionally an MLP, then the upsampling (bilinear, or the SHT round
    trip with ``upsample_sht``), then a grouped DISCO convolution at the
    output resolution (port of ace_tpu/models/fcn3.py:132)."""

    def __init__(self, inp_shape, out_shape, inp_chans, out_chans, grid_in,
                 grid_out, kernel_shape=(3, 3), groups=1, use_mlp=False,
                 mlp_ratio=2.0, activation="gelu", upsample_sht=False,
                 basis_type="piecewise linear", device=None):
        super().__init__()
        self.act = _ACTIVATIONS[activation]
        self.mlp = (MLP(inp_chans, int(mlp_ratio * inp_chans), inp_chans,
                        act=self.act, device=device)
                    if use_mlp else None)
        self.upsample_sht = upsample_sht
        if upsample_sht:
            self.sht = build_sht(*inp_shape, grid=grid_in, device=device)
            self.isht = build_isht(*out_shape, lmax=self.sht.lmax,
                                   mmax=self.sht.mmax, grid=grid_out,
                                   device=device)
        else:
            self.resample = ResampleS2(*inp_shape, *out_shape,
                                       grid_in=grid_in, grid_out=grid_out,
                                       device=device)
        self.conv = GroupedDiscoConv(
            out_shape, out_shape, inp_chans, out_chans,
            kernel_shape=kernel_shape, grid_in=grid_out, grid_out=grid_out,
            groups=groups, basis_type=basis_type, device=device,
        )

    def forward(self, x, deterministic: bool = True, generator=None):
        if self.mlp is not None:
            x = self.mlp(self.act(x), deterministic, generator)
        x32 = x.float()
        if self.upsample_sht:
            up = self.isht.inverse_pair(*self.sht.forward_pair(x32))
        else:
            up = self.resample(x32)
        return self.conv(up.to(x.dtype))


class FCN3Block(nn.Module):
    """The global (dhconv ``global_conv``) or local (DISCO ``local_conv``)
    convolution, the optional layer norm, the MLP, the layer scale and the
    residual over the first ``out_chans`` channels; the input may carry
    more (the auxiliary embedding) than it returns (port of
    ace_tpu/models/fcn3.py:196)."""

    def __init__(self, forward_transform, inverse_transform, inp_chans,
                 out_chans, conv_type="local", kernel_shape=(3, 3),
                 basis_type="piecewise linear", sht_grid="legendre-gauss",
                 mlp_ratio=2.0, activation="gelu", normalization="none",
                 use_mlp=True, layer_scale=True, use_bias=False,
                 device=None):
        super().__init__()
        self.conv_type, self.out_chans = conv_type, out_chans
        if conv_type == "global":
            self.global_conv = SpectralConvS2(
                forward_transform, inverse_transform, inp_chans, inp_chans,
                operator_type="dhconv", use_bias=use_bias, device=device)
        else:
            shape = (forward_transform.nlat, forward_transform.nlon)
            self.local_conv = GroupedDiscoConv(
                shape, shape, inp_chans, inp_chans,
                kernel_shape=kernel_shape, grid_in=sht_grid,
                grid_out=sht_grid, theta_cutoff_factor=2.0,
                basis_type=basis_type, device=device)
        self.norm = (LayerNorm(inp_chans, device=device)
                     if normalization == "layer_norm" else None)
        self.mlp = (MLP(inp_chans, int(inp_chans * mlp_ratio), out_chans,
                        act=_ACTIVATIONS[activation], device=device)
                    if use_mlp else None)
        self.layer_scale = (
            nn.Parameter(torch.empty(out_chans, device=device))
            if layer_scale else None)

    def reset_parameters(self, generator=None):
        if self.layer_scale is not None:
            with torch.no_grad():
                # per-channel scale, 0.1 at init (the reference's depthwise
                # 1x1 convolution)
                self.layer_scale.fill_(0.1)

    def forward(self, x, deterministic: bool = True, generator=None):
        if self.conv_type == "global":
            dx, _ = self.global_conv(x)
        else:
            dx = self.local_conv(x)
        if self.norm is not None:
            dx = self.norm(dx)
        if self.mlp is not None:
            dx = self.mlp(dx, deterministic, generator)
        else:
            dx = dx[..., : self.out_chans]
        if self.layer_scale is not None:
            dx = dx * self.layer_scale.to(dx.dtype)
        return x[..., : self.out_chans] + dx


def _fold_groups(x: torch.Tensor, groups: int, chans: int) -> torch.Tensor:
    """``[B, H, W, G * chans] -> [B * G, H, W, chans]`` (level-major,
    variables fastest)."""
    b, h, w, _ = x.shape
    x = x.reshape(b, h, w, groups, chans).movedim(-2, 1)
    return x.reshape(b * groups, h, w, chans)


def _unfold_groups(x: torch.Tensor, groups: int, chans: int) -> torch.Tensor:
    bg, h, w, _ = x.shape
    x = x.reshape(bg // groups, groups, h, w, chans).movedim(1, -2)
    return x.reshape(bg // groups, h, w, groups * chans)


class FourCastNet3(nn.Module):
    """FourCastNet3 (port of ace_tpu/models/fcn3.py:265).

    ``forward(x_atmo [B, H, W, G * Ca_in], x_surf [B, H, W, Cs_in], x_aux
    [B, H, W, Caux])`` returns ``(atmo_out [B, H, W, G * Ca], surf_out [B,
    H, W, Cs])`` (``surf_out`` None without surface channels). Atmosphere
    channels are level (group)-major, variables fastest.
    """

    def __init__(self, img_shape, n_atmo_channels, n_atmo_groups,
                 n_surf_channels, n_aux_channels,
                 n_atmo_diagnostic_channels=0, n_surf_diagnostic_channels=0,
                 model_grid_type="equiangular",
                 sht_grid_type="legendre-gauss", kernel_shape=(3, 3),
                 filter_basis_type="piecewise linear", scale_factor=8,
                 encoder_mlp=False, upsample_sht=False, atmo_embed_dim=8,
                 surf_embed_dim=8, aux_embed_dim=8, num_layers=4,
                 use_mlp=True, mlp_ratio=2.0, activation_function="gelu",
                 layer_scale=True, normalization_layer="none",
                 max_modes=None, hard_thresholding_fraction=1.0,
                 sfno_block_frequency=2, use_bias=False, device=None):
        super().__init__()
        nlat, nlon = img_shape
        self.img_shape = (nlat, nlon)
        self.h, self.w = int(nlat // scale_factor), int(nlon // scale_factor)
        if max_modes is not None:
            lmax = mmax = max_modes
        else:
            lmax = int(self.h * hard_thresholding_fraction)
            mmax = int((self.w // 2 + 1) * hard_thresholding_fraction)
        self.sht = build_sht(self.h, self.w, lmax=lmax, mmax=mmax,
                             grid=sht_grid_type, device=device)
        self.isht = build_isht(self.h, self.w, lmax=lmax, mmax=mmax,
                               grid=sht_grid_type, device=device)
        g = self.n_atmo_groups = n_atmo_groups
        self.n_atmo_channels = n_atmo_channels
        self.ca_in = n_atmo_channels - n_atmo_diagnostic_channels
        cs_in = n_surf_channels - n_surf_diagnostic_channels
        self.atmo_embed_dim = atmo_embed_dim
        self.surf_embed_dim = surf_embed_dim
        self.has_surf = n_surf_channels > 0
        self.has_aux = n_aux_channels > 0
        self.num_layers = num_layers
        # as ace_tpu counts it, with or without surface channels
        total_embed = g * atmo_embed_dim + surf_embed_dim
        common = dict(kernel_shape=kernel_shape,
                      basis_type=filter_basis_type, mlp_ratio=mlp_ratio,
                      activation=activation_function, device=device)
        coarse = (self.h, self.w)
        encoder = functools.partial(
            DiscoEncoder, self.img_shape, coarse, grid_in=model_grid_type,
            grid_out=sht_grid_type, use_mlp=encoder_mlp, use_bias=use_bias,
            **common)
        self.atmo_encoder = encoder(
            self.ca_in, atmo_embed_dim,
            groups=math.gcd(self.ca_in, atmo_embed_dim))
        if self.has_surf:
            self.surf_encoder = encoder(
                cs_in, surf_embed_dim, groups=math.gcd(cs_in, surf_embed_dim))
        if self.has_aux:
            self.aux_encoder = encoder(
                n_aux_channels, aux_embed_dim,
                groups=math.gcd(n_aux_channels, aux_embed_dim))
        inp_chans = total_embed + (aux_embed_dim if self.has_aux else 0)
        for i in range(num_layers):
            self.add_module(f"block_{i}", FCN3Block(
                self.sht, self.isht, inp_chans, total_embed,
                conv_type=("global" if i % sfno_block_frequency == 0
                           else "local"),
                sht_grid=sht_grid_type, normalization=normalization_layer,
                use_mlp=use_mlp, layer_scale=layer_scale, use_bias=use_bias,
                kernel_shape=kernel_shape, basis_type=filter_basis_type,
                mlp_ratio=mlp_ratio, activation=activation_function,
                device=device,
            ))
        decoder = functools.partial(
            DiscoDecoder, coarse, self.img_shape, grid_in=sht_grid_type,
            grid_out=model_grid_type, use_mlp=encoder_mlp,
            upsample_sht=upsample_sht, **common)
        self.atmo_decoder = decoder(
            atmo_embed_dim, n_atmo_channels,
            groups=math.gcd(n_atmo_channels, atmo_embed_dim))
        if self.has_surf:
            self.surf_decoder = decoder(
                surf_embed_dim, n_surf_channels,
                groups=math.gcd(n_surf_channels, surf_embed_dim))

    def forward(self, x_atmo, x_surf, x_aux, deterministic: bool = True,
                generator: torch.Generator | None = None):
        g, embed = self.n_atmo_groups, self.atmo_embed_dim
        kw = dict(deterministic=deterministic, generator=generator)
        # encode (the atmosphere's levels share one encoder)
        x = _unfold_groups(
            self.atmo_encoder(_fold_groups(x_atmo, g, self.ca_in), **kw),
            g, embed)
        if self.has_surf:
            x = torch.cat([x, self.surf_encoder(x_surf, **kw)], dim=-1)
        aux = self.aux_encoder(x_aux, **kw) if self.has_aux else None
        # processor
        for i in range(self.num_layers):
            if aux is not None:
                x = torch.cat([x, aux.to(x.dtype)], dim=-1)
            x = getattr(self, f"block_{i}")(x, **kw)
        # decode
        x_a = x[..., : g * embed]
        atmo_out = _unfold_groups(
            self.atmo_decoder(_fold_groups(x_a, g, embed), **kw),
            g, self.n_atmo_channels)
        surf_out = None
        if self.has_surf:
            surf_out = self.surf_decoder(x[..., -self.surf_embed_dim:], **kw)
        return atmo_out, surf_out
