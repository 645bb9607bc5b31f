"""HEALPix (DLWP-style) neighbour padding and UNet (port of
ace_tpu/models/healpix.py; face layout: faces 0-3 north, 4-7 equator,
8-11 south).

Data stay channels-last, ``[batch, 12, H, W, C]``, as in the JAX
package. ``healpix_pad`` is one gather: the source pixel of each padded
pixel comes from a host table, built once per face size and padding by
running the JAX package's rotations and concatenations on pixel indices;
the cells of the equatorial faces' corner wedges that average two
neighbours are computed as there, ``0.5 * a + 0.5 * b``, so the padded
faces equal the JAX package's bit for bit. A face convolution pads, then
runs ``F.conv2d`` without padding on the ``[batch * 12, C, H, W]`` view of
the channels-last tensor (channels-last memory, no copy). Convolution
kernels are ``F.conv2d``'s ``[out, in, kh, kw]`` under flax's name
``kernel`` (``models/samudra.py:Conv2d``), the transposed convolution's
too (``[out, in, r, r]``), so that ``utils/convert.py``'s rule for a 4-D
``kernel`` maps both to and from flax's ``[kh, kw, in, out]``. The
convolutions follow ``torch.backends.cudnn.allow_tf32`` on the card; the
entries pin float32.
"""

import dataclasses
import functools
from typing import Literal

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ace_tpu_torch.device import cached_on_device
from ace_tpu_torch.models.samudra import Conv2d, bilinear_upsample
from ace_tpu_torch.models.samudra import capped_gelu as _capped_gelu

# --- the padding's source table (numpy, on pixel indices) ---
#
# Each face array is [H, W, 2]: a pixel's pair of source indices, equal
# for a copied pixel. The code below is the JAX package's padding with
# its value arithmetic replaced by index bookkeeping (``_avg``).

_ROT_AXES = (-3, -2)


def _rot90(x, k):
    return np.rot90(x, k, axes=_ROT_AXES)


def _avg(a, b):
    """The cell that averages original pixels ``a`` and ``b``."""
    return np.stack([a[..., 0], b[..., 0]], axis=-1)


def _tl_corner(top, lft, p):
    """Synthetic top-left wedge for equatorial faces."""
    ret = np.full((p, p, 2), -1, np.int64)
    ret[-1, -1] = _avg(top[-1, 0], lft[0, -1])
    for i in range(1, p):
        ret[-i - 1, -i:] = top[-i - 1, :i]
        ret[-i:, -i - 1] = lft[:i, -i - 1]
        ret[-i - 1, -i - 1] = _avg(top[-i - 1, 0], lft[0, -i - 1])
    return ret


def _br_corner(b, r, p):
    """Synthetic bottom-right wedge for equatorial faces."""
    ret = np.full((p, p, 2), -1, np.int64)
    ret[0, 0] = _avg(b[0, -1], r[-1, 0])
    for i in range(1, p):
        ret[:i, i] = r[-i:, i]
        ret[i, :i] = b[i, -i:]
        ret[i, i] = _avg(b[i, -1], r[-1, i])
    return ret


def _pn(c, t, tl, lft, bl, b, br, rgt, tr, p):
    """North-face padding."""
    c = np.concatenate([_rot90(t, 1)[-p:], c, b[:p]], axis=-3)
    left = np.concatenate([
        _rot90(tl, 2)[-p:, -p:], _rot90(lft, -1)[:, -p:], bl[:p, -p:],
    ], axis=-3)
    right = np.concatenate([tr[-p:, :p], rgt[:, :p], br[:p, :p]], axis=-3)
    return np.concatenate([left, c, right], axis=-2)


def _pe(c, t, tl, lft, bl, b, br, rgt, tr, p):
    """Equatorial-face padding."""
    c = np.concatenate([t[-p:], c, b[:p]], axis=-3)
    left = np.concatenate([tl, lft[:, -p:], bl[:p, -p:]], axis=-3)
    right = np.concatenate([tr[-p:, :p], rgt[:, :p], br], axis=-3)
    return np.concatenate([left, c, right], axis=-2)


def _ps(c, t, tl, lft, bl, b, br, rgt, tr, p):
    """South-face padding."""
    c = np.concatenate([t[-p:], c, _rot90(b, 1)[:p]], axis=-3)
    left = np.concatenate([tl[-p:, -p:], lft[:, -p:], bl[:p, -p:]], axis=-3)
    right = np.concatenate([
        tr[-p:, :p], _rot90(rgt, -1)[:, :p], _rot90(br, 2)[:p, :p],
    ], axis=-3)
    return np.concatenate([left, c, right], axis=-2)


@functools.lru_cache(maxsize=32)
def pad_sources(h: int, w: int, p: int):
    """The padding of ``[12, h, w]`` faces by ``p`` as flat pixel indices
    into the faces: ``(src, cells, a, b)``: each padded pixel's source
    ``src`` ``[12 (h + 2p) (w + 2p)]``, and the padded pixels ``cells``
    that average sources ``a`` and ``b`` instead."""
    idx = np.arange(12 * h * w).reshape(12, h, w)
    f = list(np.stack([idx, idx], axis=-1))
    padded = np.stack([
        _pn(f[0], f[1], f[2], f[3], f[3], f[4], f[8], f[5], f[1], p),
        _pn(f[1], f[2], f[3], f[0], f[0], f[5], f[9], f[6], f[2], p),
        _pn(f[2], f[3], f[0], f[1], f[1], f[6], f[10], f[7], f[3], p),
        _pn(f[3], f[0], f[1], f[2], f[2], f[7], f[11], f[4], f[0], p),
        _pe(f[4], f[0], _tl_corner(f[0], f[3], p), f[3], f[7], f[11],
            _br_corner(f[11], f[8], p), f[8], f[5], p),
        _pe(f[5], f[1], _tl_corner(f[1], f[0], p), f[0], f[4], f[8],
            _br_corner(f[8], f[9], p), f[9], f[6], p),
        _pe(f[6], f[2], _tl_corner(f[2], f[1], p), f[1], f[5], f[9],
            _br_corner(f[9], f[10], p), f[10], f[7], p),
        _pe(f[7], f[3], _tl_corner(f[3], f[2], p), f[2], f[6], f[10],
            _br_corner(f[10], f[11], p), f[11], f[4], p),
        _ps(f[8], f[5], f[0], f[4], f[11], f[11], f[10], f[9], f[9], p),
        _ps(f[9], f[6], f[1], f[5], f[8], f[8], f[11], f[10], f[10], p),
        _ps(f[10], f[7], f[2], f[6], f[9], f[9], f[8], f[11], f[11], p),
        _ps(f[11], f[4], f[3], f[7], f[10], f[10], f[9], f[8], f[8], p),
    ]).reshape(-1, 2)
    if (padded < 0).any():
        raise AssertionError("a padded pixel has no source")
    cells = np.flatnonzero(padded[:, 0] != padded[:, 1])
    return (np.ascontiguousarray(padded[:, 0]), cells,
            padded[cells, 0].copy(), padded[cells, 1].copy())


_PAD_TABLES: dict = {}


def healpix_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Pad all 12 faces with their neighbours' values:
    ``[..., 12, H, W, C] -> [..., 12, H + 2p, W + 2p, C]``."""
    *lead, faces, h, w, c = x.shape
    if faces != 12:
        raise ValueError(f"HEALPix data has 12 faces, got {faces}")
    tables = [cached_on_device(_PAD_TABLES, f"{h}/{w}/{p}/{i}", t, x.device)
              for i, t in enumerate(pad_sources(h, w, p))]
    src, cells, a, b = tables
    flat = x.reshape(*lead, 12 * h * w, c)
    avg = 0.5 * flat.index_select(-2, a) + 0.5 * flat.index_select(-2, b)
    out = flat.index_select(-2, src).index_copy(-2, cells, avg)
    return out.reshape(*lead, 12, h + 2 * p, w + 2 * p, c)


def capped_gelu(x: torch.Tensor, cap: float = 10.0) -> torch.Tensor:
    """The exact (erf) GELU, clamped at ``cap``."""
    return _capped_gelu(x, cap)


def _faces(x: torch.Tensor) -> torch.Tensor:
    """``[B, 12, H, W, C]`` as the ``[B * 12, C, H, W]`` view with
    channels-last strides."""
    return x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)


def _unfaces(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_faces`` for an output ``y`` of the faces of
    ``x``."""
    y = y.permute(0, 2, 3, 1)
    return y.reshape(*x.shape[:-3], *y.shape[1:])


class _FaceConv(nn.Module):
    """Neighbour-pad by ``((k - 1) // 2) * dilation``, then a convolution
    without padding of each face."""

    def __init__(self, in_channels, features, kernel_size=3, dilation=1,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.pad = ((kernel_size - 1) // 2) * dilation
        self.conv = Conv2d(in_channels, features, kernel_size, dilation,
                           dtype=dtype, device=device)

    def forward(self, x):
        if self.pad > 0:
            x = healpix_pad(x, self.pad)
        return _unfaces(self.conv(_faces(x)), x)


class BasicConvBlock(nn.Module):
    """``n_layers`` face convolutions, each followed by the capped GELU
    where ``cap_value`` is set."""

    def __init__(self, in_channels, out_channels, kernel_size=3, dilation=1,
                 n_layers=1, latent_channels=None, cap_value=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        latent = (max(in_channels, out_channels) if latent_channels is None
                  else latent_channels)
        self.n_layers, self.cap_value = n_layers, cap_value
        c = in_channels
        for n in range(n_layers):
            feats = out_channels if n == n_layers - 1 else latent
            self.add_module(f"conv_{n}", _FaceConv(
                c, feats, kernel_size, dilation, dtype, device))
            c = feats

    def forward(self, x):
        for n in range(self.n_layers):
            x = getattr(self, f"conv_{n}")(x)
            if self.cap_value is not None:
                x = capped_gelu(x, self.cap_value)
        return x


class _ActMixin:
    def _act(self, x):
        return x if self.cap_value is None else capped_gelu(x, self.cap_value)


class ConvNeXtBlock(_ActMixin, nn.Module):
    """k-conv up, k-conv, 1x1 down, plus a skip: the identity where the
    input width is ``out_channels``, else a 1x1 face convolution."""

    def __init__(self, in_channels, out_channels, latent_channels=1,
                 kernel_size=3, dilation=1, upscale_factor=4,
                 cap_value=None, dtype=torch.float32, device=None):
        super().__init__()
        self.cap_value = cap_value
        self.skip = (None if in_channels == out_channels else _FaceConv(
            in_channels, out_channels, 1, 1, dtype, device))
        hidden = int(latent_channels * upscale_factor)
        self.conv1 = _FaceConv(in_channels, hidden, kernel_size, dilation,
                               dtype, device)
        self.conv2 = _FaceConv(hidden, hidden, kernel_size, dilation, dtype,
                               device)
        self.conv3 = _FaceConv(hidden, out_channels, 1, 1, dtype, device)

    def forward(self, x):
        skip = x if self.skip is None else self.skip(x)
        h = self._act(self.conv1(x))
        h = self._act(self.conv2(h))
        return skip + self.conv3(h)


class SymmetricConvNeXtBlock(_ActMixin, nn.Module):
    """k-conv, 1x1 up, 1x1 down, k-conv, with the reference's skip: the
    identity where the input width is ``latent_channels``, else a 1x1
    face convolution to ``out_channels``."""

    def __init__(self, in_channels, out_channels, latent_channels=1,
                 kernel_size=3, dilation=1, upscale_factor=4,
                 cap_value=None, dtype=torch.float32, device=None):
        super().__init__()
        self.cap_value = cap_value
        latent = int(latent_channels)
        hidden = int(latent_channels * upscale_factor)
        self.skip = (None if in_channels == latent else _FaceConv(
            in_channels, out_channels, 1, 1, dtype, device))
        self.conv1 = _FaceConv(in_channels, latent, kernel_size, dilation,
                               dtype, device)
        self.conv2 = _FaceConv(latent, hidden, 1, dilation, dtype, device)
        self.conv3 = _FaceConv(hidden, latent, 1, dilation, dtype, device)
        self.conv4 = _FaceConv(latent, out_channels, kernel_size, dilation,
                               dtype, device)

    def forward(self, x):
        skip = x if self.skip is None else self.skip(x)
        h = self._act(self.conv1(x))
        h = self._act(self.conv2(h))
        h = self._act(self.conv3(h))
        return skip + self._act(self.conv4(h))


class MultiSymmetricConvNeXtBlock(nn.Module):
    """``n_layers`` stacked ``SymmetricConvNeXtBlock``s."""

    def __init__(self, in_channels, out_channels, latent_channels=1,
                 kernel_size=3, dilation=1, upscale_factor=4, n_layers=1,
                 cap_value=None, dtype=torch.float32, device=None):
        super().__init__()
        self.n_layers = n_layers
        c = in_channels
        for i in range(n_layers):
            self.add_module(f"blocks_{i}", SymmetricConvNeXtBlock(
                c, out_channels, latent_channels, kernel_size, dilation,
                upscale_factor, cap_value, dtype, device))
            c = out_channels

    def forward(self, x):
        for i in range(self.n_layers):
            x = getattr(self, f"blocks_{i}")(x)
        return x


def _pool_faces(x, pooling: int, reduce: str):
    """Per-face pooling with kernel = stride."""
    *b, h, w, c = x.shape
    r = x.reshape(*b, h // pooling, pooling, w // pooling, pooling, c)
    if reduce == "max":
        return r.amax(dim=(-4, -2))
    return r.mean(dim=(-4, -2))


class MaxPool(nn.Module):
    def __init__(self, pooling=2):
        super().__init__()
        self.pooling = pooling

    def forward(self, x):
        return _pool_faces(x, self.pooling, "max")


class AvgPool(nn.Module):
    def __init__(self, pooling=2):
        super().__init__()
        self.pooling = pooling

    def forward(self, x):
        return _pool_faces(x, self.pooling, "mean")


class DealiasedDownsample(nn.Module):
    """log2(stride) stages of a fixed depthwise blur at stride 2, each
    after a neighbour pad."""

    def __init__(self, in_channels, resample_filter=(1.0, 2.0, 1.0),
                 stride=2, dtype=torch.float32, device=None):
        super().__init__()
        f = np.asarray(resample_filter, np.float32)
        f2d = f[:, None] * f[None, :]
        f2d = f2d / f2d.sum()
        self.pad = (f.shape[0] - 1) // 2
        self.n_stages = int(np.log2(stride))
        self.compute_dtype = dtype
        kernel = np.tile(f2d[None, None], (in_channels, 1, 1, 1))
        self.register_buffer("kernel", torch.as_tensor(kernel, device=device),
                             persistent=False)

    def forward(self, x):
        c = x.shape[-1]
        kernel = self.kernel.to(self.compute_dtype)
        for _ in range(self.n_stages):
            if self.pad > 0:
                x = healpix_pad(x, self.pad)
            x = _unfaces(F.conv2d(_faces(x).to(self.compute_dtype), kernel,
                                  stride=2, groups=c), x)
        return x


class TransposedConvUpsample(nn.Module):
    """A transposed convolution with kernel = stride (disjoint output
    blocks): ``kernel`` ``[out, in, r, r]``, ``bias``; drawn as flax draws
    them (uniform of variance 1 / (3 r^2 out), zeros)."""

    def __init__(self, in_channels, out_channels, upsampling=2,
                 cap_value=None, dtype=torch.float32, device=None):
        super().__init__()
        r = upsampling
        self.upsampling, self.cap_value = r, cap_value
        self.compute_dtype = dtype
        self.kernel = nn.Parameter(torch.empty(out_channels, in_channels, r,
                                               r, device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        r, out = self.upsampling, self.kernel.shape[0]
        bound = (1.0 / (r * r * out)) ** 0.5
        with torch.no_grad():
            self.kernel.uniform_(-bound, bound, generator=generator)
            self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv_transpose2d(_faces(x).to(dt),
                               self.kernel.to(dt).transpose(0, 1),
                               self.bias.to(dt), stride=self.upsampling)
        y = _unfaces(y, x)
        if self.cap_value is not None:
            y = capped_gelu(y, self.cap_value)
        return y


def _upsample_faces(flat, r, mode):
    """``[N, C, H, W]`` upsampled by ``r``: nearest (repeat) or bilinear
    with half-pixel centres."""
    if mode == "nearest":
        return flat.repeat_interleave(r, dim=-2).repeat_interleave(r, dim=-1)
    return bilinear_upsample(flat, r)


class SmoothedInterpolateConv(nn.Module):
    """Neighbour-pad by 1, interpolate, four-point smooth, trim, then a
    face convolution."""

    def __init__(self, in_channels, out_channels, kernel_size=3,
                 scale_factor=2, mode="nearest", cap_value=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.scale_factor, self.mode = scale_factor, mode
        self.cap_value, self.compute_dtype = cap_value, dtype
        k = np.zeros((3, 3), np.float32)
        k[0, 1] = k[1, 0] = k[1, 2] = k[2, 1] = 1.0
        self.register_buffer(
            "smoother", torch.as_tensor(np.tile(k[None, None],
                                                (in_channels, 1, 1, 1)),
                                        device=device), persistent=False)
        self.conv = _FaceConv(in_channels, out_channels, kernel_size, 1,
                              dtype, device)

    def forward(self, x):
        x = healpix_pad(x, 1).to(self.compute_dtype)
        y = _upsample_faces(_faces(x), self.scale_factor, self.mode)
        y = F.conv2d(y, self.smoother.to(y.dtype), groups=y.shape[1]) / 4.0
        x = _unfaces(y[..., 1:-1, 1:-1], x)
        out = self.conv(x)
        if self.cap_value is not None:
            out = capped_gelu(out, self.cap_value)
        return out


class InterpolateUpsample(nn.Module):
    """Per-face interpolation (nearest or bilinear)."""

    def __init__(self, stride=2, mode="nearest"):
        super().__init__()
        self.stride, self.mode = stride, mode

    def forward(self, x):
        return _unfaces(_upsample_faces(_faces(x), self.stride, self.mode), x)


# --- config dataclasses ({block_type}-discriminated, the JAX package's
# YAML surface) ---


@dataclasses.dataclass
class CappedGELUConfig:
    cap_value: float = 10

    @property
    def cap(self):
        return float(self.cap_value)


def _cap(activation):
    return activation.cap if activation else None


@dataclasses.dataclass
class MaxPoolDownsamplingBlockConfig:
    block_type: Literal["MaxPool"] = "MaxPool"
    pooling: int = 2

    def build(self, in_channels, dtype=torch.float32, device=None):
        return MaxPool(pooling=self.pooling)


@dataclasses.dataclass
class AvgPoolDownsamplingBlockConfig:
    block_type: Literal["AvgPool"] = "AvgPool"
    pooling: int = 2

    def build(self, in_channels, dtype=torch.float32, device=None):
        return AvgPool(pooling=self.pooling)


@dataclasses.dataclass
class DealiasedDownsampleBlockConfig:
    block_type: Literal["DealiasedDownsample"] = "DealiasedDownsample"
    pooling: int = 2
    resample_filter: list[float] = dataclasses.field(
        default_factory=lambda: [1.0, 2.0, 1.0]
    )

    def build(self, in_channels, dtype=torch.float32, device=None):
        return DealiasedDownsample(
            in_channels, resample_filter=tuple(self.resample_filter),
            stride=self.pooling, dtype=dtype, device=device)


DownsamplingBlockConfig = (
    MaxPoolDownsamplingBlockConfig
    | AvgPoolDownsamplingBlockConfig
    | DealiasedDownsampleBlockConfig
)


@dataclasses.dataclass
class TransposedConvUpsampleBlockConfig:
    block_type: Literal["TransposedConvUpsample"] = "TransposedConvUpsample"
    stride: int = 2
    activation: CappedGELUConfig | None = None

    def build(self, in_channels, out_channels, dtype=torch.float32,
              device=None):
        return TransposedConvUpsample(
            in_channels, out_channels, upsampling=self.stride,
            cap_value=_cap(self.activation), dtype=dtype, device=device)


@dataclasses.dataclass
class SmoothedInterpolateConvBlockConfig:
    block_type: Literal["SmoothedInterpolateConv"] = "SmoothedInterpolateConv"
    stride: int = 2
    kernel_size: int = 3
    dilation: int = 1
    upsample_mode: str = "nearest"
    activation: CappedGELUConfig | None = None

    def build(self, in_channels, out_channels, dtype=torch.float32,
              device=None):
        if self.dilation > 1:
            raise ValueError(
                "dilation > 1 is not supported for HEALPix resize convs")
        return SmoothedInterpolateConv(
            in_channels, out_channels, kernel_size=self.kernel_size,
            scale_factor=self.stride, mode=self.upsample_mode,
            cap_value=_cap(self.activation), dtype=dtype, device=device)


@dataclasses.dataclass
class InterpolateUpsampleBlockConfig:
    block_type: Literal["Interpolate"] = "Interpolate"
    stride: int = 2
    upsample_mode: str = "nearest"
    align_corners: bool = False

    def build(self, in_channels, out_channels, dtype=torch.float32,
              device=None):
        return InterpolateUpsample(stride=self.stride,
                                   mode=self.upsample_mode)


UpsamplingBlockConfig = (
    TransposedConvUpsampleBlockConfig
    | SmoothedInterpolateConvBlockConfig
    | InterpolateUpsampleBlockConfig
)


@dataclasses.dataclass
class BasicConvBlockConfig:
    block_type: Literal["BasicConvBlock"] = "BasicConvBlock"
    kernel_size: int = 3
    n_layers: int = 1
    activation: CappedGELUConfig | None = None

    def build(self, in_channels, out_channels, latent_channels=None,
              dilation=1, n_layers=None, dtype=torch.float32, device=None):
        return BasicConvBlock(
            in_channels, out_channels, kernel_size=self.kernel_size,
            dilation=dilation,
            n_layers=self.n_layers if n_layers is None else n_layers,
            latent_channels=latent_channels,
            cap_value=_cap(self.activation), dtype=dtype, device=device)


@dataclasses.dataclass
class ConvNeXtBlockConfig:
    block_type: Literal["ConvNeXtBlock"] = "ConvNeXtBlock"
    kernel_size: int = 3
    upscale_factor: int = 4
    activation: CappedGELUConfig | None = None

    def build(self, in_channels, out_channels, latent_channels=None,
              dilation=1, n_layers=None, dtype=torch.float32, device=None):
        return ConvNeXtBlock(
            in_channels, out_channels,
            latent_channels=1 if latent_channels is None else latent_channels,
            kernel_size=self.kernel_size, dilation=dilation,
            upscale_factor=self.upscale_factor,
            cap_value=_cap(self.activation), dtype=dtype, device=device)


@dataclasses.dataclass
class SymmetricConvNeXtBlockConfig:
    block_type: Literal["SymmetricConvNeXtBlock"] = "SymmetricConvNeXtBlock"
    kernel_size: int = 3
    upscale_factor: int = 4
    activation: CappedGELUConfig | None = None

    def build(self, in_channels, out_channels, latent_channels=None,
              dilation=1, n_layers=None, dtype=torch.float32, device=None):
        return SymmetricConvNeXtBlock(
            in_channels, out_channels,
            latent_channels=1 if latent_channels is None else latent_channels,
            kernel_size=self.kernel_size, dilation=dilation,
            upscale_factor=self.upscale_factor,
            cap_value=_cap(self.activation), dtype=dtype, device=device)


@dataclasses.dataclass
class MultiSymmetricConvNeXtBlockConfig:
    block_type: Literal["Multi_SymmetricConvNeXtBlock"] = (
        "Multi_SymmetricConvNeXtBlock"
    )
    kernel_size: int = 3
    n_layers: int = 1
    upscale_factor: int = 4
    activation: CappedGELUConfig | None = None

    def build(self, in_channels, out_channels, latent_channels=None,
              dilation=1, n_layers=None, dtype=torch.float32, device=None):
        return MultiSymmetricConvNeXtBlock(
            in_channels, out_channels,
            latent_channels=1 if latent_channels is None else latent_channels,
            kernel_size=self.kernel_size, dilation=dilation,
            upscale_factor=self.upscale_factor,
            n_layers=self.n_layers if n_layers is None else n_layers,
            cap_value=_cap(self.activation), dtype=dtype, device=device)


ConvBlockConfig = (
    BasicConvBlockConfig
    | ConvNeXtBlockConfig
    | SymmetricConvNeXtBlockConfig
    | MultiSymmetricConvNeXtBlockConfig
)


@dataclasses.dataclass
class UNetEncoderConfig:
    conv_block: ConvBlockConfig
    down_sampling_block: DownsamplingBlockConfig
    n_channels: list[int] = dataclasses.field(
        default_factory=lambda: [136, 68, 34]
    )
    n_layers: list[int] = dataclasses.field(
        default_factory=lambda: [2, 2, 1]
    )
    dilations: list[int] | None = None


@dataclasses.dataclass
class UNetDecoderConfig:
    conv_block: ConvBlockConfig
    up_sampling_block: UpsamplingBlockConfig
    output_layer: ConvBlockConfig
    n_channels: list[int] = dataclasses.field(
        default_factory=lambda: [34, 68, 136]
    )
    n_layers: list[int] = dataclasses.field(
        default_factory=lambda: [1, 2, 2]
    )
    dilations: list[int] | None = None


def default_encoder() -> UNetEncoderConfig:
    return UNetEncoderConfig(
        conv_block=ConvNeXtBlockConfig(activation=CappedGELUConfig()),
        down_sampling_block=AvgPoolDownsamplingBlockConfig(),
    )


def default_decoder() -> UNetDecoderConfig:
    return UNetDecoderConfig(
        conv_block=ConvNeXtBlockConfig(activation=CappedGELUConfig()),
        up_sampling_block=TransposedConvUpsampleBlockConfig(
            activation=CappedGELUConfig()),
        output_layer=BasicConvBlockConfig(kernel_size=1, n_layers=1),
    )


class HEALPixUNet(nn.Module):
    """Feed-forward UNet on the 12 HEALPix faces (port of
    ace_tpu/models/healpix.py:686): ``[batch, 12, H, W, in] -> [batch, 12,
    H, W, out]``. Encoder level n: downsample where n > 0, then its conv
    block; the decoder runs deepest to shallowest, upsampling and
    concatenating the encoder's skip, each level's conv block mapping to
    the next level's width. Submodules carry flax's names."""

    def __init__(self, in_channels, out_channels,
                 encoder: UNetEncoderConfig | None = None,
                 decoder: UNetDecoderConfig | None = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        enc = encoder or default_encoder()
        dec = decoder or default_decoder()
        if len(enc.n_channels) != len(dec.n_channels):
            raise ValueError(
                "encoder and decoder must have the same number of levels")
        self.compute_dtype = dtype
        self.n_levels = len(dec.n_channels)
        enc_dil = enc.dilations or [1] * len(enc.n_channels)
        dec_dil = dec.dilations or [1] * len(dec.n_channels)
        kw = dict(dtype=dtype, device=device)
        c, widths = in_channels, []
        for n, ch in enumerate(enc.n_channels):
            if n > 0:
                self.add_module(f"encoder_down_{n}",
                                enc.down_sampling_block.build(c, **kw))
            self.add_module(f"encoder_conv_{n}", enc.conv_block.build(
                c, ch, latent_channels=ch, dilation=enc_dil[n],
                n_layers=enc.n_layers[n], **kw))
            c = ch
            widths.append(ch)
        for n, ch in enumerate(dec.n_channels):
            if n > 0:
                up = dec.up_sampling_block.build(c, ch, **kw)
                self.add_module(f"decoder_up_{n}", up)
                up_width = c if isinstance(up, InterpolateUpsample) else ch
                c = up_width + widths[self.n_levels - 1 - n]
            next_ch = (dec.n_channels[n + 1] if n < self.n_levels - 1
                       else dec.n_channels[-1])
            self.add_module(f"decoder_conv_{n}", dec.conv_block.build(
                c, next_ch, latent_channels=ch, dilation=dec_dil[n],
                n_layers=dec.n_layers[n], **kw))
            c = next_ch
        self.output_layer = dec.output_layer.build(
            c, out_channels, dilation=dec_dil[-1], **kw)

    def forward(self, x, noise=None, generator=None, deterministic=True):
        x = x.to(self.compute_dtype)
        encodings = []
        for n in range(self.n_levels):
            if n > 0:
                x = getattr(self, f"encoder_down_{n}")(x)
            x = getattr(self, f"encoder_conv_{n}")(x)
            encodings.append(x)
        x = encodings[-1]
        for n in range(self.n_levels):
            if n > 0:
                up = getattr(self, f"decoder_up_{n}")(x)
                x = torch.cat([up, encodings[self.n_levels - 1 - n]], dim=-1)
            x = getattr(self, f"decoder_conv_{n}")(x)
        return self.output_layer(x).float()
