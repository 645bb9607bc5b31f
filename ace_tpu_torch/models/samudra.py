"""Samudra ocean emulator: a ConvNeXt U-Net with circular longitude
padding (port of ace_tpu/models/samudra.py).

The module takes and returns channels-last tensors, as every network of
the port does, and runs NCHW inside (``F.conv2d``'s layout). Its
convolution kernels are ``F.conv2d``'s ``[out, in, kh, kw]`` under flax's
name ``kernel``; ``utils/convert.py`` maps them to and from flax's ``[kh,
kw, in, out]``. Padding matches the JAX package: circular along longitude, zeros
along latitude. The convolutions follow ``torch.backends.cudnn.allow_tf32``
on the card (PyTorch's default is True; the JAX package has no such
switch, and computes them in float32): the entries pin float32
(``device.entry_device`` turns TF32 off), so a user's run computes them
as ``ace_tpu`` does.
"""

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ace_tpu_torch.models.layers import exact_gelu, trunc_normal_init

NORM_EPS = 1e-5


class _CappedGelu(torch.autograd.Function):
    """``min(gelu(x), cap)`` (exact erf form) that saves only ``x`` for
    its backward (the composed ops would save ``x`` and ``gelu(x)``: a
    full-resolution tensor of every wide activation)."""

    @staticmethod
    def forward(ctx, x, cap):
        ctx.save_for_backward(x)
        ctx.cap = cap
        return torch.clamp(F.gelu(x), max=cap)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        cdf = 0.5 * (1.0 + torch.erf(x * 0.7071067811865476))
        slope = cdf + x * torch.exp(-0.5 * x * x) * 0.3989422804014327
        # the clamp passes no gradient where gelu(x) exceeds the cap
        return torch.where(x * cdf < ctx.cap, grad * slope, 0.0), None


def capped_gelu(x: torch.Tensor, cap: float = 1.0) -> torch.Tensor:
    """The exact (erf) GELU, clamped at ``cap`` (bfloat16: the tanh form,
    as ``exact_gelu``)."""
    if x.dtype == torch.bfloat16:
        return torch.clamp(exact_gelu(x), max=cap)
    return _CappedGelu.apply(x, cap)


def pad_lon_circular_lat_zero(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad ``[..., H, W]``: circular along W (lon), zeros along H (lat)."""
    if pad == 0:
        return x
    x = torch.cat([x[..., -pad:], x, x[..., :pad]], dim=-1)
    return F.pad(x, (0, 0, pad, pad))


def bilinear_upsample(x: torch.Tensor, factor: int = 2,
                      zonally_periodic: bool = False) -> torch.Tensor:
    """Bilinear upsampling of ``[..., C, H, W]`` by ``factor``
    (``align_corners=False``: at an upsampling's edges, clamping the
    source index equals ``jax.image.resize``'s renormalized weights).
    With ``zonally_periodic`` the longitude seam is interpolated against
    its wrapped neighbour."""
    h, w = x.shape[-2], x.shape[-1]
    if not zonally_periodic:
        return F.interpolate(x, size=(h * factor, w * factor),
                             mode="bilinear", align_corners=False)
    padded = torch.cat([x[..., -1:], x, x[..., :1]], dim=-1)
    up = F.interpolate(padded, size=(h * factor, (w + 2) * factor),
                       mode="bilinear", align_corners=False)
    return up[..., factor:factor + w * factor]


class Conv2d(nn.Module):
    """A convolution without padding of its own that computes in
    ``dtype``: ``kernel`` ``[out, in, kh, kw]`` (``F.conv2d``'s layout,
    under flax ``nn.Conv``'s name) and ``bias``, drawn as flax draws them:
    a truncated normal of variance 1/fan_in, zeros."""

    def __init__(self, in_channels, out_channels, kernel_size, dilation=1,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size,
            device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        self.dilation = dilation
        self.compute_dtype = dtype
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        fan_in = self.kernel[0].numel()
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        with torch.no_grad():
            trunc_normal_init(self.kernel, std=std, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.kernel.to(dt), self.bias.to(dt),
                        dilation=self.dilation)


class ConvNeXtBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, dilation: int = 1,
                 upscale_factor: int = 4, norm: str | None = "instance",
                 dtype=torch.float32, device=None):
        super().__init__()
        if norm not in ("instance", "layer", None):
            raise NotImplementedError(f"norm {norm}")
        hidden = int(in_channels * upscale_factor)
        self.norm = norm
        self.pad = (kernel_size + (kernel_size - 1) * (dilation - 1) - 1) // 2
        self.skip_conv = (
            Conv2d(in_channels, out_channels, 1, dtype=dtype, device=device)
            if in_channels != out_channels else None)
        self.conv1 = Conv2d(in_channels, hidden, kernel_size,
                            dilation=dilation, dtype=dtype, device=device)
        self.conv2 = Conv2d(hidden, hidden, kernel_size, dilation=dilation,
                            dtype=dtype, device=device)
        self.conv_out = Conv2d(hidden, out_channels, 1, dtype=dtype,
                               device=device)

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        """Instance norm (over H and W) or layer norm (over C), biased
        variance, no affine (``F.instance_norm`` without running
        statistics: one pass that saves only its input and the
        statistics)."""
        if self.norm is None:
            return x
        if self.norm == "instance":
            return F.instance_norm(x, eps=NORM_EPS)
        var, mean = torch.var_mean(x, dim=-3, keepdim=True, correction=0)
        return (x - mean) * torch.rsqrt(var + NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x if self.skip_conv is None else self.skip_conv(x)
        h = self.conv1(pad_lon_circular_lat_zero(x, self.pad))
        h = capped_gelu(self._norm(h))
        h = self.conv2(pad_lon_circular_lat_zero(h, self.pad))
        h = capped_gelu(self._norm(h))
        return self.conv_out(h) + skip


class Samudra(nn.Module):
    """The U-Net: a ConvNeXt block and a 2x average pool per level, a
    bottleneck block, then per level a bilinear upsample, the skip added
    (after padding to its shape) and a block; a 3x3 head."""

    def __init__(self, in_channels: int, out_channels: int,
                 ch_width: Sequence[int] = (200, 250, 300, 400),
                 dilation: Sequence[int] = (1, 2, 4, 8),
                 norm: str | None = "instance", upscale_factor: int = 4,
                 zonally_periodic_upsample: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.ch_width = list(ch_width)
        self.zonally_periodic_upsample = zonally_periodic_upsample
        self.dtype = dtype
        n = len(self.ch_width)

        def block(c_in, c_out, d):
            return ConvNeXtBlock(c_in, c_out, dilation=d,
                                 upscale_factor=upscale_factor, norm=norm,
                                 dtype=dtype, device=device)

        # named down_<i> and up_<i>, as the JAX package names them
        widths_in = [in_channels] + self.ch_width[:-1]
        for i in range(n):
            self.add_module(f"down_{i}", block(widths_in[i], self.ch_width[i],
                                               dilation[i]))
        self.bottleneck = block(self.ch_width[-1], self.ch_width[-1],
                                dilation[-1])
        widths_up = self.ch_width[::-1][1:] + [self.ch_width[0]]
        dil_up = list(dilation[::-1])
        c = self.ch_width[-1]
        for i in range(n):
            # the last block reuses the one before it's dilation, as the
            # reference's loop index does
            self.add_module(f"up_{i}", block(
                c, widths_up[i], dil_up[min(i, max(n - 2, 0))]))
            c = widths_up[i]
        self.head = Conv2d(self.ch_width[0], out_channels, 3, dtype=dtype,
                           device=device)

    def forward(self, x: torch.Tensor, noise=None, generator=None,
                deterministic: bool = True) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        n = len(self.ch_width)
        skips = []
        for i in range(n):
            x = getattr(self, f"down_{i}")(x)
            skips.append(x)
            h2, w2 = x.shape[-2] // 2, x.shape[-1] // 2
            x = F.avg_pool2d(x[..., :h2 * 2, :w2 * 2], 2)
        x = self.bottleneck(x)
        x = bilinear_upsample(x, zonally_periodic=self.zonally_periodic_upsample)
        for i in range(n):
            skip = skips[n - 1 - i]
            dh = skip.shape[-2] - x.shape[-2]
            dw = skip.shape[-1] - x.shape[-1]
            if dw > 0:
                # the circular pad split left/right
                left, right = dw // 2, dw - dw // 2
                x = torch.cat([x[..., x.shape[-1] - left:], x,
                               x[..., :right]], dim=-1)
            if dh > 0:
                x = F.pad(x, (0, 0, dh // 2, dh - dh // 2))
            if x.shape[-3] == skip.shape[-3]:
                x = x + skip
            x = getattr(self, f"up_{i}")(x)
            if i < n - 1:
                x = bilinear_upsample(
                    x, zonally_periodic=self.zonally_periodic_upsample)
        out = self.head(pad_lon_circular_lat_zero(x, 1))
        return out.float().permute(0, 2, 3, 1)
