"""The compact noise-conditional UNet for diffusion downscaling (port of
ace_tpu/downscaling/unet.py).

Channels-last in and out, NCHW inside. Parameter names are flax's,
including its automatic ones (``FourierTimeEmbedding_0``, ``GroupNorm_0``,
``GroupNorm_1``); convolution kernels are ``F.conv2d``'s ``[out, in, kh,
kw]`` under flax's name ``kernel``, the attention's projections keep flax
``DenseGeneral``'s ``[C, heads, head_dim]`` and ``[heads, head_dim, C]``
kernels. The group norms compute flax's statistics: float32, the variance
as ``E[x^2] - E[x]^2``, eps 1e-6.
"""

import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ace_tpu_torch.models.layers import Linear


def _lecun_normal_(tensor, fan_in, generator=None):
    """flax's default kernel initializer: a truncated normal of variance
    1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(tensor, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class FlaxGroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over NCHW (``scale``, ``bias``)."""

    def __init__(self, channels, num_groups, eps=1e-6, device=None):
        super().__init__()
        self.groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        b, c, h, w = x.shape
        xg = x.float().reshape(b, self.groups, c // self.groups, h, w)
        mean = xg.mean((2, 3, 4), keepdim=True)
        var = (xg.square().mean((2, 3, 4), keepdim=True)
               - mean.square()).clamp_min(0.0)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(b, c, h, w)
        return y * self.scale[:, None, None] + self.bias[:, None, None]


class Conv(nn.Module):
    """flax ``nn.Conv`` with SAME padding over NCHW, computing in
    ``dtype``; ``init`` "lecun_normal" or "zeros"."""

    def __init__(self, cin, cout, kernel=3, stride=1, init="lecun_normal",
                 dtype=torch.float32, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cout, cin, kernel, kernel,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))
        self.stride, self.init, self.compute_dtype = stride, init, dtype
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            if self.init == "zeros":
                self.kernel.zero_()
            else:
                _lecun_normal_(self.kernel, self.kernel[0].numel(),
                               generator)
            self.bias.zero_()

    def forward(self, x):
        k, s = self.kernel.shape[-1], self.stride
        h, w = x.shape[-2:]
        pads = []
        for n in (w, h):  # F.pad's order: last axis first
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        dt = self.compute_dtype
        return F.conv2d(F.pad(x.to(dt), pads), self.kernel.to(dt),
                        self.bias.to(dt), stride=s)


class FourierTimeEmbedding(nn.Module):
    """Gaussian Fourier features of ``c_noise`` (``freqs`` ~ N(0, 16²), a
    trained parameter as in ``ace_tpu``)."""

    def __init__(self, dim=128, device=None):
        super().__init__()
        self.freqs = nn.Parameter(torch.empty(dim // 2, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.freqs.normal_(generator=generator).mul_(16.0)

    def forward(self, t):
        ang = 2 * math.pi * t[:, None] * self.freqs[None, :]
        return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _dense(n_in, n_out, init="lecun_normal", device=None):
    return Linear(n_in, n_out, init=init, device=device)


class ResBlock(nn.Module):
    def __init__(self, cin, channels, emb_dim, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.GroupNorm_0 = FlaxGroupNorm(cin, min(32, cin), device=device)
        self.conv1 = Conv(cin, channels, **kw)
        self.emb_proj = _dense(emb_dim, 2 * channels, device=device)
        self.GroupNorm_1 = FlaxGroupNorm(channels, min(32, channels),
                                         device=device)
        self.conv2 = Conv(channels, channels, init="zeros", **kw)
        self.skip = (Conv(cin, channels, kernel=1, **kw)
                     if cin != channels else None)

    def forward(self, x, emb):
        h = self.conv1(F.silu(self.GroupNorm_0(x)))
        mod = self.emb_proj(F.silu(emb))[:, :, None, None]
        scale, shift = mod.chunk(2, dim=1)
        h = self.GroupNorm_1(h) * (1 + scale) + shift
        h = self.conv2(F.silu(h))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class MultiHeadAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (self-attention, no
    dropout) with its ``DenseGeneral`` kernel layouts and a zero output
    kernel."""

    def __init__(self, channels, num_heads, dtype=torch.float32,
                 device=None):
        super().__init__()
        d = channels // num_heads
        for name in ("query", "key", "value"):
            proj = nn.Module()
            proj.kernel = nn.Parameter(torch.empty(channels, num_heads, d,
                                                   device=device))
            proj.bias = nn.Parameter(torch.zeros(num_heads, d, device=device))
            self.add_module(name, proj)
        self.out = nn.Module()
        self.out.kernel = nn.Parameter(torch.zeros(num_heads, d, channels,
                                                   device=device))
        self.out.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.compute_dtype = dtype
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            for name in ("query", "key", "value"):
                proj = getattr(self, name)
                _lecun_normal_(proj.kernel, proj.kernel.shape[0], generator)
                proj.bias.zero_()
            self.out.kernel.zero_()
            self.out.bias.zero_()

    def forward(self, y):
        dt = self.compute_dtype
        y = y.to(dt)

        def project(proj):
            return (torch.einsum("bnc,chd->bnhd", y, proj.kernel.to(dt))
                    + proj.bias.to(dt))

        q, k, v = (project(p) for p in (self.query, self.key, self.value))
        q = q / math.sqrt(q.shape[-1])
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        attn = torch.softmax(logits.float(), dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return (torch.einsum("bqhd,hdc->bqc", out, self.out.kernel.to(dt))
                + self.out.bias.to(dt))


class SelfAttention2d(nn.Module):
    def __init__(self, channels, num_heads=4, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.GroupNorm_0 = FlaxGroupNorm(channels, min(32, channels),
                                         device=device)
        self.attn = MultiHeadAttention(channels, num_heads, dtype=dtype,
                                       device=device)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.GroupNorm_0(x).reshape(b, c, h * w).transpose(1, 2)
        y = self.attn(y)
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class DiffusionUNet(nn.Module):
    """The raw network F of the EDM preconditioning: ``(x [B, H, W,
    C_out], condition [B, H, W, C_cond], c_noise [B])`` -> ``[B, H, W,
    C_out]`` (float32)."""

    def __init__(self, in_channels: int, out_channels: int,
                 base_channels: int = 64,
                 channel_mults: Sequence[int] = (1, 2, 2),
                 num_res_blocks: int = 2, emb_dim: int = 256,
                 attn_levels: Sequence[int] = (),
                 bottleneck_attention: bool = True, num_heads: int = 4,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.channel_mults = tuple(channel_mults)
        self.num_res_blocks = num_res_blocks
        self.attn_levels = tuple(attn_levels)
        self.bottleneck_attention = bottleneck_attention
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.FourierTimeEmbedding_0 = FourierTimeEmbedding(emb_dim, device)
        self.emb_fc1 = _dense(emb_dim, emb_dim, device=device)
        self.emb_fc2 = _dense(emb_dim, emb_dim, device=device)
        self.stem = Conv(in_channels, base_channels, **kw)
        ch, skips = base_channels, [base_channels]
        last = len(self.channel_mults) - 1
        for level, mult in enumerate(self.channel_mults):
            out = base_channels * mult
            for j in range(num_res_blocks):
                self.add_module(f"down_{level}_{j}",
                                ResBlock(ch, out, emb_dim, **kw))
                ch = out
                if level in self.attn_levels:
                    self.add_module(f"down_attn_{level}_{j}",
                                    SelfAttention2d(ch, num_heads, **kw))
                skips.append(ch)
            if level < last:
                self.add_module(f"downsample_{level}",
                                Conv(ch, ch, stride=2, **kw))
                skips.append(ch)
        self.mid_0 = ResBlock(ch, ch, emb_dim, **kw)
        if bottleneck_attention:
            self.mid_attn = SelfAttention2d(ch, num_heads, **kw)
        self.mid_1 = ResBlock(ch, ch, emb_dim, **kw)
        for level, mult in reversed(list(enumerate(self.channel_mults))):
            out = base_channels * mult
            for j in range(num_res_blocks + 1):
                self.add_module(f"up_{level}_{j}",
                                ResBlock(ch + skips.pop(), out, emb_dim,
                                         **kw))
                ch = out
                if level in self.attn_levels:
                    self.add_module(f"up_attn_{level}_{j}",
                                    SelfAttention2d(ch, num_heads, **kw))
            if level > 0:
                target = base_channels * self.channel_mults[level - 1]
                self.add_module(f"upsample_{level}", Conv(ch, target, **kw))
                ch = target
        self.GroupNorm_0 = FlaxGroupNorm(ch, min(32, ch), device=device)
        self.head = Conv(ch, out_channels, init="zeros", **kw)

    def forward(self, x, condition, c_noise, deterministic: bool = True,
                generator=None):
        emb = self.FourierTimeEmbedding_0(c_noise)
        emb = self.emb_fc2(F.silu(self.emb_fc1(emb)))
        h = torch.cat([x.to(self.dtype), condition.to(self.dtype)], dim=-1)
        h = self.stem(h.permute(0, 3, 1, 2))
        skips = [h]
        last = len(self.channel_mults) - 1
        for level in range(len(self.channel_mults)):
            for j in range(self.num_res_blocks):
                h = getattr(self, f"down_{level}_{j}")(h, emb)
                if level in self.attn_levels:
                    h = getattr(self, f"down_attn_{level}_{j}")(h)
                skips.append(h)
            if level < last:
                h = getattr(self, f"downsample_{level}")(h)
                skips.append(h)
        h = self.mid_0(h, emb)
        if self.bottleneck_attention:
            h = self.mid_attn(h)
        h = self.mid_1(h, emb)
        for level in reversed(range(len(self.channel_mults))):
            for j in range(self.num_res_blocks + 1):
                h = torch.cat([h, skips.pop().to(h.dtype)], dim=1)
                h = getattr(self, f"up_{level}_{j}")(h, emb)
                if level in self.attn_levels:
                    h = getattr(self, f"up_attn_{level}_{j}")(h)
            if level > 0:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = getattr(self, f"upsample_{level}")(h)
        out = self.head(F.silu(self.GroupNorm_0(h)))
        return out.float().permute(0, 2, 3, 1)
