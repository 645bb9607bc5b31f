"""SwinIR, the deterministic downscaling network (port of
ace_tpu/downscaling/swinir.py): shallow convolution, residual groups of
SwinV1 pre-norm blocks with a relative-position bias table, and a
pixel-shuffle upsampler.

Channels-last throughout, as ``ace_tpu``: the windows come from
``models/swin.py``'s ``window_partition``/``window_reverse``, the 3x3
convolutions permute to NCHW around ``F.conv2d``. The bias table's index
is a numpy constant kept as a non-persistent buffer; the shifted-window
mask is made once per grid size and device.
"""

from collections.abc import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ace_tpu_torch.models.layers import (
    MLP,
    LayerNorm,
    Linear,
    trunc_normal_init,
)
from ace_tpu_torch.models.swin import Conv3x3, window_partition, window_reverse


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``[B, H, W, C * r^2]`` -> ``[B, H * r, W * r, C]``."""
    b, h, w, c = x.shape
    r = factor
    c_out = c // (r * r)
    x = x.reshape(b, h, w, r, r, c_out).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * r, w * r, c_out)


def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """Each token pair's row in the ``[(2 wh - 1)(2 ww - 1), heads]``
    bias table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def shifted_window_mask(h: int, w: int, wh: int, ww: int) -> np.ndarray:
    """The 9-region mask of a shifted block, ``[nWin, T, T]``: neither
    edge of a regional patch is periodic."""
    sh, sw = wh // 2, ww // 2
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, h - wh), slice(h - wh, h - sh), slice(h - sh, h)):
        for ws in (slice(0, w - ww), slice(w - ww, w - sw), slice(w - sw, w)):
            img_mask[:, hs, ws] = cnt
            cnt += 1
    m = img_mask.reshape(1, h // wh, wh, w // ww, ww, 1)
    m_windows = m.transpose(0, 1, 3, 2, 4, 5).reshape(-1, wh * ww)
    diff = m_windows[:, None, :] - m_windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _dense(n_in, n_out, dtype, device):
    return Linear(n_in, n_out, dtype=dtype, device=device)


class WindowAttention(nn.Module):
    """W-MSA with a relative position bias table; float32 scores."""

    def __init__(self, dim, window_size, num_heads, dtype=torch.float32,
                 device=None):
        super().__init__()
        wh, ww = window_size
        self.num_heads = num_heads
        self.qkv = _dense(dim, 3 * dim, dtype, device)
        self.relative_position_bias = nn.Parameter(torch.empty(
            (2 * wh - 1) * (2 * ww - 1), num_heads, device=device))
        self.proj = _dense(dim, dim, dtype, device)
        self.register_buffer("index", torch.as_tensor(
            relative_position_index(wh, ww), device=device),
            persistent=False)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        trunc_normal_init(self.relative_position_bias, std=0.02,
                          generator=generator)

    def forward(self, x, mask=None):
        n_win, n_tokens, c = x.shape
        d = c // self.num_heads
        qkv = self.qkv(x).reshape(n_win, n_tokens, 3, self.num_heads, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        attn = torch.matmul((q * d ** -0.5).float(),
                            k.float().transpose(-1, -2))
        bias = self.relative_position_bias[self.index]  # [T, T, heads]
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            n_masks = mask.shape[0]
            attn = attn.reshape(-1, n_masks, self.num_heads, n_tokens,
                                n_tokens) + mask[None, :, None]
            attn = attn.reshape(-1, self.num_heads, n_tokens, n_tokens)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(n_win, n_tokens,
                                                             c)
        return self.proj(out)


class SwinBlock(nn.Module):
    """Pre-norm Swin block (shifted windows on odd blocks)."""

    def __init__(self, dim, num_heads, window_size, shift=False,
                 mlp_ratio=4.0, dtype=torch.float32, device=None):
        super().__init__()
        self.window_size, self.shift = tuple(window_size), shift
        self.norm1 = LayerNorm(dim, device=device)
        self.attn = WindowAttention(dim, self.window_size, num_heads,
                                    dtype=dtype, device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dim, dtype=dtype,
                       device=device)
        self._masks = {}

    def _mask(self, h, w, device):
        key = (h, w, str(device))
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(
                shifted_window_mask(h, w, *self.window_size), device=device)
        return self._masks[key]

    def forward(self, x, deterministic: bool = True, generator=None):
        b, h, w, c = x.shape
        wh, ww = self.window_size
        shortcut = x
        x = self.norm1(x)
        if self.shift:
            x = torch.roll(x, (-(wh // 2), -(ww // 2)), dims=(1, 2))
        out = self.attn(window_partition(x, wh, ww),
                        self._mask(h, w, x.device) if self.shift else None)
        x = window_reverse(out, wh, ww, h, w)
        if self.shift:
            x = torch.roll(x, (wh // 2, ww // 2), dims=(1, 2))
        x = shortcut + x
        return x + self.mlp(self.norm2(x), deterministic, generator)


class ResidualSwinBlockGroup(nn.Module):
    """RSTB: Swin blocks and a 3x3 convolution with a residual."""

    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio=2.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block_{i}", SwinBlock(
                dim, num_heads, window_size, shift=i % 2 == 1,
                mlp_ratio=mlp_ratio, dtype=dtype, device=device))
        self.conv = Conv3x3(dim, dim, dtype=dtype, device=device)

    def forward(self, x, deterministic: bool = True, generator=None):
        h = x
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, deterministic, generator)
        return x + self.conv(h)


class SwinIR(nn.Module):
    """``[B, h, w, C_in]`` -> ``[B, h * factor, w * factor, C_out]``
    (float32); reflect-pads to a multiple of the window and crops after
    the upsampler."""

    def __init__(self, in_channels: int, out_channels: int,
                 upscale_factor: int, embed_dim: int = 96,
                 depths: Sequence[int] = (4, 4, 4), num_heads: int = 4,
                 window_size: Sequence[int] = (4, 8), mlp_ratio: float = 2.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.window_size = tuple(window_size)
        self.upscale_factor, self.dtype = upscale_factor, dtype
        self.n_groups = len(depths)
        kw = dict(dtype=dtype, device=device)
        self.conv_first = Conv3x3(in_channels, embed_dim, **kw)
        for g, depth in enumerate(depths):
            self.add_module(f"group_{g}", ResidualSwinBlockGroup(
                embed_dim, depth, num_heads, self.window_size,
                mlp_ratio=mlp_ratio, **kw))
        self.conv_body = Conv3x3(embed_dim, embed_dim, **kw)
        r = upscale_factor
        self.upsample_conv = Conv3x3(embed_dim, embed_dim * r * r, **kw)
        self.conv_last = Conv3x3(embed_dim, out_channels, **kw)

    def forward(self, x, deterministic: bool = True, generator=None):
        b, h_in, w_in, _ = x.shape
        wh, ww = self.window_size
        pad_h, pad_w = (wh - h_in % wh) % wh, (ww - w_in % ww) % ww
        if pad_h or pad_w:
            x = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h),
                      mode="reflect").permute(0, 2, 3, 1)
        shallow = self.conv_first(x.to(self.dtype))
        h = shallow
        for g in range(self.n_groups):
            h = getattr(self, f"group_{g}")(h, deterministic, generator)
        h = shallow + self.conv_body(h)
        r = self.upscale_factor
        h = pixel_shuffle(self.upsample_conv(h), r)
        out = self.conv_last(h)[:, :h_in * r, :w_in * r]
        return out.float()
