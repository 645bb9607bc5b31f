"""2D Swin U-Net (ArchesWeather-style) for lat-lon grids, channels-last
(port of ace_tpu/models/swin.py).

encoder conv3x3 -> channel mixer -> stage 1 (full resolution) -> patch
merging -> stages 2, 3 (half resolution) -> patch expanding -> optional
skip concat -> stage 4 -> final linear -> decoder conv3x3. Blocks are
post-norm; the window attention is SwinV2's cosine attention with a
continuous-position-bias MLP (optionally with the longitude offsets
scaled by cos(lat)); a column mixer is folded into each attention
branch. Conditioning is ``adaln`` (per-stage scale, shift and gate from
label embeddings) or ``cln`` (each block's norms conditioned on a
per-pixel noise field: the NoiseConditionedSwinTransformer).

Everything stays channels-last, ``[B, H, W, C]``, as in the JAX package,
so the window order, the rolls of the shifted windows and the per-window
bias keep its axes. The shifted-window masks and the bias MLP's inputs
are numpy constants, computed with the JAX package's expressions, and
kept as non-persistent buffers. The window attention is plain torch
(``torch.matmul`` over the windows, float32 scores and softmax). Dense
and convolution parameters keep the port's layouts (``nn.Linear``'s
``[out, in]``; the convolutions' ``[out, in, 3, 3]`` under flax's name
``kernel``), which ``utils/convert.py`` maps to flax's.
"""

import math
from collections.abc import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ace_tpu_torch.models.conditional_sfno import ConditionalLayerNorm
from ace_tpu_torch.models.layers import (DropPath, LayerNorm, Linear,
                                         exact_gelu)
from ace_tpu_torch.models.samudra import Conv2d


def _dense(n_in, n_out, bias=True, dtype=torch.float32, device=None,
           init="lecun_normal"):
    """flax ``nn.Dense`` with its default initializers (or zeros)."""
    return Linear(n_in, n_out, bias=bias, dtype=dtype, device=device,
                  init=init)


def window_partition(x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B * nWin, wh * ww, C]`` (windows h-major per
    image)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, wh * ww, c)


def window_reverse(windows: torch.Tensor, wh: int, ww: int, h: int,
                   w: int) -> torch.Tensor:
    b = windows.shape[0] // ((h // wh) * (w // ww))
    x = windows.reshape(b, h // wh, w // ww, wh, ww, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _pad_lon_circular(x, pw, pe):
    if pw == 0 and pe == 0:
        return x
    parts = []
    if pw > 0:
        parts.append(x[:, :, -pw:])
    parts.append(x)
    if pe > 0:
        parts.append(x[:, :, :pe])
    return torch.cat(parts, dim=2)


def earth_pad(x: torch.Tensor, pad_lat, pad_lon) -> torch.Tensor:
    """Earth padding of ``[B, H, W, C]``: the poles take a 180°-rolled
    flip, the longitudes wrap."""
    pn, ps = pad_lat
    pw, pe = pad_lon
    if pn > 0 or ps > 0:
        xroll = torch.roll(x, x.shape[2] // 2, dims=2)
        pieces = []
        if pn > 0:
            pieces.append(xroll[:, :pn].flip(1))
        pieces.append(x)
        if ps > 0:
            pieces.append(xroll[:, -ps:].flip(1))
        x = torch.cat(pieces, dim=1)
    return _pad_lon_circular(x, pw, pe)


def mirror_pad(x: torch.Tensor, pad_lat, pad_lon) -> torch.Tensor:
    """Mirror padding: the longitudes wrap first, then the latitudes
    reflect (numpy's ``reflect``: the edge row is not repeated)."""
    pn, ps = pad_lat
    x = _pad_lon_circular(x, *pad_lon)
    if pn > 0 or ps > 0:
        h = x.shape[1]
        pieces = []
        if pn > 0:
            pieces.append(x[:, 1:pn + 1].flip(1))
        pieces.append(x)
        if ps > 0:
            pieces.append(x[:, h - ps - 1:h - 1].flip(1))
        x = torch.cat(pieces, dim=1)
    return x


def boundary_unpad(x: torch.Tensor, pad_lat, pad_lon) -> torch.Tensor:
    pn, ps = pad_lat
    pw, pe = pad_lon
    return x[:, pn:x.shape[1] - ps, pw:x.shape[2] - pe]


class Conv3x3(Conv2d):
    """flax ``nn.Conv`` with a 3x3 kernel and one cell of zero padding, on
    channels-last input."""

    def __init__(self, in_channels, out_channels, dtype=torch.float32,
                 device=None):
        super().__init__(in_channels, out_channels, 3, dtype=dtype,
                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.kernel.to(dt),
                     self.bias.to(dt), padding=1)
        return y.permute(0, 2, 3, 1)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2."""

    def __init__(self, dim, hidden, dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = _dense(dim, hidden, dtype=dtype, device=device)
        self.fc2 = _dense(hidden, dim, dtype=dtype, device=device)

    def forward(self, x):
        return self.fc2(exact_gelu(self.fc1(x)))


class SwiGLU(nn.Module):
    """fc1 (two halves) -> silu(x1) * x2 -> fc2."""

    def __init__(self, dim, hidden, dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = _dense(dim, 2 * hidden, dtype=dtype, device=device)
        self.fc2 = _dense(hidden, dim, dtype=dtype, device=device)

    def forward(self, x):
        x1, x2 = self.fc1(x).chunk(2, dim=-1)
        return self.fc2(F.silu(x1) * x2)


def _rel_coords(window_size):
    wh, ww = window_size
    coords = np.stack(
        np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
    ).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    return rel.reshape(-1, 2).astype(np.float32)  # (N*N, 2)


def cpb_log_coords(window_size, lat_mean=None) -> np.ndarray:
    """The bias MLP's input, sign·log1p of the relative coordinates:
    ``[N*N, 2]``, or with ``lat_mean`` (each window's mean latitude in
    degrees, ``[nW]``) ``[nW, N*N, 2]`` with the longitude offsets scaled
    by cos(lat) (the JAX package's numpy expressions)."""
    base = _rel_coords(window_size)
    if lat_mean is None:
        return np.sign(base) * np.log1p(np.abs(base))
    lat_rad = np.asarray(lat_mean, np.float32) * (np.pi / 180.0)
    n_w = lat_rad.shape[0]
    h_off = np.broadcast_to(base[None, :, 0], (n_w, base.shape[0]))
    w_off = base[None, :, 1] * np.cos(lat_rad)[:, None]
    coords = np.stack([h_off, w_off], axis=-1)
    return np.sign(coords) * np.log1p(np.abs(coords))


class WindowAttention2D(nn.Module):
    """Cosine window attention with a continuous position bias (port of
    ace_tpu/models/swin.py:149): q and k normalized in float32 (the
    denominator clamped at 1e-6), a per-head temperature ``tau`` clamped
    at 0.01, the bias ``16 sigmoid(cpb(log coords))`` (the output layer
    starts at zero), the shifted windows' mask, softmax in float32."""

    def __init__(self, dim, window_size, num_heads, cpb_hidden_dim=64,
                 lat_mean=None, dtype=torch.float32, device=None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.window_size = tuple(window_size)
        self.qkv = _dense(dim, 3 * dim, dtype=dtype, device=device)
        self.tau = nn.Parameter(torch.ones(1, num_heads, 1, 1, device=device))
        self.cpb_fc1 = _dense(2, cpb_hidden_dim, device=device)
        self.cpb_fc2 = _dense(cpb_hidden_dim, num_heads, device=device,
                              init="zeros")
        self.proj = _dense(dim, dim, dtype=dtype, device=device)
        self.per_window = lat_mean is not None
        self.register_buffer(
            "log_coords", torch.as_tensor(
                cpb_log_coords(self.window_size, lat_mean), device=device),
            persistent=False)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.tau.fill_(1.0)

    def bias(self) -> torch.Tensor:
        """``[heads, N, N]``, or ``[nW, heads, N, N]`` per window."""
        h = self.cpb_fc2(F.relu(self.cpb_fc1(self.log_coords)))
        bias = 16.0 * torch.sigmoid(h)
        n = self.window_size[0] * self.window_size[1]
        if not self.per_window:
            return bias.t().reshape(self.num_heads, n, n)
        return bias.transpose(1, 2).reshape(-1, self.num_heads, n, n)

    def forward(self, x, mask=None):
        n_win, n_tokens, c = x.shape
        heads = self.num_heads
        qkv = self.qkv(x).reshape(n_win, n_tokens, 3, heads, c // heads)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        q32, k32 = q.float(), k.float()
        nq = torch.linalg.vector_norm(q32, dim=-1, keepdim=True)
        nk = torch.linalg.vector_norm(k32, dim=-1, keepdim=True)
        denom = torch.clamp(nq * nk.transpose(-2, -1), min=1e-6)
        attn = torch.matmul(q32, k32.transpose(-2, -1)) / denom
        attn = attn / torch.clamp(self.tau, min=0.01)
        bias = self.bias()
        if not self.per_window:
            attn = attn + bias[None]
        else:
            attn = (attn.reshape(-1, bias.shape[0], heads, n_tokens, n_tokens)
                    + bias[None]).reshape(-1, heads, n_tokens, n_tokens)
        if mask is not None:
            attn = (attn.reshape(-1, mask.shape[0], heads, n_tokens, n_tokens)
                    + mask[None, :, None]).reshape(-1, heads, n_tokens,
                                                   n_tokens)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(n_win, n_tokens, c)
        return self.proj(out)


def shifted_window_mask(input_resolution, window_size, shift_size):
    """The shifted windows' attention mask ``[nW, N, N]`` (−100 between
    tokens from different regions), or None without a shift."""
    sh, sw = shift_size
    if sh == 0 and sw == 0:
        return None
    h, w = input_resolution
    wh, ww = window_size
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, h - wh), slice(h - wh, h - sh), slice(h - sh, None)):
        for ws in (slice(0, w - ww), slice(w - ww, w - sw),
                   slice(w - sw, None)):
            img_mask[:, hs, ws] = cnt
            cnt += 1
    m = img_mask.reshape(1, h // wh, wh, w // ww, ww, 1)
    m = m.transpose(0, 1, 3, 2, 4, 5).reshape(-1, wh * ww)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_lat_mean(lat_coords, input_resolution, window_size, shift_size):
    """Each window's mean latitude (the latitudes rolled by −shift), or
    None without latitudes."""
    if lat_coords is None:
        return None
    h, w = input_resolution
    wh, ww = window_size
    sh = shift_size[0]
    lat = np.asarray(lat_coords, np.float32)
    if sh != 0:
        lat = np.roll(lat, -sh)
    n_h, n_w = h // wh, w // ww
    return np.repeat(lat[:h].reshape(n_h, wh).mean(1), n_w)


class SwinTransformerBlock(nn.Module):
    """Post-norm Swin block with the column mixer and AdaLN or CLN
    conditioning (port of ace_tpu/models/swin.py:243)."""

    def __init__(self, dim, input_resolution, num_heads, window_size,
                 shift_size, mlp_ratio=4.0, drop_path=0.0, mlp_layer="mlp",
                 conditioning="adaln", noise_embed_dim=0, embed_dim_labels=0,
                 cpb_hidden_dim=64, lat_coords=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        self.conditioning = conditioning
        self.attn = WindowAttention2D(
            dim, window_size, num_heads, cpb_hidden_dim,
            lat_mean=window_lat_mean(lat_coords, input_resolution,
                                     window_size, shift_size),
            dtype=dtype, device=device)
        mask = shifted_window_mask(input_resolution, window_size, shift_size)
        self.register_buffer(
            "attn_mask", None if mask is None else torch.as_tensor(
                mask, device=device), persistent=False)
        self.column_mixer = _dense(dim, dim, dtype=dtype, device=device)
        hidden = int(dim * mlp_ratio)
        mlp = SwiGLU if mlp_layer == "swiglu" else Mlp
        self.mlp = mlp(dim, hidden, dtype=dtype, device=device)
        if conditioning == "cln":
            self.norm1, self.norm2 = (ConditionalLayerNorm(
                dim, noise_embed_dim, embed_dim_labels=embed_dim_labels,
                device=device) for _ in range(2))
        else:
            self.norm1, self.norm2 = (LayerNorm(dim, 1e-5, device=device)
                                      for _ in range(2))
        self.drop_path = DropPath(drop_path)

    def forward(self, x, cond_params=None, noise=None, labels=None,
                deterministic=True, generator=None):
        h_res, w_res = self.input_resolution
        wh, ww = self.window_size
        sh, sw = self.shift_size
        shortcut = x
        h = torch.roll(x, (-sh, -sw), dims=(1, 2)) if sh or sw else x
        h = self.attn(window_partition(h, wh, ww), mask=self.attn_mask)
        h = window_reverse(h, wh, ww, h_res, w_res)
        if sh or sw:
            h = torch.roll(h, (sh, sw), dims=(1, 2))
        h = h + self.column_mixer(h)

        def drop(y):
            return self.drop_path(y, deterministic, generator)

        if self.conditioning == "cln":
            x = shortcut + drop(self.norm1(h, noise, labels))
            return x + drop(self.norm2(self.mlp(x), noise, labels))
        if cond_params is not None:
            (shift_msa, scale_msa, gate_msa,
             shift_mlp, scale_mlp, gate_mlp) = cond_params
            h_norm = self.norm1(h) * (1 + scale_msa) + shift_msa
            x = shortcut + gate_msa * drop(h_norm)
            h_norm = self.norm2(self.mlp(x)) * (1 + scale_mlp) + shift_mlp
            return x + gate_mlp * drop(h_norm)
        x = shortcut + drop(self.norm1(h))
        return x + drop(self.norm2(self.mlp(x)))


class PatchMerging(nn.Module):
    """2x downsample: the 2x2 neighbours concatenated -> LayerNorm(4C) ->
    Linear(4C -> 2C, no bias)."""

    def __init__(self, dim, dtype=torch.float32, device=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, 1e-5, device=device)
        self.reduction = _dense(4 * dim, 2 * dim, bias=False, dtype=dtype,
                                device=device)

    def forward(self, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class PatchExpanding(nn.Module):
    """2x upsample: Linear(C -> 2C) -> pixel shuffle (channels-last, ``k =
    c_out*4 + i*2 + j``) -> LayerNorm -> Linear."""

    def __init__(self, dim, dtype=torch.float32, device=None):
        super().__init__()
        self.out_dim = dim // 2
        self.expand = _dense(dim, 2 * dim, bias=False, dtype=dtype,
                             device=device)
        self.norm = LayerNorm(self.out_dim, 1e-5, device=device)
        self.linear = _dense(self.out_dim, self.out_dim, bias=False,
                             dtype=dtype, device=device)

    def forward(self, x):
        b, h, w, _ = x.shape
        x = self.expand(x).reshape(b, h, w, self.out_dim, 2, 2)
        x = x.permute(0, 1, 4, 2, 5, 3).reshape(b, 2 * h, 2 * w, self.out_dim)
        return self.linear(self.norm(x))


class BasicLayer(nn.Module):
    """A stage of Swin blocks with its AdaLN projections (which start at
    zero); odd blocks shift by half a window (port of
    ace_tpu/models/swin.py:411)."""

    def __init__(self, dim, input_resolution, depth, num_heads, window_size,
                 mlp_ratio, drop_path, embed_dim_scalar=0, embed_dim_labels=0,
                 mlp_layer="mlp", conditioning="adaln", noise_embed_dim=0,
                 cpb_hidden_dim=64, lat_coords=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.depth, self.conditioning = depth, conditioning
        self.embed_dim_scalar = embed_dim_scalar
        if conditioning == "adaln" and embed_dim_labels > 0:
            self.adaln_labels = _dense(embed_dim_labels, 6 * dim,
                                       device=device, init="zeros")
        wh, ww = window_size
        cln = conditioning == "cln"
        for i in range(depth):
            self.add_module(f"blocks_{i}", SwinTransformerBlock(
                dim, input_resolution, num_heads, window_size,
                (0, 0) if i % 2 == 0 else (wh // 2, ww // 2),
                mlp_ratio=mlp_ratio, drop_path=drop_path[i],
                mlp_layer=mlp_layer, conditioning=conditioning,
                noise_embed_dim=noise_embed_dim if cln else 0,
                embed_dim_labels=embed_dim_labels if cln else 0,
                cpb_hidden_dim=cpb_hidden_dim, lat_coords=lat_coords,
                dtype=dtype, device=device))

    def forward(self, x, cond_labels=None, noise=None, labels=None,
                deterministic=True, generator=None):
        cond_params = None
        if self.conditioning == "adaln":
            if self.embed_dim_scalar > 0:
                # the net passes no scalar conditioning (as in the JAX
                # package, where this raises at the first call)
                raise ValueError(
                    "cond_scalar required for scalar-conditioned layer")
            if hasattr(self, "adaln_labels") and cond_labels is not None:
                raw = self.adaln_labels(F.silu(cond_labels))
                cond_params = tuple(p[:, None, None, :]
                                    for p in raw.chunk(6, dim=-1))
        for i in range(self.depth):
            x = getattr(self, f"blocks_{i}")(
                x, cond_params=cond_params, noise=noise, labels=labels,
                deterministic=deterministic, generator=generator)
        return x


class SwinTransformerNet(nn.Module):
    """2D Swin U-Net (port of ace_tpu/models/swin.py:489).

    ``forward(x, noise=None, generator=None, deterministic=True,
    labels=None)`` maps ``[B, H, W, in_chans]`` to ``[B, H, W,
    out_chans]`` float32. The input is optionally earth- or
    mirror-padded, then zero-padded to a multiple of twice the window;
    the output is cropped back. With ``conditioning="cln"`` and
    ``noise_embed_dim > 0`` a noise field ``[B, H, W, noise_embed_dim]``
    conditions every block's norms: ``noise`` when given, else drawn with
    ``generator`` (zeros without one, as the JAX net without a "noise"
    rng); the half-resolution stages take ``noise[:, ::2, ::2]`` of the
    padded field. Drop path draws from ``generator`` when not
    ``deterministic``.
    """

    def __init__(self, in_chans, out_chans, img_shape, embed_dim=96,
                 depth_multiplier=1, num_heads: Sequence[int] = (3, 6, 6, 3),
                 window_size=(4, 8), mlp_ratio=4.0, drop_path_rate=0.2,
                 use_skip=True, mlp_layer="mlp", conditioning="adaln",
                 embed_dim_scalar=0, n_labels=0, label_embed_dim=0,
                 noise_embed_dim=0, cpb_hidden_dim=64, lat_coords=None,
                 padding_mode=None, pad_lat=(0, 0), pad_lon=(0, 0),
                 dtype=torch.float32, device=None):
        super().__init__()
        self.img_shape = tuple(img_shape)
        self.window_size = tuple(window_size)
        self.conditioning = conditioning
        self.noise_embed_dim = noise_embed_dim
        self.n_labels = n_labels
        self.use_skip = use_skip
        self.padding_mode = padding_mode
        self.pad_lat, self.pad_lon = tuple(pad_lat), tuple(pad_lon)
        self.dtype = dtype
        self.lat_coords = lat_coords
        h0, w0, hp, wp = self.padded_geometry()
        lat_full, lat_half = self._padded_lat(h0, hp)
        if n_labels > 0 and label_embed_dim > 0:
            self.label_embedding = _dense(n_labels, label_embed_dim,
                                          device=device)
        label_dim = label_embed_dim if label_embed_dim > 0 else n_labels
        self.encoder = Conv3x3(in_chans, embed_dim, dtype=dtype, device=device)
        self.channel_mixer = _dense(embed_dim, embed_dim, dtype=dtype,
                                    device=device)
        d = depth_multiplier
        dpr = np.linspace(0.0, drop_path_rate / d, 8 * d).tolist()
        dpr_shallow, dpr_deep = tuple(dpr[:2 * d]), tuple(dpr[2 * d:8 * d])

        def stage(dim, res, depth, heads, rates, lat):
            return BasicLayer(
                dim, res, depth, heads, self.window_size, mlp_ratio, rates,
                embed_dim_scalar=embed_dim_scalar, embed_dim_labels=label_dim,
                mlp_layer=mlp_layer, conditioning=conditioning,
                noise_embed_dim=noise_embed_dim,
                cpb_hidden_dim=cpb_hidden_dim, lat_coords=lat, dtype=dtype,
                device=device)

        half = (hp // 2, wp // 2)
        self.layer1 = stage(embed_dim, (hp, wp), 2 * d, num_heads[0],
                            dpr_shallow, lat_full)
        self.downsample = PatchMerging(embed_dim, dtype=dtype, device=device)
        # stages 2 and 3 both take the deep rates (as in the JAX package)
        self.layer2 = stage(2 * embed_dim, half, 6 * d, num_heads[1],
                            dpr_deep, lat_half)
        self.layer3 = stage(2 * embed_dim, half, 6 * d, num_heads[2],
                            dpr_deep, lat_half)
        self.upsample = PatchExpanding(2 * embed_dim, dtype=dtype,
                                       device=device)
        decoder_dim = 2 * embed_dim if use_skip else embed_dim
        self.layer4 = stage(decoder_dim, (hp, wp), 2 * d, num_heads[3],
                            dpr_shallow, lat_full)
        self.final_linear = _dense(decoder_dim, embed_dim, bias=False,
                                   dtype=dtype, device=device)
        self.decoder = Conv3x3(embed_dim, out_chans, dtype=dtype,
                               device=device)
        self.label_dim = label_dim

    def padded_geometry(self):
        """The boundary-padded shape ``(h0, w0)`` and its zero-padded
        multiple of twice the window ``(hp, wp)``."""
        h0, w0 = self.img_shape
        if self.padding_mode is not None:
            h0 += self.pad_lat[0] + self.pad_lat[1]
            w0 += self.pad_lon[0] + self.pad_lon[1]
        mh, mw = 2 * self.window_size[0], 2 * self.window_size[1]
        return h0, w0, math.ceil(h0 / mh) * mh, math.ceil(w0 / mw) * mw

    def _padded_lat(self, h0, hp):
        """The latitudes of the padded rows (reversed rows repeat at the
        boundary pads, the last row fills the zero pad) and of the half
        resolution, or None."""
        if self.lat_coords is None:
            return None, None
        lat = np.asarray(self.lat_coords, np.float32)
        if self.padding_mode is not None:
            pn, ps = self.pad_lat
            parts = []
            if pn > 0:
                parts.append(lat[:pn][::-1])
            parts.append(lat)
            if ps > 0:
                parts.append(lat[-ps:][::-1])
            lat = np.concatenate(parts)
        if hp > h0:
            lat = np.concatenate([lat, np.full(hp - h0, lat[-1], np.float32)])
        lat_half = (lat[::2] + lat[1::2]) / 2
        return tuple(lat.tolist()), tuple(lat_half.tolist())

    def make_noise(self, x, generator=None):
        """The noise field ``[B, H, W, noise_embed_dim]`` float32 at the
        input's shape, drawn with ``generator`` (zeros without one); None
        unless the net is noise-conditioned."""
        if self.conditioning != "cln" or self.noise_embed_dim == 0:
            return None
        b, h, w, _ = x.shape
        shape = (b, h, w, self.noise_embed_dim)
        if generator is None:
            return torch.zeros(shape, device=x.device)
        return torch.randn(shape, generator=generator, device=x.device)

    def _boundary_pad(self, x):
        if self.padding_mode == "earth":
            return earth_pad(x, self.pad_lat, self.pad_lon)
        if self.padding_mode == "mirror":
            return mirror_pad(x, self.pad_lat, self.pad_lon)
        return x

    def forward(self, x, noise=None, generator=None, deterministic=True,
                labels=None):
        x = x.to(self.dtype)
        if noise is None:
            noise = self.make_noise(x, generator)
        x = self._boundary_pad(x)
        if noise is not None:
            noise = self._boundary_pad(noise)
        h0, w0, hp, wp = self.padded_geometry()
        if hp > h0 or wp > w0:
            x = F.pad(x, (0, 0, 0, wp - w0, 0, hp - h0))
            if noise is not None:
                noise = F.pad(noise, (0, 0, 0, wp - w0, 0, hp - h0))
        noise_half = noise[:, ::2, ::2] if noise is not None else None

        lab = None
        if self.n_labels > 0:
            lab = labels
            if lab is None:
                lab = torch.zeros(x.shape[0], self.n_labels, device=x.device)
            lab = lab.float()
            if hasattr(self, "label_embedding"):
                lab = self.label_embedding(lab)
        kw = dict(deterministic=deterministic, generator=generator)
        if self.label_dim > 0:
            kw["labels" if self.conditioning == "cln" else "cond_labels"] = lab

        x = self.encoder(x)
        x = x + self.channel_mixer(x)
        x = self.layer1(x, noise=noise, **kw)
        skip = x
        x = self.downsample(x)
        x = self.layer2(x, noise=noise_half, **kw)
        x = self.layer3(x, noise=noise_half, **kw)
        x = self.upsample(x)
        if self.use_skip:
            x = torch.cat([x, skip], dim=-1)
        x = self.layer4(x, noise=noise, **kw)
        out = self.decoder(self.final_linear(x))[:, :h0, :w0]
        if self.padding_mode is not None:
            out = boundary_unpad(out, self.pad_lat, self.pad_lon)
        return out.float()
