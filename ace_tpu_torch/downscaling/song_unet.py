"""SongUNet v2, the HiRO-ACE diffusion backbone (port of
ace_tpu/downscaling/song_unet.py).

The module takes and returns channels-last tensors, as ``ace_tpu``'s
does, and runs NCHW inside: cuDNN convolutions, ``F.group_norm`` and
``torch.matmul`` attention. Every reshape that depends on the channel
order keeps ``ace_tpu``'s: the group norm's groups are runs of
consecutive channels, and the attention's qkv channels are ordered
``(heads, C / heads, 3)``. Parameter names follow the flax tree one to one
(a ``Conv2d``'s ``conv.kernel`` is ``F.conv2d``'s ``[out, in, kh, kw]``
under flax's name, a ``Linear``'s ``linear.weight`` is ``nn.Linear``'s),
so ``utils/convert.py`` maps them both ways. The Fourier embedding's
frequencies are a persistent buffer (``ace_tpu`` keeps them as a
gradient-stopped parameter; Adam never moves them there either).

Dropout draws from an explicit ``torch.Generator`` when the call is not
deterministic; with ``checkpointing >= 1`` each block is recomputed in the
backward pass and replays its draws.
"""

import functools
import math
from collections.abc import Sequence

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ace_tpu_torch.device import cached_on_device
from ace_tpu_torch.models.layers import dropout, replaying, trunc_normal_init


def groupnorm_groups(num_channels: int, num_groups: int = 32,
                     min_channels_per_group: int = 4) -> int:
    """The group count of a group norm over ``num_channels``."""
    groups = min(
        num_groups,
        (num_channels + min_channels_per_group - 1) // min_channels_per_group,
    )
    if num_channels % groups != 0:
        raise ValueError(
            "num_channels must be divisible by num_groups or "
            "min_channels_per_group"
        )
    return groups


def _xavier_uniform_(tensor: torch.Tensor, fan_in: int, fan_out: int,
                     scale: float, generator=None):
    """flax ``variance_scaling(1, "fan_avg", "uniform")`` times ``scale``."""
    limit = math.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
    with torch.no_grad():
        tensor.uniform_(-limit, limit, generator=generator).mul_(scale)


class GroupNorm(nn.Module):
    """Group norm over NCHW with float32 statistics (biased variance) and
    an optional fused SiLU; the output keeps the input's dtype."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 act: str | None = None, device=None):
        super().__init__()
        if act not in (None, "silu"):
            raise ValueError(f"unsupported fused activation {act!r}")
        self.groups = groupnorm_groups(channels)
        self.eps, self.act = eps, act
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.groups, self.weight, self.bias,
                         self.eps).to(x.dtype)
        return F.silu(y) if self.act == "silu" else y


def resample_filter_2d(resample_filter: Sequence[int]) -> np.ndarray:
    """``[k]`` -> the normalized ``[k, k]`` outer-product filter."""
    f = np.asarray(resample_filter, np.float32)
    return np.outer(f, f) / (f.sum() ** 2)


_FILTERS: dict = {}


def _filter(filt2d: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """``filt2d`` on ``x``'s device in its dtype, copied there once
    without waiting for the device."""
    array = np.ascontiguousarray(filt2d, np.float32)
    tensor = cached_on_device(_FILTERS, array.tobytes().hex(), array,
                              x.device)
    return tensor.to(x.dtype)


def depthwise_down(x: torch.Tensor, filt2d: np.ndarray, stride_pad=None
                   ) -> torch.Tensor:
    """Stride-2 depthwise filter over NCHW (padding ``(k - 1) // 2``, or
    ``stride_pad``)."""
    c, k = x.shape[1], filt2d.shape[0]
    pad = (k - 1) // 2 if stride_pad is None else stride_pad
    return F.conv2d(x, _filter(filt2d, x).expand(c, 1, k, k), stride=2,
                    padding=pad, groups=c)


def depthwise_up(x: torch.Tensor, filt2d: np.ndarray) -> torch.Tensor:
    """Stride-2 transposed depthwise filter x4 over NCHW: output ``(H - 1)
    * 2 - 2p + k``, as ``ace_tpu``'s input-dilated convolution with
    padding ``k - 1 - p`` (the filters are symmetric: no flip)."""
    c, k = x.shape[1], filt2d.shape[0]
    return F.conv_transpose2d(x, _filter(filt2d * 4.0, x).expand(c, 1, k, k),
                              stride=2, padding=(k - 1) // 2, groups=c)


class _Conv(nn.Module):
    """flax ``nn.Conv`` (square kernel, symmetric zero padding
    ``padding``) over NCHW, computing in ``dtype``; xavier-uniform kernel
    times ``init_weight``, zero bias."""

    def __init__(self, cin, cout, kernel, bias=True, padding=None,
                 init_weight=1.0, dtype=torch.float32, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cout, cin, kernel, kernel,
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(cout, device=device))
                     if bias else None)
        self.padding = kernel // 2 if padding is None else padding
        self.init_weight, self.compute_dtype = init_weight, dtype
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        cout, cin, kh, kw = self.kernel.shape
        _xavier_uniform_(self.kernel, kh * kw * cin, kh * kw * cout,
                         self.init_weight, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.kernel.to(dt), bias,
                        padding=self.padding)


class Conv2d(nn.Module):
    """A convolution (``conv``) after an optional depthwise up- or
    down-sampling."""

    def __init__(self, in_channels, out_channels, kernel, up=False,
                 down=False, resample_filter=(1, 1), init_weight=1.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.up, self.down = up, down
        self.filt = resample_filter_2d(resample_filter)
        self.conv = _Conv(in_channels, out_channels, kernel,
                          init_weight=init_weight, dtype=dtype, device=device)

    def forward(self, x):
        if self.up:
            x = depthwise_up(x, self.filt)
        if self.down:
            x = depthwise_down(x, self.filt)
        return self.conv(x)


class Linear(nn.Module):
    """A dense layer (``linear``) with a xavier-uniform weight."""

    def __init__(self, n_in, n_out, use_bias=True, init_weight=1.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.linear = nn.Module()
        self.linear.weight = nn.Parameter(torch.empty(n_out, n_in,
                                                      device=device))
        self.linear.bias = (nn.Parameter(torch.zeros(n_out, device=device))
                            if use_bias else None)
        self.init_weight, self.compute_dtype = init_weight, dtype
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        n_out, n_in = self.linear.weight.shape
        _xavier_uniform_(self.linear.weight, n_in, n_out, self.init_weight,
                         generator)
        if self.linear.bias is not None:
            with torch.no_grad():
                self.linear.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        bias = self.linear.bias
        return F.linear(x.to(dt), self.linear.weight.to(dt),
                        None if bias is None else bias.to(dt))


def positional_embedding(x: torch.Tensor, num_channels: int,
                         max_positions: int = 10000,
                         endpoint: bool = True) -> torch.Tensor:
    """The cos/sin noise-level embedding, ``[B]`` -> ``[B, num_channels]``."""
    half = num_channels // 2
    freqs = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = freqs / (half - (1 if endpoint else 0))
    freqs = (1.0 / max_positions) ** freqs
    x = x[:, None].float() * freqs[None, :]
    return torch.cat([torch.cos(x), torch.sin(x)], dim=1)


class FourierEmbedding(nn.Module):
    """Random Fourier features of the noise level; the frequencies (normal
    times ``scale``) are a buffer."""

    def __init__(self, num_channels: int, scale: float = 16.0, device=None):
        super().__init__()
        self.scale = scale
        self.register_buffer("freqs", torch.empty(num_channels // 2,
                                                  device=device))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.freqs.normal_(generator=generator).mul_(self.scale)

    def forward(self, x):
        x = x[:, None].float() * (2 * np.pi * self.freqs)[None, :]
        return torch.cat([torch.cos(x), torch.sin(x)], dim=1)


class Attention(nn.Module):
    """Self-attention over the pixels with a group norm and 1x1 qkv/proj
    convolutions; float32 scores and softmax."""

    def __init__(self, channels, num_heads, eps=1e-5, init_attn_weight=1.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm(channels, eps=eps, device=device)
        self.qkv = Conv2d(channels, channels * 3, 1,
                          init_weight=init_attn_weight, dtype=dtype,
                          device=device)
        self.proj = Conv2d(channels, channels, 1, init_weight=1e-5,
                           dtype=dtype, device=device)

    def forward(self, x):
        b, c, h, w = x.shape
        dk = c // self.num_heads
        qkv = self.qkv(self.norm(x)).reshape(b, self.num_heads, dk, 3, h * w)
        q, k, v = qkv.unbind(3)  # [B, heads, dk, HW]
        logits = torch.matmul(q.transpose(-1, -2).float(), k.float())
        attn = torch.softmax(logits / math.sqrt(dk), dim=-1).to(v.dtype)
        out = torch.matmul(v, attn.transpose(-1, -2))  # [B, heads, dk, HW]
        out = out.reshape(b, c, h, w).to(x.dtype)
        return x + self.proj(out)


class UNetBlock(nn.Module):
    """SongUNetv2's block: norm, conv (with resampling), the embedding's
    affine shift, norm, dropout, conv, skip, and an optional attention."""

    def __init__(self, in_channels, out_channels, emb_channels, up=False,
                 down=False, attention=False, num_heads=1, dropout=0.0,
                 skip_scale=1.0 / math.sqrt(2.0), eps=1e-6,
                 resample_filter=(1, 1), init_attn_weight=math.sqrt(0.2),
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dropout, self.skip_scale = dropout, skip_scale
        kw = dict(dtype=dtype, device=device)
        self.norm0 = GroupNorm(in_channels, eps=eps, act="silu",
                               device=device)
        self.conv0 = Conv2d(in_channels, out_channels, 3, up=up, down=down,
                            resample_filter=resample_filter, **kw)
        self.affine = Linear(emb_channels, out_channels, device=device)
        self.norm1 = GroupNorm(out_channels, eps=eps, act="silu",
                               device=device)
        self.conv1 = Conv2d(out_channels, out_channels, 3, init_weight=1e-5,
                            **kw)
        self.skip = (Conv2d(in_channels, out_channels, 1, up=up, down=down,
                            resample_filter=resample_filter, **kw)
                     if out_channels != in_channels or up or down else None)
        self.attn = (Attention(out_channels, num_heads, eps=eps,
                               init_attn_weight=init_attn_weight, **kw)
                     if attention else None)

    def forward(self, x, emb, deterministic=True, generator=None):
        orig = x
        x = self.conv0(self.norm0(x))
        params = self.affine(emb)
        x = self.norm1(x + params[:, :, None, None])
        x = dropout(x, self.dropout, deterministic, generator)
        x = self.conv1(x)
        skip = self.skip(orig) if self.skip is not None else orig
        x = (x + skip) * self.skip_scale
        if self.attn is not None:
            x = self.attn(x) * self.skip_scale
        return x


class _BlockPlan:
    __slots__ = ("name", "kind", "cin", "cout", "attn")

    def __init__(self, name, kind, cin=0, cout=0, attn=False):
        self.name, self.kind = name, kind
        self.cin, self.cout, self.attn = cin, cout, attn


def song_unet_plan(img_resolution, in_channels, out_channels,
                   model_channels, channel_mult, num_blocks,
                   attn_resolutions, encoder_type, decoder_type,
                   bottleneck_attention):
    """The encoder and decoder plans of ``ace_tpu``'s ``SongUNetV2._plan``
    (names, kinds, channels, attention)."""
    enc: list[_BlockPlan] = []
    cout = caux = in_channels
    for level, mult in enumerate(channel_mult):
        res = img_resolution >> level
        if level == 0:
            cin, cout = cout, model_channels
            enc.append(_BlockPlan(f"enc_{res}x{res}_conv", "conv", cin, cout))
        else:
            enc.append(_BlockPlan(f"enc_{res}x{res}_down", "down", cout,
                                  cout))
            if encoder_type == "skip":
                enc.append(_BlockPlan(f"enc_{res}x{res}_aux_down",
                                      "aux_down", caux, caux))
                enc.append(_BlockPlan(f"enc_{res}x{res}_aux_skip",
                                      "aux_skip", caux, cout))
            if encoder_type == "residual":
                enc.append(_BlockPlan(f"enc_{res}x{res}_aux_residual",
                                      "aux_residual", caux, cout))
                caux = cout
        for idx in range(num_blocks):
            cin, cout = cout, model_channels * mult
            enc.append(_BlockPlan(f"enc_{res}x{res}_block{idx}", "block",
                                  cin, cout, attn=res in attn_resolutions))
    skips = [p.cout for p in enc if "aux" not in p.kind]

    dec: list[_BlockPlan] = []
    last = len(channel_mult) - 1
    for level, mult in reversed(list(enumerate(channel_mult))):
        res = img_resolution >> level
        if level == last:
            dec.append(_BlockPlan(f"dec_{res}x{res}_in0", "in0", cout, cout,
                                  attn=bottleneck_attention))
            dec.append(_BlockPlan(f"dec_{res}x{res}_in1", "in1", cout, cout))
        else:
            dec.append(_BlockPlan(f"dec_{res}x{res}_up", "up", cout, cout))
        for idx in range(num_blocks + 1):
            cin, cout = cout + skips.pop(), model_channels * mult
            dec.append(_BlockPlan(
                f"dec_{res}x{res}_block{idx}", "block", cin, cout,
                attn=idx == num_blocks and res in attn_resolutions))
        if decoder_type == "skip" or level == 0:
            if decoder_type == "skip" and level < last:
                dec.append(_BlockPlan(f"dec_{res}x{res}_aux_up", "aux_up",
                                      out_channels, out_channels))
            dec.append(_BlockPlan(f"dec_{res}x{res}_aux_norm", "aux_norm",
                                  cout, cout))
            dec.append(_BlockPlan(f"dec_{res}x{res}_aux_conv", "aux_conv",
                                  cout, out_channels))
    return enc, dec


class SongUNetV2(nn.Module):
    """``(x [B, H, W, C_out], condition [B, H, W, C_cond], c_noise [B])``
    -> ``[B, H, W, C_out]``; ``x`` and ``condition`` are concatenated
    (``in_channels`` counts both)."""

    def __init__(self, img_resolution: int, in_channels: int,
                 out_channels: int, label_dim: int = 0, augment_dim: int = 0,
                 model_channels: int = 128,
                 channel_mult: Sequence[int] = (1, 2, 2, 2),
                 channel_mult_emb: int = 4, num_blocks: int = 4,
                 attn_resolutions: Sequence[int] = (16,),
                 dropout: float = 0.10, label_dropout: float = 0.0,
                 embedding_type: str = "positional",
                 channel_mult_noise: int = 1,
                 encoder_type: str = "standard",
                 decoder_type: str = "standard",
                 resample_filter: Sequence[int] = (1, 1),
                 additive_pos_embed: bool = False,
                 bottleneck_attention: bool = True, checkpointing: int = 0,
                 dtype=torch.float32, device=None):
        super().__init__()
        if embedding_type not in ("positional", "fourier", "zero"):
            raise ValueError(f"invalid embedding_type {embedding_type!r}")
        self.img_resolution = img_resolution
        self.model_channels = model_channels
        self.label_dim, self.augment_dim = label_dim, augment_dim
        self.dropout, self.label_dropout = dropout, label_dropout
        self.embedding_type = embedding_type
        self.additive_pos_embed = additive_pos_embed
        self.checkpointing = checkpointing
        self.dtype = dtype
        self.filt = resample_filter_2d(resample_filter)
        noise_channels = model_channels * channel_mult_noise
        self.emb_channels = emb_channels = model_channels * channel_mult_emb
        self.noise_channels = noise_channels
        kw = dict(dtype=dtype, device=device)

        if embedding_type == "fourier":
            self.map_noise = FourierEmbedding(noise_channels, device=device)
        if embedding_type != "zero":
            if label_dim:
                self.map_label = Linear(label_dim, noise_channels,
                                        device=device)
            if augment_dim:
                self.map_augment = Linear(augment_dim, noise_channels,
                                          use_bias=False, device=device)
            self.map_layer0 = Linear(noise_channels, emb_channels,
                                     device=device)
            self.map_layer1 = Linear(emb_channels, emb_channels,
                                     device=device)

        self.enc_plan, self.dec_plan = song_unet_plan(
            img_resolution, in_channels, out_channels, model_channels,
            tuple(channel_mult), num_blocks, tuple(attn_resolutions),
            encoder_type, decoder_type, bottleneck_attention)
        rf = tuple(resample_filter)

        def block(plan, up=False, down=False):
            return UNetBlock(plan.cin, plan.cout, emb_channels, up=up,
                             down=down, attention=plan.attn, num_heads=1,
                             dropout=dropout, resample_filter=rf, **kw)

        for plan in self.enc_plan:
            if plan.kind == "conv":
                self.add_module(plan.name, Conv2d(plan.cin, plan.cout, 3,
                                                  **kw))
                if additive_pos_embed:
                    self.spatial_emb = nn.Parameter(torch.empty(
                        1, img_resolution, img_resolution, model_channels,
                        device=device))
            elif plan.kind == "down":
                self.add_module(plan.name, block(plan, down=True))
            elif plan.kind == "aux_skip":
                self.add_module(plan.name, Conv2d(plan.cin, plan.cout, 1,
                                                  **kw))
            elif plan.kind == "aux_residual":
                # a 3x3 conv padded (1 + filter pad) at full resolution,
                # then an unpadded stride-2 depthwise filter, then a bias
                pad = 1 + (self.filt.shape[0] - 1) // 2
                self.add_module(f"{plan.name}_conv", _Conv(
                    plan.cin, plan.cout, 3, bias=False, padding=pad,
                    device=device))
                self.register_parameter(f"{plan.name}_bias", nn.Parameter(
                    torch.zeros(plan.cout, device=device)))
            elif plan.kind == "block":
                self.add_module(plan.name, block(plan))
        for plan in self.dec_plan:
            if plan.kind in ("in0", "in1", "block"):
                self.add_module(plan.name, block(plan))
            elif plan.kind == "up":
                self.add_module(plan.name, block(plan, up=True))
            elif plan.kind == "aux_norm":
                self.add_module(plan.name, GroupNorm(plan.cin, eps=1e-6,
                                                     device=device))
            elif plan.kind == "aux_conv":
                self.add_module(plan.name, Conv2d(
                    plan.cin, plan.cout, 3, init_weight=1e-5, **kw))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            if self.additive_pos_embed:
                trunc_normal_init(self.spatial_emb, std=0.02,
                                  generator=generator)
            for plan in self.enc_plan:
                if plan.kind == "aux_residual":
                    getattr(self, f"{plan.name}_bias").zero_()

    def _block(self, name, x, emb, deterministic, generator):
        call = functools.partial(getattr(self, name),
                                 deterministic=deterministic,
                                 generator=generator)
        if self.checkpointing >= 1 and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                replaying(call, generator), x, emb, use_reentrant=False,
                preserve_rng_state=False)
        return call(x, emb)

    def _embedding(self, c_noise, deterministic, generator, class_labels,
                   augment_labels):
        b = c_noise.shape[0]
        if self.embedding_type == "zero":
            return torch.zeros(b, self.emb_channels, dtype=self.dtype,
                               device=c_noise.device)
        if self.embedding_type == "positional":
            emb = positional_embedding(c_noise, self.noise_channels)
        else:
            emb = self.map_noise(c_noise)
        emb = emb.reshape(b, 2, -1).flip(1).reshape(b, -1)  # sin, cos
        if self.label_dim:
            if class_labels is None:
                raise ValueError("label_dim > 0 requires class_labels")
            lab = class_labels
            if not deterministic and self.label_dropout:
                keep = torch.rand(b, 1, generator=generator,
                                  device=lab.device) >= self.label_dropout
                lab = lab * keep.to(lab.dtype)
            emb = emb + self.map_label(lab * np.sqrt(self.label_dim))
        if self.augment_dim and augment_labels is not None:
            emb = emb + self.map_augment(augment_labels)
        emb = F.silu(self.map_layer0(emb))
        emb = F.silu(self.map_layer1(emb))
        return emb.to(self.dtype)

    def forward(self, x, condition, c_noise, deterministic: bool = True,
                generator: torch.Generator | None = None, class_labels=None,
                augment_labels=None):
        x = torch.cat([x.to(self.dtype), condition.to(self.dtype)], dim=-1)
        x = x.permute(0, 3, 1, 2)
        emb = self._embedding(c_noise, deterministic, generator,
                              class_labels, augment_labels)
        run = functools.partial(self._block, emb=emb,
                                deterministic=deterministic,
                                generator=generator)

        skips, aux = [], x
        for plan in self.enc_plan:
            if plan.kind == "conv":
                x = getattr(self, plan.name)(x)
                if self.additive_pos_embed:
                    x = x + self.spatial_emb.permute(0, 3, 1, 2).to(x.dtype)
                skips.append(x)
            elif plan.kind == "aux_down":
                aux = depthwise_down(aux, self.filt)
            elif plan.kind == "aux_skip":
                x = x + getattr(self, plan.name)(aux)
                skips[-1] = x
            elif plan.kind == "aux_residual":
                a = getattr(self, f"{plan.name}_conv")(aux)
                a = depthwise_down(a, self.filt, stride_pad=0)
                a = a + getattr(self, f"{plan.name}_bias").to(
                    a.dtype)[:, None, None]
                x = (x + a) / np.sqrt(2.0)
                aux = x
                skips[-1] = x
            else:  # down, block
                x = run(plan.name, x)
                skips.append(x)

        aux_out = tmp = None
        for plan in self.dec_plan:
            if plan.kind == "aux_up":
                aux_out = depthwise_up(aux_out, self.filt)
            elif plan.kind == "aux_norm":
                tmp = getattr(self, plan.name)(x)
            elif plan.kind == "aux_conv":
                tmp = getattr(self, plan.name)(F.silu(tmp))
                aux_out = tmp if aux_out is None else tmp + aux_out
            else:
                if plan.kind == "block" and x.shape[1] != plan.cin:
                    x = torch.cat([x, skips.pop()], dim=1)
                x = run(plan.name, x)
        return aux_out.permute(0, 2, 3, 1)
