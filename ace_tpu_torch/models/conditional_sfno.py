"""Noise-conditioned SFNO, the ACE2-ERA5 architecture, channels-last
(port of ace_tpu/models/conditional_sfno.py).

Noise fields (gaussian, or SHT-synthesized isotropic) condition the layer
norms of every block: ``scale = 1 + W_s(noise)``, ``bias = W_b(noise)``,
both zero-initialized. With ``n_labels`` set the one-hot dataset labels
(optionally through a learned ``label_embed``) are broadcast over the grid
and appended to the noise channels. Parameter names mirror the flax tree
(``block_0``, ``norm0``, ``w_scale_2d``, ``mlp.fc1`` ...), so
``utils/convert.py`` maps a JAX parameter tree onto ``state_dict`` keys one
to one.

The fused block tail (``ops/fused_block_tail.py``, kernel K2) is an
explicit choice, ``NoiseConditionedSFNO.use_fused_block_tail(True)``, off
by default as in the JAX package (where ``ACE_TPU_PALLAS_BLOCK=1`` turns
it on). It reads the same parameters as the unfused tail, so the
``state_dict`` is the same either way. ``checkpointing >= 1`` recomputes
each block in the backward pass (``torch.utils.checkpoint``), as the JAX
model's ``nn.remat`` does. Every option of the JAX model is ported: the
global layer norm, labels, local (DISCO) blocks (``models/localnet.py``'s
``DiscoFilterLayer``), LoRA and ``spectral_ratio`` (``models/sfno.py``).
"""

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ace_tpu_torch.models.layers import MLP, Linear, trunc_normal_init
from ace_tpu_torch.models.sfno import _ACTIVATIONS, SpectralConvS2
from ace_tpu_torch.ops.fused_block_tail import fused_block_tail
from ace_tpu_torch.ops.sht import build_isht, build_sht


class ChannelLayerNorm(nn.Module):
    """Per-pixel layer norm over the channel axis. bfloat16 input keeps
    the JAX package's mixed path: f32 statistics, bf16 centred values and
    a bf16 ``rsqrt`` factor."""

    eps = 1e-5

    def __init__(self, n_channels, elementwise_affine=False, device=None):
        super().__init__()
        if elementwise_affine:
            self.weight = nn.Parameter(torch.empty(n_channels, device=device))
            self.bias = nn.Parameter(torch.empty(n_channels, device=device))
        else:
            self.weight = self.bias = None

    def reset_parameters(self, generator=None):
        if self.weight is not None:
            with torch.no_grad():
                self.weight.fill_(1.0)
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if dt == torch.float32:
            mean = x.mean(-1, keepdim=True)
            var = (x - mean).square().mean(-1, keepdim=True)
            y = (x - mean) * torch.rsqrt(var + self.eps)
        else:
            mean = x.mean(-1, keepdim=True, dtype=torch.float32)
            xc = x - mean.to(dt)
            var = xc.square().mean(-1, keepdim=True, dtype=torch.float32)
            y = xc * torch.rsqrt(var + self.eps).to(dt)
        if self.weight is not None:
            y = y * self.weight.to(y.dtype) + self.bias.to(y.dtype)
        return y.to(dt)


class ConditionalLayerNorm(nn.Module):
    """Layer norm with scale and bias conditioned on per-pixel noise
    channels (port of ace_tpu/models/conditional_sfno.py:63).

    The channel norm normalizes each pixel over its channels
    (``ChannelLayerNorm``, its affine weights under ``norm``); the global
    one (``global_layer_norm``) normalizes each sample over (lat, lon,
    channel) in float32 and casts back, and then applies float32 affine
    weights of its own (``weight``, ``bias``), so that a bfloat16 input
    leaves an affine global norm as float32, as in JAX."""

    eps = 1e-5

    def __init__(self, n_channels, embed_dim_noise=0, elementwise_affine=False,
                 global_layer_norm=False, embed_dim_labels=0, device=None):
        super().__init__()
        self.global_layer_norm = global_layer_norm
        self.weight = self.bias = None
        if not global_layer_norm:
            self.norm = ChannelLayerNorm(
                n_channels, elementwise_affine=elementwise_affine,
                device=device
            )
        elif elementwise_affine:
            self.weight = nn.Parameter(torch.empty(n_channels, device=device))
            self.bias = nn.Parameter(torch.empty(n_channels, device=device))
        self.embed_dim_noise = embed_dim_noise
        if embed_dim_noise > 0:
            self.w_scale_2d = Linear(embed_dim_noise, n_channels, bias=False,
                                     device=device, init="zeros")
            self.w_bias_2d = Linear(embed_dim_noise, n_channels, bias=False,
                                    device=device, init="zeros")
        self.embed_dim_labels = embed_dim_labels
        if embed_dim_labels > 0:
            # per-sample label terms broadcast over the grid (the Swin
            # blocks'), zero-initialized
            self.w_scale_labels = Linear(embed_dim_labels, n_channels,
                                         device=device, init="zeros")
            self.w_bias_labels = Linear(embed_dim_labels, n_channels,
                                        device=device, init="zeros")

    def reset_parameters(self, generator=None):
        if self.weight is not None:
            with torch.no_grad():
                self.weight.fill_(1.0)
                self.bias.zero_()

    def _global_norm(self, x):
        x32 = x.float()
        mean = x32.mean((-3, -2, -1), keepdim=True)
        var = (x32 - mean).square().mean((-3, -2, -1), keepdim=True)
        y = ((x32 - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
        if self.weight is not None:
            y = y * self.weight + self.bias
        return y

    def forward(self, x, noise=None, labels=None):
        y = self._global_norm(x) if self.global_layer_norm else self.norm(x)
        if self.embed_dim_noise == 0 and self.embed_dim_labels == 0:
            return y
        scale, bias = 1.0, 0.0
        if self.embed_dim_noise > 0:
            if noise is None:
                raise ValueError("noise conditioning requires noise input")
            # the conditioning denses compute in the activation dtype, so
            # the full-grid scale/bias fields stay in it
            dt = y.dtype
            n = noise.to(dt)
            scale = 1.0 + F.linear(n, self.w_scale_2d.weight.to(dt))
            bias = F.linear(n, self.w_bias_2d.weight.to(dt))
        if self.embed_dim_labels > 0:
            if labels is None:
                raise ValueError("label conditioning requires labels input")
            lab = labels.to(y.dtype)
            scale = scale + self.w_scale_labels(lab)[:, None, None, :]
            bias = bias + self.w_bias_labels(lab)[:, None, None, :]
        return y * scale + bias


def isotropic_noise(isht, batch: int, channels: int,
                    generator: torch.Generator) -> torch.Tensor:
    """White spherical-harmonic coefficients drawn with ``generator`` and
    synthesized to the grid by ``isht`` with unit pointwise variance:
    ``[batch, nlat, nlon, channels]`` float32 (the JAX models' isotropic
    noise)."""
    lmax, mmax = isht.lmax, isht.mmax
    device = isht.pct.device
    cshape = (batch, lmax, mmax, channels)
    real = torch.randn(cshape, generator=generator, device=device)
    imag = torch.randn(cshape, generator=generator, device=device)
    imag[:, :, 0] = 0.0
    real[:, :, 1:] /= math.sqrt(2.0)
    imag[:, :, 1:] /= math.sqrt(2.0)
    scale = math.sqrt(4.0 * math.pi) / lmax
    return isht.inverse_pair(real * scale, imag * scale)


class ConditionalFNOBlock(nn.Module):
    """FNO block with noise-conditioned norms (port of
    ace_tpu/models/conditional_sfno.py:224): norm0, the filter (spectral,
    or a local DISCO filter for ``filter_type="local"``, whose residual is
    the normalized input), then the tail: the linear inner skip,
    activation, norm1, MLP, the identity outer skip.

    With ``fused_tail`` set, the tail goes through ``fused_block_tail``
    wherever the block computes that function (the JAX package's gate,
    conditional_sfno.py:301-312): bf16 activations, the MLP, the channel
    norm, GELU, and noise conditioning with noise given. Otherwise the
    unfused tail runs. The kernel's own width limits are the wrapper's to
    check: on the card it launches or raises.
    """

    def __init__(self, forward_transform, inverse_transform, embed_dim,
                 embed_dim_noise, mlp_ratio=2.0, activation="gelu",
                 use_mlp=True, global_layer_norm=False, affine_norms=False,
                 filter_type="spectral", kernel_shape=(3, 3),
                 basis_type="morlet", data_grid="legendre-gauss",
                 spectral_ratio=1.0, lora_rank=0, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.activation = activation
        self.act = _ACTIVATIONS[activation]
        self.embed_dim, self.embed_dim_noise = embed_dim, embed_dim_noise
        self.hidden = int(embed_dim * mlp_ratio)
        self.global_layer_norm = global_layer_norm
        self.filter_type = filter_type
        self.fused_tail = False
        self._tail_weights = None
        norm = dict(elementwise_affine=affine_norms,
                    global_layer_norm=global_layer_norm, device=device)
        self.norm0 = ConditionalLayerNorm(embed_dim, embed_dim_noise, **norm)
        if filter_type == "local":
            from ace_tpu_torch.models.localnet import DiscoFilterLayer

            self.filter = DiscoFilterLayer(
                (forward_transform.nlat, forward_transform.nlon), embed_dim,
                kernel_shape=kernel_shape, basis_type=basis_type,
                data_grid=data_grid, device=device,
            )
        else:
            self.filter = SpectralConvS2(
                forward_transform, inverse_transform, embed_dim, embed_dim,
                use_bias=True, spectral_ratio=spectral_ratio,
                lora_rank=lora_rank, device=device,
            )
        self.inner_skip = Linear(embed_dim, embed_dim, dtype=dtype,
                                 device=device)
        self.norm1 = ConditionalLayerNorm(embed_dim, embed_dim_noise, **norm)
        self.mlp = (
            MLP(embed_dim, self.hidden, embed_dim,
                act=self.act, dtype=dtype, device=device)
            if use_mlp else None
        )

    def _fuses(self, x_f, noise) -> bool:
        return (
            self.fused_tail
            and x_f.dtype == torch.bfloat16
            and self.mlp is not None
            and not self.global_layer_norm
            and self.activation == "gelu"
            and self.embed_dim_noise > 0
            and noise is not None
        )

    def tail_params(self) -> tuple[torch.Tensor, ...]:
        """The fused tail's weights as float32 views of the parameters
        (dense kernels ``[in, out]``): ``inner_skip``, ``norm1`` (ones and
        zeros without affine norms) and ``mlp``. Gradients reach the
        parameters through them."""
        norm = self.norm1.norm
        if norm.weight is not None:
            ln_w, ln_b = norm.weight, norm.bias
        else:
            ln_w = torch.ones(self.embed_dim,
                              device=self.inner_skip.weight.device)
            ln_b = torch.zeros_like(ln_w)
        return (
            self.inner_skip.weight.t(), self.inner_skip.bias, ln_w, ln_b,
            self.norm1.w_scale_2d.weight.t(), self.norm1.w_bias_2d.weight.t(),
            self.mlp.fc1.weight.t(), self.mlp.fc1.bias,
            self.mlp.fc2.weight.t(), self.mlp.fc2.bias,
        )

    def tail_weights(self) -> tuple[torch.Tensor, ...]:
        """``tail_params`` in the kernel's layout (all bf16, contiguous)
        for calls without grad, prepared once per weight version (load,
        init, move or optimizer update). Copies made under
        ``torch.inference_mode()`` are inference tensors, so the cache is
        kept apart for that mode."""
        params = list(self.parameters())
        key = (tuple((p.device, p.data_ptr(), p._version) for p in params),
               torch.is_inference_mode_enabled())
        if self._tail_weights is None or self._tail_weights[0] != key:
            with torch.no_grad():
                self._tail_weights = (key, tuple(
                    w.to(torch.bfloat16).contiguous()
                    for w in self.tail_params()
                ))
        return self._tail_weights[1]

    def drop_weight_cache(self):
        """Forget :meth:`tail_weights`' copies (their memory too)."""
        self._tail_weights = None

    def forward(self, x, noise):
        x_norm = self.norm0(x, noise)
        if self.filter_type == "local":
            x_f, residual = self.filter(x_norm), x_norm
        else:
            x_f, residual = self.filter(x_norm)
        if self._fuses(x_f, noise):
            weights = (self.tail_params() if torch.is_grad_enabled()
                       else self.tail_weights())
            return fused_block_tail(
                x_f.contiguous(), residual.contiguous(), noise.contiguous(),
                weights,
            )
        x_f = self.norm1(self.act(x_f + self.inner_skip(residual)), noise)
        if self.mlp is not None:
            x_f = self.mlp(x_f)
        return x_f + residual


class NoiseConditionedSFNO(nn.Module):
    """Stochastic SFNO (port of ace_tpu/models/conditional_sfno.py:366).

    ``forward(x, noise=None, generator=None, deterministic=True,
    labels=None)`` maps ``[B, nlat, nlon, in_chans]`` float32 to ``[B,
    nlat, nlon, out_chans]`` float32. The noise is ``noise`` when given;
    otherwise it is drawn with ``generator`` (on the model's device); with
    neither it is zero, as the JAX model runs without a "noise" rng. With
    ``n_labels`` set, ``labels`` ``[B, n_labels]`` (zeros when absent) are
    appended to the noise as the conditioning channels; blocks listed in
    ``local_blocks`` take a DISCO filter in place of the spectral one.
    """

    def __init__(self, img_shape, in_chans, out_chans, embed_dim=256,
                 noise_embed_dim=256, noise_type="gaussian", num_layers=12,
                 mlp_ratio=2.0,
                 activation_function="gelu", encoder_layers=1, use_mlp=True,
                 pos_embed=True, big_skip=True, normalize_big_skip=False,
                 affine_norms=False, global_layer_norm=False,
                 filter_residual=False, filter_output=False,
                 residual_filter_factor=1, local_blocks=None,
                 kernel_shape=(3, 3), basis_type="morlet", spectral_ratio=1.0,
                 lora_rank=0, n_labels=0, label_embed_dim=0,
                 data_grid="legendre-gauss", checkpointing=0,
                 dtype=torch.float32, device=None):
        super().__init__()
        if noise_type not in ("gaussian", "isotropic"):
            raise ValueError(f"unknown noise_type {noise_type!r}")
        nlat, nlon = img_shape
        self.img_shape = (nlat, nlon)
        self.in_chans, self.out_chans = in_chans, out_chans
        self.embed_dim, self.noise_embed_dim = embed_dim, noise_embed_dim
        self.noise_type = noise_type
        self.dtype = dtype
        self.checkpointing = checkpointing
        self.act = _ACTIVATIONS[activation_function]
        self.big_skip, self.normalize_big_skip = big_skip, normalize_big_skip
        self.filter_residual = filter_residual or residual_filter_factor > 1
        self.filter_output = filter_output
        self.n_labels = n_labels
        label_width = 0
        if n_labels:
            label_width = label_embed_dim if label_embed_dim > 0 else n_labels
            if label_embed_dim > 0:
                self.label_embed = Linear(n_labels, label_embed_dim,
                                          bias=False, device=device)
        cond_dim = noise_embed_dim + label_width
        kw = dict(lmax=nlat, mmax=nlon // 2 + 1, device=device)
        # only the first forward and the last inverse transform touch the
        # data grid; the blocks in between stay on the Gauss grid
        self.trans_down = build_sht(nlat, nlon, grid=data_grid, **kw)
        self.itrans_up = build_isht(nlat, nlon, grid=data_grid, **kw)
        self.trans = build_sht(nlat, nlon, grid="legendre-gauss", **kw)
        self.itrans = build_isht(nlat, nlon, grid="legendre-gauss", **kw)

        if big_skip and normalize_big_skip:
            # the channel norm whatever ``global_layer_norm``, as in JAX
            self.norm_big_skip = ConditionalLayerNorm(
                in_chans, cond_dim, elementwise_affine=affine_norms,
                device=device,
            )
        self.encoder_layers = encoder_layers
        width = in_chans
        for i in range(encoder_layers):
            self.add_module(f"encoder_{i}", Linear(
                width, embed_dim, dtype=dtype, device=device
            ))
            width = embed_dim
        self.encoder_out = Linear(width, embed_dim, bias=False, dtype=dtype,
                                  device=device)
        self.pos_embed = (
            nn.Parameter(torch.empty(1, nlat, nlon, embed_dim, device=device))
            if pos_embed else None
        )
        self.num_layers = num_layers
        local = set(local_blocks or ())
        for i in range(num_layers):
            first, last = i == 0, i == num_layers - 1
            self.add_module(f"block_{i}", ConditionalFNOBlock(
                self.trans_down if first else self.trans,
                self.itrans_up if last else self.itrans,
                embed_dim, cond_dim, mlp_ratio=mlp_ratio,
                activation=activation_function, use_mlp=use_mlp,
                global_layer_norm=global_layer_norm,
                affine_norms=affine_norms,
                filter_type="local" if i in local else "spectral",
                kernel_shape=kernel_shape, basis_type=basis_type,
                data_grid=data_grid, spectral_ratio=spectral_ratio,
                lora_rank=lora_rank, dtype=dtype, device=device,
            ))
        width = embed_dim + (in_chans if big_skip else 0)
        for i in range(encoder_layers):
            self.add_module(f"decoder_{i}", Linear(
                width, embed_dim, dtype=dtype, device=device
            ))
            width = embed_dim
        self.decoder_out = Linear(width, out_chans, bias=False, dtype=dtype,
                                  device=device)

    def _blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    def use_fused_block_tail(self, enabled: bool = True):
        """Send every block's tail through the fused kernel (where the
        block's gate allows it) or through the unfused modules (the
        default). The parameters are the same either way."""
        for block in self._blocks():
            block.fused_tail = bool(enabled)
        return self

    def reset_parameters(self, generator=None):
        if self.pos_embed is not None:
            with torch.no_grad():
                trunc_normal_init(self.pos_embed, generator=generator)

    def make_noise(self, batch: int, generator: torch.Generator | None):
        """The noise field ``[batch, nlat, nlon, noise_embed_dim]``
        float32, drawn with ``generator`` (zero without one)."""
        nlat, nlon = self.img_shape
        device = self.trans_down.fc.device
        shape = (batch, nlat, nlon, self.noise_embed_dim)
        if generator is None:
            return torch.zeros(shape, device=device)
        if self.noise_type == "gaussian":
            return torch.randn(shape, generator=generator, device=device)
        return isotropic_noise(self.itrans_up, batch, self.noise_embed_dim,
                               generator)

    def conditioning(self, noise, labels=None):
        """The blocks' conditioning channels: ``noise``, with the labels
        (zeros when absent; through ``label_embed`` when it exists)
        broadcast over the grid and appended when ``n_labels`` is set."""
        if not self.n_labels:
            return noise
        batch, nlat, nlon, _ = noise.shape
        if labels is None:
            labels = torch.zeros(batch, self.n_labels, device=noise.device)
        lab = labels.float()
        if hasattr(self, "label_embed"):
            lab = self.label_embed(lab)
        lab2d = lab[:, None, None, :].expand(batch, nlat, nlon, lab.shape[-1])
        return torch.cat([noise, lab2d], dim=-1)

    def forward(self, x, noise=None, generator=None, deterministic=True,
                labels=None):
        # the model has no dropout: ``deterministic`` changes nothing
        if noise is None:
            noise = self.make_noise(x.shape[0], generator)
        noise = self.conditioning(noise, labels)
        if any(block.fused_tail for block in self._blocks()):
            # the fused tail reads the noise rows in place: one copy for
            # all blocks if the synthesized field is strided
            noise = noise.contiguous()
        act = self.act
        if self.big_skip:
            residual = x
            if self.filter_residual:
                residual = self.itrans_up.inverse_pair(
                    *self.trans_down.forward_pair(residual)
                ).to(x.dtype)
            if self.normalize_big_skip:
                residual = self.norm_big_skip(residual, noise)

        h = x.to(self.dtype)
        for i in range(self.encoder_layers):
            h = act(getattr(self, f"encoder_{i}")(h))
        h = self.encoder_out(h)
        if self.pos_embed is not None:
            h = h + self.pos_embed.to(h.dtype)
        for block in self._blocks():
            if self.checkpointing >= 1 and torch.is_grad_enabled():
                # the block draws no random numbers (the noise is drawn
                # once above), so the recompute needs no saved RNG state
                h = torch.utils.checkpoint.checkpoint(
                    block, h, noise, use_reentrant=False,
                    preserve_rng_state=False,
                )
            else:
                h = block(h, noise)
        if self.big_skip:
            h = torch.cat([h, residual.to(h.dtype)], dim=-1)
        for i in range(self.encoder_layers):
            h = act(getattr(self, f"decoder_{i}")(h))
        out = self.decoder_out(h)
        if self.filter_output:
            out = self.itrans_up.inverse_pair(
                *self.trans_down.forward_pair(out)
            )
        return out.float()
