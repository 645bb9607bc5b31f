"""Shared layers, channels-last (port of ace_tpu/models/layers.py).

Parameters stay float32 and are cast to the compute dtype where they are
used, as flax's ``Dense(dtype=...)`` does. ``Linear`` keeps
``torch.nn.Linear``'s ``[out, in]`` weight layout; the converter in
``utils/convert.py`` transposes flax's ``[in, out]`` kernels.
"""

import torch
import torch.nn.functional as F
from torch import nn


def exact_gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU as the JAX package computes it: the erf form for float32,
    the tanh form for bfloat16 (within one bf16 ulp of erf)."""
    approximate = "tanh" if x.dtype == torch.bfloat16 else "none"
    return F.gelu(x, approximate=approximate)


def trunc_normal_init(tensor: torch.Tensor, std: float = 0.02,
                      generator: torch.Generator | None = None):
    """Truncated normal at ±2 std (flax ``truncated_normal(stddev=std,
    lower=-2, upper=2)``, the reference's ``trunc_normal_``)."""
    return nn.init.trunc_normal_(tensor, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


class Linear(nn.Linear):
    """Dense layer over the trailing channel axis that computes in
    ``dtype`` (its parameters stay float32)."""

    def __init__(self, in_features, out_features, bias=True,
                 dtype=torch.float32, device=None, init="trunc_normal"):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype
        self.init = init

    def reset_parameters(self, generator: torch.Generator | None = None):
        if not hasattr(self, "init"):  # called by nn.Linear's constructor
            return
        with torch.no_grad():
            if self.init == "zeros":
                self.weight.zero_()
            elif self.init == "lecun_normal":
                # flax Dense's default: truncated normal of variance
                # 1/fan_in (std corrected for the truncation at ±2)
                std = (1.0 / self.in_features) ** 0.5 / 0.87962566103423978
                trunc_normal_init(self.weight, std=std, generator=generator)
            else:
                trunc_normal_init(self.weight, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: zero each element with probability ``rate``
    and divide the kept ones by ``1 - rate``; the identity when
    ``deterministic`` or ``rate`` is 0. The mask is drawn from
    ``generator``, which a random layer needs (as the JAX layer needs its
    "dropout" rng)."""
    if rate == 0.0 or deterministic:
        return x
    return _drop(x, rate, x.shape, generator)


def _drop(x, rate, mask_shape, generator):
    """``x / (1 - rate)`` where a mask of ``mask_shape`` drawn from
    ``generator`` keeps it (probability ``1 - rate``), 0 elsewhere."""
    if generator is None:
        raise ValueError("a random layer that is not deterministic needs a "
                         "generator")
    keep = 1.0 - rate
    mask = torch.rand(mask_shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def replaying(fn, generator: torch.Generator | None):
    """``fn`` such that a second call (the recompute of a checkpoint) draws
    the same numbers from ``generator`` as the first, and leaves the
    generator where it was: ``torch.utils.checkpoint``'s
    ``preserve_rng_state`` covers the default generators only."""
    if generator is None:
        return fn
    start = generator.get_state()
    calls = [0]

    def wrapped(*args):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*args)
        resume = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*args)
        finally:
            generator.set_state(resume)

    return wrapped


class MLP(nn.Module):
    """Per-point two-layer MLP ``fc2(act(fc1(x)))``, with dropout at
    ``drop_rate`` after each layer (port of ace_tpu/models/layers.py:99)."""

    def __init__(self, in_features, hidden_features, out_features,
                 act=exact_gelu, drop_rate=0.0, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, dtype=dtype,
                          device=device)
        self.fc2 = Linear(hidden_features, out_features, dtype=dtype,
                          device=device)
        self.act = act
        self.drop_rate = drop_rate

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.act(self.fc1(x))
        x = dropout(x, self.drop_rate, deterministic, generator)
        return dropout(self.fc2(x), self.drop_rate, deterministic, generator)


class DropPath(nn.Module):
    """Stochastic depth per sample (port of ace_tpu/models/layers.py:136):
    each sample of the batch is kept with probability ``1 - rate`` and
    divided by it, or zeroed."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.rate == 0.0 or deterministic:
            return x
        return _drop(x, self.rate, (x.shape[0],) + (1,) * (x.dim() - 1),
                     generator)


class InstanceNorm(nn.Module):
    """Instance normalization over the spatial axes of ``[..., H, W, C]``
    with per-channel ``scale`` and ``bias`` (port of
    ace_tpu/models/layers.py:39, eps 1e-6). bfloat16 input keeps the JAX
    package's mixed path: f32 statistics, the mean cast to bf16 before the
    subtraction, the variance of the bf16 difference in f32, and the
    ``rsqrt`` cast to bf16."""

    eps = 1e-6

    def __init__(self, n_channels, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(n_channels, device=device))
        self.bias = nn.Parameter(torch.empty(n_channels, device=device))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        dims = (-3, -2)
        if dt == torch.float32:
            mean = x.mean(dims, keepdim=True)
            var = (x - mean).square().mean(dims, keepdim=True)
            out = (x - mean) * torch.rsqrt(var + self.eps)
        else:
            mean = x.mean(dims, keepdim=True, dtype=torch.float32)
            xc = x - mean.to(dt)
            var = xc.square().mean(dims, keepdim=True, dtype=torch.float32)
            out = xc * torch.rsqrt(var + self.eps).to(dt)
        return (out * self.scale.to(out.dtype)
                + self.bias.to(out.dtype)).to(dt)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the channels in float32 (``scale`` and
    ``bias``; flax's eps 1e-6 unless ``eps`` says otherwise)."""

    def __init__(self, n_channels, eps=1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(n_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(n_channels, device=device))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.scale.shape, self.scale,
                            self.bias, self.eps)


class LayerNorm2d(nn.Module):
    """Layer norm over the ``(H, W)`` axes per channel, in float32, with
    ``[H, W, 1]`` ``scale`` and ``bias`` (port of
    ace_tpu/models/layers.py:76, eps 1e-6)."""

    eps = 1e-6

    def __init__(self, spatial_shape, device=None):
        super().__init__()
        shape = (*spatial_shape, 1)
        self.scale = nn.Parameter(torch.empty(shape, device=device))
        self.bias = nn.Parameter(torch.empty(shape, device=device))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean((-3, -2), keepdim=True)
        var = (x32 - mean).square().mean((-3, -2), keepdim=True)
        out = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (out * self.scale + self.bias).to(x.dtype)


def init_weights(module: nn.Module, generator: torch.Generator | None = None):
    """Draw every parameter of ``module`` from its initializer, with the
    same distributions as the JAX package's flax initializers (the draws
    differ: the two frameworks' generators are unrelated). Each module's
    ``reset_parameters`` initializes its own direct parameters only."""
    for sub in module.modules():
        if hasattr(sub, "reset_parameters"):
            sub.reset_parameters(generator=generator)
