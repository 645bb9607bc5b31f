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
            else:
                trunc_normal_init(self.weight, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class MLP(nn.Module):
    """Per-point two-layer MLP ``fc2(act(fc1(x)))``."""

    def __init__(self, in_features, hidden_features, out_features,
                 act=exact_gelu, dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, dtype=dtype,
                          device=device)
        self.fc2 = Linear(hidden_features, out_features, dtype=dtype,
                          device=device)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


def init_weights(module: nn.Module, generator: torch.Generator | None = None):
    """Draw every parameter of ``module`` from its initializer, with the
    same distributions as the JAX package's flax initializers (the draws
    differ: the two frameworks' generators are unrelated). Each module's
    ``reset_parameters`` initializes its own direct parameters only."""
    for sub in module.modules():
        if hasattr(sub, "reset_parameters"):
            sub.reset_parameters(generator=generator)
