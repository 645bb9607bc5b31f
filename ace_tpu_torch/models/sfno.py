"""Spherical Fourier layers, channels-last (port of ace_tpu/models/sfno.py).

Only the Driscoll-Healy ("dhconv") spectral convolution is ported so far;
LoRA adapters, CP factorization, ``spectral_ratio`` bottlenecks and the
distributed transforms wait for later work.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ace_tpu_torch.models.layers import exact_gelu
from ace_tpu_torch.ops.dhconv_filter import dhconv_filter, dhconv_filter_param

_ACTIVATIONS = {
    "gelu": exact_gelu,
    "relu": F.relu,
    "silu": F.silu,
}


class SpectralConvS2(nn.Module):
    """Driscoll-Healy spectral convolution on S2 (port of
    ace_tpu/models/sfno.py:59 with operator_type="dhconv").

    ``forward(x)`` with ``x: [B, nlat, nlon, C]`` returns
    ``(filtered, residual)``; residual is the input, re-gridded when the
    two transforms' grids differ. The weight is ``[2, l, in, out]`` float32
    (re and im, each in the kernels' ``[l, in, out]`` layout; the JAX
    package keeps ``[in, out, l, 2]``, and ``utils/convert.py`` maps
    between the two). For bfloat16 activations the filter runs through
    ``ops/dhconv_filter.py`` (the kernels on CUDA tensors): without grad on
    a bfloat16 copy of the weight made once per weight version, in grad
    mode through the differentiable ``dhconv_filter_param`` on ``weight``
    itself, so that its gradient reaches the float32 parameter. Float32
    activations take four float32 einsums.
    """

    def __init__(self, forward_transform, inverse_transform, in_channels,
                 out_channels, operator_type="dhconv", use_bias=False,
                 device=None):
        super().__init__()
        if operator_type != "dhconv":
            raise NotImplementedError(
                f"operator_type {operator_type!r}: only 'dhconv' is ported"
            )
        self.forward_transform = forward_transform
        self.inverse_transform = inverse_transform
        self.in_channels, self.out_channels = in_channels, out_channels
        modes_lat = inverse_transform.lmax
        self.weight = nn.Parameter(torch.empty(
            2, modes_lat, in_channels, out_channels, device=device
        ))
        self.bias = (
            nn.Parameter(torch.empty(out_channels, device=device))
            if use_bias else None
        )
        self._kernel_weights = None

    def reset_parameters(self, generator: torch.Generator | None = None):
        scale = 1.0 / (self.in_channels * self.out_channels)
        with torch.no_grad():
            nn.init.normal_(self.weight, std=scale, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def kernel_weights(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(w_r, w_i) ``[l, in, out]`` bfloat16, one cast of ``weight``
        made once per weight version (load, init, move or optimizer
        update) for calls without grad. Copies made under
        ``torch.inference_mode()`` are inference tensors, so the cache is
        kept apart for that mode."""
        w = self.weight
        key = (w.device, w.data_ptr(), w._version,
               torch.is_inference_mode_enabled())
        if self._kernel_weights is None or self._kernel_weights[0] != key:
            with torch.no_grad():
                wl = w.to(torch.bfloat16).contiguous()
                self._kernel_weights = (key, wl[0], wl[1])
        return self._kernel_weights[1], self._kernel_weights[2]

    def drop_weight_cache(self):
        """Forget :meth:`kernel_weights`' copy (its memory too)."""
        self._kernel_weights = None

    def forward(self, x: torch.Tensor):
        in_dtype = x.dtype
        ft, it = self.forward_transform, self.inverse_transform
        modes_lat, modes_lon = it.lmax, it.mmax
        xr_full, xi_full = ft.forward_pair(x.float())
        residual = x
        if (ft.nlat, ft.nlon, ft.grid) != (it.nlat, it.nlon, it.grid):
            residual = it.inverse_pair(xr_full, xi_full).to(in_dtype)
        xr = xr_full[..., :modes_lat, :modes_lon, :]
        xi = xi_full[..., :modes_lat, :modes_lon, :]

        if in_dtype == torch.bfloat16 and torch.is_grad_enabled():
            # training: the gradient reaches the f32 weight through 1b/1c
            outr, outi = dhconv_filter_param(
                xr.contiguous(), xi.contiguous(), self.weight
            )
        elif in_dtype == torch.bfloat16:
            # AMP semantics of the reference: bf16 operands, f32
            # accumulation, bf16 outputs; the kernel on CUDA tensors
            outr, outi = dhconv_filter(
                xr.contiguous(), xi.contiguous(), *self.kernel_weights()
            )
        else:
            wr, wi = self.weight

            def ein(a, b):
                return torch.einsum("...lmi,lio->...lmo", a, b)

            outr = ein(xr, wr) - ein(xi, wi)
            outi = ein(xr, wi) + ein(xi, wr)

        # re-pad to the forward transform's full (lmax, mmax)
        pad = (0, 0, 0, ft.mmax - modes_lon, 0, ft.lmax - modes_lat)
        out = it.inverse_pair(F.pad(outr, pad), F.pad(outi, pad))
        if self.bias is not None:
            out = out + self.bias
        return out.to(in_dtype), residual
