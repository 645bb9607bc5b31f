"""Spherical Fourier Neural Operator, channels-last (port of
ace_tpu/models/sfno.py).

``SpectralConvS2`` is the spectral convolution of both SFNOs (this one and
``models/conditional_sfno.py``): the "dhconv" and "diagonal" operators,
separable or not, CP-factorized or not, over the SHT pair (``ops/sht.py``)
or the FFT pair (``ops/fft2.py``). ``FourierNeuralOperatorBlock`` and
``SphericalFourierNeuralOperatorNet`` are the SFNO of the ACE2 recipes
outside ERA5, with instance or layer norms, dropout and drop-path, a
learned grid or frequency position embedding, weight-shared repeats and
per-block recompute. ``SpectralConvS2`` also takes the conditional SFNO's
``spectral_ratio`` bottleneck and its LoRA adapters. Not ported: the
distributed transforms.
"""

import functools
import itertools

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ace_tpu_torch.models.layers import (
    MLP,
    DropPath,
    InstanceNorm,
    LayerNorm2d,
    Linear,
    dropout,
    exact_gelu,
    replaying,
    trunc_normal_init,
)
from ace_tpu_torch.ops.dhconv_filter import dhconv_filter, dhconv_filter_param
from ace_tpu_torch.ops.fft2 import InverseRealFFT2, RealFFT2
from ace_tpu_torch.ops.sht import build_isht, build_sht

_ACTIVATIONS = {
    "gelu": exact_gelu,
    "relu": F.relu,
    "silu": F.silu,
}

_BF16 = torch.bfloat16

# the contraction of each weight layout: (operator_type, separable) ->
# (einsum of the activations [..., l, m, i] with one real weight, the
# permutation from the dense weight's flax axis order to the port's)
_CONTRACTIONS = {
    ("dhconv", False): ("...lmi,lio->...lmo", (2, 0, 1)),
    ("diagonal", False): ("...lmi,lmio->...lmo", (2, 3, 0, 1)),
    ("dhconv", True): ("...lmi,il->...lmi", None),
    ("diagonal", True): ("...lmi,mil->...lmi", None),
}


class SpectralConvS2(nn.Module):
    """Spectral convolution on S2 (port of ace_tpu/models/sfno.py:59).

    ``forward(x)`` with ``x: [B, nlat, nlon, C]`` returns ``(filtered,
    residual)``; residual is the input, re-gridded when the two
    transforms' grids differ. ``weight`` is float32 in the port's layout,
    which ``utils/convert.py`` maps to and from flax's:

    - dhconv: ``[2, l, in, out]`` (re and im, each in the kernels' ``[l,
      in, out]``; flax ``[in, out, l, 2]``);
    - diagonal: ``[2, l, m, in, out]`` (flax ``[in, out, l, m, 2]``);
    - separable dhconv: flax's ``[in, l, 2]``;
    - separable diagonal: ``[2, m, in, l]`` (flax ``[in, l, m, 2]``).

    With ``factorization="cp"`` the weight is ``cp_factor_{ax}`` ``[d, r,
    2]`` (flax's layout) per axis of the dense weight, expanded each call
    into the dense complex weight term by term as the JAX package does.

    ``spectral_ratio < 1`` narrows the filter path to ``round(C *
    spectral_ratio)`` channels: ``pre_proj`` before the transform,
    ``post_proj`` after the inverse (float32 denses, as flax's without a
    dtype); the residual keeps the full width. ``lora_rank > 0`` (dhconv)
    adds two complex float32 contractions with ``lora_a`` ``[c_in, r, L,
    2]`` and ``lora_b`` ``[r, c_out, L, 2]`` (flax's layout, ``lora_b``
    zero-initialized) to the filter's output; a bf16 filter's output then
    sums to float32, as in JAX.

    Arithmetic, as ace_tpu/models/sfno.py:273-293: float32 activations
    take four float32 einsums. bfloat16 activations on a (non-separable)
    dhconv go through ``ops/dhconv_filter.py`` (the kernels on CUDA
    tensors): without grad on a bfloat16 copy of the weight made once per
    weight version, in grad mode through the differentiable
    ``dhconv_filter_param`` on the float32 weight. Other bfloat16 filters
    contract bfloat16-rounded operands with float32 outputs (JAX's
    ``preferred_element_type=float32``): the operands are rounded to bf16
    and the einsum runs in float32, which is exact for bf16 products as
    long as TF32 matmuls are off.
    """

    def __init__(self, forward_transform, inverse_transform, in_channels,
                 out_channels, operator_type="dhconv", separable=False,
                 use_bias=False, factorization=None, rank=1.0,
                 spectral_ratio=1.0, lora_rank=0, device=None):
        super().__init__()
        if (operator_type, separable) not in _CONTRACTIONS:
            raise ValueError(f"Unsupported operator type {operator_type}")
        if not 0.0 < spectral_ratio <= 1.0:
            raise ValueError("spectral_ratio must be in (0, 1]")
        self.forward_transform = forward_transform
        self.inverse_transform = inverse_transform
        self.operator_type, self.separable = operator_type, separable
        modes_lat = inverse_transform.lmax
        modes_lon = inverse_transform.mmax
        self.use_proj = spectral_ratio < 1.0
        if self.use_proj:
            if separable:
                raise ValueError(
                    "spectral_ratio requires non-separable filter")
            width = round(in_channels * spectral_ratio)
            self.pre_proj = Linear(in_channels, width, bias=False,
                                   device=device)
            self.post_proj = Linear(width, out_channels, bias=False,
                                    device=device)
            in_channels = out_channels = width
        self.in_channels, self.out_channels = in_channels, out_channels
        dims = [in_channels] if separable else [in_channels, out_channels]
        dims += [modes_lat] if operator_type == "dhconv" else [modes_lat,
                                                               modes_lon]
        self.dims = dims
        self.cp_rank = None
        if factorization is not None:
            if factorization.lower() != "cp":
                raise NotImplementedError(
                    f"factorization {factorization!r}; only 'cp' is "
                    "implemented"
                )
            if separable:
                raise ValueError("factorization requires non-separable")
            full = int(np.prod(dims))
            self.cp_rank = max(1, round(rank * full / sum(dims)))
            for ax, d in enumerate(dims):
                self.register_parameter(f"cp_factor_{ax}", nn.Parameter(
                    torch.empty(d, self.cp_rank, 2, device=device)))
            self.weight = None
        else:
            self.weight = nn.Parameter(torch.empty(
                self._port_shape(dims), device=device))
        self.lora_rank = lora_rank if operator_type == "dhconv" else 0
        if self.lora_rank > 0:
            self.lora_a = nn.Parameter(torch.empty(
                in_channels, lora_rank, modes_lat, 2, device=device))
            self.lora_b = nn.Parameter(torch.empty(
                lora_rank, out_channels, modes_lat, 2, device=device))
        self.bias = (
            nn.Parameter(torch.empty(
                self.post_proj.out_features if self.use_proj
                else out_channels, device=device))
            if use_bias else None
        )
        self._kernel_weights = None

    def _port_shape(self, dims):
        if self.separable and self.operator_type == "dhconv":
            return (*dims, 2)  # flax's [in, l, 2]
        if self.separable:
            i, l, m = dims
            return (2, m, i, l)
        perm = _CONTRACTIONS[(self.operator_type, False)][1]
        return (2, *(dims[p] for p in perm))

    def _factors(self):
        return [getattr(self, f"cp_factor_{ax}")
                for ax in range(len(self.dims))]

    def reset_parameters(self, generator: torch.Generator | None = None):
        scale = 1.0 / (self.in_channels * self.out_channels)
        with torch.no_grad():
            if self.weight is not None:
                nn.init.normal_(self.weight, std=scale, generator=generator)
            else:
                for f in self._factors():
                    nn.init.normal_(f, std=scale ** (1.0 / len(self.dims)),
                                    generator=generator)
            if self.lora_rank > 0:
                nn.init.normal_(self.lora_a, std=scale, generator=generator)
                self.lora_b.zero_()
            if self.bias is not None:
                self.bias.zero_()

    def dense_weight(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(w_r, w_i) float32 in the port's layout without the leading 2:
        halves of ``weight``, or the CP factors expanded."""
        if self.weight is None:
            return self._cp_to_dense()
        if self.separable and self.operator_type == "dhconv":
            return self.weight[..., 0], self.weight[..., 1]
        return self.weight[0], self.weight[1]

    def _cp_to_dense(self):
        # the product of complex factors, summed over the subsets of axes
        # that take the imaginary part: an even number adds to the real
        # part, an odd one to the imaginary, with sign (-1)^(n // 2)
        # (ace_tpu/models/sfno.py:184-221, term for term)
        factors = self._factors()
        letters = "iolm"[: len(self.dims)]
        eq = ",".join(f"{c}r" for c in letters) + "->" + letters
        reals = [f[..., 0] for f in factors]
        imags = [f[..., 1] for f in factors]
        device = factors[0].device
        wr = torch.zeros(self.dims, device=device)
        wi = torch.zeros(self.dims, device=device)
        for mask in itertools.product([0, 1], repeat=len(self.dims)):
            parts = [imags[ax] if flag else reals[ax]
                     for ax, flag in enumerate(mask)]
            n_imag = sum(mask)
            term = torch.einsum(eq, *parts)
            sign = (-1) ** (n_imag // 2)
            if n_imag % 2 == 0:
                wr = wr + sign * term
            else:
                wi = wi + sign * term
        perm = _CONTRACTIONS[(self.operator_type, False)][1]
        return wr.permute(perm), wi.permute(perm)

    def kernel_weights(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(w_r, w_i) ``[l, in, out]`` bfloat16 of a dhconv filter, one cast
        of ``weight`` made once per weight version (load, init, move or
        optimizer update) for calls without grad. Copies made under
        ``torch.inference_mode()`` are inference tensors, so the cache is
        kept apart for that mode. CP factors are expanded at each call."""
        if self.weight is None:
            wr, wi = self._cp_to_dense()
            return wr.to(_BF16).contiguous(), wi.to(_BF16).contiguous()
        w = self.weight
        key = (w.device, w.data_ptr(), w._version,
               torch.is_inference_mode_enabled())
        if self._kernel_weights is None or self._kernel_weights[0] != key:
            with torch.no_grad():
                wl = w.to(_BF16).contiguous()
                self._kernel_weights = (key, wl[0], wl[1])
        return self._kernel_weights[1], self._kernel_weights[2]

    def drop_weight_cache(self):
        """Forget :meth:`kernel_weights`' copy (its memory too)."""
        self._kernel_weights = None

    def _filter(self, xr, xi, bf16):
        if bf16 and self.operator_type == "dhconv" and not self.separable:
            if torch.is_grad_enabled():
                # training: the gradient reaches the f32 weight (or the
                # CP factors) through 1b/1c
                weight = (self.weight if self.weight is not None
                          else torch.stack(self._cp_to_dense()))
                return dhconv_filter_param(xr.contiguous(), xi.contiguous(),
                                           weight)
            # AMP semantics of the reference: bf16 operands, f32
            # accumulation, bf16 outputs; the kernel on CUDA tensors
            return dhconv_filter(xr.contiguous(), xi.contiguous(),
                                 *self.kernel_weights())
        eq = _CONTRACTIONS[(self.operator_type, self.separable)][0]
        wr, wi = self.dense_weight()
        if bf16:
            # bf16 operands, f32 outputs: bf16 products are exact in f32
            def rounded(t):
                return t.to(_BF16).float()

            xr, xi, wr, wi = map(rounded, (xr, xi, wr, wi))
        ein = functools.partial(torch.einsum, eq)
        return ein(xr, wr) - ein(xi, wi), ein(xr, wi) + ein(xi, wr)

    def _lora(self, xr, xi):
        """The adapter's two complex contractions, float32."""
        la_r, la_i = self.lora_a[..., 0], self.lora_a[..., 1]
        lb_r, lb_i = self.lora_b[..., 0], self.lora_b[..., 1]
        ein_a = functools.partial(torch.einsum, "...lmi,irl->...lmr")
        ein_b = functools.partial(torch.einsum, "...lmr,rol->...lmo")
        ar = ein_a(xr, la_r) - ein_a(xi, la_i)
        ai = ein_a(xr, la_i) + ein_a(xi, la_r)
        return (ein_b(ar, lb_r) - ein_b(ai, lb_i),
                ein_b(ar, lb_i) + ein_b(ai, lb_r))

    def forward(self, x: torch.Tensor):
        in_dtype = x.dtype
        ft, it = self.forward_transform, self.inverse_transform
        modes_lat, modes_lon = it.lmax, it.mmax
        use_pair = hasattr(ft, "forward_pair") and hasattr(it, "inverse_pair")
        regrid = (ft.nlat, ft.nlon, ft.grid) != (it.nlat, it.nlon, it.grid)
        residual = full_x = x
        if self.use_proj:
            x = self.pre_proj(x)
        if use_pair:
            xr_full, xi_full = ft.forward_pair(x.float())
            if regrid:
                residual = it.inverse_pair(
                    *(ft.forward_pair(full_x.float()) if self.use_proj
                      else (xr_full, xi_full))).to(in_dtype)
        else:
            # transforms without the real pair (the FFT pair): complex
            coeffs = ft(x.float())
            if regrid:
                residual = it(ft(full_x.float()) if self.use_proj
                              else coeffs).to(in_dtype)
            xr_full, xi_full = coeffs.real, coeffs.imag
        xr = xr_full[..., :modes_lat, :modes_lon, :]
        xi = xi_full[..., :modes_lat, :modes_lon, :]
        outr, outi = self._filter(xr, xi, in_dtype == _BF16)
        if self.lora_rank > 0:
            lr, li = self._lora(xr, xi)
            outr, outi = outr + lr, outi + li

        # re-pad to the forward transform's full (lmax, mmax)
        pad = (0, 0, 0, ft.mmax - modes_lon, 0, ft.lmax - modes_lat)
        outr, outi = F.pad(outr, pad), F.pad(outi, pad)
        if use_pair:
            out = it.inverse_pair(outr, outi)
        else:
            out = it(torch.complex(outr.float(), outi.float()))
        if self.use_proj:
            out = self.post_proj(out)
        if self.bias is not None:
            out = out + self.bias
        return out.to(in_dtype), residual


def _norm(kind, n_channels, spatial_shape, device):
    if kind == "instance_norm":
        return InstanceNorm(n_channels, device=device)
    if kind == "layer_norm":
        return LayerNorm2d(spatial_shape, device=device)
    if kind == "none":
        return nn.Identity()
    raise NotImplementedError(f"normalization {kind} not implemented")


class FourierNeuralOperatorBlock(nn.Module):
    """One SFNO block (port of ace_tpu/models/sfno.py:401): norm0 ->
    filter -> inner skip (``linear`` or ``identity``) -> activation ->
    norm1 -> MLP -> drop-path -> outer skip. Parameter names follow the
    flax tree (``norm0``, ``filter``, ``inner_skip``, ``norm1``,
    ``mlp.fc1``/``fc2``, ``outer_skip``)."""

    def __init__(self, forward_transform, inverse_transform, embed_dim,
                 operator_type="diagonal", mlp_ratio=2.0, drop_rate=0.0,
                 drop_path=0.0, activation="gelu",
                 normalization="instance_norm", inner_skip="linear",
                 outer_skip="identity", use_mlp=True, separable=False,
                 factorization=None, rank=1.0, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.act = _ACTIVATIONS[activation]
        in_shape = (forward_transform.nlat, forward_transform.nlon)
        out_shape = (inverse_transform.nlat, inverse_transform.nlon)
        self.norm0 = _norm(normalization, embed_dim, in_shape, device)
        self.filter = SpectralConvS2(
            forward_transform, inverse_transform, embed_dim, embed_dim,
            operator_type=operator_type, separable=separable, use_bias=True,
            factorization=factorization, rank=rank, device=device,
        )
        self.inner_skip_kind, self.outer_skip_kind = inner_skip, outer_skip
        if inner_skip == "linear":
            self.inner_skip = Linear(embed_dim, embed_dim, dtype=dtype,
                                     device=device)
        self.norm1 = _norm(normalization, embed_dim, out_shape, device)
        self.mlp = (
            MLP(embed_dim, int(embed_dim * mlp_ratio), embed_dim,
                act=self.act, drop_rate=drop_rate, dtype=dtype,
                device=device)
            if use_mlp else None
        )
        self.drop_path = DropPath(drop_path)
        if outer_skip == "linear":
            self.outer_skip = Linear(embed_dim, embed_dim, dtype=dtype,
                                     device=device)

    def _skip(self, kind, name, x, residual):
        if kind == "linear":
            return x + getattr(self, name)(residual)
        if kind == "identity":
            return x + residual
        return x

    def forward(self, x, deterministic: bool = True,
                generator: torch.Generator | None = None):
        x, residual = self.filter(self.norm0(x))
        x = self.act(self._skip(self.inner_skip_kind, "inner_skip", x,
                                residual))
        x = self.norm1(x)
        if self.mlp is not None:
            x = self.mlp(x, deterministic, generator)
        x = self.drop_path(x, deterministic, generator)
        return self._skip(self.outer_skip_kind, "outer_skip", x, residual)


class SphericalFourierNeuralOperatorNet(nn.Module):
    """The SFNO backbone (port of ace_tpu/models/sfno.py:490).

    ``forward(x, noise=None, generator=None, deterministic=True)`` maps
    ``[B, nlat, nlon, in_chans]`` to ``[B, nlat, nlon, out_chans]``
    float32; the model takes no noise. Dropout and drop-path draw from
    ``generator`` when ``deterministic`` is False (the train step), and
    are the identity otherwise. ``checkpointing >= 1`` recomputes each
    block in the backward pass, replaying the generator so that the
    recompute draws the same masks.

    ``spectral_precision`` ("default", "high", "highest") is accepted as
    in the JAX package; the port computes the transforms and float32
    filters in full float32 (TF32 matmuls off, PyTorch's default) at any
    of the three, which is what ``ace_tpu`` computes on the CPU.
    """

    def __init__(self, img_shape, in_chans, out_chans, embed_dim=256,
                 num_layers=12, spectral_transform="sht",
                 operator_type="diagonal", scale_factor=1,
                 residual_filter_factor=1, hard_thresholding_fraction=1.0,
                 normalization_layer="instance_norm", use_mlp=True,
                 mlp_ratio=2.0, activation_function="gelu", encoder_layers=1,
                 pos_embed=True, factorization=None, rank=1.0,
                 spectral_precision="high", repeat_layers=1, big_skip=True,
                 separable=False, drop_rate=0.0, drop_path_rate=0.0,
                 data_grid="legendre-gauss", checkpointing=0,
                 dtype=torch.float32, device=None):
        super().__init__()
        if spectral_precision not in ("default", "high", "highest"):
            raise ValueError(f"spectral_precision {spectral_precision!r}")
        nlat, nlon = img_shape
        self.img_shape = (nlat, nlon)
        self.in_chans, self.out_chans = in_chans, out_chans
        self.embed_dim, self.dtype = embed_dim, dtype
        self.act = _ACTIVATIONS[activation_function]
        self.big_skip, self.drop_rate = big_skip, drop_rate
        self.checkpointing, self.repeat_layers = checkpointing, repeat_layers
        h, w = int(nlat // scale_factor), int(nlon // scale_factor)
        modes_lat = int(h * hard_thresholding_fraction)
        modes_lon = int((w // 2 + 1) * hard_thresholding_fraction)
        kw = dict(lmax=modes_lat, mmax=modes_lon)
        if spectral_transform == "fft":
            self.trans_down = RealFFT2(nlat, nlon, **kw)
            self.itrans_up = InverseRealFFT2(nlat, nlon, **kw)
            self.trans = RealFFT2(h, w, **kw)
            self.itrans = InverseRealFFT2(h, w, **kw)
        elif spectral_transform == "sht":
            kw["device"] = device
            self.trans_down = build_sht(nlat, nlon, grid=data_grid, **kw)
            self.itrans_up = build_isht(nlat, nlon, grid=data_grid, **kw)
            self.trans = build_sht(h, w, grid="legendre-gauss", **kw)
            self.itrans = build_isht(h, w, grid="legendre-gauss", **kw)
        else:
            raise ValueError(
                f"unknown spectral_transform {spectral_transform!r}")
        self.residual_filter = residual_filter_factor > 1
        if self.residual_filter:
            mlr = int(nlat // residual_filter_factor)
            mmr = int(nlon // residual_filter_factor // 2 + 1)
            self.residual_filter_down = build_sht(
                nlat, nlon, lmax=mlr, mmax=mmr, grid=data_grid, device=device)
            self.residual_filter_up = build_isht(
                nlat, nlon, lmax=mlr, mmax=mmr, grid=data_grid, device=device)

        self.encoder_layers = encoder_layers
        width = in_chans
        for i in range(encoder_layers):
            self.add_module(f"encoder_{i}", Linear(
                width, embed_dim, dtype=dtype, device=device))
            width = embed_dim
        self.encoder_out = Linear(width, embed_dim, bias=False, dtype=dtype,
                                  device=device)

        self.pos_embed_type = (
            pos_embed if isinstance(pos_embed, str)
            else ("direct" if pos_embed else "none"))
        if self.pos_embed_type == "direct":
            self.pos_embed = nn.Parameter(torch.empty(
                1, nlat, nlon, embed_dim, device=device))
        elif self.pos_embed_type == "frequency":
            lmax, mmax = self.itrans_up.lmax, self.itrans_up.mmax
            self.pos_embed_r = nn.Parameter(torch.empty(
                1, lmax, mmax, embed_dim, device=device))
            self.pos_embed_c = nn.Parameter(torch.empty(
                1, lmax, max(mmax - 1, 0), embed_dim, device=device))
        elif self.pos_embed_type != "none":
            raise ValueError(
                f"unknown pos_embed type {self.pos_embed_type!r}")

        dpr = np.linspace(0, drop_path_rate, num_layers)
        self.num_layers = num_layers
        for i in range(num_layers):
            first, last = i == 0, i == num_layers - 1
            self.add_module(f"block_{i}", FourierNeuralOperatorBlock(
                self.trans_down if first else self.trans,
                self.itrans_up if last else self.itrans,
                embed_dim, operator_type=operator_type, mlp_ratio=mlp_ratio,
                drop_rate=drop_rate, drop_path=float(dpr[i]),
                activation=activation_function,
                normalization=normalization_layer, use_mlp=use_mlp,
                separable=separable, factorization=factorization, rank=rank,
                dtype=dtype, device=device,
            ))
        width = embed_dim + (in_chans if big_skip else 0)
        for i in range(encoder_layers):
            self.add_module(f"decoder_{i}", Linear(
                width, embed_dim, dtype=dtype, device=device))
            width = embed_dim
        self.decoder_out = Linear(width, out_chans, bias=False, dtype=dtype,
                                  device=device)

    def _blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            for name in ("pos_embed", "pos_embed_r", "pos_embed_c"):
                p = getattr(self, name, None)
                if isinstance(p, nn.Parameter):
                    trunc_normal_init(p, generator=generator)

    def _frequency_embedding(self):
        # learned lower-triangular spectral coefficients synthesized on
        # the grid (ace_tpu/models/sfno.py:636-663); the m = 0 imaginary
        # parts are structurally zero
        lmax, mmax = self.itrans_up.lmax, self.itrans_up.mmax
        device = self.pos_embed_r.device
        l_idx = torch.arange(lmax, device=device)[:, None]
        m_idx = torch.arange(mmax, device=device)[None, :]
        rmask = (m_idx <= l_idx)[None, :, :, None]
        cmask = (m_idx[:, : mmax - 1] + 1 <= l_idx)[None, :, :, None]
        real = self.pos_embed_r * rmask
        imag = F.pad(self.pos_embed_c * cmask, (0, 0, 1, 0))
        if hasattr(self.itrans_up, "inverse_pair"):
            return self.itrans_up.inverse_pair(real, imag)
        return self.itrans_up(torch.complex(real, imag))

    def forward(self, x, noise=None, generator=None, deterministic=True):
        act = self.act
        if self.big_skip:
            residual = x
            if self.residual_filter:
                residual = self.residual_filter_up.inverse_pair(
                    *self.residual_filter_down.forward_pair(x.float())
                ).to(x.dtype)

        h = x.to(self.dtype)
        for i in range(self.encoder_layers):
            h = act(getattr(self, f"encoder_{i}")(h))
        h = self.encoder_out(h)
        if self.pos_embed_type == "direct":
            h = h + self.pos_embed.to(h.dtype)
        elif self.pos_embed_type == "frequency":
            h = h + self._frequency_embedding().to(h.dtype)
        h = dropout(h, self.drop_rate, deterministic, generator)

        for _ in range(self.repeat_layers):
            for block in self._blocks():
                call = functools.partial(block, deterministic=deterministic,
                                         generator=generator)
                if self.checkpointing >= 1 and torch.is_grad_enabled():
                    # the recompute replays the explicit generator, which
                    # preserve_rng_state does not cover
                    h = torch.utils.checkpoint.checkpoint(
                        replaying(call, generator), h, use_reentrant=False,
                        preserve_rng_state=False,
                    )
                else:
                    h = call(h)

        if self.big_skip:
            h = torch.cat([h, residual.to(h.dtype)], dim=-1)
        for i in range(self.encoder_layers):
            h = act(getattr(self, f"decoder_{i}")(h))
        return self.decoder_out(h).float()
