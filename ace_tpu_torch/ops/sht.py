"""Real spherical harmonic transforms, single device (port of
ace_tpu/ops/sht.py). Channels-last (``[..., nlat, nlon, C]``, the layout
every model of the port uses) by default; ``channels_last=False`` gives
the JAX package's default layout, ``[..., nlat, nlon]``.

Same conventions as the JAX package (torch-harmonics ``norm="ortho"``,
``csphase=True``): the longitudinal DFT is a matmul against precomputed
cos/sin matrices with the 2π/nlon scale folded in, truncated to ``mmax``
modes; the Legendre contraction is an einsum against quadrature-weighted
associated Legendre tables ``w[m, l, k]``. Both transforms compute in
float32 whatever the input dtype, as the JAX package pins them. On the
GPU they run in full float32 as long as TF32 matmuls are off (PyTorch's
default, ``torch.backends.cuda.matmul.allow_tf32 = False``).

Tables are numpy float64 precomputes cast to float32 and held as
non-persistent buffers, so ``.to(device)`` moves them and checkpoints do
not carry them. A transform computes in its tables' dtype: float32,
unless the module was cast (``.double()`` evaluates the same transform
in float64, for measuring a float32 one's error).

``RealSHT.forward_fused`` is the fused forward transform
(``ops/fused_sht.py``, kernel K3); no model calls it, as in the JAX
package.
"""

import functools

import numpy as np
import torch
from torch import nn

from ace_tpu_torch.ops.fused_sht import fused_sht, kernel_tables
from ace_tpu_torch.ops.legendre import precompute_legpoly
from ace_tpu_torch.ops.quadrature import (
    clenshaw_curtiss_weights,
    legendre_gauss_weights,
    lobatto_weights,
)

_GRIDS = ("legendre-gauss", "lobatto", "equiangular")


def quadrature_for_grid(grid: str, nlat: int):
    """Return (cost ascending, weights, default lmax) for a grid type."""
    if grid == "legendre-gauss":
        cost, w = legendre_gauss_weights(nlat, -1, 1)
        lmax = nlat
    elif grid == "lobatto":
        cost, w = lobatto_weights(nlat, -1, 1)
        lmax = nlat - 1
    elif grid == "equiangular":
        cost, w = clenshaw_curtiss_weights(nlat, -1, 1)
        lmax = nlat
    else:
        raise ValueError(f"Unknown quadrature mode {grid!r}; options: {_GRIDS}")
    return cost, w, lmax


@functools.lru_cache(maxsize=32)
def _dft_matrices(nlon: int, mmax: int):
    """Forward/inverse real-DFT matrices for the lon axis, float64.

    Forward: ``xm = x @ (cosF - i sinF)`` equals ``rfft(x)`` rows
    0..mmax-1 (zero rows beyond nlon//2+1 if mmax is larger), scaled by
    2π/nlon. Inverse matrices implement the Hermitian-doubled irfft with
    "forward" normalization (no 1/n).
    """
    m = np.arange(mmax)
    j = np.arange(nlon)
    ang = 2.0 * np.pi * np.outer(j, m) / nlon  # [nlon, mmax]
    valid = m <= nlon // 2  # modes beyond nyquist are zero-padding
    scale = 2.0 * np.pi / nlon
    fwd_cos = scale * np.cos(ang) * valid
    fwd_sin = -scale * np.sin(ang) * valid
    # inverse: f_j = sum_m alpha_m (cr_m cos - ci_m sin)
    alpha = np.where((m == 0) | (2 * m == nlon), 1.0, 2.0) * valid
    inv_cos = alpha[:, None] * np.cos(ang.T)  # [mmax, nlon]
    inv_sin = -alpha[:, None] * np.sin(ang.T)
    return fwd_cos, fwd_sin, inv_cos, inv_sin


@functools.lru_cache(maxsize=16)
def _legendre_table(nlat: int, lmax: int, mmax: int, grid: str, norm: str,
                    csphase: bool, inverse: bool) -> np.ndarray:
    """[m, l, k] float64 Legendre table; the forward one carries the
    quadrature weights (weights are symmetric in latitude, so no flip)."""
    cost, w, _ = quadrature_for_grid(grid, nlat)
    # colatitudes ascending (north pole first)
    theta = np.flip(np.arccos(cost))
    pct = precompute_legpoly(mmax, lmax, theta, norm=norm, inverse=inverse,
                             csphase=csphase)
    if not inverse:
        pct = pct * w[None, None, :]
    return pct


def _f32(table: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(table, dtype=torch.float32, device=device)


# the einsums of each layout: (DFT, Legendre) forward, (Legendre, DFT)
# inverse
_FORWARD_EQS = {True: ("...kjc,jm->...kmc", "...kmc,mlk->...lmc"),
                False: ("...kj,jm->...km", "...km,mlk->...lm")}
_INVERSE_EQS = {True: ("...lmc,mlk->...kmc", "...kmc,mj->...kjc"),
                False: ("...lm,mlk->...km", "...km,mj->...kj")}


class RealSHT(nn.Module):
    """Forward real SHT: ``[..., nlat, nlon, C] -> (real, imag)`` each
    ``[..., lmax, mmax, C]`` float32 through ``forward_pair`` (without
    the channel axis where ``channels_last`` is False), complex through
    ``forward`` (port of ace_tpu/ops/sht.py:123 RealSHT)."""

    def __init__(self, nlat, nlon, lmax=None, mmax=None,
                 grid="legendre-gauss", norm="ortho", csphase=True,
                 channels_last=True, device=None):
        super().__init__()
        self.channels_last = channels_last
        self.nlat, self.nlon, self.grid = nlat, nlon, grid
        _, _, default_lmax = quadrature_for_grid(grid, nlat)
        self.lmax = lmax or default_lmax
        self.mmax = mmax or nlon // 2 + 1
        table = _legendre_table(nlat, self.lmax, self.mmax, grid, norm,
                                csphase, False)
        fc, fs, _, _ = _dft_matrices(nlon, self.mmax)
        self.register_buffer("weights", _f32(table, device), persistent=False)
        self.register_buffer("fc", _f32(fc, device), persistent=False)
        self.register_buffer("fs", _f32(fs, device), persistent=False)
        self.norm, self.csphase = norm, csphase
        self._kernel_tables = None

    def forward_pair(self, x: torch.Tensor):
        dft, leg = _FORWARD_EQS[self.channels_last]
        x = x.to(self.fc.dtype)
        xr = torch.einsum(dft, x, self.fc)
        xi = torch.einsum(dft, x, self.fs)
        cr = torch.einsum(leg, xr, self.weights)
        ci = torch.einsum(leg, xi, self.weights)
        return cr, ci

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.complex(*self.forward_pair(x))

    def fused_table(self) -> torch.Tensor:
        """The Legendre table in the fused transform's layout ``[k, l, m]``:
        a view of ``weights``, so it costs no memory."""
        return self.weights.permute(2, 1, 0)

    def kernel_tables(self):
        """The fused kernel's split TF32 tables
        (``ops/fused_sht.py:kernel_tables``), prepared once per device."""
        w = self.weights
        key = (w.device, w.data_ptr())
        if self._kernel_tables is None or self._kernel_tables[0] != key:
            self._kernel_tables = (
                key, kernel_tables(self.fc, self.fs, self.fused_table())
            )
        return self._kernel_tables[1]

    def tables_float64(self):
        """``(fc, fs, weights)`` as float64 numpy arrays, before the
        float32 cast: for measuring a transform's error against an exact
        evaluation."""
        fc, fs, _, _ = _dft_matrices(self.nlon, self.mmax)
        table = _legendre_table(self.nlat, self.lmax, self.mmax, self.grid,
                                self.norm, self.csphase, False)
        return fc, fs, table

    def forward_fused(self, x: torch.Tensor):
        """The forward transform in one call (port of
        ace_tpu/ops/sht.py:195): ``[B, K, J, C]`` only; returns (real,
        imag) float32 ``[B, lmax, mmax, C]`` as ``forward_pair`` does.
        The kernel (``ops/fused_sht.py``) runs for CUDA tensors, in split
        TF32 on the tensor cores, and masks ragged edges, so nothing is
        padded."""
        if not self.channels_last or x.dim() != 4:
            raise ValueError("forward_fused needs [B, K, J, C] input")
        x = x.float().contiguous()
        tables = self.kernel_tables() if x.device.type == "cuda" else None
        return fused_sht(x, self.fc, self.fs, self.fused_table(),
                         tables=tables)


class InverseRealSHT(nn.Module):
    """Inverse real SHT: ``(real, imag) [..., lmax, mmax, C] -> [...,
    nlat, nlon, C]`` float32 through ``inverse_pair`` (without the channel
    axis where ``channels_last`` is False), from complex through
    ``forward`` (port of ace_tpu/ops/sht.py:292 InverseRealSHT)."""

    def __init__(self, nlat, nlon, lmax=None, mmax=None,
                 grid="legendre-gauss", norm="ortho", csphase=True,
                 channels_last=True, device=None):
        super().__init__()
        self.channels_last = channels_last
        self.nlat, self.nlon, self.grid = nlat, nlon, grid
        _, _, default_lmax = quadrature_for_grid(grid, nlat)
        self.lmax = lmax or default_lmax
        self.mmax = mmax or nlon // 2 + 1
        table = _legendre_table(nlat, self.lmax, self.mmax, grid, norm,
                                csphase, True)
        _, _, ic, is_ = _dft_matrices(nlon, self.mmax)
        self.register_buffer("pct", _f32(table, device), persistent=False)
        self.register_buffer("ic", _f32(ic, device), persistent=False)
        self.register_buffer("is_", _f32(is_, device), persistent=False)

    def inverse_pair(self, cr: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
        leg, dft = _INVERSE_EQS[self.channels_last]
        xr = torch.einsum(leg, cr.to(self.pct.dtype), self.pct)
        xi = torch.einsum(leg, ci.to(self.pct.dtype), self.pct)
        # the sin rows of the inverse DFT matrix vanish at m=0 and the
        # nyquist mode, which drops their imaginary parts (Hermitian
        # cleanup)
        out = torch.einsum(dft, xr, self.ic)
        return out + torch.einsum(dft, xi, self.is_)

    def forward(self, coeffs: torch.Tensor) -> torch.Tensor:
        return self.inverse_pair(coeffs.real, coeffs.imag)


def build_sht(nlat, nlon, lmax=None, mmax=None, grid="legendre-gauss",
              norm="ortho", csphase=True, device=None) -> RealSHT:
    """Forward-SHT constructor (single device; the JAX package's mesh
    dispatch has no counterpart yet)."""
    return RealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid, norm=norm,
                   csphase=csphase, device=device)


def build_isht(nlat, nlon, lmax=None, mmax=None, grid="legendre-gauss",
               norm="ortho", csphase=True, device=None) -> InverseRealSHT:
    """Inverse-SHT constructor (see ``build_sht``)."""
    return InverseRealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid,
                          norm=norm, csphase=csphase, device=device)
