"""Real spherical harmonic transforms, channels-last, single device
(port of ace_tpu/ops/sht.py).

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
not carry them.

``RealSHT.forward_fused`` is the fused forward transform
(``ops/fused_sht.py``, kernel K3); no model calls it, as in the JAX
package.
"""

import functools

import numpy as np
import torch
from torch import nn

from ace_tpu_torch.ops.fused_sht import fused_sht
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
    """Forward/inverse real-DFT matrices for the lon axis.

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
    fwd_cos = (scale * np.cos(ang) * valid).astype(np.float32)
    fwd_sin = (-scale * np.sin(ang) * valid).astype(np.float32)
    # inverse: f_j = sum_m alpha_m (cr_m cos - ci_m sin)
    alpha = np.where((m == 0) | (2 * m == nlon), 1.0, 2.0) * valid
    inv_cos = (alpha[:, None] * np.cos(ang.T)).astype(np.float32)  # [mmax, nlon]
    inv_sin = (-alpha[:, None] * np.sin(ang.T)).astype(np.float32)
    return fwd_cos, fwd_sin, inv_cos, inv_sin


@functools.lru_cache(maxsize=16)
def _legendre_table(nlat: int, lmax: int, mmax: int, grid: str, norm: str,
                    csphase: bool, inverse: bool) -> np.ndarray:
    """[m, l, k] float32 Legendre table; the forward one carries the
    quadrature weights (weights are symmetric in latitude, so no flip)."""
    cost, w, _ = quadrature_for_grid(grid, nlat)
    # colatitudes ascending (north pole first)
    theta = np.flip(np.arccos(cost))
    pct = precompute_legpoly(mmax, lmax, theta, norm=norm, inverse=inverse,
                             csphase=csphase)
    if not inverse:
        pct = pct * w[None, None, :]
    return pct.astype(np.float32)


class RealSHT(nn.Module):
    """Forward real SHT on channels-last data:
    ``[..., nlat, nlon, C] -> (real, imag)`` each ``[..., lmax, mmax, C]``
    float32 (port of ace_tpu/ops/sht.py:123 RealSHT.forward_pair)."""

    def __init__(self, nlat, nlon, lmax=None, mmax=None,
                 grid="legendre-gauss", norm="ortho", csphase=True,
                 device=None):
        super().__init__()
        self.nlat, self.nlon, self.grid = nlat, nlon, grid
        _, _, default_lmax = quadrature_for_grid(grid, nlat)
        self.lmax = lmax or default_lmax
        self.mmax = mmax or nlon // 2 + 1
        table = _legendre_table(nlat, self.lmax, self.mmax, grid, norm,
                                csphase, False)
        fc, fs, _, _ = _dft_matrices(nlon, self.mmax)
        self.register_buffer("weights", torch.as_tensor(table, device=device),
                             persistent=False)
        self.register_buffer("fc", torch.as_tensor(fc, device=device),
                             persistent=False)
        self.register_buffer("fs", torch.as_tensor(fs, device=device),
                             persistent=False)
        self._fused_table = None

    def forward_pair(self, x: torch.Tensor):
        x = x.float()
        xr = torch.einsum("...kjc,jm->...kmc", x, self.fc)
        xi = torch.einsum("...kjc,jm->...kmc", x, self.fs)
        cr = torch.einsum("...kmc,mlk->...lmc", xr, self.weights)
        ci = torch.einsum("...kmc,mlk->...lmc", xi, self.weights)
        return cr, ci

    def fused_table(self) -> torch.Tensor:
        """The Legendre table in the fused kernel's layout ``[k, l, m]``,
        prepared once per device."""
        w = self.weights
        key = (w.device, w.data_ptr())
        if self._fused_table is None or self._fused_table[0] != key:
            self._fused_table = (key, w.permute(2, 1, 0).contiguous())
        return self._fused_table[1]

    def forward_fused(self, x: torch.Tensor):
        """The forward transform in one pass (port of
        ace_tpu/ops/sht.py:195): ``[B, K, J, C]`` only; returns (real,
        imag) float32 ``[B, lmax, mmax, C]`` as ``forward_pair`` does.
        The kernel (``ops/fused_sht.py``) runs for CUDA tensors; it keeps
        the DFT intermediate on chip and masks ragged edges, so nothing is
        padded."""
        if x.dim() != 4:
            raise ValueError("forward_fused needs [B, K, J, C] input")
        return fused_sht(x.float().contiguous(), self.fc, self.fs,
                         self.fused_table())


class InverseRealSHT(nn.Module):
    """Inverse real SHT on channels-last coefficients:
    ``(real, imag) [..., lmax, mmax, C] -> [..., nlat, nlon, C]`` float32
    (port of ace_tpu/ops/sht.py:292 InverseRealSHT.inverse_pair)."""

    def __init__(self, nlat, nlon, lmax=None, mmax=None,
                 grid="legendre-gauss", norm="ortho", csphase=True,
                 device=None):
        super().__init__()
        self.nlat, self.nlon, self.grid = nlat, nlon, grid
        _, _, default_lmax = quadrature_for_grid(grid, nlat)
        self.lmax = lmax or default_lmax
        self.mmax = mmax or nlon // 2 + 1
        table = _legendre_table(nlat, self.lmax, self.mmax, grid, norm,
                                csphase, True)
        _, _, ic, is_ = _dft_matrices(nlon, self.mmax)
        self.register_buffer("pct", torch.as_tensor(table, device=device),
                             persistent=False)
        self.register_buffer("ic", torch.as_tensor(ic, device=device),
                             persistent=False)
        self.register_buffer("is_", torch.as_tensor(is_, device=device),
                             persistent=False)

    def inverse_pair(self, cr: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
        xr = torch.einsum("...lmc,mlk->...kmc", cr.float(), self.pct)
        xi = torch.einsum("...lmc,mlk->...kmc", ci.float(), self.pct)
        # the sin rows of the inverse DFT matrix vanish at m=0 and the
        # nyquist mode, which drops their imaginary parts (Hermitian
        # cleanup)
        out = torch.einsum("...kmc,mj->...kjc", xr, self.ic)
        return out + torch.einsum("...kmc,mj->...kjc", xi, self.is_)


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
