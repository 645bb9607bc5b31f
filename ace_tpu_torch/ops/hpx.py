"""HEALPix index reordering and spherical harmonic transforms, channels-
last (port of ace_tpu/ops/hpx.py).

The index tables and the ring decomposition are host-side numpy, copied
from the JAX package (whose module imports JAX). The transforms are the
JAX package's: rings are scattered into a ``[ntheta, nphi_max]`` padded
array and transformed by one einsum against a per-ring DFT table (rows
beyond a ring's ``nphi`` are zero, modes above its Nyquist are zero),
then contracted against the Legendre table; the inverse evaluates the
same tables and gathers the rings back out. No Condon-Shortley phase.
They compute in their tables' dtype: float32 (full float32 on the card
with TF32 off, as the entries pin it), or float64 after ``.double()``.
With ``xy_order`` a transform reads (or writes) the flat-XY order of
``[..., 12, nside, nside, C]`` data: the reorder is folded into the
scatter and gather indices, which move the same values.
"""

import functools

import numpy as np
import torch
from torch import nn

from ace_tpu_torch.ops.legendre import precompute_legpoly

_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4])
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7])


def _xyf2ring(nside: int, f, ix, iy):
    """Vectorized HEALPix (face, x, y) -> ring pixel index (standard
    healpix geometry; ix to NE, iy to NW within the face).
    """
    npix = 12 * nside * nside
    ncap = 2 * nside * (nside - 1)
    jr = _JRLL[f] * nside - ix - iy - 1
    north = jr < nside
    south = jr > 3 * nside
    nr = np.where(north, jr, np.where(south, 4 * nside - jr, nside))
    n_before = np.where(
        north,
        2 * nr * (nr - 1),
        np.where(
            south,
            npix - 2 * nr * (nr + 1),
            ncap + (jr - nside) * 4 * nside,
        ),
    )
    kshift = np.where(north | south, 0, (jr - nside) & 1)
    jp = (_JPLL[f] * nr + ix - iy + 1 + kshift) // 2
    jp = np.where(jp > 4 * nr, jp - 4 * nr, jp)
    jp = np.where(jp < 1, jp + 4 * nr, jp)
    return n_before + jp - 1


@functools.lru_cache(maxsize=16)
def ring_to_xy_indices(nside: int) -> np.ndarray:
    """Index table mapping flat-XY order to ring pixel numbers:
    ``x_xy = x_ring[ring_to_xy_indices(nside)]`` (row and column both
    reversed, ix = row)."""
    f, r, c = np.meshgrid(
        np.arange(12), np.arange(nside), np.arange(nside), indexing="ij"
    )
    ix = nside - 1 - r
    iy = nside - 1 - c
    return _xyf2ring(nside, f, ix, iy).ravel().astype(np.int64)


@functools.lru_cache(maxsize=16)
def xy_to_ring_indices(nside: int) -> np.ndarray:
    """``x_ring = x_xy[xy_to_ring_indices(nside)]``."""
    return np.argsort(ring_to_xy_indices(nside)).astype(np.int64)


def ring_decomposition(nside: int):
    """Per-ring (nphi, start offset, theta, phi0) for the ring ordering."""
    ntheta = 4 * nside - 1
    t = np.arange(ntheta)
    nphi = np.where(
        t < nside - 1,
        4 * (t + 1),
        np.where(t <= 3 * nside - 1, 4 * nside, 4 * (ntheta - t)),
    )
    start = np.concatenate([[0], np.cumsum(nphi)[:-1]])
    # z from north to south
    z = np.where(
        t < nside - 1,
        1 - ((t + 1) ** 2) / (3 * nside**2),
        np.where(
            t <= 3 * nside - 1,
            4 / 3 - 2 * (t + 1) / (3 * nside),
            ((4 * nside - 1 - t) ** 2) / (3 * nside**2) - 1,
        ),
    )
    theta = np.arccos(z)
    # first-pixel longitude offset per ring: polar rings and shifted
    # equatorial rings are offset by half a pixel
    shift = np.where(
        (t < nside - 1) | (t > 3 * nside - 1),
        1,
        (t - nside) % 2,
    )
    phi0 = shift * np.pi / nphi
    return nphi, start, theta, phi0


def _ring_positions(nside: int, nphi_max: int, xy_order: bool) -> np.ndarray:
    """Each input pixel's flat position in the padded ``[ntheta,
    nphi_max]`` array: ring order, or flat-XY order with ``xy_order``."""
    nphi, start, _, _ = ring_decomposition(nside)
    pos = np.zeros(12 * nside * nside, np.int64)
    for t in range(len(nphi)):
        p = np.arange(nphi[t])
        pos[start[t]:start[t] + nphi[t]] = t * nphi_max + p
    if xy_order:
        # xy pixel i is ring pixel ring_to_xy_indices[i]
        pos = pos[ring_to_xy_indices(nside)]
    return pos


def _f32(table: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(table, dtype=torch.float32, device=device)


class HealpixSHT(nn.Module):
    """Forward SHT on HEALPix pixels, channels-last: ``[..., npix, C]``
    (ring order; ``[..., 12, nside, nside, C]`` with ``xy_order``) ->
    (real, imag) each ``[..., lmax, mmax, C]`` float32 through
    ``forward_pair``, complex through ``forward`` (port of
    ace_tpu/ops/hpx.py:108). Equal-area quadrature."""

    def __init__(self, nside: int, lmax: int | None = None,
                 mmax: int | None = None, norm: str = "ortho",
                 csphase: bool = False, xy_order: bool = False,
                 device=None):
        super().__init__()
        self.nside = nside
        ntheta = 4 * nside - 1
        self.nlat, self.nlon = ntheta, 4 * nside
        self.lmax = lmax or self.nlat
        self.mmax = mmax or (self.nlon // 2 + 1)
        self.xy_order = xy_order
        npix = 12 * nside * nside
        nphi, _, theta, phi0 = ring_decomposition(nside)
        w = 4.0 * np.pi / npix * np.ones(ntheta)
        pct = precompute_legpoly(self.mmax, self.lmax, theta, norm=norm,
                                 csphase=csphase)
        nphi_max = int(nphi.max())
        m = np.arange(self.mmax)
        fr = np.zeros((ntheta, nphi_max, self.mmax), np.float32)
        fi = np.zeros((ntheta, nphi_max, self.mmax), np.float32)
        for t in range(ntheta):
            phi = phi0[t] + 2.0 * np.pi * np.arange(nphi[t]) / nphi[t]
            ang = np.outer(phi, m)
            # a ring's rfft keeps only the modes below its Nyquist
            valid = m <= nphi[t] // 2
            fr[t, : nphi[t]] = np.cos(ang) * valid
            fi[t, : nphi[t]] = -np.sin(ang) * valid
        self._ntheta, self._nphi_max = ntheta, nphi_max
        self.register_buffer("leg", _f32(np.einsum("mlk,k->mlk", pct, w),
                                         device), persistent=False)
        self.register_buffer("fr", torch.from_numpy(fr).to(device),
                             persistent=False)
        self.register_buffer("fi", torch.from_numpy(fi).to(device),
                             persistent=False)
        self.register_buffer(
            "scatter", torch.from_numpy(
                _ring_positions(nside, nphi_max, xy_order)).to(device),
            persistent=False)

    def _to_padded(self, x: torch.Tensor) -> torch.Tensor:
        """``[..., npix, C] -> [..., ntheta, nphi_max, C]``: a fresh
        zero array each call, the pixels scattered into it."""
        lead = x.shape[:-2]
        padded = x.new_zeros(*lead, self._ntheta * self._nphi_max,
                             x.shape[-1])
        padded = padded.index_copy(-2, self.scatter, x)
        return padded.reshape(*lead, self._ntheta, self._nphi_max,
                              x.shape[-1])

    def forward_pair(self, x: torch.Tensor):
        x = x.to(self.fr.dtype)
        if self.xy_order:
            x = x.reshape(*x.shape[:-4], -1, x.shape[-1])
        x = self._to_padded(x)
        xr = torch.einsum("...kpc,kpm->...kmc", x, self.fr)
        xi = torch.einsum("...kpc,kpm->...kmc", x, self.fi)
        yr = torch.einsum("...kmc,mlk->...lmc", xr, self.leg)
        yi = torch.einsum("...kmc,mlk->...lmc", xi, self.leg)
        return yr, yi

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.complex(*self.forward_pair(x))


class HealpixISHT(nn.Module):
    """Inverse SHT to HEALPix pixels, channels-last: (real, imag) each
    ``[..., lmax, mmax, C]`` -> ``[..., npix, C]`` float32 (ring order;
    ``[..., 12, nside, nside, C]`` with ``xy_order``) through
    ``inverse_pair``, from complex through ``forward`` (port of
    ace_tpu/ops/hpx.py:183)."""

    def __init__(self, nside: int, lmax: int | None = None,
                 mmax: int | None = None, norm: str = "ortho",
                 csphase: bool = False, xy_order: bool = False,
                 device=None):
        super().__init__()
        self.nside = nside
        ntheta = 4 * nside - 1
        self.nlat, self.nlon = ntheta, 4 * nside
        self.lmax = lmax or self.nlat
        self.mmax = mmax or (self.nlon // 2 + 1)
        self.xy_order = xy_order
        nphi, _, theta, phi0 = ring_decomposition(nside)
        pct = precompute_legpoly(self.mmax, self.lmax, theta, norm=norm,
                                 csphase=csphase, inverse=True)
        nphi_max = int(nphi.max())
        m = np.arange(self.mmax)
        # inverse DFT with Hermitian doubling; a ring's Nyquist counted once
        cr = np.zeros((ntheta, self.mmax, nphi_max), np.float32)
        ci = np.zeros((ntheta, self.mmax, nphi_max), np.float32)
        for t in range(ntheta):
            phi = phi0[t] + 2.0 * np.pi * np.arange(nphi[t]) / nphi[t]
            ang = np.outer(m, phi)
            double = np.where(
                (m == 0) | ((nphi[t] % 2 == 0) & (m == nphi[t] // 2)),
                1.0, 2.0,
            )
            valid = (m <= nphi[t] // 2).astype(np.float32)
            scale = (double * valid)[:, None]
            cr[t, :, : nphi[t]] = np.cos(ang) * scale
            ci[t, :, : nphi[t]] = -np.sin(ang) * scale
        self._ntheta, self._nphi_max = ntheta, nphi_max
        self.register_buffer("leg", _f32(pct, device), persistent=False)
        self.register_buffer("cr", torch.from_numpy(cr).to(device),
                             persistent=False)
        self.register_buffer("ci", torch.from_numpy(ci).to(device),
                             persistent=False)
        self.register_buffer(
            "gather", torch.from_numpy(
                _ring_positions(nside, nphi_max, xy_order)).to(device),
            persistent=False)

    def inverse_pair(self, yr: torch.Tensor, yi: torch.Tensor
                     ) -> torch.Tensor:
        xr = torch.einsum("...lmc,mlk->...kmc", yr.to(self.leg.dtype),
                          self.leg)
        xi = torch.einsum("...lmc,mlk->...kmc", yi.to(self.leg.dtype),
                          self.leg)
        f = (torch.einsum("...kmc,kmp->...kpc", xr, self.cr)
             + torch.einsum("...kmc,kmp->...kpc", xi, self.ci))
        flat = f.reshape(*f.shape[:-3], self._ntheta * self._nphi_max,
                         f.shape[-1])
        out = flat.index_select(-2, self.gather)
        if self.xy_order:
            out = out.reshape(*out.shape[:-2], 12, self.nside, self.nside,
                              out.shape[-1])
        return out

    def forward(self, coeffs: torch.Tensor) -> torch.Tensor:
        return self.inverse_pair(coeffs.real, coeffs.imag)
