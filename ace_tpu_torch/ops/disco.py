"""Discrete-continuous (DISCO) convolutions on S2, channels-last (port of
ace_tpu/ops/disco.py; algorithm per Ocampo, Price, McEwen, ICLR 2023).

The filter basis functions and the precompute of the rotated-filter
tensor psi are host-side numpy, copied from the JAX package (whose module
imports JAX): psi is banded over input latitude, so that each output
latitude reads ``bw`` rows. ``DiscoConvS2`` is the contraction, as the
JAX package computes it: the longitude DFT as a matmul, the band gather
per output latitude, four real einsums over the band against the
conjugated psi FFT, the inverse DFT as a matmul and the stride subsample
to the output longitudes. It computes in float32 (full float32 on the
card with TF32 off, as the entries pin it).
"""

import math

import numpy as np
import torch
from torch import nn

from ace_tpu_torch.ops.sht import _dft_matrices, quadrature_for_grid


def _circle_dist(phi1, phi2):
    # matches the reference exactly incl. |x1-x2| > 2*pi cases
    # (reference: _filter_basis.py:14)
    d = np.abs(phi1 - phi2)
    return np.minimum(d, np.abs(2 * math.pi - d))


def _piecewise_linear_support(kernel_shape, r, phi, r_cutoff):
    """Evaluate the piecewise-linear filter basis at (r, phi)
    (reference: fme/core/disco/_filter_basis.py:74). Returns
    (indices [n, 3] of (k, lat, lon), values [n]).
    """
    nr, nphi = kernel_shape
    if nphi == 1:
        kernel_size = nr // 2 + nr % 2
        dr = 2 * r_cutoff / (nr + 1)
        if nr % 2 == 1:
            ir = np.arange(kernel_size) * dr
        else:
            ir = (np.arange(kernel_size) + 0.5) * dr
        ir = ir.reshape(-1, 1, 1)
        cond = (np.abs(r - ir) <= dr) & (r <= r_cutoff)
        iidx = np.argwhere(cond)
        vals = 1 - np.abs(
            r[iidx[:, 1], iidx[:, 2]] - ir[iidx[:, 0], 0, 0]
        ) / dr
        return iidx, vals

    kernel_size = (nr // 2) * nphi + nr % 2
    ik = np.arange(kernel_size).reshape(-1, 1, 1)
    dr = 2 * r_cutoff / (nr + 1)
    dphi = 2.0 * math.pi / nphi
    if nr % 2 == 1:
        ir = ((ik - 1) // nphi + 1) * dr
        iphi = ((ik - 1) % nphi) * dphi - math.pi
        cond_r = (np.abs(r - ir) <= dr) & (r <= r_cutoff)
        cond_phi = (ik == 0) | (np.abs(_circle_dist(phi, iphi)) <= dphi)
        iidx = np.argwhere(cond_r & cond_phi)
        dist_r = np.abs(r[iidx[:, 1], iidx[:, 2]] - ir[iidx[:, 0], 0, 0])
        dist_phi = _circle_dist(
            phi[iidx[:, 1], iidx[:, 2]], iphi[iidx[:, 0], 0, 0]
        )
        vals = 1 - dist_r / dr
        vals = vals * np.where(iidx[:, 0] > 0, 1 - dist_phi / dphi, 1.0)
        return iidx, vals

    ir = (ik // nphi + 0.5) * dr
    iphi = (ik % nphi) * dphi - math.pi
    rn = -r
    phin = np.where(phi + math.pi >= math.pi, phi - math.pi, phi + math.pi)
    cond_r = (np.abs(r - ir) <= dr) & (r <= r_cutoff)
    cond_phi = _circle_dist(phi, iphi) <= dphi
    cond_rn = (np.abs(rn - ir) <= dr) & (rn <= r_cutoff)
    cond_phin = _circle_dist(phin, iphi) <= dphi
    iidx = np.argwhere((cond_r & cond_phi) | (cond_rn & cond_phin))
    k_, a_, b_ = iidx[:, 0], iidx[:, 1], iidx[:, 2]
    dist_r = np.abs(r[a_, b_] - ir[k_, 0, 0])
    dist_phi = _circle_dist(phi[a_, b_], iphi[k_, 0, 0])
    dist_rn = np.abs(rn[a_, b_] - ir[k_, 0, 0])
    dist_phin = _circle_dist(phin[a_, b_], iphi[k_, 0, 0])
    vals = cond_r[k_, a_, b_] * (1 - dist_r / dr)
    vals = vals * (cond_phi[k_, a_, b_] * (1 - dist_phi / dphi))
    valsn = cond_rn[k_, a_, b_] * (1 - dist_rn / dr)
    valsn = valsn * (cond_phin[k_, a_, b_] * (1 - dist_phin / dphi))
    return iidx, vals + valsn


def pl_kernel_size(kernel_shape) -> int:
    """(reference: _filter_basis.py:91 kernel_size property)."""
    nr, nphi = kernel_shape
    if nphi == 1:
        return nr // 2 + nr % 2
    return (nr // 2) * nphi + nr % 2


def _morlet_support(kernel_shape, r, phi, r_cutoff, width=1.0):
    """Morlet-style filter basis on the disk
    (reference: _filter_basis.py:169 MorletFilterBasis): a Hann window
    times separable sin/cos harmonics in disk (x, y) coordinates.
    """
    nr, nphi = kernel_shape
    kernel_size = nr * nphi
    cond = r <= r_cutoff
    a_, b_ = np.nonzero(cond)
    rr = r[a_, b_] / r_cutoff
    pp = phi[a_, b_]
    x = rr * np.sin(pp)
    y = rr * np.cos(pp)
    hann = np.cos(0.5 * math.pi * rr / width) ** 2
    iidx_parts, val_parts = [], []
    for k in range(kernel_size):
        n = k % nphi
        m = k // nphi
        hx = (
            np.sin(math.ceil(n / 2) * math.pi * x / width)
            if n % 2 == 1
            else np.cos(math.ceil(n / 2) * math.pi * x / width)
        )
        hy = (
            np.sin(math.ceil(m / 2) * math.pi * y / width)
            if m % 2 == 1
            else np.cos(math.ceil(m / 2) * math.pi * y / width)
        )
        iidx_parts.append(
            np.stack([np.full(len(a_), k), a_, b_], axis=1)
        )
        val_parts.append(hann * hx * hy)
    return (
        np.concatenate(iidx_parts, axis=0),
        np.concatenate(val_parts, axis=0),
    )


def _isotropic_morlet_support(kernel_shape, r, phi, r_cutoff, width=1.0):
    """Radial-only Morlet basis (reference: _filter_basis.py:229
    IsotropicMorletFilterBasis): Hann radial window times 1-D Fourier
    harmonics in the normalized radius; independent of phi so learned
    combinations are radially symmetric. ``kernel_shape`` counts radial
    modes (first element if a tuple).
    """
    if isinstance(kernel_shape, (tuple, list)):
        kernel_shape = kernel_shape[0]
    cond = r <= r_cutoff
    a_, b_ = np.nonzero(cond)
    rr = r[a_, b_] / r_cutoff
    hann = np.cos(0.5 * math.pi * rr / width) ** 2
    iidx_parts, val_parts = [], []
    for n in range(kernel_shape):
        harmonic = (
            np.sin(math.ceil(n / 2) * math.pi * rr / width)
            if n % 2 == 1
            else np.cos(math.ceil(n / 2) * math.pi * rr / width)
        )
        iidx_parts.append(
            np.stack([np.full(len(a_), n), a_, b_], axis=1)
        )
        val_parts.append(hann * harmonic)
    return (
        np.concatenate(iidx_parts, axis=0),
        np.concatenate(val_parts, axis=0),
    )


def _zernike_radial(r, n, m):
    out = np.zeros_like(r)
    for k in range((n - m) // 2 + 1):
        out += (
            (-1) ** k
            * math.factorial(n - k)
            * r ** (n - 2 * k)
            / (
                math.factorial(k)
                * math.factorial((n + m) // 2 - k)
                * math.factorial((n - m) // 2 - k)
            )
        )
    return out


def _zernike_support(kernel_shape, r, phi, r_cutoff):
    """Zernike polynomial basis on the disk
    (reference: _filter_basis.py:289 ZernikeFilterBasis).
    """
    nmax = kernel_shape[0] if isinstance(
        kernel_shape, (tuple, list)
    ) else kernel_shape
    cond = r <= r_cutoff
    a_, b_ = np.nonzero(cond)
    rr = r[a_, b_] / r_cutoff
    pp = phi[a_, b_]
    iidx_parts, val_parts = [], []
    k = 0
    for n in range(nmax):
        for l in range(n + 1):  # noqa: E741
            m = 2 * l - n
            if m < 0:
                vals = _zernike_radial(rr, n, -m) * np.sin(m * pp)
            else:
                vals = _zernike_radial(rr, n, m) * np.cos(m * pp)
            iidx_parts.append(
                np.stack([np.full(len(a_), k), a_, b_], axis=1)
            )
            val_parts.append(vals)
            k += 1
    return (
        np.concatenate(iidx_parts, axis=0),
        np.concatenate(val_parts, axis=0),
    )


def basis_kernel_size(kernel_shape, basis_type: str) -> int:
    """(reference: _filter_basis.py kernel_size properties)."""
    if basis_type == "piecewise linear":
        return pl_kernel_size(kernel_shape)
    if basis_type == "morlet":
        return kernel_shape[0] * kernel_shape[1]
    if basis_type == "isotropic morlet":
        return kernel_shape[0] if isinstance(
            kernel_shape, (tuple, list)
        ) else kernel_shape
    if basis_type == "zernike":
        n = kernel_shape[0] if isinstance(
            kernel_shape, (tuple, list)
        ) else kernel_shape
        return (n * (n + 1)) // 2
    raise ValueError(f"unknown basis type {basis_type!r}")


def evaluate_basis(kernel_shape, theta, phi, r_cutoff, basis_type: str):
    if basis_type == "piecewise linear":
        return _piecewise_linear_support(
            kernel_shape, theta, phi, r_cutoff
        )
    if basis_type == "morlet":
        return _morlet_support(kernel_shape, theta, phi, r_cutoff)
    if basis_type == "isotropic morlet":
        return _isotropic_morlet_support(kernel_shape, theta, phi, r_cutoff)
    if basis_type == "zernike":
        return _zernike_support(kernel_shape, theta, phi, r_cutoff)
    raise ValueError(f"unknown basis type {basis_type!r}")


def _colatitudes(nlat, grid):
    cost, w, _ = quadrature_for_grid(grid, nlat)
    lats = np.flip(np.arccos(cost)).copy()
    w = np.flip(w).copy()
    return lats, w


def precompute_disco_psi(
    in_shape, out_shape, kernel_shape,
    grid_in="equiangular", grid_out="equiangular",
    theta_cutoff=None, theta_eps=1e-3, basis_norm_mode="mean",
    eps=1e-9, basis_type="piecewise linear",
):
    """Numpy port of the psi precompute
    (reference: fme/core/disco/_convolution.py:100
    _precompute_convolution_tensor_s2 with merge_quadrature=True) plus the
    banded representation (:48 _precompute_psi_banded).

    Returns (psi_banded [K, nlat_out, bw, nlon_in] float32,
             gather_idx [nlat_out, bw] int32).
    """
    nlat_in, nlon_in = in_shape
    nlat_out, nlon_out = out_shape
    kernel_size = basis_kernel_size(kernel_shape, basis_type)
    if theta_cutoff is None:
        theta_cutoff = math.pi / float(nlat_out - 1)
    theta_cutoff_eff = (1.0 + theta_eps) * theta_cutoff

    lats_in, win = _colatitudes(nlat_in, grid_in)
    lats_out, _ = _colatitudes(nlat_out, grid_out)
    lons_in = np.linspace(0, 2 * math.pi, nlon_in + 1)[:-1]
    quad_weights = win / nlon_in / 2.0

    beta = lons_in[None, :]
    gamma = lats_in[:, None]
    cbeta, sbeta = np.cos(beta), np.sin(beta)
    cgamma, sgamma = np.cos(gamma), np.sin(gamma)

    entries_k, entries_t, entries_lat, entries_lon, entries_val = (
        [], [], [], [], []
    )
    for t in range(nlat_out):
        alpha = -lats_out[t]
        x = math.cos(alpha) * cbeta * sgamma + cgamma * math.sin(alpha)
        y = sbeta * sgamma
        z = -cbeta * math.sin(alpha) * sgamma + math.cos(alpha) * cgamma
        norm = np.sqrt(x * x + y * y + z * z)
        theta = np.arccos(np.clip(z / norm, -1.0, 1.0))
        phi = np.arctan2(y / norm, x / norm)
        phi = np.where(phi < 0.0, phi + 2 * math.pi, phi)
        # theta/phi are (nlat_in, nlon_in); the basis broadcasts them
        # against (K, 1, 1) kernel slots, argwhere yields (k, lat, lon)
        iidx, vals = evaluate_basis(
            kernel_shape, theta, phi, theta_cutoff_eff, basis_type
        )
        entries_k.append(iidx[:, 0])
        entries_t.append(np.full(len(vals), t, dtype=np.int64))
        entries_lat.append(iidx[:, 1])
        entries_lon.append(iidx[:, 2])
        entries_val.append(vals)

    k_arr = np.concatenate(entries_k)
    t_arr = np.concatenate(entries_t)
    lat_arr = np.concatenate(entries_lat)
    lon_arr = np.concatenate(entries_lon)
    val_arr = np.concatenate(entries_val).astype(np.float64)

    # normalization (reference: _normalize_convolution_tensor_s2)
    q = quad_weights[lat_arr]
    vnorm = np.zeros((kernel_size, nlat_out))
    np.add.at(vnorm, (k_arr, t_arr), np.abs(val_arr) * q)
    if basis_norm_mode == "mean":
        denom = vnorm.mean(axis=1, keepdims=True)  # per-kernel mean
        val_arr = val_arr / (denom[k_arr, 0] + eps)
    elif basis_norm_mode == "individual":
        val_arr = val_arr / (vnorm[k_arr, t_arr] + eps)
    elif basis_norm_mode == "none":
        pass
    else:
        raise ValueError(f"unknown basis_norm_mode {basis_norm_mode}")
    val_arr = val_arr * q  # merge_quadrature

    # banded representation over input latitude
    lat_min = np.full(nlat_out, nlat_in, dtype=np.int64)
    lat_max = np.zeros(nlat_out, dtype=np.int64)
    np.minimum.at(lat_min, t_arr, lat_arr)
    np.maximum.at(lat_max, t_arr, lat_arr)
    empty = lat_min >= nlat_in
    lat_min[empty] = 0
    lat_max[empty] = 0
    bw = int((lat_max - lat_min + 1).max())
    psi_banded = np.zeros(
        (kernel_size, nlat_out, bw, nlon_in), dtype=np.float32
    )
    banded_lat = lat_arr - lat_min[t_arr]
    np.add.at(
        psi_banded, (k_arr, t_arr, banded_lat, lon_arr),
        val_arr.astype(np.float32),
    )
    gather_idx = np.clip(
        lat_min[:, None] + np.arange(bw)[None, :], 0, nlat_in - 1
    ).astype(np.int32)
    return psi_banded, gather_idx


class DiscoConvS2(nn.Module):
    """The DISCO contraction (the fixed-geometry part, no learned weights;
    port of ace_tpu/ops/disco.py:351).

    Channels-last: ``x [..., nlat_in, nlon_in, C] -> [..., nlat_out,
    nlon_out, K, C]`` float32. The buffers (not saved with the weights)
    are the DFT matrices, the conjugated psi FFT ``[K, T, W, M]`` as its
    real and imaginary parts, and the gather index ``[T, W]``.
    """

    def __init__(self, in_shape, out_shape, kernel_shape,
                 grid_in="equiangular", grid_out="equiangular",
                 theta_cutoff=None, basis_norm_mode="mean",
                 basis_type="piecewise linear", device=None):
        super().__init__()
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)
        psi_banded, gather_idx = precompute_disco_psi(
            in_shape, out_shape, kernel_shape,
            grid_in=grid_in, grid_out=grid_out,
            theta_cutoff=theta_cutoff, basis_norm_mode=basis_norm_mode,
            basis_type=basis_type,
        )
        self.kernel_size = psi_banded.shape[0]
        nlon = in_shape[1]
        mmax = nlon // 2 + 1
        fc, fs, ic, is_ = (torch.as_tensor(m, dtype=torch.float32)
                           for m in _dft_matrices(nlon, mmax))
        # fold the SHT's (2 pi / nlon) forward scaling back out: DISCO
        # uses plain rfft/irfft (factor 1 forward, 1/n inverse)
        scale = nlon / (2 * math.pi)
        fc, fs = fc * scale, fs * scale
        ic, is_ = ic / nlon, is_ / nlon
        # psi FFT (conjugated), made once on the host in float32
        psi = torch.from_numpy(psi_banded)
        psi_r = torch.einsum("ktwj,jm->ktwm", psi, fc)
        psi_i = -torch.einsum("ktwj,jm->ktwm", psi, fs)
        for name, value in (("fc", fc), ("fs", fs), ("ic", ic), ("is_", is_),
                            ("psi_r", psi_r), ("psi_i", psi_i),
                            ("gather", torch.from_numpy(
                                gather_idx.astype(np.int64)))):
            self.register_buffer(name, value.to(device), persistent=False)

    def _gathered(self, x):
        """The forward DFT over lon and the band rows per output lat:
        ``(xr_g, xi_g)``, each ``[..., T, W, m, C]`` float32."""
        x = x.float()
        xr = torch.einsum("...kjc,jm->...kmc", x, self.fc)
        xi = torch.einsum("...kjc,jm->...kmc", x, self.fs)
        return xr[..., self.gather, :, :], xi[..., self.gather, :, :]

    def _correlated(self, a, b, sign):
        """The cross-correlation ``sum_w psi_r a + sign psi_i b``,
        ``[..., T, m, K, C]``: the real part of ``Y = sum_w psi_conj * X``
        from ``(xr_g, xi_g, -1)``, its imaginary part from ``(xi_g, xr_g,
        1)``. Autograd keeps no einsum's output, so the sum may accumulate
        in place."""
        y = torch.einsum("ktwm,...twmc->...tmkc", self.psi_r, a)
        return y.add_(torch.einsum("ktwm,...twmc->...tmkc", self.psi_i, b),
                      alpha=sign)

    def _inverse(self, parts):
        """The inverse DFT over m of ``parts = [real, imag]``, each
        ``[..., T, m, X]``, at the output longitudes only: ``[..., T,
        lon_out, X]``. Each part is dropped from ``parts`` once used."""
        pscale = self.in_shape[1] // self.out_shape[1]
        out = torch.einsum("...tmx,mj->...tjx", parts.pop(0),
                           self.ic[:, ::pscale])
        return out.add_(torch.einsum("...tmx,mj->...tjx", parts.pop(0),
                                     self.is_[:, ::pscale]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # each intermediate is dropped once used: at the recipe's
        # atmosphere decoder (32 folded samples at 180x360, 128 channels)
        # they are 0.5-9.6 GB each
        xr_g, xi_g = self._gathered(x)
        parts = [self._correlated(xr_g, xi_g, -1).flatten(-2),
                 self._correlated(xi_g, xr_g, 1).flatten(-2)]
        del xr_g, xi_g
        # [..., T, lon_out, K, C]
        return self._inverse(parts).unflatten(-1, (self.kernel_size, -1))

    def mixed(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        """``einsum("...jkc,kco->...jo", self(x), weight)`` float32, with
        the weight ``[K, C, O]`` applied before the inverse DFT (both are
        linear): one ``[K C, O]`` matmul per mode, and the inverse DFT
        over O channels rather than K x C."""
        k, c, o = weight.shape
        w = weight.reshape(k * c, o)
        xr_g, xi_g = self._gathered(x)
        # [..., T, m, K, C] -> [..., T, m, O], one part alive at a time
        parts = [self._correlated(xr_g, xi_g, -1).flatten(-2) @ w,
                 self._correlated(xi_g, xr_g, 1).flatten(-2) @ w]
        del xr_g, xi_g
        return self._inverse(parts)
