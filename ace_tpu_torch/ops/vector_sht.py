"""Vector spherical harmonic transforms (spheroidal/toroidal), channels-
first (port of ace_tpu/ops/vector_sht.py): the longitudinal DFT as a
matmul, then Legendre contractions against the tables of dP/dθ and
mP/sinθ (``ops/legendre.py:precompute_dlegpoly``), as the scalar
transforms of ``ops/sht.py`` do. They compute in float32 (full float32
on the card with TF32 off); the winds' functions compute float64 fields
in float64.

A tangent field F = (F_θ, F_φ) decomposes as

    F = Σ_lm [ S_lm ∇Y_lm + T_lm (r̂ × ∇Y_lm) ]

with ∇Y_lm = (dP̂/dθ, imP̂/sinθ)e^{imφ}. The analysis returns the
potential coefficients (S the velocity potential χ_lm, T the
streamfunction ψ_lm, in the scalar SHT's basis): the projection is
divided by l(l+1), so divergence and vorticity follow by scaling with
-l(l+1) and a scalar inverse SHT. Colatitude ascends (north pole at index
0); fields are stacked (θ, φ) on axis -3, and u = F_φ, v = -F_θ.
"""

import numpy as np
import torch
from torch import nn

from ace_tpu_torch.ops.legendre import precompute_dlegpoly
from ace_tpu_torch.ops.sht import (
    InverseRealSHT,
    RealSHT,
    _dft_matrices,
    _f32,
    quadrature_for_grid,
)

_DFT = "...kj,jm->...km"
_LEG = "...km,mlk->...lm"
_ILEG = "...lm,mlk->...km"
_IDFT = "...km,mj->...kj"


class RealVectorSHT(nn.Module):
    """Forward vector SHT: ``[..., 2, nlat, nlon]`` (θ, φ components) ->
    ``[..., 2, lmax, mmax]`` complex (spheroidal, toroidal potentials)."""

    def __init__(self, nlat, nlon, lmax=None, mmax=None,
                 grid="legendre-gauss", csphase=True, device=None):
        super().__init__()
        self.nlat, self.nlon, self.grid = nlat, nlon, grid
        cost, w, default_lmax = quadrature_for_grid(grid, nlat)
        self.lmax = lmax or default_lmax
        self.mmax = mmax or nlon // 2 + 1
        dp, q = precompute_dlegpoly(self.mmax, self.lmax,
                                    np.flip(np.arccos(cost)), csphase=csphase)
        ell = np.arange(self.lmax)
        inv_ll1 = np.zeros(self.lmax)
        inv_ll1[1:] = 1.0 / (ell[1:] * (ell[1:] + 1.0))
        # the quadrature weight and the 1/(l(l+1)) potential normalization
        # folded into the Legendre tables
        scale = w[None, None, :] * inv_ll1[None, :, None]
        fc, fs, _, _ = _dft_matrices(nlon, self.mmax)
        for name, table in (("wdp", dp * scale), ("wq", q * scale),
                            ("fc", fc), ("fs", fs)):
            self.register_buffer(name, _f32(table, device), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.wdp.dtype)
        x_th, x_ph = x[..., 0, :, :], x[..., 1, :, :]
        tr = torch.einsum(_DFT, x_th, self.fc)
        ti = torch.einsum(_DFT, x_th, self.fs)
        pr = torch.einsum(_DFT, x_ph, self.fc)
        pi = torch.einsum(_DFT, x_ph, self.fs)
        # S = [<F_θ, dP> - i m <F_φ, P/sinθ>] / (l(l+1))
        # T = [i m <F_θ, P/sinθ> + <F_φ, dP>] / (l(l+1))
        # (m is folded into wq = m P̂ w / sinθ / (l(l+1)))
        s_r = (torch.einsum(_LEG, tr, self.wdp)
               + torch.einsum(_LEG, pi, self.wq))
        s_i = (torch.einsum(_LEG, ti, self.wdp)
               - torch.einsum(_LEG, pr, self.wq))
        t_r = (torch.einsum(_LEG, pr, self.wdp)
               - torch.einsum(_LEG, ti, self.wq))
        t_i = (torch.einsum(_LEG, pi, self.wdp)
               + torch.einsum(_LEG, tr, self.wq))
        return torch.complex(torch.stack([s_r, t_r], dim=-3),
                             torch.stack([s_i, t_i], dim=-3))


class InverseRealVectorSHT(nn.Module):
    """Inverse vector SHT: ``[..., 2, lmax, mmax]`` complex potentials
    (spheroidal, toroidal) -> ``[..., 2, nlat, nlon]`` (θ, φ)."""

    def __init__(self, nlat, nlon, lmax=None, mmax=None,
                 grid="legendre-gauss", csphase=True, device=None):
        super().__init__()
        self.nlat, self.nlon, self.grid = nlat, nlon, grid
        cost, _, default_lmax = quadrature_for_grid(grid, nlat)
        self.lmax = lmax or default_lmax
        self.mmax = mmax or nlon // 2 + 1
        dp, q = precompute_dlegpoly(self.mmax, self.lmax,
                                    np.flip(np.arccos(cost)), csphase=csphase)
        _, _, ic, is_ = _dft_matrices(nlon, self.mmax)
        for name, table in (("dp", dp), ("q", q), ("ic", ic), ("is_", is_)):
            self.register_buffer(name, _f32(table, device), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dp.dtype
        s_r, t_r = x.real[..., 0, :, :].to(dt), x.real[..., 1, :, :].to(dt)
        s_i, t_i = x.imag[..., 0, :, :].to(dt), x.imag[..., 1, :, :].to(dt)
        # F_θ_m = S dP/dθ - i T (mP/sinθ); F_φ_m = i S (mP/sinθ) + T dP/dθ
        th_r = (torch.einsum(_ILEG, s_r, self.dp)
                + torch.einsum(_ILEG, t_i, self.q))
        th_i = (torch.einsum(_ILEG, s_i, self.dp)
                - torch.einsum(_ILEG, t_r, self.q))
        ph_r = (torch.einsum(_ILEG, t_r, self.dp)
                - torch.einsum(_ILEG, s_i, self.q))
        ph_i = (torch.einsum(_ILEG, t_i, self.dp)
                + torch.einsum(_ILEG, s_r, self.q))
        f_th = (torch.einsum(_IDFT, th_r, self.ic)
                + torch.einsum(_IDFT, th_i, self.is_))
        f_ph = (torch.einsum(_IDFT, ph_r, self.ic)
                + torch.einsum(_IDFT, ph_i, self.is_))
        return torch.stack([f_th, f_ph], dim=-3)


def _dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def u_v_to_vort_div(u: torch.Tensor, v: torch.Tensor,
                    grid: str = "legendre-gauss"):
    """Relative vorticity and divergence of an (eastward, northward) wind
    field ``[..., nlat, nlon]`` on the unit sphere, latitudes north to
    south; on ``u``'s device."""
    nlat, nlon = u.shape[-2], u.shape[-1]
    dtype = _dtype(u)
    vsht = RealVectorSHT(nlat, nlon, grid=grid).to(u.device, dtype)
    isht = InverseRealSHT(nlat, nlon, grid=grid, channels_last=False
                          ).to(u.device, dtype)
    # θ̂ points south: F_θ = -v, F_φ = u
    st = vsht(torch.stack([-v, u], dim=-3))
    ell = torch.arange(vsht.lmax, dtype=dtype, device=u.device)
    lap = (-ell * (ell + 1.0))[:, None]
    div = isht(st[..., 0, :, :] * lap)
    vort = isht(st[..., 1, :, :] * lap)
    return vort, div


def vort_div_to_u_v(vort: torch.Tensor, div: torch.Tensor,
                    grid: str = "legendre-gauss"):
    """The rotational and divergent wind of a vorticity and divergence
    (the inverse of ``u_v_to_vort_div`` up to the zonal-mean solid-body
    null space)."""
    nlat, nlon = vort.shape[-2], vort.shape[-1]
    dtype = _dtype(vort)
    sht = RealSHT(nlat, nlon, grid=grid, channels_last=False
                  ).to(vort.device, dtype)
    ivsht = InverseRealVectorSHT(nlat, nlon, grid=grid).to(vort.device, dtype)
    ell = torch.arange(sht.lmax, dtype=dtype, device=vort.device)
    inv_lap = torch.where(ell > 0, -1.0 / (ell * (ell + 1.0) + 1e-30),
                          0.0)[:, None]
    chi = sht(div) * inv_lap  # velocity potential
    psi = sht(vort) * inv_lap  # streamfunction
    f = ivsht(torch.stack([chi, psi], dim=-3))
    return f[..., 1, :, :], -f[..., 0, :, :]
