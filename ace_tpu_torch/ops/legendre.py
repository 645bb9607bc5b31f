"""Normalized associated Legendre polynomial precompute (host-side numpy).

Computes P̂_l^m(x) = N_l^m P_l^m(x) with the orthonormal spherical-harmonic
normalization N_l^m = sqrt((2l+1)/(4π) (l-m)!/(l+m)!), optionally with the
Condon-Shortley phase (-1)^m, using the stable three-term recurrences
(Schaeffer 2013). This matches the convention the reference consumes from
torch_harmonics._precompute_legpoly (reference: fme/sht_fix.py:110,196).

Recurrences (P̂ below is the orthonormal ALP without csphase):
    P̂_0^0       = 1 / sqrt(4π)
    P̂_m^m       = sqrt((2m+1)/(2m)) sinθ P̂_{m-1}^{m-1}
    P̂_{m+1}^m   = sqrt(2m+3) x P̂_m^m
    P̂_l^m       = a_l^m x P̂_{l-1}^m - a_l^m b_l^m P̂_{l-2}^m
        a_l^m = sqrt((4l²-1)/(l²-m²))
        b_l^m = sqrt(((l-1)²-m²)/(4(l-1)²-1))
"""

import numpy as np


def legpoly(
    mmax: int,
    lmax: int,
    x: np.ndarray,
    norm: str = "ortho",
    inverse: bool = False,
    csphase: bool = True,
) -> np.ndarray:
    """Compute normalized ALPs at points ``x`` in [-1, 1].

    Returns:
        array of shape (mmax, lmax, len(x)); entries with m > l are zero.
    """
    nmax = max(mmax, lmax)
    x = np.asarray(x, dtype=np.float64)
    vdm = np.zeros((nmax, nmax, len(x)), dtype=np.float64)

    # "ortho" uses orthonormal polys both ways; "4pi"/"schmidt" rescale
    norm_factor = 1.0 if norm == "ortho" else np.sqrt(4 * np.pi)
    norm_factor = 1.0 / norm_factor if inverse else norm_factor

    vdm[0, 0, :] = norm_factor / np.sqrt(4 * np.pi)

    sint = np.sqrt((1.0 - x) * (1.0 + x))
    # diagonal and first off-diagonal
    for l in range(1, nmax):
        vdm[l - 1, l, :] = np.sqrt(2 * l + 1) * x * vdm[l - 1, l - 1, :]
        vdm[l, l, :] = np.sqrt((2 * l + 1) / (2 * l)) * sint * vdm[l - 1, l - 1, :]

    # remaining upper triangle
    for l in range(2, nmax):
        for m in range(0, l - 1):
            a = np.sqrt((4 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            vdm[m, l, :] = a * (x * vdm[m, l - 1, :] - b * vdm[m, l - 2, :])

    if norm == "schmidt":
        for l in range(0, nmax):
            if inverse:
                vdm[:, l, :] = vdm[:, l, :] * np.sqrt(2 * l + 1)
            else:
                vdm[:, l, :] = vdm[:, l, :] / np.sqrt(2 * l + 1)

    vdm = vdm[:mmax, :lmax]

    if csphase:
        for m in range(1, mmax, 2):
            vdm[m] *= -1

    return vdm


def precompute_legpoly(
    mmax: int,
    lmax: int,
    theta: np.ndarray,
    norm: str = "ortho",
    inverse: bool = False,
    csphase: bool = True,
) -> np.ndarray:
    """ALPs evaluated at colatitudes ``theta`` (radians); shape (mmax, lmax, K)."""
    return legpoly(mmax, lmax, np.cos(theta), norm=norm, inverse=inverse,
                   csphase=csphase)
