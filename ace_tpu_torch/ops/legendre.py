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


def precompute_dlegpoly(
    mmax: int,
    lmax: int,
    theta: np.ndarray,
    csphase: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Vector-harmonic Legendre tensors at colatitudes ``theta``:

    - ``dP[m, l, k]`` = dP̂_l^m/dθ, obtained by differentiating the same
      three-term recurrences used for P̂ (exact, pole-safe).
    - ``Q[m, l, k]`` = m P̂_l^m / sinθ, recurred directly in Q-form so no
      division by sinθ occurs (finite at the poles for every m; zero for
      m = 0). Both use the orthonormal ("ortho") normalization.

    These are the θ- and φ-direction factors of the vector spherical
    harmonics ∇Y_lm = (dP̂/dθ, i m P̂/sinθ)·e^{imφ} used by the vector SHT
    (the torch-harmonics CUDA path precomputes the same quantities in
    torch_harmonics._precompute_dlegpoly).
    """
    nmax = max(mmax, lmax)
    theta = np.asarray(theta, dtype=np.float64)
    c = np.cos(theta)
    s = np.sin(theta)
    n_pts = len(theta)

    p = np.zeros((nmax, nmax, n_pts))
    dp = np.zeros((nmax, nmax, n_pts))
    q = np.zeros((nmax, nmax, n_pts))

    p[0, 0] = 1.0 / np.sqrt(4 * np.pi)
    # diagonal (m = l) and first off-diagonal (l = m + 1); q recurs the
    # ratio m·P/sinθ with the identical coefficients (division by sinθ
    # commutes with the l-recurrence at fixed m)
    for l in range(1, nmax):
        f_diag = np.sqrt((2 * l + 1) / (2 * l))
        f_off = np.sqrt(2 * l + 1)
        p[l, l] = f_diag * s * p[l - 1, l - 1]
        dp[l, l] = f_diag * (c * p[l - 1, l - 1] + s * dp[l - 1, l - 1])
        if l == 1:
            q[1, 1] = f_diag * p[0, 0] * np.ones(n_pts)
        else:
            # Q_l^l = l/(l-1) · f_diag · sinθ · Q_{l-1}^{l-1}
            q[l, l] = (l / (l - 1)) * f_diag * s * q[l - 1, l - 1]
        p[l - 1, l] = f_off * c * p[l - 1, l - 1]
        dp[l - 1, l] = f_off * (c * dp[l - 1, l - 1] - s * p[l - 1, l - 1])
        q[l - 1, l] = f_off * c * q[l - 1, l - 1]

    for l in range(2, nmax):
        for m in range(0, l - 1):
            a = np.sqrt((4 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(
                ((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0)
            )
            p[m, l] = a * (c * p[m, l - 1] - b * p[m, l - 2])
            dp[m, l] = a * (
                c * dp[m, l - 1] - s * p[m, l - 1] - b * dp[m, l - 2]
            )
            q[m, l] = a * (c * q[m, l - 1] - b * q[m, l - 2])

    dp = dp[:mmax, :lmax].copy()
    q = q[:mmax, :lmax].copy()
    if csphase:
        for m in range(1, mmax, 2):
            dp[m] *= -1
            q[m] *= -1
    return dp, q
