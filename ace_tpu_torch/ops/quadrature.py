"""Quadrature nodes/weights on [-1, 1] for spherical transforms.

Host-side (numpy, float64) precompute used to build SHT weight tensors
(reference behavior: fme/sht_fix.py:92-104 via torch_harmonics.quadrature).

All functions return ``(cost, w)`` with ``cost`` (= cos(colatitude)) in
ascending order and weights such that ``sum(f(cost) * w) ≈ ∫_{-1}^{1} f``.
"""

import numpy as np


def legendre_gauss_weights(n: int, a: float = -1.0, b: float = 1.0):
    """Gauss-Legendre nodes and weights on [a, b]."""
    x, w = np.polynomial.legendre.leggauss(n)
    x = (b - a) * 0.5 * x + (b + a) * 0.5
    w = w * (b - a) * 0.5
    return x, w


def lobatto_weights(n: int, a: float = -1.0, b: float = 1.0,
                    tol: float = 1e-16, maxiter: int = 100):
    """Gauss-Lobatto nodes (endpoints included) and weights on [a, b].

    Nodes are the endpoints plus the roots of P'_{n-1}; found by Newton
    iteration on the Legendre Vandermonde recurrence. Weights are
    ``2 / (n (n-1) P_{n-1}(x)^2)``.
    """
    if n < 2:
        raise ValueError("lobatto quadrature needs n >= 2")
    x = np.cos(np.pi * np.arange(n) / (n - 1))  # descending initial guess
    vdm = np.zeros((n, n))
    for _ in range(maxiter):
        x_old = x.copy()
        vdm[:, 0] = 1.0
        vdm[:, 1] = x
        for k in range(2, n):
            vdm[:, k] = ((2 * k - 1) * x * vdm[:, k - 1]
                         - (k - 1) * vdm[:, k - 2]) / k
        x = x_old - (x * vdm[:, n - 1] - vdm[:, n - 2]) / (n * vdm[:, n - 1])
        if np.max(np.abs(x - x_old)) < tol:
            break
    w = 2.0 / (n * (n - 1) * vdm[:, n - 1] ** 2)
    order = np.argsort(x)
    x, w = x[order], w[order]
    x = (b - a) * 0.5 * x + (b + a) * 0.5
    w = w * (b - a) * 0.5
    return x, w


def clenshaw_curtiss_weights(n: int, a: float = -1.0, b: float = 1.0):
    """Clenshaw-Curtis nodes ``cos(kπ/(n-1))`` (endpoints included) and
    weights, for the "equiangular" grid.

    Uses the classic closed form (Trefethen, Spectral Methods in MATLAB,
    clencurt): for N = n-1 intervals and nodes θ_k = kπ/N,

        w_k = (c_k / N) (1 - Σ_{j=1}^{⌊N/2⌋} b_j cos(2 j θ_k) / (4j² - 1))

    with c_k = 1 at the endpoints else 2, and b_j = 1 if j = N/2 else 2.
    """
    if n < 2:
        raise ValueError("clenshaw-curtis quadrature needs n >= 2")
    N = n - 1
    theta = np.pi * np.arange(n) / N
    w = np.zeros(n)
    jmax = N // 2
    j = np.arange(1, jmax + 1)
    bj = np.where(j == N / 2, 1.0, 2.0)
    # sum over j for all k at once: [n, jmax]
    s = np.cos(2.0 * np.outer(theta, j)) @ (bj / (4.0 * j**2 - 1.0))
    c = np.full(n, 2.0)
    c[0] = c[-1] = 1.0
    w = (c / N) * (1.0 - s)
    x = np.cos(theta)  # descending
    order = np.argsort(x)
    x, w = x[order], w[order]
    x = (b - a) * 0.5 * x + (b + a) * 0.5
    w = w * (b - a) * 0.5
    return x, w
