"""The port's quadrature/Legendre tables and SHT pair against ace_tpu's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.ops import legendre as jax_legendre
from ace_tpu.ops import quadrature as jax_quadrature
from ace_tpu.ops import sht as jax_sht
from ace_tpu_torch.ops import legendre, quadrature, sht

torch.set_num_threads(2)

GRIDS = ["legendre-gauss", "lobatto", "equiangular"]
NLAT, NLON, C = 16, 32, 6


@pytest.mark.parametrize("grid", GRIDS)
def test_tables_equal_ace_tpu_bit_for_bit(grid):
    cost, w, lmax = sht.quadrature_for_grid(grid, NLAT)
    cost_j, w_j, lmax_j = jax_sht.quadrature_for_grid(grid, NLAT)
    np.testing.assert_array_equal(cost, cost_j)
    np.testing.assert_array_equal(w, w_j)
    assert lmax == lmax_j
    theta = np.flip(np.arccos(cost))
    for inverse in (False, True):
        np.testing.assert_array_equal(
            legendre.precompute_legpoly(NLON // 2 + 1, lmax, theta,
                                        inverse=inverse),
            jax_legendre.precompute_legpoly(NLON // 2 + 1, lmax, theta,
                                            inverse=inverse),
        )
    # the transforms' float32 tables
    fwd = sht.RealSHT(NLAT, NLON, grid=grid, device="cpu")
    fwd_j = jax_sht.RealSHT(NLAT, NLON, grid=grid, channels_last=True)
    np.testing.assert_array_equal(fwd.weights.numpy(), np.asarray(fwd_j.weights))
    inv = sht.InverseRealSHT(NLAT, NLON, grid=grid, device="cpu")
    inv_j = jax_sht.InverseRealSHT(NLAT, NLON, grid=grid, channels_last=True)
    np.testing.assert_array_equal(inv.pct.numpy(), np.asarray(inv_j.pct))
    for name in ("legendre_gauss_weights", "clenshaw_curtiss_weights"):
        for a, b in zip(getattr(quadrature, name)(NLAT),
                        getattr(jax_quadrature, name)(NLAT)):
            np.testing.assert_array_equal(a, b)


def _rel_err(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("grid", ["legendre-gauss", "equiangular"])
def test_sht_pair_matches_ace_tpu(grid):
    """f32 forward, inverse and round trip; the only difference is the
    summation order of the contractions, so ~1e-5 relative."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, NLAT, NLON, C).astype(np.float32)
    fwd = sht.build_sht(NLAT, NLON, grid=grid, device="cpu")
    inv = sht.build_isht(NLAT, NLON, grid=grid, device="cpu")
    fwd_j = jax_sht.RealSHT(NLAT, NLON, grid=grid, channels_last=True)
    inv_j = jax_sht.InverseRealSHT(NLAT, NLON, grid=grid, channels_last=True)

    cr, ci = fwd.forward_pair(torch.from_numpy(x))
    cr_j, ci_j = fwd_j.forward_pair(jnp.asarray(x))
    assert cr.shape == (2, fwd.lmax, fwd.mmax, C) and cr.dtype == torch.float32
    assert _rel_err(cr.numpy(), np.asarray(cr_j)) < 1e-5
    assert _rel_err(ci.numpy(), np.asarray(ci_j)) < 1e-5

    coeff_r = rng.randn(2, inv.lmax, inv.mmax, C).astype(np.float32)
    coeff_i = rng.randn(2, inv.lmax, inv.mmax, C).astype(np.float32)
    y = inv.inverse_pair(torch.from_numpy(coeff_r), torch.from_numpy(coeff_i))
    y_j = inv_j.inverse_pair(jnp.asarray(coeff_r), jnp.asarray(coeff_i))
    assert _rel_err(y.numpy(), np.asarray(y_j)) < 1e-5

    round_trip = inv.inverse_pair(cr, ci)
    round_trip_j = inv_j.inverse_pair(cr_j, ci_j)
    assert _rel_err(round_trip.numpy(), np.asarray(round_trip_j)) < 1e-5


def test_sht_computes_in_float32_for_bf16_input():
    x = torch.randn(1, NLAT, NLON, C, generator=torch.Generator().manual_seed(0))
    fwd = sht.RealSHT(NLAT, NLON, device="cpu")
    cr, _ = fwd.forward_pair(x.to(torch.bfloat16))
    ref, _ = fwd.forward_pair(x.to(torch.bfloat16).float())
    assert cr.dtype == torch.float32
    torch.testing.assert_close(cr, ref, rtol=0, atol=0)
