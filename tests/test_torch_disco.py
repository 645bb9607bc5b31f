"""The port's DISCO convolution and sphere resampler against ace_tpu's:
the filter basis functions, ``_colatitudes`` and ``precompute_disco_psi``
(numpy copies of the same code: exactly equal) over the four basis
types, kernel shapes 3x3 and 2x2, both grids, 16x32 -> 8x16 and
same-grid; ``DiscoConvS2`` within 1e-5 of the largest output (float32 on
both sides); ``ResampleS2`` within 1e-6; ``compute_cutoff_radius`` and
``build_disco`` equal."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.models import localnet as jax_localnet
from ace_tpu.ops import disco as jax_disco
from ace_tpu.ops import distributed_disco as jax_distributed_disco
from ace_tpu.ops import resample as jax_resample
from ace_tpu_torch.models import localnet
from ace_tpu_torch.ops import disco, distributed_disco, resample

torch.set_num_threads(2)

BASES = ["piecewise linear", "morlet", "isotropic morlet", "zernike"]
GRIDS = ["equiangular", "legendre-gauss"]
SHAPES = [((16, 32), (8, 16)), ((16, 32), (16, 32))]
DISCO_TOL = 1e-5


def _draw(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _disk(n=9, seed=0):
    """(r, phi) over a grid of the disk and past its edge, and a cutoff."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.0, 0.6, (n, n))
    phi = rng.uniform(0.0, 2 * math.pi, (n, n))
    return r, phi, 0.4


@pytest.mark.parametrize("basis", BASES)
@pytest.mark.parametrize("kernel_shape", [(3, 3), (2, 2), (4, 1), (3, 1)])
def test_basis_functions_equal_ace_tpu(basis, kernel_shape):
    """``evaluate_basis`` (each basis' support: indices and values) and
    ``basis_kernel_size`` equal ace_tpu's bit for bit, and so do the
    helpers they rest on."""
    r, phi, cutoff = _disk()
    got = disco.evaluate_basis(kernel_shape, r, phi, cutoff, basis)
    ref = jax_disco.evaluate_basis(kernel_shape, r, phi, cutoff, basis)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g, w)
    assert disco.basis_kernel_size(kernel_shape, basis) == (
        jax_disco.basis_kernel_size(kernel_shape, basis))
    assert disco.pl_kernel_size(kernel_shape) == (
        jax_disco.pl_kernel_size(kernel_shape))
    np.testing.assert_array_equal(disco._circle_dist(r, phi),
                                  jax_disco._circle_dist(r, phi))
    for n in range(4):
        for m in range(n % 2, n + 1, 2):
            np.testing.assert_array_equal(disco._zernike_radial(r, n, m),
                                          jax_disco._zernike_radial(r, n, m))


@pytest.mark.parametrize("grid", GRIDS + ["lobatto"])
@pytest.mark.parametrize("nlat", [8, 17])
def test_colatitudes_equal_ace_tpu(grid, nlat):
    for got, ref in zip(disco._colatitudes(nlat, grid),
                        jax_disco._colatitudes(nlat, grid)):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(resample.grid_colatitudes(nlat, grid),
                                  jax_resample.grid_colatitudes(nlat, grid))


@pytest.mark.parametrize("basis", BASES)
@pytest.mark.parametrize("kernel_shape", [(3, 3), (2, 2)])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("shapes", SHAPES, ids=["16x32-8x16", "16x32"])
def test_psi_equals_ace_tpu(basis, kernel_shape, grid, shapes):
    """The banded psi and its gather index, bit for bit."""
    in_shape, out_shape = shapes
    kw = dict(grid_in=grid, grid_out=grid, basis_type=basis)
    got = disco.precompute_disco_psi(in_shape, out_shape, kernel_shape, **kw)
    ref = jax_disco.precompute_disco_psi(in_shape, out_shape, kernel_shape,
                                         **kw)
    for g, w in zip(got, ref):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["individual", "none"])
def test_psi_norm_modes_equal_ace_tpu(mode):
    kw = dict(grid_in="equiangular", grid_out="legendre-gauss",
              basis_norm_mode=mode, theta_cutoff=0.5)
    for g, w in zip(disco.precompute_disco_psi((16, 32), (8, 16), (3, 3),
                                               **kw),
                    jax_disco.precompute_disco_psi((16, 32), (8, 16), (3, 3),
                                                   **kw)):
        np.testing.assert_array_equal(g, w)


def _assert_disco_close(conv, jconv, x):
    got = conv(torch.from_numpy(x)).numpy()
    ref = np.asarray(jconv(jnp.asarray(x)))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= DISCO_TOL * np.abs(ref).max()


@pytest.mark.parametrize("basis", BASES)
@pytest.mark.parametrize("grid_in, grid_out", [
    ("equiangular", "equiangular"), ("legendre-gauss", "legendre-gauss"),
    ("equiangular", "legendre-gauss")])
@pytest.mark.parametrize("shapes", SHAPES + [((17, 32), (17, 32))],
                         ids=["16x32-8x16", "16x32", "17x32"])
def test_disco_conv_matches_ace_tpu(basis, grid_in, grid_out, shapes):
    """``[B, H, W, C] -> [B, T, lon_out, K, C]`` within 1e-5 of the
    largest output, downsampling and on the same grid, an odd ``nlat``
    too."""
    in_shape, out_shape = shapes
    kw = dict(grid_in=grid_in, grid_out=grid_out, basis_type=basis)
    conv = disco.DiscoConvS2(in_shape, out_shape, (3, 3), **kw)
    jconv = jax_disco.DiscoConvS2(in_shape, out_shape, (3, 3), **kw)
    assert conv.kernel_size == jconv.kernel_size
    assert not conv.state_dict()  # the geometry is rebuilt, never saved
    _assert_disco_close(conv, jconv, _draw((2, *in_shape, 5)))


def test_disco_conv_takes_leading_axes():
    """Any number of leading axes, as ace_tpu's ``...``: none and two."""
    conv = disco.DiscoConvS2((16, 32), (8, 16), (2, 2))
    jconv = jax_disco.DiscoConvS2((16, 32), (8, 16), (2, 2))
    for shape in ((16, 32, 3), (2, 3, 16, 32, 3)):
        _assert_disco_close(conv, jconv, _draw(shape, seed=1))


@pytest.mark.parametrize("grid_in, grid_out", [
    ("legendre-gauss", "legendre-gauss"), ("legendre-gauss", "equiangular"),
    ("equiangular", "legendre-gauss")])
@pytest.mark.parametrize("shapes", [((8, 16), (16, 32)), ((16, 32), (8, 16)),
                                    ((5, 9), (11, 20))],
                         ids=["up", "down", "odd"])
def test_resample_matches_ace_tpu(grid_in, grid_out, shapes):
    """Bilinear regridding within 1e-6 of the largest output."""
    (hi, wi), (ho, wo) = shapes
    x = _draw((2, hi, wi, 3), seed=2)
    got = resample.ResampleS2(hi, wi, ho, wo, grid_in, grid_out)(
        torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_resample.ResampleS2(hi, wi, ho, wo, grid_in,
                                             grid_out)(jnp.asarray(x)))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    for a, b in zip(resample._lat_interp_weights(
            resample.grid_colatitudes(hi, grid_in),
            resample.grid_colatitudes(ho, grid_out)),
            jax_resample._lat_interp_weights(
                jax_resample.grid_colatitudes(hi, grid_in),
                jax_resample.grid_colatitudes(ho, grid_out))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("basis", BASES)
@pytest.mark.parametrize("nlat", [16, 45, 180])
def test_cutoff_radius_equals_ace_tpu(basis, nlat):
    for kernel_shape in ((3, 3), (2, 2), (5, 5)):
        assert localnet.compute_cutoff_radius(nlat, kernel_shape, basis) == (
            jax_localnet.compute_cutoff_radius(nlat, kernel_shape, basis))


def test_build_disco_equals_ace_tpu():
    """The single-device branch: a ``DiscoConvS2`` of the same geometry."""
    kw = dict(grid_in="equiangular", grid_out="legendre-gauss",
              theta_cutoff=0.3, basis_type="morlet")
    conv = distributed_disco.build_disco((16, 32), (8, 16), (3, 3), **kw)
    jconv = jax_distributed_disco.build_disco((16, 32), (8, 16), (3, 3),
                                              **kw)
    assert isinstance(conv, disco.DiscoConvS2)
    assert conv.kernel_size == jconv.kernel_size
    np.testing.assert_array_equal(conv.gather.numpy(),
                                  np.asarray(jconv._gather))
    _assert_disco_close(conv, jconv, _draw((2, 16, 32, 4), seed=3))
