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


def test_forward_fused_matches_ace_tpu():
    """The port's fused forward transform (its plain version on the CPU)
    against JAX's fused Pallas transform in the interpreter, at JAX's own
    test size and limit (tests/test_sht.py:189, atol 2e-3), and against
    the port's forward_pair, which computes the same einsums (exact)."""
    nlat, nlon, c = 36, 72, 64
    x = np.random.RandomState(0).randn(1, nlat, nlon, c).astype(np.float32)
    fwd_j = jax_sht.RealSHT(nlat, nlon, channels_last=True)
    out_j = np.asarray(fwd_j.forward_fused(
        jnp.asarray(x), l_tile=16, c_tile=32, k_tile=8, interpret=True
    ))
    fwd = sht.RealSHT(nlat, nlon, device="cpu")
    cr, ci = fwd.forward_fused(torch.from_numpy(x))
    assert cr.shape == (1, fwd.lmax, fwd.mmax, c) and cr.dtype == torch.float32
    np.testing.assert_allclose(cr.numpy(), out_j.real, rtol=0, atol=2e-3)
    np.testing.assert_allclose(ci.numpy(), out_j.imag, rtol=0, atol=2e-3)
    ref_r, ref_i = fwd.forward_pair(torch.from_numpy(x))
    torch.testing.assert_close(cr, ref_r, rtol=0, atol=0)
    torch.testing.assert_close(ci, ref_i, rtol=0, atol=0)
    # the plain version's table layout [k, l, m], a view of the weights;
    # the kernel's split tables, K-major and padded to 16-byte rows,
    # prepared once
    table = fwd.fused_table()
    assert table.shape == (nlat, fwd.lmax, fwd.mmax)
    assert table.data_ptr() == fwd.weights.data_ptr()
    d_hi, d_lo, leg_hi, leg_lo = fwd.kernel_tables()
    assert d_hi.shape == d_lo.shape == (2 * fwd.mmax, nlon)
    assert leg_hi.shape == leg_lo.shape == (fwd.mmax, fwd.lmax, nlat)
    torch.testing.assert_close(d_hi[0::2] + d_lo[0::2], fwd.fc.t())
    torch.testing.assert_close(d_hi[1::2] + d_lo[1::2], fwd.fs.t())
    torch.testing.assert_close(leg_hi + leg_lo, fwd.weights)
    assert fwd.kernel_tables()[0] is d_hi


def test_forward_fused_refuses_what_the_kernel_does_not_take():
    from ace_tpu_torch.ops.fused_sht import fused_sht

    fwd = sht.RealSHT(NLAT, NLON, device="cpu")
    with pytest.raises(ValueError, match="B, K, J, C"):
        fwd.forward_fused(torch.zeros(NLAT, NLON, C))
    x = torch.zeros(1, NLAT, NLON, C, requires_grad=True)
    with pytest.raises(NotImplementedError, match="requires grad"):
        fwd.forward_fused(x)
    meta = [t.to("meta") for t in (x.detach(), fwd.fc, fwd.fs,
                                   fwd.fused_table())]
    with pytest.raises(NotImplementedError, match="no kernel"):
        fused_sht(*meta)
    with pytest.raises(ValueError, match="leg shape"):
        fused_sht(x.detach(), fwd.fc, fwd.fs, fwd.weights)


# ragged and truncated grids: odd latitude counts, lmax and mmax cut below
# the grid's defaults, and the three quadratures
FUSED_CASES = [
    (16, 32, None, None, "legendre-gauss"),
    (9, 18, None, None, "equiangular"),
    (9, 18, None, None, "lobatto"),
    (12, 24, 7, 9, "legendre-gauss"),
    (13, 24, 11, 10, "equiangular"),
]


@pytest.mark.parametrize("nlat,nlon,lmax,mmax,grid", FUSED_CASES)
def test_forward_fused_matches_forward_pair_on_every_grid(nlat, nlon, lmax,
                                                          mmax, grid):
    """forward_fused on the CPU against the port's forward_pair and JAX's
    dense forward transform. The plain version runs forward_pair's einsums
    on the re-laid table, which may change the CPU's summation order: 1e-6
    of the largest output (f32 sums of at most 32 terms). Against JAX,
    1e-5 relative, as test_sht_pair_matches_ace_tpu."""
    x = np.random.RandomState(1).randn(2, nlat, nlon, 3).astype(np.float32)
    kw = dict(lmax=lmax, mmax=mmax, grid=grid)
    fwd = sht.RealSHT(nlat, nlon, device="cpu", **kw)
    fwd_j = jax_sht.RealSHT(nlat, nlon, channels_last=True, **kw)
    cr, ci = fwd.forward_fused(torch.from_numpy(x))
    ref_r, ref_i = fwd.forward_pair(torch.from_numpy(x))
    assert _rel_err(cr.numpy(), ref_r.numpy()) < 1e-6
    assert _rel_err(ci.numpy(), ref_i.numpy()) < 1e-6
    cr_j, ci_j = fwd_j.forward_pair(jnp.asarray(x))
    assert cr.shape == (2, fwd.lmax, fwd.mmax, 3)
    assert _rel_err(cr.numpy(), np.asarray(cr_j)) < 1e-5
    assert _rel_err(ci.numpy(), np.asarray(ci_j)) < 1e-5


# the kernel's host-side split (ops/fused_sht.py:split_tf32) and the
# arithmetic of its split-TF32 products, emulated on the CPU


def _low_bits(t):
    return int((t.view(torch.int32) & 0x1FFF).abs().max())


@pytest.mark.parametrize("grid", GRIDS)
def test_split_tf32_tables_keep_22_bits(grid):
    """hi and lo are exact TF32 values (low 13 bits zero), and hi + lo
    gives back every entry of the f32 DFT and Legendre tables within
    2^-21 of its magnitude; hi alone is only TF32's 2^-11."""
    from ace_tpu_torch.ops.fused_sht import split_tf32

    fwd = sht.RealSHT(NLAT, NLON, grid=grid, device="cpu")
    for t in (fwd.fc, fwd.fs, fwd.weights):
        hi, lo = split_tf32(t)
        assert _low_bits(hi) == 0 and _low_bits(lo) == 0
        err = (hi.double() + lo.double() - t.double()).abs()
        assert bool((err <= 2.0 ** -21 * t.double().abs()).all())
        assert float((hi - t).abs().max()) > 2.0 ** -21 * float(t.abs().max())


def test_split_tf32_rounds_to_nearest_ties_away():
    """The host split rounds as the kernel's cvt.rna.tf32.f32: to nearest,
    ties away from zero, never truncating."""
    from ace_tpu_torch.ops.fused_sht import split_tf32

    ulp = 2.0 ** -10  # TF32's ulp at 1
    v = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp * 0.49,
                      1 + ulp * 0.51, 1 + 1.5 * ulp], dtype=torch.float32)
    hi, lo = split_tf32(v)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 1 + 2 * ulp])
    torch.testing.assert_close(hi, want, rtol=0, atol=0)
    torch.testing.assert_close(hi + lo, v, rtol=0, atol=0)
    with pytest.raises(TypeError):
        split_tf32(v.double())


def _split_product(a, b, equation):
    """lo*hi + hi*lo + hi*hi in f32, both operands split as the kernel
    splits them (the same three products, without the tensor cores)."""
    from ace_tpu_torch.ops.fused_sht import split_tf32

    a_hi, a_lo = split_tf32(a.contiguous())
    b_hi, b_lo = split_tf32(b.contiguous())
    return (torch.einsum(equation, a_lo, b_hi)
            + torch.einsum(equation, a_hi, b_lo)
            + torch.einsum(equation, a_hi, b_hi))


@pytest.mark.parametrize("grid", GRIDS)
def test_split_tf32_transform_is_f32_accurate(grid):
    """The kernel's arithmetic, emulated: the DFT and the Legendre
    contraction each as three split products in f32, on a 16 x 32 grid
    with C = 8, against a float64 evaluation from the float64 tables. The
    plain f32 version is ~2e-7 of the largest output off; the emulation
    must stay within 1e-6 (single-pass TF32 is ~5e-4 off)."""
    from ace_tpu_torch.ops.fused_sht import fused_sht_plain

    fwd = sht.RealSHT(NLAT, NLON, grid=grid, device="cpu")
    x = torch.from_numpy(
        np.random.RandomState(2).randn(2, NLAT, NLON, 8).astype(np.float32))
    fc, fs, w = (torch.from_numpy(t) for t in fwd.tables_float64())
    ref = [torch.einsum("bkmc,mlk->blmc",
                        torch.einsum("bkjc,jm->bkmc", x.double(), d), w)
           for d in (fc, fs)]
    emulated = [_split_product(_split_product(x, d, "bkjc,jm->bkmc"),
                               fwd.weights, "bkmc,mlk->blmc")
                for d in (fwd.fc, fwd.fs)]
    plain = fused_sht_plain(x, fwd.fc, fwd.fs, fwd.fused_table())
    scale = max(float(r.abs().max()) for r in ref)

    def err(out):
        return max(float((o.double() - r).abs().max())
                   for o, r in zip(out, ref)) / scale

    assert err(plain) < 1e-6
    assert err(emulated) < 1e-6


@pytest.mark.parametrize("name", ["nostore", "nomma", "onemma",
                                  "nostore+nomma"])
def test_profile_variants_apply_to_the_kernel_source(name):
    """Each variant of ``profile_fused_sht`` finds the code it removes in
    the kernel source, so the profile cannot time a stale edit."""
    from ace_tpu_torch import profile_fused_sht
    from ace_tpu_torch.ops import kernel_build

    source = (kernel_build.CSRC_DIR / "fused_sht.cu").read_text()
    assert profile_fused_sht.variant_source(name) != source
    with pytest.raises(KeyError):
        profile_fused_sht.variant_source("nothing")
