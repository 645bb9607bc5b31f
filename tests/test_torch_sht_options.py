"""The rest of the port's small modules against ``ace_tpu``'s at small
sizes (16x32 for the transforms): ``precompute_dlegpoly`` and the
conservative regridder (numpy copies, equal), the channels-first layout of
``RealSHT``/``InverseRealSHT`` and the vector SHT with the
vorticity/divergence winds (1e-5 of the largest value), ``core/tensors.py``
(the dict helpers, ``TensorDictAccumulator``, the wind conversions; 1e-5)
and ``data/cloud.py`` on ``memory://`` and ``file://`` paths, with a
netCDF file read through a URL."""

import numpy as np
import pytest
import torch

from ace_tpu.core import tensors as jax_tensors
from ace_tpu.data import cloud as jax_cloud
from ace_tpu.data.store import write_h5
from ace_tpu.ops import conservative_regrid as jax_regrid
from ace_tpu.ops import legendre as jax_legendre
from ace_tpu.ops import sht as jax_sht
from ace_tpu.ops import vector_sht as jax_vector_sht
from ace_tpu_torch.core import tensors
from ace_tpu_torch.data import cloud
from ace_tpu_torch.data.store import open_file_dataset
from ace_tpu_torch.ops import conservative_regrid, legendre, sht, vector_sht

torch.set_num_threads(2)

NLAT, NLON = 16, 32
TOL = 1e-5


def _draw(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("csphase", [True, False])
def test_precompute_dlegpoly_equals_ace_tpu(csphase):
    theta = np.concatenate([[0.0], np.linspace(0.1, np.pi - 0.1, 13),
                            [np.pi]])
    for got, ref in zip(
            legendre.precompute_dlegpoly(9, 12, theta, csphase=csphase),
            jax_legendre.precompute_dlegpoly(9, 12, theta,
                                             csphase=csphase)):
        np.testing.assert_array_equal(got, ref)


def test_conservative_regrid_equals_ace_tpu():
    """Weights and regridded fields (with and without NaN skipping) on a
    coarsening and a shifted-longitude grid."""
    lat_in, lon_in = np.linspace(-87.5, 87.5, 36), np.arange(0, 360, 5.0)
    lat_out, lon_out = np.linspace(-85, 85, 18), np.arange(-180, 180, 10.0)
    x = _draw((2, 36, 72)).astype(np.float64)
    x[0, :4, :6] = np.nan
    got = conservative_regrid.ConservativeRegridder(lat_in, lon_in, lat_out,
                                                    lon_out)
    ref = jax_regrid.ConservativeRegridder(lat_in, lon_in, lat_out, lon_out)
    np.testing.assert_array_equal(
        conservative_regrid.latitude_weights(lat_in, lat_out[::-1]),
        jax_regrid.latitude_weights(lat_in, lat_out[::-1]))
    np.testing.assert_array_equal(
        conservative_regrid.longitude_weights(lon_in, lon_out),
        jax_regrid.longitude_weights(lon_in, lon_out))
    for kw in ({}, {"skipna": True}, {"skipna": True, "na_thres": 0.5}):
        np.testing.assert_array_equal(got(x, **kw), ref(x, **kw))


@pytest.mark.parametrize("grid", ["legendre-gauss", "equiangular"])
def test_channels_first_sht_matches_ace_tpu(grid):
    """``channels_last=False`` (the JAX default): ``[..., nlat, nlon]`` to
    complex coefficients and back; the channels-last ``forward_pair`` of
    the same transform gives the same numbers."""
    x = _draw((2, 3, NLAT, NLON))
    ref = np.asarray(jax_sht.RealSHT(NLAT, NLON, grid=grid)(x))
    fwd = sht.RealSHT(NLAT, NLON, grid=grid, channels_last=False)
    coeffs = fwd(torch.from_numpy(x))
    assert coeffs.dtype == torch.complex64
    _close(coeffs.numpy(), ref)
    cr, ci = sht.RealSHT(NLAT, NLON, grid=grid).forward_pair(
        torch.from_numpy(x).movedim(1, -1))
    _close(torch.complex(cr, ci).movedim(-1, 1).numpy(), ref)
    back = np.asarray(jax_sht.InverseRealSHT(NLAT, NLON, grid=grid)(ref))
    inv = sht.InverseRealSHT(NLAT, NLON, grid=grid, channels_last=False)
    _close(inv(torch.from_numpy(ref.copy())).numpy(), back)


def test_vector_sht_pair_matches_ace_tpu():
    x = _draw((2, 2, NLAT, NLON), seed=1)
    ref = np.asarray(jax_vector_sht.RealVectorSHT(NLAT, NLON)(x))
    got = vector_sht.RealVectorSHT(NLAT, NLON)(torch.from_numpy(x))
    _close(got.numpy(), ref)
    back = np.asarray(jax_vector_sht.InverseRealVectorSHT(NLAT, NLON)(ref))
    got = vector_sht.InverseRealVectorSHT(NLAT, NLON)(
        torch.from_numpy(ref.copy()))
    _close(got.numpy(), back)


@pytest.mark.parametrize("grid", ["legendre-gauss", "equiangular"])
def test_vorticity_divergence_winds_match_ace_tpu(grid):
    """``u_v_to_vort_div`` then ``vort_div_to_u_v`` (``ace_tpu`` runs
    them at its highest precision, the port in float32)."""
    u, v = _draw((2, NLAT, NLON), seed=2), _draw((2, NLAT, NLON), seed=3)
    ref_vort, ref_div = jax_vector_sht.u_v_to_vort_div(u, v, grid=grid)
    vort, div = vector_sht.u_v_to_vort_div(torch.from_numpy(u),
                                           torch.from_numpy(v), grid=grid)
    _close(vort.numpy(), ref_vort)
    _close(div.numpy(), ref_div)
    ref_u, ref_v = jax_vector_sht.vort_div_to_u_v(ref_vort, ref_div,
                                                  grid=grid)
    got_u, got_v = vector_sht.vort_div_to_u_v(vort, div, grid=grid)
    _close(got_u.numpy(), ref_u)
    _close(got_v.numpy(), ref_v)


def test_tensor_dict_helpers_match_ace_tpu():
    data = {"a": _draw((2, 3, 4)), "b": _draw((2, 3, 4), seed=1)}
    t = {k: torch.from_numpy(v) for k, v in data.items()}
    for got, ref in ((tensors.add_ensemble_dim(t, 3),
                      jax_tensors.add_ensemble_dim(data, 3)),
                     (tensors.fold_ensemble_dim(t)[0],
                      jax_tensors.fold_ensemble_dim(data)[0]),
                     (tensors.unfold_ensemble_dim(t, 2),
                      jax_tensors.unfold_ensemble_dim(data, 2)),
                     (tensors.add_names(t, t, ["a"]),
                      jax_tensors.add_names(data, data, ["a"]))):
        tensors.assert_dict_allclose(got, ref, rtol=0, atol=0)
    assert tensors.fold_ensemble_dim(t)[1] == 3
    nested = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    assert tensors.flatten_dict(nested) == jax_tensors.flatten_dict(nested)
    assert tensors.unflatten_dict(tensors.flatten_dict(nested, "/"),
                                  "/") == nested
    with pytest.raises(AssertionError, match="missing"):
        tensors.assert_dict_allclose({"a": t["a"]}, t)
    acc, jacc = tensors.TensorDictAccumulator(), (
        jax_tensors.TensorDictAccumulator())
    for seed in range(3):
        step = {k: _draw((4,), seed=seed + i) for i, k in enumerate("xy")}
        acc.record({k: torch.from_numpy(v) for k, v in step.items()})
        jacc.record(step)
    tensors.assert_dict_allclose(acc.get_mean(), jacc.get_mean(), rtol=TOL)
    with pytest.raises(ValueError, match="inconsistent"):
        acc.record({"x": torch.zeros(4)})
    with pytest.raises(ValueError, match="no data"):
        tensors.TensorDictAccumulator().get_mean()


def test_wind_conversions_match_ace_tpu():
    lat = np.linspace(-89, 89, 16, dtype=np.float32)[:, None]
    lon = np.linspace(0, 350, 32, dtype=np.float32)[None, :]
    u, v = _draw((16, 32)), _draw((16, 32), seed=1)
    targs = [torch.from_numpy(a) for a in np.broadcast_arrays(u, v, lat, lon)]
    ref = jax_tensors.u_v_to_x_y_z_wind(u, v, lat, lon)
    got = tensors.u_v_to_x_y_z_wind(*targs)
    for g, r in zip(got, ref):
        _close(g.numpy(), r)
    back = tensors.x_y_z_to_u_v_wind(*got, targs[2], targs[3])
    ref_back = jax_tensors.x_y_z_to_u_v_wind(*ref, lat, lon)
    for g, r, orig in zip(back, ref_back, (u, v)):
        _close(g.numpy(), r)
        _close(g.numpy(), orig)


def test_cloud_helpers_on_memory_and_file_paths(tmp_path):
    """``memory://`` is remote (through fsspec), ``file://`` and plain
    paths are local; a copy round-trips the bytes, as ``ace_tpu``'s
    does."""
    local = tmp_path / "a.bin"
    local.write_bytes(b"healpix")
    for path in (str(local), f"file://{local}", "memory://x/a.bin",
                 "gs://bucket/a.bin"):
        assert cloud.is_local(path) == jax_cloud.is_local(path)
    cloud.inter_filesystem_copy(str(local), "memory://port/a.bin")
    jax_cloud.inter_filesystem_copy(str(local), "memory://jax/a.bin")
    assert cloud.exists("memory://port/a.bin")
    assert cloud.exists(f"file://{local}") and cloud.exists(str(local))
    assert not cloud.exists("memory://port/none.bin")
    assert not cloud.exists(f"file://{tmp_path}/none.bin")
    fetched, handle = cloud.fetch_to_local("memory://port/a.bin")
    with open(fetched, "rb") as f:
        assert f.read() == b"healpix"
    handle.close()
    assert not cloud.exists(fetched)
    assert cloud.fetch_to_local(f"file://{local}") == (str(local), None)


def test_netcdf_through_urls_reads_as_the_local_file(tmp_path):
    """A netCDF file opened as a plain path, a ``file://`` URL and, after
    a copy, a ``memory://`` URL: the same variables and values; the
    fetched copy is removed on close."""
    path = str(tmp_path / "d.nc")
    write_h5(path, {"ta": _draw((3, 4, 5))},
             {"ta": ("time", "lat", "lon")})
    cloud.inter_filesystem_copy(path, "memory://store/d.nc")
    ref = open_file_dataset(path)["ta"].read(())
    for url in (f"file://{path}", "memory://store/d.nc"):
        ds = open_file_dataset(url)
        np.testing.assert_array_equal(ds["ta"].read(()), ref)
        ds.close()


def test_remote_paths_without_fsspec_name_it(monkeypatch):
    """fsspec is imported only for a remote path; without it, a remote
    path raises naming it, and a local one needs nothing."""
    import sys

    monkeypatch.setitem(sys.modules, "fsspec", None)
    with pytest.raises(ImportError, match="fsspec"):
        cloud.exists("memory://x/a.bin")
    assert cloud.fetch_to_local("file:///tmp/a.nc") == ("/tmp/a.nc", None)
