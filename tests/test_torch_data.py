"""The port's data layer and the modules around it against ace_tpu: the
copied modules (time, store, requirements, timing, insolation, data
writers) give what the originals give, both packages read the same
windows, initial conditions and times from synthetic files, and the
derived variables, the flood fill and the file statistics agree."""

import dataclasses
import datetime
import importlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.core import coordinates as jax_coords
from ace_tpu.core.config import from_dict as jax_from_dict
from ace_tpu.core.dataset_info import DatasetInfo as JaxDatasetInfo
from ace_tpu.core.derived_variables import (
    compute_derived_for as jax_compute_derived_for,
)
from ace_tpu.core.fill import SmoothFloodFill as JaxSmoothFloodFill
from ace_tpu.core.normalizer import NormalizationConfig as JaxNormalization
from ace_tpu.data import store as jax_store
from ace_tpu.data import time as jax_time
from ace_tpu.data.inference import (
    InferenceDataLoaderConfig as JaxInferenceDataLoaderConfig,
)
from ace_tpu.inference import data_writer as jax_data_writer
from ace_tpu.stepper import insolation as jax_insolation
from ace_tpu.testing import SyntheticData
from ace_tpu_torch import flagship
from ace_tpu_torch.core import coordinates
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.dataset_info import (
    DatasetInfo,
    IncompatibleDatasetInfo,
)
from ace_tpu_torch.core.derived_variables import compute_derived_for
from ace_tpu_torch.core.fill import SmoothFloodFill
from ace_tpu_torch.core.normalizer import NormalizationConfig
from ace_tpu_torch.data import store, time
from ace_tpu_torch.data.inference import InferenceDataLoaderConfig
from ace_tpu_torch.inference import data_writer
from ace_tpu_torch.stepper import insolation

torch.set_num_threads(2)

CALENDARS = ["proleptic_gregorian", "standard", "noleap", "julian",
             "360_day", "all_leap"]
NAMES = ["a", "b", "c", "d"]


@pytest.mark.parametrize("copy, original", [
    ("ace_tpu_torch.data.time", "ace_tpu.data.time"),
    ("ace_tpu_torch.data.requirements", "ace_tpu.data.requirements"),
    ("ace_tpu_torch.core.timing", "ace_tpu.core.timing"),
])
def test_copied_modules_keep_the_originals_code(copy, original):
    """These copies differ from their originals in the module docstring
    only."""
    def body(name):
        source = pathlib.Path(importlib.import_module(name).__file__)
        text = source.read_text()
        return text[text.index('"""', 3) + 3:]

    assert body(copy) == body(original)


@pytest.mark.parametrize("calendar", CALENDARS)
def test_time_functions_match_over_each_calendar(calendar):
    coord = time.TimeCoord.from_range("1999-12-30T18:00", 40, 21600 * 7,
                                      calendar)
    ref = jax_time.TimeCoord.from_range("1999-12-30T18:00", 40, 21600 * 7,
                                        calendar)
    np.testing.assert_array_equal(coord.values, ref.values)
    for key, value in ref.components().items():
        np.testing.assert_array_equal(coord.components()[key], value)
    np.testing.assert_array_equal(coord.fractional_day_of_year(),
                                  ref.fractional_day_of_year())
    np.testing.assert_array_equal(coord.days_in_year(), ref.days_in_year())
    assert coord.timestep_seconds() == ref.timestep_seconds()
    stamp = "2000-03-01T06:00:00"
    assert (time.parse_datetime_string(stamp, calendar)
            == jax_time.parse_datetime_string(stamp, calendar))
    assert (time.format_time(int(coord.values[7]), calendar)
            == jax_time.format_time(int(ref.values[7]), calendar))
    window = time.TimeSlice("2000-01-02", "2000-01-20").indices(coord)
    np.testing.assert_array_equal(
        window, jax_time.TimeSlice("2000-01-02", "2000-01-20").indices(ref))
    np.testing.assert_array_equal(
        time.RepeatedInterval(2, 1, 5).indices(coord),
        jax_time.RepeatedInterval(2, 1, 5).indices(ref))


@pytest.mark.parametrize("calendar", ["proleptic_gregorian", "noleap",
                                      "360_day"])
def test_insolation_matches_at_a_few_times(calendar):
    lat = jax_coords.gaussian_latitudes(16)
    lon = np.linspace(0, 360, 32, endpoint=False)
    step = datetime.timedelta(hours=6)
    times = jax_time.TimeCoord(np.asarray(
        [[jax_time.parse_datetime_string(s, calendar) for s in
          ("2001-01-01T06:00", "2001-06-21T12:00", "2001-09-23T18:00")]]),
        calendar)
    ref = jax_insolation.CM4Insolation(23.439, 0.0167, 102.932)(
        times, step, jax_coords.LatLonCoordinates(lat=lat, lon=lon), 1360.78)
    out = insolation.CM4Insolation(23.439, 0.0167, 102.932)(
        time.TimeCoord(times.values, calendar), step,
        coordinates.LatLonCoordinates(lat=lat, lon=lon), 1360.78)
    assert out.dtype == ref.dtype and out.shape == (1, 3, 16, 32)
    np.testing.assert_array_equal(out, ref)


def _sample_file_data():
    rng = np.random.RandomState(0)
    t = jax_time.TimeCoord.from_range("2000-01-01T00:00", 3, 21600)
    data = {"x": rng.randn(3, 4, 5).astype(np.float32),
            "s": np.float32(2.5)}
    dims = {"x": ("time", "lat", "lon"), "s": ()}
    coords = {"lat": np.linspace(-60, 60, 4), "lon": np.arange(5.0)}
    attrs = {"x": {"units": "K", "long_name": "x field"}}
    return data, dims, coords, attrs, t


def _assert_same_dataset(out, ref):
    assert set(out.keys()) == set(ref.keys())
    for k in ref.keys():
        assert out[k].dims == ref[k].dims, k
        assert out[k].attrs == ref[k].attrs, k
        np.testing.assert_array_equal(out[k].read(()), ref[k].read(()))
    np.testing.assert_array_equal(out.read_time().values,
                                  ref.read_time().values)


@pytest.mark.parametrize("writer", ["port", "ace_tpu"])
def test_each_package_reads_the_others_h5_file(tmp_path, writer):
    data, dims, coords, attrs, t = _sample_file_data()
    path = str(tmp_path / "f.nc")
    if writer == "port":
        store.write_h5(path, data, dims, coords=coords, attrs=attrs,
                       time=time.TimeCoord(t.values, t.calendar))
    else:
        jax_store.write_h5(path, data, dims, coords=coords, attrs=attrs,
                           time=t)
    _assert_same_dataset(store.open_file_dataset(path),
                         jax_store.open_file_dataset(path))
    # a remote file (here in fsspec's memory filesystem, no network) is
    # fetched to a local copy by each package's cloud module
    from ace_tpu_torch.data import cloud

    url = f"memory://{writer}/f.nc"
    cloud.inter_filesystem_copy(path, url)
    _assert_same_dataset(store.open_file_dataset(url),
                         jax_store.open_file_dataset(url))


@pytest.mark.parametrize("writer", ["port", "ace_tpu"])
def test_each_package_reads_the_others_zarr_store(tmp_path, writer):
    pytest.importorskip("tensorstore")
    data, dims, coords, attrs, t = _sample_file_data()
    path = str(tmp_path / "f.zarr")
    if writer == "port":
        store.write_zarr(path, data, dims, coords=coords, attrs=attrs,
                         time=time.TimeCoord(t.values, t.calendar))
    else:
        jax_store.write_zarr(path, data, dims, coords=coords, attrs=attrs,
                             time=t)
    _assert_same_dataset(store.open_file_dataset(path),
                         jax_store.open_file_dataset(path))


@pytest.mark.parametrize("kind", ["raw", "monthly", "coarsen"])
def test_data_writers_write_what_ace_tpu_writes(tmp_path, kind):
    """The copied writers (raw, monthly means, time coarsening) and the
    restart file, fed the same batches, write the same files."""
    rng = np.random.RandomState(0)
    lat = np.linspace(-80, 80, 4)
    lon = np.arange(0, 360, 45.0)
    infos = {
        "port": DatasetInfo(
            horizontal_coordinates=coordinates.LatLonCoordinates(lat, lon)),
        "ace_tpu": JaxDatasetInfo(
            horizontal_coordinates=jax_coords.LatLonCoordinates(lat, lon)),
    }
    batches = [{"v": rng.randn(2, 3, 4, 8).astype(np.float32)}
               for _ in range(2)]
    t = jax_time.TimeCoord.from_range("2000-01-30T00:00", 6, 86400 * 2)
    modules = {"port": (data_writer, time), "ace_tpu": (jax_data_writer,
                                                        jax_time)}
    for tag, (module, tmod) in modules.items():
        path = str(tmp_path / f"{tag}.nc")
        info = infos[tag]
        if kind == "monthly":
            writer = module.MonthlyMeanWriter(path, info)
        elif kind == "coarsen":
            writer = module.TimeCoarsenWriter(
                module.H5DataWriter(path, info), 3)
        else:
            writer = module.H5DataWriter(path, info)
        for i, batch in enumerate(batches):
            values = np.stack([t.values[3 * i:3 * i + 3]] * 2)
            writer.append_batch(batch, tmod.TimeCoord(values, t.calendar))
        writer.flush()
        writer.close()
        module.save_restart(str(tmp_path / f"{tag}_restart.nc"),
                            {"v": batches[-1]["v"][:, -1:]},
                            tmod.TimeCoord(t.values[-1:][None], t.calendar),
                            info)
    for name in ("", "_restart"):
        out = jax_store.open_file_dataset(str(tmp_path / f"port{name}.nc"))
        ref = jax_store.open_file_dataset(str(tmp_path / f"ace_tpu{name}.nc"))
        assert set(out.keys()) == set(ref.keys())
        for k in ref.keys():
            np.testing.assert_array_equal(out[k].read(()), ref[k].read(()))


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    return SyntheticData(tmp_path_factory.mktemp("data"), NAMES, n_time=12,
                         nlat=8, nlon=16)


@pytest.mark.parametrize("start_indices", [
    {"list": [0, 1]},
    {"n_initial_conditions": 3, "first": 1, "interval": 2},
    {"times": ["2000-01-01T06:00:00", "2000-01-02T00:00:00"]},
])
def test_inference_data_matches_ace_tpu(synthetic, start_indices):
    """Windows, initial conditions and times of both packages'
    XarrayDataset and InferenceGriddedData on the same files."""
    cfg = {"dataset": {"data_path": str(synthetic.data_dir)},
           "start_indices": start_indices}
    args = (["c", "d"], ["a", "b"], 6, 4)
    out = from_dict(InferenceDataLoaderConfig, cfg).build(*args)
    ref = jax_from_dict(JaxInferenceDataLoaderConfig, cfg).build(*args)
    assert out.n_initial_conditions == ref.n_initial_conditions
    ic, ic_ref = out.initial_condition(), ref.initial_condition()
    np.testing.assert_array_equal(ic.time.values, ic_ref.time.values)
    for k, v in ic_ref.data.items():
        np.testing.assert_array_equal(ic.data[k], v)
    windows = list(out.windows())
    ref_windows = list(ref.windows())
    assert [k for _, k in windows] == [k for _, k in ref_windows] == [0, 1]
    for (w, _), (r, _) in zip(windows, ref_windows):
        assert w.time.calendar == r.time.calendar
        np.testing.assert_array_equal(w.time.values, r.time.values)
        assert set(w.data) == set(r.data) == {"c", "d"}
        for k, v in r.data.items():
            np.testing.assert_array_equal(w.data[k], v)
    for (w, _), (r, _) in zip(out.target_windows(["a", "x"]),
                              ref.target_windows(["a", "x"])):
        np.testing.assert_array_equal(w.data["x"], r.data["x"])
    info, info_ref = out.dataset_info, ref.dataset_info
    assert info.timestep == info_ref.timestep
    np.testing.assert_array_equal(info.horizontal_coordinates.lat,
                                  info_ref.horizontal_coordinates.lat)
    assert (info.horizontal_coordinates.grid
            == info_ref.horizontal_coordinates.grid == "equiangular")
    np.testing.assert_array_equal(info.vertical_coordinate.ak,
                                  info_ref.vertical_coordinate.ak)
    assert set(info.variable_metadata) == set(info_ref.variable_metadata)


def test_dataset_info_compatibility(synthetic):
    info = from_dict(InferenceDataLoaderConfig, {
        "dataset": {"data_path": str(synthetic.data_dir)}}
    ).build([], ["a"], 2, 2).dataset_info
    info.assert_compatible_with(info)
    other = dataclasses.replace(info, timestep=datetime.timedelta(hours=3))
    with pytest.raises(IncompatibleDatasetInfo, match="timesteps"):
        info.assert_compatible_with(other)
    other = dataclasses.replace(
        info, horizontal_coordinates=coordinates.LatLonCoordinates(
            lat=coordinates.gaussian_latitudes(8),
            lon=info.horizontal_coordinates.lon))
    with pytest.raises(IncompatibleDatasetInfo, match="horizontal"):
        info.assert_compatible_with(other)


@pytest.mark.parametrize("method", [
    "area_weighted_sum", "area_weighted_mean", "area_weighted_std",
    "area_weighted_rmse", "area_weighted_mean_bias", "zonal_mean",
])
def test_gridded_operations_match_ace_tpu(method):
    """The lat-lon reductions the aggregators take (``zonal_mean``, the
    area-weighted sum, and the bias, RMSE and std helpers)."""
    from ace_tpu.core.dataset_info import DatasetInfo as JaxInfo

    lat = coordinates.gaussian_latitudes(16)
    lon = np.linspace(0, 360, 32, endpoint=False)
    ops = DatasetInfo(horizontal_coordinates=coordinates.LatLonCoordinates(
        lat=lat, lon=lon)).gridded_operations
    ref_ops = JaxInfo(horizontal_coordinates=jax_coords.LatLonCoordinates(
        lat=lat, lon=lon)).gridded_operations
    rng = np.random.RandomState(0)
    a, b = (rng.randn(2, 3, 16, 32).astype(np.float32) for _ in range(2))
    args = (a, b) if method in ("area_weighted_rmse",
                                "area_weighted_mean_bias") else (a,)
    out = getattr(ops, method)(*map(torch.from_numpy, args))
    ref = np.asarray(getattr(ref_ops, method)(*map(jnp.asarray, args)))
    assert out.shape == ref.shape
    # float32 sums of 512 terms in another order: within 1e-6 of the
    # data's scale
    atol = 1e-6 * np.abs(a).max()
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=atol)
    dict_method = {"area_weighted_sum": "area_weighted_sum_dict",
                   "area_weighted_mean": "area_weighted_mean_dict",
                   "area_weighted_std": "area_weighted_std_dict",
                   "area_weighted_rmse": "area_weighted_rmse_dict",
                   "area_weighted_mean_bias": "area_weighted_mean_bias_dict",
                   }.get(method)
    if dict_method:
        out = getattr(ops, dict_method)(
            *({"x": torch.from_numpy(v)} for v in args))
        np.testing.assert_allclose(out["x"].numpy(), ref, rtol=1e-6,
                                   atol=atol)


def test_statistics_from_files_match_ace_tpu(synthetic):
    """The normalizer's statistics read from stats files (the small repair
    of ``core/normalizer.py``)."""
    cfg = {"global_means_path": str(synthetic.mean_path),
           "global_stds_path": str(synthetic.std_path)}
    out = from_dict(NormalizationConfig, cfg).build(NAMES)
    ref = jax_from_dict(JaxNormalization, cfg).build(NAMES)
    for k in NAMES:
        assert out.means[k] == float(ref.means[k])
        assert out.stds[k] == float(ref.stds[k])
    loaded = from_dict(NormalizationConfig, cfg)
    loaded.load()
    assert loaded.global_means_path is None
    assert loaded.means == {k: float(v) for k, v in ref.means.items()}


def _flagship_fields(nlat=16, nlon=32, batch=2, n_time=3):
    """Every flagship variable at 16x32, drawn at physical scales."""
    prognostic, diagnostic, forcing = flagship.names()
    rng = np.random.RandomState(0)
    data = {}
    for k in prognostic + diagnostic + forcing:
        v = rng.randn(batch, n_time, nlat, nlon).astype(np.float32)
        if k == "PRESsfc":
            v = v * 1000 + 1.0e5
        elif k.startswith("air_temperature") or k == "surface_temperature":
            v = v * 10 + 260
        elif k.startswith("specific_total_water"):
            v = np.abs(v) * 1e-3
        elif k == "HGTsfc":
            v = v * 500
        elif k == "ocean_fraction":
            v = np.clip(np.abs(v), 0, 1)
        else:
            v = v * 50 + 100
        data[k] = v.astype(np.float32)
    return prognostic + diagnostic, forcing, data


def test_derived_variables_match_ace_tpu_on_flagship_names():
    outputs, forcing, data = _flagship_fields()
    nz = flagship.NZ
    ak = np.concatenate([np.linspace(100.0, 5000.0, nz // 2),
                         np.linspace(5000.0, 0.0, nz // 2 + 1)])
    bk = np.linspace(0.0, 1.0, nz + 1)
    step = datetime.timedelta(hours=6)
    out = compute_derived_for(
        {k: torch.from_numpy(data[k]) for k in outputs},
        coordinates.HybridSigmaPressureCoordinate(ak=ak, bk=bk), step,
        forcing_data={k: torch.from_numpy(data[k]) for k in forcing})
    ref = jax_compute_derived_for(
        {k: jnp.asarray(data[k]) for k in outputs},
        jax_coords.HybridSigmaPressureCoordinate(ak=ak, bk=bk), step,
        forcing_data={k: jnp.asarray(data[k]) for k in forcing})
    assert set(out) == set(ref)
    derived = set(ref) - set(outputs)
    assert {"total_water_path", "total_energy_ace2_path",
            "net_energy_flux_into_atmospheric_column",
            "implied_tendency_of_total_energy_ace2_path_due_to_advection",
            } <= derived
    # within 1e-6 of the largest value each variable is computed from: its
    # own, except for the tendencies of the energy path (~3e9 J/m**2),
    # which difference two float32 paths and divide by the timestep
    path_scale = np.abs(np.asarray(ref["total_energy_ace2_path"])).max()
    for k in derived:
        r = np.asarray(ref[k])
        scale = (path_scale / step.total_seconds()
                 if "tendency_of_total_energy" in k
                 or k == "total_energy_ace2_path_tendency"
                 else np.abs(r).max())
        np.testing.assert_allclose(out[k].numpy(), r, rtol=0,
                                   atol=1e-6 * scale, err_msg=k)


def test_flood_fill_matches_ace_tpu():
    _, _, data = _flagship_fields()
    x = data["surface_temperature"].copy()
    land = np.zeros((16, 32), bool)
    land[3:11, 4:15] = True  # an interior no expansion reaches
    land[12:14, 20:23] = True
    x[..., land] = np.nan
    fill, ref_fill = SmoothFloodFill(num_steps=4), JaxSmoothFloodFill(4)
    out = fill(torch.from_numpy(x), "sst")
    ref = np.asarray(ref_fill(jnp.asarray(x), "sst"))
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    # a field with no NaN is returned as it is, and several fields go
    # through one stacked fill with the same result
    clean = data["PRESsfc"]
    both = fill.fill_stacked(torch.stack([torch.from_numpy(x),
                                          torch.from_numpy(clean)]),
                             ["sst", "ps"])
    np.testing.assert_array_equal(both[0].numpy(), out.numpy())
    np.testing.assert_array_equal(both[1].numpy(), clean)


def test_flood_fill_skips_fields_with_no_nan(monkeypatch):
    """Once the host knows that no variable of a call has a NaN, the call
    returns the fields as they are without filling, as the JAX package
    skips such names; a call with a NaN field fills."""
    from ace_tpu_torch.core import fill as fill_module

    calls = []
    flood_fill = fill_module._flood_fill
    monkeypatch.setattr(fill_module, "_flood_fill",
                        lambda *a: calls.append(1) or flood_fill(*a))
    _, _, data = _flagship_fields()
    clean = torch.from_numpy(np.stack([data["PRESsfc"], data["h500"]]))
    fill = SmoothFloodFill(num_steps=4)
    for _ in range(2):
        out = fill.fill_stacked(clean, ["ps", "h500"])
        np.testing.assert_array_equal(out.numpy(), clean.numpy())
    assert not calls
    holed = clean[0].clone()
    holed[..., 3:6, 4:9] = float("nan")
    out = fill.fill_stacked(torch.stack([holed, clean[1]]), ["sst", "h500"])
    assert calls and torch.isfinite(out).all()


@pytest.mark.parametrize("kind", ["time_mean", "monthly"])
def test_reference_loaders_match_ace_tpu(tmp_path, kind):
    """The aggregators' offline references: a time-mean map file, and a
    monthly-means file as ``MonthlyMeanWriter`` writes it."""
    from ace_tpu.aggregator import inference as jax_aggregators
    from ace_tpu.core.dataset_info import DatasetInfo as JaxDatasetInfo
    from ace_tpu_torch.aggregator import inference as aggregators

    rng = np.random.RandomState(0)
    lat = coordinates.gaussian_latitudes(8)
    lon = np.linspace(0, 360, 16, endpoint=False)
    path = str(tmp_path / "reference.nc")
    if kind == "time_mean":
        jax_store.write_h5(
            path, {"a": rng.randn(3, 8, 16).astype(np.float32),
                   "b": rng.randn(8, 16).astype(np.float32)},
            {"a": ("time", "lat", "lon"), "b": ("lat", "lon")},
            coords={"lat": lat, "lon": lon})
        out = aggregators.load_time_mean_reference(path)
        ref = jax_aggregators.load_time_mean_reference(path)
    else:
        info = JaxDatasetInfo(
            horizontal_coordinates=jax_coords.LatLonCoordinates(lat, lon))
        writer = jax_data_writer.MonthlyMeanWriter(path, info)
        t = jax_time.TimeCoord.from_range("2000-01-01T00:00", 90, 86400 * 5)
        for i in range(3):
            values = np.stack([t.values[30 * i:30 * i + 30]] * 2)
            writer.append_batch(
                {"a": rng.randn(2, 30, 8, 16).astype(np.float32)},
                jax_time.TimeCoord(values, t.calendar))
        writer.close()
        out = aggregators.load_monthly_reference(
            path, DatasetInfo(horizontal_coordinates=coordinates
                              .LatLonCoordinates(lat, lon)).gridded_operations)
        ref = jax_aggregators.load_monthly_reference(
            path, info.gridded_operations)
    assert set(out) == set(ref) and out
    for k, r in ref.items():
        if kind == "monthly":
            assert set(out[k]) == set(r) == {2000, 2001}
            np.testing.assert_allclose([out[k][y] for y in r],
                                       list(r.values()), rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(out[k], r)
