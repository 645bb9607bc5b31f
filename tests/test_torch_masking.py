"""The spatial half of the port's masking and the depth coordinate
(``ace_tpu_torch/core/masking.py``, ``core/coordinates.py``,
``core/gridded_ops.py``, ``core/dataset_info.py``, the dataset's depth
coordinate and masks, ``StepperConfig.input_masking``) against
``ace_tpu``'s on the same inputs: the mask priority (name > level suffix
> ``mask_2d``), input masking with its exclusions and fill values, the
output masker, ``dz`` with partial bottom cells and the depth integral
(float32 on both sides, within 1e-6 of the largest value), masked
area-weighted means (1e-6 of the values summed), and the state round
trips both ways, exact."""

import datetime
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ace_tpu.core.coordinates import DepthCoordinate as JaxDepth
from ace_tpu.core.coordinates import LatLonCoordinates as JaxLatLon
from ace_tpu.core.config import from_dict as jax_from_dict
from ace_tpu.core.dataset_info import DatasetInfo as JaxDatasetInfo
from ace_tpu.core.gridded_ops import LatLonOperations as JaxOps
from ace_tpu.core.masking import MaskProvider as JaxMaskProvider
from ace_tpu.core.masking import SpatialMaskProvider as JaxSpatialProvider
from ace_tpu.core.masking import (
    StaticSpatialMaskingConfig as JaxMaskingConfig,
)
from ace_tpu.data.dataset import XarrayDataConfig as JaxDataConfig
from ace_tpu.stepper.stepper import StepperConfig as JaxStepperConfig
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.coordinates import (
    DepthCoordinate,
    LatLonCoordinates,
    deserialize_vertical_coordinate,
    serialize_vertical_coordinate,
)
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.gridded_ops import LatLonOperations
from ace_tpu_torch.core.masking import (
    MaskProvider,
    NameAndPrefixMatcher,
    SpatialMaskProvider,
    StaticSpatialMaskingConfig,
)
from ace_tpu_torch.core.metrics import spherical_area_weights
from ace_tpu_torch.data.dataset import XarrayDataConfig
from ace_tpu_torch.stepper.stepper import StepperConfig

NLAT, NLON = 8, 16
TOL = 1e-6


def _masks(seed=0, levels=3):
    rng = np.random.default_rng(seed)
    floor = rng.integers(0, levels + 1, (NLAT, NLON))
    masks = {f"mask_{k}": (floor > k).astype(np.float32)
             for k in range(levels)}
    masks["mask_2d"] = masks["mask_0"]
    masks["mask_zos"] = (rng.random((NLAT, NLON)) > 0.5).astype(np.float32)
    return masks


def _fields(names, seed=1, batch=2):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((batch, NLAT, NLON)).astype(np.float32)
            for k in names}


NAMES = ["thetao_0", "thetao_2", "zos", "sst", "land_fraction", "so_1",
         "HI", "uo_5", "thetao"]


def test_mask_provider_priority_matches_ace_tpu():
    """``mask_{name}`` over ``mask_{level}`` over ``mask_2d``; a name with
    a level suffix whose level has no mask gets none (not ``mask_2d``)."""
    masks = _masks()
    port, ref = MaskProvider(masks), JaxMaskProvider(masks)
    for name in NAMES:
        got, want = port.get_mask_for(name), ref.get_mask_for(name)
        assert (got is None) == (want is None), name
        if want is not None:
            np.testing.assert_array_equal(got, want)
    assert port.mask_key_for("zos") == "mask_zos"
    assert port.mask_key_for("thetao_2") == "mask_2"
    assert port.mask_key_for("sst") == "mask_2d"
    assert port.mask_key_for("uo_5") is None
    with pytest.raises(ValueError, match="must start with mask_"):
        MaskProvider({"land": masks["mask_0"]})
    matcher = NameAndPrefixMatcher(["so", "HI"])
    assert [matcher.match(n) for n in ("so", "so_3", "sox", "HI_a", "HI")] == [
        "so", "so", None, None, "HI"]


@pytest.mark.parametrize("config", [
    {"mask_value": 0, "fill_value": 0.0,
     "exclude_names_and_prefixes": ["land_fraction"]},
    {"mask_value": 1, "fill_value": -2.5},
    {"mask_value": 0, "fill_value": "mean",
     "exclude_names_and_prefixes": ["thetao"]},
], ids=["recipe", "mask-value-1", "mean-excluding-a-prefix"])
def test_input_masking_matches_ace_tpu(config):
    """``StepperConfig.input_masking``'s callable on fields with NaN on the
    dry cells: the same values (the exclusions untouched, NaN kept there),
    exact."""
    masks = _masks()
    data = _fields(NAMES)
    for k, v in data.items():
        mask = MaskProvider(masks).get_mask_for(k)
        if mask is not None:
            data[k] = np.where(mask != 0, v, np.nan).astype(np.float32)
    means = {k: float(i) for i, k in enumerate(NAMES)}
    port = from_dict(StaticSpatialMaskingConfig, config).build(
        MaskProvider(masks), means=means)
    ref = jax_from_dict(JaxMaskingConfig, config).build(
        JaxMaskProvider(masks), means=means)
    got = port({k: torch.from_numpy(v) for k, v in data.items()})
    want = ref({k: jnp.asarray(v) for k, v in data.items()})
    for k in NAMES:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if config["mask_value"] == 0 and config["fill_value"] == 0.0:
        for k in NAMES:
            if k != "land_fraction":
                assert torch.isfinite(got[k]).all(), k
    no_masks = from_dict(StaticSpatialMaskingConfig, config).build(None)
    assert no_masks({"sst": torch.ones(1)})["sst"] is not None


def test_output_masker_and_static_masking_match_ace_tpu():
    """NaN in every output's masked cells; ``StaticSpatialMasking`` from
    ``SpatialMaskProvider`` fills a named field and a prefix's levels."""
    masks = _masks()
    data = _fields(NAMES)
    got = MaskProvider(masks).build_output_masker()(
        {k: torch.from_numpy(v) for k, v in data.items()})
    want = JaxMaskProvider(masks).build_output_masker()(
        {k: jnp.asarray(v) for k, v in data.items()})
    for k in NAMES:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    spatial = {"thetao": "mask_1", "zos": "mask_zos"}
    port = SpatialMaskProvider(spatial, fill_value=3.0).build(masks)
    ref = JaxSpatialProvider(spatial, fill_value=3.0).build(masks)
    got = port({k: torch.from_numpy(v) for k, v in data.items()})
    want = ref({k: jnp.asarray(v) for k, v in data.items()})
    for k in NAMES:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert MaskProvider(masks) == MaskProvider.from_state(
        MaskProvider(masks).get_state())


def _depth_inputs(seed=2, levels=3):
    rng = np.random.default_rng(seed)
    idepth = np.asarray([0.0, 10.0, 60.0, 200.0], np.float32)[:levels + 1]
    floor = rng.uniform(5.0, 250.0, (NLAT, NLON))
    mask = np.stack([(floor > idepth[k]) for k in range(levels)],
                    -1).astype(np.float32)
    mask[:2, :2] = 0  # dry columns
    deptho = np.where(mask[..., 0] > 0, floor, np.nan).astype(np.float32)
    return idepth, mask, deptho


@pytest.mark.parametrize("with_deptho", [True, False])
def test_depth_coordinate_matches_ace_tpu(with_deptho):
    """``dz`` (partial bottom cells from ``deptho``, or from the mask
    alone) exactly, the depth integral within 1e-6 of its largest value
    with NaN on the same (dry) columns, and the serialized state both
    ways, exact."""
    idepth, mask, deptho = _depth_inputs()
    deptho = deptho if with_deptho else None
    port = DepthCoordinate(idepth=idepth, mask=mask, deptho=deptho)
    ref = JaxDepth(idepth=idepth, mask=mask, deptho=deptho)
    np.testing.assert_array_equal(port.dz, ref.dz)
    x = _fields(["t"], seed=3)["t"][..., None] + np.arange(3, dtype=np.float32)
    x[0, 3, 3, 1] = np.nan  # a NaN integrand counts as zero
    got = port.depth_integral(torch.from_numpy(x)).numpy()
    want = np.asarray(ref.depth_integral(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[:, :2, :2]).all()
    assert np.nanmax(np.abs(got - want)) <= TOL * np.nanmax(np.abs(want))
    state = serialize_vertical_coordinate(port)
    assert state == {"type": "depth", "data": ref.as_dict()}
    back = deserialize_vertical_coordinate(state)
    np.testing.assert_array_equal(back.dz, port.dz)
    from ace_tpu.core.coordinates import (
        deserialize_vertical_coordinate as jax_deserialize,
    )

    np.testing.assert_array_equal(jax_deserialize(state).dz, port.dz)
    assert serialize_vertical_coordinate(None) == {"type": "null",
                                                   "data": {}}


def test_masked_area_weighted_means_match_ace_tpu():
    """A named variable's means over its wet cells only (zero weight on
    the masked cells, NaN there ignored), from a mask provider or exact
    ``spatial_masks``; unnamed means keep every cell."""
    masks = _masks()
    weights = spherical_area_weights(np.linspace(-80, 80, NLAT), NLON)
    data = _fields(NAMES)
    for k in ("thetao_2", "zos"):
        data[k] = np.where(MaskProvider(masks).get_mask_for(k) != 0, data[k],
                           np.nan).astype(np.float32)
    for kwargs in ({"mask_provider": "provider"},
                   {"spatial_masks": {"zos": masks["mask_zos"]}}):
        port = LatLonOperations(weights, **{
            k: MaskProvider(masks) if v == "provider" else v
            for k, v in kwargs.items()})
        ref = JaxOps(weights, **{
            k: JaxMaskProvider(masks) if v == "provider" else v
            for k, v in kwargs.items()})
        for name in ("thetao_2", "zos", "sst"):
            x = data[name]
            for method in ("area_weighted_mean", "area_weighted_sum"):
                got = getattr(port, method)(torch.from_numpy(x), name=name)
                want = np.asarray(getattr(ref, method)(jnp.asarray(x),
                                                       name=name))
                np.testing.assert_array_equal(np.isnan(got.numpy()),
                                              np.isnan(want))
                # within 1e-6 of the summed values' size (a mean can
                # cancel to far less)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=0,
                    atol=TOL * np.nanmax(np.abs(x)) * x[0].size)
    unnamed = LatLonOperations(weights, mask_provider=MaskProvider(masks))
    assert torch.isnan(unnamed.area_weighted_mean(
        torch.from_numpy(data["zos"]))).all()


def _infos(with_masks=True):
    idepth, mask, deptho = _depth_inputs()
    kwargs = dict(timestep=datetime.timedelta(days=5))
    masks = _masks() if with_masks else None
    port = DatasetInfo(
        horizontal_coordinates=LatLonCoordinates(
            lat=np.linspace(-80, 80, NLAT), lon=np.linspace(0, 360, NLON)),
        vertical_coordinate=DepthCoordinate(idepth=idepth, mask=mask,
                                            deptho=deptho),
        mask_provider=MaskProvider(masks) if masks else None, **kwargs)
    ref = JaxDatasetInfo(
        horizontal_coordinates=JaxLatLon(
            lat=np.linspace(-80, 80, NLAT), lon=np.linspace(0, 360, NLON)),
        vertical_coordinate=JaxDepth(idepth=idepth, mask=mask,
                                     deptho=deptho),
        mask_provider=JaxMaskProvider(masks) if masks else None, **kwargs)
    return port, ref


@pytest.mark.parametrize("with_masks", [True, False])
def test_dataset_info_state_round_trips_both_ways(with_masks):
    """The port's state equals ``ace_tpu``'s and each reads the other's:
    the depth coordinate and the masks come back exactly; the gridded
    operations of the info weight by the masks."""
    port, ref = _infos(with_masks)
    state, ref_state = port.get_state(), ref.get_state()
    assert state == ref_state
    back = DatasetInfo.from_state(ref_state)
    jax_back = JaxDatasetInfo.from_state(state)
    assert back.depth_coordinate is not None
    np.testing.assert_array_equal(back.depth_coordinate.dz,
                                  jax_back.depth_coordinate.dz)
    if with_masks:
        assert back.mask_provider == port.mask_provider
        assert jax_back.mask_provider == ref.mask_provider
        ops = back.gridded_operations
        x = torch.ones(1, NLAT, NLON)
        x[:, back.mask_provider.masks["mask_2d"] == 0] = float("nan")
        assert float(ops.area_weighted_mean(x, name="sst")) == 1.0
    else:
        assert back.mask_provider is None and "mask_provider" not in state


def _write(path, data, dims):
    from ace_tpu_torch.data.store import write_h5
    from ace_tpu_torch.data.time import TimeCoord

    os.makedirs(path, exist_ok=True)
    write_h5(os.path.join(path, "data.nc"), data, dims,
             coords={"lat": np.linspace(-80, 80, NLAT),
                     "lon": np.linspace(0, 360, NLON, endpoint=False)},
             time=TimeCoord.from_range("0311-01-01", 3, 432000, "noleap"))


def test_dataset_reads_the_depth_coordinate_and_masks_as_ace_tpu(tmp_path):
    """``idepth_N``, ``mask_N`` and ``deptho`` make the depth coordinate,
    the ``mask_*`` statics the mask provider, in both packages' loaders;
    a file with both ``ak_N``/``bk_N`` and ``idepth_N`` is refused."""
    idepth, mask, deptho = _depth_inputs()
    data = {"sst": np.ones((3, NLAT, NLON), np.float32),
            "deptho": deptho, "mask_2d": mask[..., 0]}
    dims = {"sst": ("time", "lat", "lon"), "deptho": ("lat", "lon"),
            "mask_2d": ("lat", "lon")}
    for k in range(mask.shape[-1]):
        data[f"mask_{k}"], dims[f"mask_{k}"] = mask[..., k], ("lat", "lon")
    for i, z in enumerate(idepth):
        data[f"idepth_{i}"], dims[f"idepth_{i}"] = np.float32(z), ()
    _write(str(tmp_path / "ocean"), data, dims)
    config = {"data_path": str(tmp_path / "ocean"), "file_pattern": "data.nc"}
    port = from_dict(XarrayDataConfig, config).build().dataset_info
    ref = jax_from_dict(JaxDataConfig, config).build().dataset_info
    assert port.get_state() == ref.get_state()
    assert sorted(port.mask_provider.masks) == sorted(ref.mask_provider.masks)
    data.update(ak_0=np.float32(1.0), bk_0=np.float32(0.0))
    dims.update(ak_0=(), bk_0=())
    _write(str(tmp_path / "both"), data, dims)
    with pytest.raises(ValueError, match="ambiguous"):
        from_dict(XarrayDataConfig, {**config, "data_path": str(
            tmp_path / "both")}).build()


def test_stepper_config_input_masking_round_trips_both_ways():
    """The uncoupled-ocean YAML's stepper: ``input_masking`` builds, its
    state equals ``ace_tpu``'s and each package reads the other's; the
    stepper's input masker fills the masked cells and the output masker
    NaN-fills them."""
    config, info = chip_smoke.ocean_stepper_config(
        NLAT, NLON, ch_width=(8, 12), dilation=(1, 2))
    state = config.get_state()
    assert state["input_masking"] == {
        "mask_value": 0, "fill_value": 0.0,
        "exclude_names_and_prefixes": ["land_fraction"]}
    jax_config = JaxStepperConfig.from_state(state)
    assert jax_config.get_state()["input_masking"] == state["input_masking"]
    assert StepperConfig.from_state(jax_config.get_state()).input_masking == (
        config.input_masking)
    stepper = config.get_stepper(info, device="cpu")
    provider = info.mask_provider
    sst = torch.full((1, NLAT, NLON), float("nan"))
    filled = stepper.input_masker({"sst": sst, "land_fraction": sst})
    wet = torch.from_numpy(provider.masks["mask_2d"] != 0)
    assert (filled["sst"][:, ~wet] == 0).all()
    assert torch.isnan(filled["land_fraction"]).all()
    out = stepper.output_masker({"sst": torch.zeros(1, NLAT, NLON)})["sst"]
    assert torch.isnan(out[:, ~wet]).all() and (out[:, wet] == 0).all()
