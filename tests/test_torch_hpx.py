"""The port's HEALPix grid against ``ace_tpu``'s at small sizes (nside
1-16): the ring and xy index tables and the ring decomposition (equal),
``HealpixSHT``/``HealpixISHT`` and the gridded operations' transforms on
flat-XY data (1e-5 of the largest coefficient or value), the coordinates
(``meshgrid`` and ``xyz`` equal), ``HEALPixOperations`` and its state,
``DatasetInfo`` round-tripping nside, the dataset on (face, height, width)
files, the inference aggregators with the spectrum on HEALPix, and one
ensemble-loss step (CRPS and the energy score over the HEALPix SHT):
loss and gradients within 1e-4."""

from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.aggregator.inference import (
    InferenceAggregatorConfig as JaxAggregatorConfig,
)
from ace_tpu.core.config import from_dict as jax_from_dict
from ace_tpu.core.coordinates import HEALPixCoordinates as JaxHEALPix
from ace_tpu.core.dataset_info import DatasetInfo as JaxDatasetInfo
from ace_tpu.core.gridded_ops import HEALPixOperations as JaxHEALPixOps
from ace_tpu.core.loss import StepLossConfig as JaxStepLossConfig
from ace_tpu.core.optimization import EMAConfig as JaxEMAConfig
from ace_tpu.core.optimization import OptimizationConfig as JaxOptConfig
from ace_tpu.core.step import StepSelector as JaxStepSelector
from ace_tpu.data.dataset import XarrayDataConfig as JaxXarrayDataConfig
from ace_tpu.data.store import write_h5
from ace_tpu.data.time import TimeCoord
from ace_tpu.ops import hpx as jax_hpx
from ace_tpu.stepper.stepper import StepperConfig as JaxStepperConfig
from ace_tpu.stepper.train import StepperTrainConfig as JaxTrainConfig
from ace_tpu.stepper.train import TrainStepper as JaxTrainStepper
from ace_tpu_torch import flagship
from ace_tpu_torch.aggregator.inference import InferenceAggregatorConfig
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.coordinates import HEALPixCoordinates
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.gridded_ops import HEALPixOperations
from ace_tpu_torch.core.loss import StepLossConfig
from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
from ace_tpu_torch.core.step import StepSelector
from ace_tpu_torch.data.dataset import XarrayDataConfig
from ace_tpu_torch.ops import hpx
from ace_tpu_torch.stepper.stepper import StepperConfig
from ace_tpu_torch.stepper.train import StepperTrainConfig, TrainStepper
from ace_tpu_torch.utils.convert import state_dict_to_flax_params

torch.set_num_threads(2)

TOL = 1e-5


def _draw(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("nside", [1, 2, 4, 8, 16])
def test_index_tables_and_rings_equal_ace_tpu(nside):
    np.testing.assert_array_equal(hpx.ring_to_xy_indices(nside),
                                  jax_hpx.ring_to_xy_indices(nside))
    np.testing.assert_array_equal(hpx.xy_to_ring_indices(nside),
                                  jax_hpx.xy_to_ring_indices(nside))
    for got, ref in zip(hpx.ring_decomposition(nside),
                        jax_hpx.ring_decomposition(nside)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("nside, lmax", [(4, None), (8, None), (8, 15),
                                         (8, 6)])
def test_healpix_sht_pair_matches_ace_tpu(nside, lmax):
    """Ring-ordered ``[B, npix, C]`` through both transforms; the inverse
    from ``ace_tpu``'s coefficients. Calling the forward transform twice
    gives the same coefficients: its scatter fills a fresh array."""
    x = _draw((2, 12 * nside * nside, 3))
    ref = np.asarray(jax_hpx.HealpixSHT(nside, lmax=lmax, mmax=lmax)(
        jnp.asarray(x)))
    sht = hpx.HealpixSHT(nside, lmax=lmax, mmax=lmax)
    _close(sht(torch.from_numpy(x)).numpy(), ref)
    again = sht(torch.from_numpy(_draw(x.shape, seed=1)))
    assert not torch.equal(again, sht(torch.from_numpy(x)))
    _close(sht(torch.from_numpy(x)).numpy(), ref)
    back = np.asarray(jax_hpx.HealpixISHT(nside, lmax=lmax, mmax=lmax)(
        jnp.asarray(ref)))
    got = hpx.HealpixISHT(nside, lmax=lmax, mmax=lmax)(
        torch.from_numpy(ref.copy()))
    _close(got.numpy(), back)


def test_band_limited_round_trip():
    """Synthesis from random low-degree coefficients and analysis back
    recover the lowest degrees, as ``ace_tpu``'s test holds its pair."""
    nside, lmax = 16, 8
    rng = np.random.RandomState(0)
    real = np.tril(rng.randn(lmax, lmax))
    imag = np.tril(rng.randn(lmax, lmax), -1)
    imag[:, 0] = 0.0
    coeffs = torch.from_numpy(real + 1j * imag).to(torch.complex64)[..., None]
    f = hpx.HealpixISHT(nside, lmax=lmax, mmax=lmax)(coeffs)
    back = hpx.HealpixSHT(nside, lmax=lmax, mmax=lmax)(f)
    err = (back - coeffs).abs()[:4, :4].max()
    assert err < 0.15 * coeffs.abs()[:4, :4].max()


@pytest.mark.parametrize("nside", [2, 8])
def test_gridded_transforms_on_flat_xy_match_ace_tpu(nside):
    """``HEALPixOperations.get_real_sht``/``get_real_isht`` on
    ``[B, T, 12, nside, nside, C]`` data (lmax = mmax = 2 nside - 1, the
    xy order folded into the scatter and gather) against ``ace_tpu``'s
    reorder and transform."""
    x = _draw((2, 3, 12, nside, nside, 2), seed=2)
    jops, ops = JaxHEALPixOps(nside), HEALPixOperations(nside)
    ref = np.asarray(jops.get_real_sht()(jnp.asarray(x)))
    _close(ops.get_real_sht()(torch.from_numpy(x)).numpy(), ref)
    back = np.asarray(jops.get_real_isht()(jnp.asarray(ref)))
    got = ops.get_real_isht()(torch.from_numpy(ref.copy()))
    _close(got.numpy(), back)
    assert got.shape == x.shape


@pytest.mark.parametrize("nside", [1, 4, 8])
def test_coordinates_equal_ace_tpu(nside):
    jc, c = JaxHEALPix.from_nside(nside), HEALPixCoordinates.from_nside(nside)
    assert c.shape == jc.shape and c.grid == jc.grid == "healpix"
    assert c.area_weights is None
    for got, ref in zip(c.meshgrid(), jc.meshgrid()):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(c.xyz, jc.xyz):
        np.testing.assert_array_equal(got, ref)
    assert c.as_dict() == jc.as_dict()
    assert HEALPixCoordinates.from_dict(jc.as_dict()) == c
    assert c != HEALPixCoordinates.from_nside(2 * nside)
    with pytest.raises(ValueError, match="power of 2"):
        HEALPixCoordinates(face=np.arange(12), height=np.arange(3),
                           width=np.arange(3))


def test_healpix_operations_match_ace_tpu():
    """Sums, means, std, RMSE and bias over (face, height, width), the
    gradient metric, the refusal of regional means and the state."""
    nside = 4
    a, b = _draw((2, 3, 12, nside, nside)), _draw((2, 3, 12, nside, nside),
                                                  seed=1)
    jops = JaxHEALPix.from_nside(nside).get_gridded_operations()
    ops = HEALPixCoordinates.from_nside(nside).get_gridded_operations()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pairs = [
        (ops.area_weighted_sum(ta), jops.area_weighted_sum(ja)),
        (ops.area_weighted_mean(ta, keepdim=True),
         jops.area_weighted_mean(ja, keepdim=True)),
        (ops.area_weighted_std(ta), jops.area_weighted_std(ja)),
        (ops.area_weighted_rmse(ta, tb), jops.area_weighted_rmse(ja, jb)),
        (ops.area_weighted_mean_bias(ta, tb),
         jops.area_weighted_mean_bias(ja, jb)),
        (ops.area_weighted_gradient_magnitude_percent_diff(ta, tb),
         jops.area_weighted_gradient_magnitude_percent_diff(ja, jb)),
        (ops.area_weighted_mean_channels_last(ta.movedim(1, -1)),
         jops.area_weighted_mean_channels_last(jnp.moveaxis(ja, 1, -1))),
    ]
    for got, ref in pairs:
        _close(got.numpy(), ref, tol=1e-6)
    assert ops.zonal_mean is None and jops.zonal_mean is None
    with pytest.raises(NotImplementedError):
        ops.regional_area_weighted_mean(ta, None)
    assert ops.get_state() == jops.get_state()
    with pytest.raises(ValueError, match="nside"):
        HEALPixOperations().get_real_sht()


def test_dataset_info_round_trips_nside():
    """A HEALPix ``DatasetInfo``'s state goes from either package to the
    other and back to the same grid."""
    info = DatasetInfo(horizontal_coordinates=HEALPixCoordinates.from_nside(
        8), timestep=timedelta(hours=6))
    state = info.get_state()
    jinfo = JaxDatasetInfo.from_state(state)
    assert jinfo.get_state() == state
    back = DatasetInfo.from_state(jinfo.get_state())
    assert back.horizontal_coordinates == info.horizontal_coordinates
    assert back.img_shape == (12, 8, 8)
    assert isinstance(back.gridded_operations, HEALPixOperations)
    assert back.gridded_operations.get_state() == (
        jinfo.gridded_operations.get_state())


def _healpix_files(directory, nside=4, n_time=6, names=("ta", "tb")):
    rng = np.random.RandomState(0)
    directory.mkdir()
    arrays = {k: rng.randn(n_time, 12, nside, nside).astype(np.float32)
              for k in names}
    arrays["mask_0"] = (rng.rand(12, nside, nside) > 0.3).astype(np.float32)
    dims = {k: ("time", "face", "height", "width") for k in names}
    dims["mask_0"] = ("face", "height", "width")
    write_h5(str(directory / "d.nc"), arrays, dims,
             coords={"face": np.arange(12.0), "height": np.arange(
                 float(nside)), "width": np.arange(float(nside))},
             time=TimeCoord.from_range("2000-01-01T00:00", n_time, 21600))
    return str(directory)


def test_dataset_reads_healpix_files_as_ace_tpu_does(tmp_path):
    """A store on (face, height, width) dims: HEALPix coordinates, windows
    of time-varying, static and derived x, y, z fields equal to
    ``ace_tpu``'s, and the dataset info's state."""
    path = _healpix_files(tmp_path / "data")
    ds = from_dict(XarrayDataConfig, {"data_path": path}).build()
    jds = jax_from_dict(JaxXarrayDataConfig, {"data_path": path}).build()
    assert isinstance(ds.horizontal_coordinates, HEALPixCoordinates)
    names = ["ta", "tb", "mask_0", "x", "y", "z"]
    window, time = ds.get_window(1, 3, names)
    jwindow, jtime = jds.get_window(1, 3, names)
    for k in names:
        assert window[k].shape == (3, 12, 4, 4)
        np.testing.assert_array_equal(window[k], jwindow[k])
    np.testing.assert_array_equal(time.values, jtime.values)
    assert ds.dataset_info.get_state() == jds.dataset_info.get_state()


FLAGS = {"log_spectra": True, "log_zonal_mean_images": True,
         "log_histograms": True, "log_global_mean_norm_time_series": False}


def test_inference_aggregators_on_healpix_match_ace_tpu():
    """The multiplexer on HEALPix windows with the spectrum on (the
    grid's SHT, no flood fill) and the zonal mean gated off: the same log
    keys and values within 1e-5."""
    nside, n_time = 4, 3
    jinfo = JaxDatasetInfo(horizontal_coordinates=JaxHEALPix.from_nside(
        nside))
    info = DatasetInfo(horizontal_coordinates=HEALPixCoordinates.from_nside(
        nside))
    ref = jax_from_dict(JaxAggregatorConfig, FLAGS).build(
        jinfo, n_timesteps=2 * n_time)
    out = from_dict(InferenceAggregatorConfig, FLAGS).build(
        info, n_timesteps=2 * n_time)
    for w in range(2):
        gen = {k: _draw((2, n_time, 12, nside, nside), seed=10 * w + i)
               + 280.0 for i, k in enumerate(["a", "b"])}
        tgt = {k: v + _draw(v.shape, seed=99 + w) for k, v in gen.items()}
        ref.record_batch({k: jnp.asarray(v) for k, v in gen.items()},
                         {k: jnp.asarray(v) for k, v in tgt.items()})
        out.record_batch({k: torch.from_numpy(v) for k, v in gen.items()},
                         {k: torch.from_numpy(v) for k, v in tgt.items()})
    logs, ref_logs = out.get_logs(), ref.get_logs()
    assert set(logs) == set(ref_logs)
    assert any(k.startswith("spectrum/") for k in logs)
    assert not any(k.startswith("zonal_mean") for k in logs)
    for k, r in ref_logs.items():
        np.testing.assert_allclose(logs[k], r, rtol=1e-5,
                                   atol=1e-5 * max(abs(r), 1.0), err_msg=k)


# the ensemble-loss step: a HEALPixUNet of 1x1 blocks (no pads: the
# transforms and the loss are under test)
NSIDE, B, E = 4, 2, 2
STEP_NAMES = ["a", "b", "forcing"]
LOSS = {"type": "EnsembleLoss",
        "kwargs": {"crps_weight": 0.8, "energy_score_weight": 0.2}}
UNET = {"encoder": {"conv_block": {"block_type": "ConvNeXtBlock",
                                   "kernel_size": 1,
                                   "activation": {"cap_value": 10}},
                    "down_sampling_block": {"block_type": "AvgPool"},
                    "n_channels": [8, 8], "n_layers": [1, 1]},
        "decoder": {"conv_block": {"block_type": "ConvNeXtBlock",
                                   "kernel_size": 1},
                    "up_sampling_block": {
                        "block_type": "TransposedConvUpsample"},
                    "output_layer": {"block_type": "BasicConvBlock",
                                     "kernel_size": 1},
                    "n_channels": [8, 8], "n_layers": [1, 1]}}


def _step_config():
    return {"type": "single_module", "config": {
        "builder": {"type": "HEALPixUNet", "config": UNET},
        "in_names": STEP_NAMES, "out_names": ["a", "b"],
        "normalization": {"network": {
            "means": {k: 0.1 for k in STEP_NAMES},
            "stds": {k: 1.5 for k in STEP_NAMES}}}}}


def test_ensemble_loss_step_on_healpix_matches_ace_tpu():
    """``TrainStepper`` with the ensemble loss on HEALPix data: the energy
    score runs over ``get_real_sht``'s coefficients on both sides; the
    loss within 1e-4 and each gradient within 1e-4 of its norm."""
    jinfo = JaxDatasetInfo(horizontal_coordinates=JaxHEALPix.from_nside(
        NSIDE), timestep=timedelta(hours=6))
    info = DatasetInfo(horizontal_coordinates=HEALPixCoordinates.from_nside(
        NSIDE), timestep=timedelta(hours=6))
    ts = TrainStepper(
        StepperConfig(step=from_dict(StepSelector, _step_config())
                      ).get_stepper(info, device="cpu"),
        StepperTrainConfig(loss=from_dict(StepLossConfig, LOSS),
                           n_forward_steps=1, n_ensemble=E),
        OptimizationConfig(lr=1e-4, optimizer_type="AdamW"), EMAConfig())
    ts.init(torch.Generator().manual_seed(0))
    jts = JaxTrainStepper(
        JaxStepperConfig(step=jax_from_dict(JaxStepSelector, _step_config())
                         ).get_stepper(jinfo),
        JaxTrainConfig(loss=jax_from_dict(JaxStepLossConfig, LOSS),
                       n_forward_steps=1, n_ensemble=E),
        JaxOptConfig(lr=1e-4, optimizer_type="AdamW"), JaxEMAConfig())
    params = {"params": state_dict_to_flax_params(
        ts.stepper.module.state_dict())}
    batch = {k: _draw((B, 2, 12, NSIDE, NSIDE), seed=i)
             for i, k in enumerate(STEP_NAMES)}
    (ref_loss, _), ref_grads = jax.jit(
        jax.value_and_grad(jts.loss_fn, has_aux=True), static_argnums=3)(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(1), 1)
    loss, grads = flagship.train_gradients(
        ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
    flat = state_dict_to_flax_params(grads)
    ref = jax.tree_util.tree_map(np.asarray, ref_grads)["params"]
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert len(leaves) == len(grads)
    for path, r in leaves:
        node = flat
        for p in path:
            node = node[p.key]
        assert np.linalg.norm(node - r) <= 1e-4 * np.linalg.norm(r), path
