"""The port's losses against ace_tpu.core.loss, in float32 on the same
inputs (made with numpy), on a 16x32 Gauss grid. Float32 on both sides
with sums in another order: within 1e-6 of the largest value, except where
ace_tpu's own area-weighted mean is further off (``AREA_TOL``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.core import loss as jl
from ace_tpu.core.gridded_ops import LatLonOperations as JaxLatLonOperations
from ace_tpu.core.normalizer import StandardNormalizer as JaxNormalizer
from ace_tpu.ops.sht import RealSHT as JaxRealSHT
from ace_tpu_torch.core import loss as tl
from ace_tpu_torch.core.coordinates import gaussian_latitudes
from ace_tpu_torch.core.gridded_ops import LatLonOperations
from ace_tpu_torch.core.metrics import spherical_area_weights
from ace_tpu_torch.core.normalizer import StandardNormalizer
from ace_tpu_torch.ops.sht import RealSHT

torch.set_num_threads(2)

NLAT, NLON, B, E, C = 16, 32, 2, 2, 3
TOL = 1e-6
# ace_tpu's area-weighted mean sums its 512 points in float32 on the CPU in
# an order that leaves it 2.4e-6 to 3.5e-6 of the value off a float64
# evaluation on these inputs; the port's is within 2e-7 of it (asserted in
# test_elementwise_losses_match_ace_tpu)
AREA_TOL = 5e-6


def _close(out, ref, tol=TOL):
    ref = np.asarray(ref, np.float64)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    np.testing.assert_allclose(np.asarray(out, np.float64), ref, rtol=tol,
                               atol=tol * scale)


def _arrays(*shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _ops():
    weights = spherical_area_weights(gaussian_latitudes(NLAT), NLON)
    return JaxLatLonOperations(weights), LatLonOperations(weights)


def _shts():
    return (JaxRealSHT(NLAT, NLON, channels_last=True),
            tl.complex_sht(RealSHT(NLAT, NLON, device="cpu")))


def _both(fn_j, fn_t, *arrays):
    return (fn_j(*(jnp.asarray(a) for a in arrays)),
            fn_t(*(torch.from_numpy(a) for a in arrays)))


@pytest.mark.parametrize("name", ["mse", "l1", "area_mse", "lp", "global_mean"])
def test_elementwise_losses_match_ace_tpu(name):
    ops_j, ops_t = _ops()
    losses = {
        "mse": (jl.MSELoss(), tl.MSELoss()),
        "l1": (jl.L1Loss(), tl.L1Loss()),
        "area_mse": (
            jl.AreaWeightedMSELoss(ops_j.area_weighted_mean_channels_last),
            tl.AreaWeightedMSELoss(ops_t.area_weighted_mean_channels_last)),
        "lp": (jl.LpLoss(p=2), tl.LpLoss(p=2)),
        "global_mean": (
            jl.GlobalMeanLoss(ops_j.area_weighted_mean_channels_last,
                              jl.LpLoss()),
            tl.GlobalMeanLoss(ops_t.area_weighted_mean_channels_last,
                              tl.LpLoss())),
    }
    x, y = _arrays((B, NLAT, NLON, C), (B, NLAT, NLON, C))
    ref, out = _both(*losses[name], x, y)
    assert out.shape == (B, C)
    if name == "area_mse":
        w = ops_t.area_weights("cpu").double().numpy()[None, :, :, None]
        exact = ((x.astype(np.float64) - y) ** 2 * w).sum((1, 2)) / w.sum()
        _close(out, exact, tol=2e-7)
        _close(out, ref, tol=AREA_TOL)
    else:
        _close(out, ref)


@pytest.mark.parametrize("n_ens", [1, 2, 3])
@pytest.mark.parametrize("alpha", [1.0, 0.95])
def test_crps_matches_ace_tpu(n_ens, alpha):
    gen, target = _arrays((B, n_ens, NLAT, NLON, C), (B, 1, NLAT, NLON, C))
    ref, out = _both(lambda g, t: jl.get_crps(g, t, alpha),
                     lambda g, t: tl.get_crps(g, t, alpha), gen, target)
    _close(out, ref)
    ref, out = _both(jl.CRPSLoss(alpha), tl.CRPSLoss(alpha), gen, target)
    _close(out, ref)


@pytest.mark.parametrize("levels, shape", [(1, (NLAT, NLON)), (2, (NLAT, NLON)),
                                           (3, (15, 30))])
def test_finite_difference_crps_matches_ace_tpu(levels, shape):
    gen, target = _arrays((B, E, *shape, C), (B, 1, *shape, C))
    ref, out = _both(jl.FiniteDifferenceCRPSLoss(0.95, levels),
                     tl.FiniteDifferenceCRPSLoss(0.95, levels), gen, target)
    _close(out, ref)


def test_energy_score_matches_ace_tpu():
    gr, gi, tr, ti = _arrays((B, E, 8, 5, C), (B, E, 8, 5, C),
                             (B, 1, 8, 5, C), (B, 1, 8, 5, C))
    ref = jl.get_energy_score(jnp.asarray(gr + 1j * gi),
                              jnp.asarray(tr + 1j * ti))
    out = tl.get_energy_score(torch.complex(*map(torch.from_numpy, (gr, gi))),
                              torch.complex(*map(torch.from_numpy, (tr, ti))))
    _close(out, ref)


@pytest.mark.parametrize("whitening", [None, {"kind": "per_sample"},
                                       {"kind": "per_sample", "eps_frac": 0.1,
                                        "exponent": 1.0}])
def test_energy_score_loss_matches_ace_tpu(whitening):
    sht_j, sht_t = _shts()
    wj = wt = None
    if whitening is not None:
        wj = jl.SpectralWhiteningConfig(**whitening).build()
        wt = tl.SpectralWhiteningConfig(**whitening).build()
    x, y = _arrays((B, E, NLAT, NLON, C), (B, 1, NLAT, NLON, C))
    ref, out = _both(jl.EnergyScoreLoss(sht_j, wj),
                     tl.EnergyScoreLoss(sht_t, wt), x, y)
    assert out.shape == (B, C)
    _close(out, ref)


def test_energy_score_gradient_at_zero_coefficients_matches_jax():
    """The l < m triangle of both transforms is exactly zero, and so are
    the differences there: the gradient of |z| at 0 is 0 in both (not
    NaN, as sqrt(r² + i²) would give)."""
    sht_j, sht_t = _shts()
    x, y = _arrays((B, E, NLAT, NLON, C), (B, 1, NLAT, NLON, C))
    # the members agree on one channel: a zero difference everywhere
    x[:, 1, ..., 0] = x[:, 0, ..., 0]
    loss_j = jl.EnergyScoreLoss(sht_j)
    ref = jax.grad(lambda a: jnp.sum(loss_j(a, jnp.asarray(y))))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tl.EnergyScoreLoss(sht_t)(xt, torch.from_numpy(y)).sum().backward()
    assert torch.isfinite(xt.grad).all()
    assert np.isfinite(np.asarray(ref)).all()
    _close(xt.grad, ref)


@pytest.mark.parametrize("fd_weight", [0.0, 0.5])
def test_ensemble_loss_matches_ace_tpu(fd_weight):
    sht_j, sht_t = _shts()
    kw = dict(crps_weight=0.9, energy_score_weight=0.1,
              finite_difference_crps_weight=fd_weight,
              finite_difference_crps_levels=2, almost_fair_crps_alpha=0.95)
    x, y = _arrays((B, E, NLAT, NLON, C), (B, 1, NLAT, NLON, C))
    ref, out = _both(jl.EnsembleLoss(sht=sht_j, **kw),
                     tl.EnsembleLoss(sht=sht_t, **kw), x, y)
    _close(out, ref)


NAMES = ["a", "b", "c"]
MEANS = {"a": 1.0, "b": -2.0, "c": 280.0}
STDS = {"a": 2.0, "b": 0.5, "c": 10.0}


def _mapping_inputs(ensemble):
    rng = np.random.RandomState(3)
    lead = (B, E) if ensemble else (B,)
    pred = {k: (rng.randn(*lead, NLAT, NLON) * STDS[k] + MEANS[k])
            .astype(np.float32) for k in NAMES}
    tlead = (B, 1) if ensemble else (B,)
    targ = {k: (rng.randn(*tlead, NLAT, NLON) * STDS[k] + MEANS[k])
            .astype(np.float32) for k in NAMES}
    targ["b"][0, ..., 3, 4] = np.nan  # NaN targets drop out of the loss
    return pred, targ


@pytest.mark.parametrize("loss_type", ["MSE", "AreaWeightedMSE", "LpLoss",
                                       "EnsembleLoss"])
@pytest.mark.parametrize("masked", [False, True])
def test_step_loss_matches_ace_tpu(loss_type, masked):
    """StepLossConfig.build end to end: normalize, NaN fill, variable
    weights, the inner loss, (masked) channel means, the step decay."""
    ops_j, ops_t = _ops()
    sht_j, sht_t = _shts()
    ensemble = loss_type == "EnsembleLoss"
    cfg = dict(type=loss_type, weights={"a": 2.0, "c": 0.5},
               sqrt_loss_step_decay_constant=0.3,
               global_mean_type=None if ensemble else "LpLoss",
               global_mean_weight=0.25,
               kwargs={"crps_weight": 0.9, "energy_score_weight": 0.1}
               if ensemble else {})
    loss_j = jl.StepLossConfig(**cfg).build(
        ops_j, NAMES, JaxNormalizer(MEANS, STDS), sht=sht_j)
    loss_t = tl.StepLossConfig(**cfg).build(
        ops_t, NAMES, StandardNormalizer(MEANS, STDS), sht=sht_t)
    pred, targ = _mapping_inputs(ensemble)
    mask = {"a": np.array([True, False]), "c": np.array([False, False])}
    ref = loss_j({k: jnp.asarray(v) for k, v in pred.items()},
                 {k: jnp.asarray(v) for k, v in targ.items()}, 2,
                 data_mask=({k: jnp.asarray(v) for k, v in mask.items()}
                            if masked else None))
    out = loss_t({k: torch.from_numpy(v) for k, v in pred.items()},
                 {k: torch.from_numpy(v) for k, v in targ.items()}, 2,
                 data_mask=({k: torch.from_numpy(v) for k, v in mask.items()}
                            if masked else None))
    tol = AREA_TOL if loss_type == "AreaWeightedMSE" else TOL
    _close(out.total, ref.total, tol)
    assert set(out.per_channel) == set(NAMES)
    for k in NAMES:
        _close(out.per_channel[k], ref.per_channel[k], tol)


@pytest.mark.parametrize("loss_type", ["L1", "NaN"])
def test_loss_config_types_match_ace_tpu(loss_type):
    ops_j, ops_t = _ops()
    x, y = _arrays((B, NLAT, NLON, C), (B, NLAT, NLON, C))
    ref, out = _both(jl.LossConfig(type=loss_type).build(ops_j),
                     tl.LossConfig(type=loss_type).build(ops_t), x, y)
    np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(ref))
    if loss_type != "NaN":
        _close(out, ref)


def test_config_validation_matches_ace_tpu():
    with pytest.raises(ValueError):
        tl.SpectralWhiteningConfig(kind="none", exponent=0.5)
    with pytest.raises(ValueError):
        tl.SpectralWhiteningConfig(kind="per_sample", exponent=1.5)
    with pytest.raises(ValueError):
        tl.EnsembleLoss(0.0, 0.0, sht=None)
    with pytest.raises(NotImplementedError):
        tl.get_energy_score(torch.zeros(1, 3, 2, 2, 1, dtype=torch.complex64),
                            torch.zeros(1, 1, 2, 2, 1, dtype=torch.complex64))
    with pytest.raises(ValueError, match="SHT"):
        tl.LossConfig(type="EnsembleLoss").build(None)
    assert tl.StepLossConfig(type="EnsembleLoss").is_ensemble_loss
