"""The port's ocean and ice correctors and the corrector registry
(``ace_tpu_torch/core/corrector/{ocean,ice,registry}.py``) against
``ace_tpu``'s on the same inputs: the cases of tests/test_ocean_corrector.py
(sea-ice fraction, force-positive, the heat-content budget, each hfds
method, the ice budget), each corrected field and delta within 1e-6 of
its largest value (float32 on both sides, the same operations), the
gradients through ``keep_gradient_through_clamps`` against ``jax.grad``
(exact zeros where ``stop_gradient`` cuts), and the registry's dispatch
to each family through the single-module step."""

from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.core.config import from_dict as jax_from_dict
from ace_tpu.core.coordinates import DepthCoordinate as JaxDepth
from ace_tpu.core.corrector.ice import IceBudgetCorrectionConfig as JaxIce
from ace_tpu.core.corrector.registry import (
    CorrectorSelector as JaxCorrectorSelector,
)
from ace_tpu.core.gridded_ops import LatLonOperations as JaxOps
from ace_tpu.core.ocean_data import OceanData as JaxOceanData
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.coordinates import DepthCoordinate
from ace_tpu_torch.core.corrector.atmosphere import AtmosphereCorrector
from ace_tpu_torch.core.corrector.ice import (
    IceBudgetCorrectionConfig,
    IceCorrector,
)
from ace_tpu_torch.core.corrector.ocean import OceanCorrector
from ace_tpu_torch.core.corrector.registry import CorrectorSelector
from ace_tpu_torch.core.gridded_ops import LatLonOperations
from ace_tpu_torch.core.metrics import spherical_area_weights
from ace_tpu_torch.core.ocean_data import OceanData
from ace_tpu_torch.core.stacker import Stacker, natural_sort

NLAT, NLON, NZ = 6, 12, 2
TIMESTEP = timedelta(days=5)
TOL = 1e-6


def _weights():
    return spherical_area_weights(np.linspace(-60, 60, NLAT), NLON)


def _depth(cls, mask=None):
    mask = np.ones((NLAT, NLON, NZ), np.float32) if mask is None else mask
    return cls(idepth=np.asarray([0.0, 10.0, 50.0]), mask=mask)


def _data(seed, batch=2):
    """tests/test_ocean_corrector.py's inputs, as numpy."""
    rng = np.random.RandomState(seed)
    shape = (batch, NLAT, NLON)
    data = {
        "sst": 275.0 + 2 * rng.randn(*shape),
        "sea_ice_fraction": rng.uniform(-0.3, 1.3, shape),
        "land_fraction": rng.uniform(0, 0.3, shape),
        "hfds": 10.0 * rng.randn(*shape),
        "sea_surface_fraction": rng.uniform(0.7, 1.0, shape),
        "HI": np.abs(rng.randn(*shape)) - 0.2,
        "LHTFLsfc": 50 + 5 * rng.randn(*shape),
        "SHTFLsfc": 20 + 2 * rng.randn(*shape),
        "PRATEsfc": np.abs(1e-4 * rng.randn(*shape)),
        "DSWRFsfc": 300 + 10 * rng.randn(*shape),
        "USWRFsfc": 50 + 5 * rng.randn(*shape),
        "DLWRFsfc": 300 + 10 * rng.randn(*shape),
        "ULWRFsfc": 350 + 10 * rng.randn(*shape),
    }
    for k in range(NZ):
        data[f"thetao_{k}"] = 278.0 + 2 * rng.randn(*shape)
    return {k: v.astype(np.float32) for k, v in data.items()}


def _correctors(config):
    selector = {"type": "ocean_corrector", "config": config}
    jax_corrector = jax_from_dict(JaxCorrectorSelector, selector).instance.build(
        JaxOps(_weights()), _depth(JaxDepth), TIMESTEP)
    corrector = from_dict(CorrectorSelector, selector).instance.build(
        LatLonOperations(_weights()), _depth(DepthCoordinate), TIMESTEP)
    return jax_corrector, corrector


def _assert_close(got: dict, ref: dict, fields=None):
    """Within ``TOL`` of each value's largest size, or (a delta) of its
    field's in ``fields``: a delta is a difference of float32 fields and
    keeps their rounding."""
    assert set(got) == set(ref)
    for k, r in ref.items():
        r = np.asarray(r, np.float64)
        g = got[k].detach().double().numpy()
        scale = max(np.abs(r).max(), 1e-30)
        if fields is not None:
            scale = max(scale, np.abs(fields[k]).max())
        assert np.abs(g - r).max() <= TOL * scale, k


SEA_ICE = {"sea_ice_fraction_name": "sea_ice_fraction",
           "land_fraction_name": "land_fraction",
           "zero_where_ice_free_names": ["HI"]}
CASES = {
    "sea_ice_fraction": {"sea_ice_fraction_correction": SEA_ICE},
    "sea_ice_keep_ocean_fraction": {"sea_ice_fraction_correction": {
        **SEA_ICE, "remove_negative_ocean_fraction": False}},
    "force_positive": {"force_positive_names": ["HI", "sea_ice_fraction"]},
    "ocean_heat_content": {"ocean_heat_content_correction": {
        "method": "scaled_temperature",
        "constant_unaccounted_heating": 0.5}},
    "hfds_residual_prediction": {"surface_energy_flux_correction": {
        "method": "residual_prediction"}},
    "hfds_prescribed": {"surface_energy_flux_correction": {
        "method": "prescribed"}},
    "all": {"force_positive_names": ["HI"],
            "sea_ice_fraction_correction": SEA_ICE,
            "surface_energy_flux_correction": {"method": "prescribed"},
            "ocean_heat_content_correction": {
                "method": "scaled_temperature"}},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ocean_corrector_matches_ace_tpu(case):
    """Each correction, alone and all together: the corrected fields and
    the deltas."""
    jax_corrector, corrector = _correctors(CASES[case])
    assert isinstance(corrector, OceanCorrector)
    inputs, gen = _data(1), _data(2)
    # the generated hfds (the budget refuses one in the forcing too)
    forcing = {k: v for k, v in inputs.items() if k != "hfds"}

    def run(c, convert):
        return c(*(convert(d) for d in (inputs, gen, forcing)), {})

    ref = run(jax_corrector, lambda d: {k: jnp.asarray(v)
                                        for k, v in d.items()})
    out = run(corrector, lambda d: {k: torch.from_numpy(v)
                                    for k, v in d.items()})
    _assert_close(out.corrected, ref.corrected)
    _assert_close(out.delta, ref.delta, gen)


def test_heat_content_is_conserved():
    """tests/test_ocean_corrector.py's budget: after the correction the
    global heat content is the input's plus the net flux over the step."""
    _, corrector = _correctors(CASES["ocean_heat_content"])
    inputs = {k: torch.from_numpy(v) for k, v in _data(1).items()}
    gen = {k: torch.from_numpy(v) for k, v in _data(2).items()}
    out = corrector(inputs, gen, {k: v for k, v in inputs.items()
                                  if k != "hfds"}, {})
    ops, depth = LatLonOperations(_weights()), _depth(DepthCoordinate)
    ohc = ops.area_weighted_mean(
        OceanData(out.corrected, depth).ocean_heat_content).double()
    before = ops.area_weighted_mean(
        OceanData(inputs, depth).ocean_heat_content).double()
    flux = ops.area_weighted_mean(out.corrected["hfds"]
                                  * inputs["sea_surface_fraction"]).double()
    expected = before + (flux + 0.5) * TIMESTEP.total_seconds()
    torch.testing.assert_close(ohc, expected, rtol=1e-4, atol=0)


def _dry_mask():
    mask = np.ones((NLAT, NLON, NZ), np.float32)
    mask[:2, :3, :] = 0  # dry columns
    mask[2:4, :, 1] = 0  # a shallow floor
    return mask


def test_ocean_data_and_depth_integral_match_ace_tpu():
    """``OceanData``'s stacked temperatures and heat content (the depth
    integral over wet layers, NaN in dry columns), ``Stacker`` and
    ``natural_sort`` as ``ace_tpu``'s."""
    data = _data(3)
    mask = _dry_mask()
    ref = JaxOceanData({k: jnp.asarray(v) for k, v in data.items()},
                       _depth(JaxDepth, mask)).ocean_heat_content
    got = OceanData({k: torch.from_numpy(v) for k, v in data.items()},
                    _depth(DepthCoordinate, mask)).ocean_heat_content
    ref = np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    names = ["so_10", "so_2", "so_0", "so_1", "so_3", "so_4", "so_5", "so_6",
             "so_7", "so_8", "so_9", "sst"]
    assert natural_sort(names)[:3] == ["sst", "so_0", "so_1"]
    stacker = Stacker({"salinity": ["so_"]})
    stacked = stacker("salinity", {n: torch.full((2,), float(i))
                                   for i, n in enumerate(names)})
    assert stacked.shape == (2, 11)
    assert stacker.get_all_level_names("salinity", dict.fromkeys(names))[
        -1] == "so_10"
    with pytest.raises(ValueError, match="missing vertical levels"):
        stacker("salinity", {"so_0": 1, "so_2": 2})


@pytest.mark.parametrize("case", ["sea_ice_fraction", "force_positive"])
def test_keep_gradient_matches_jax_grad(case):
    """With ``keep_gradient_through_clamps`` each clamp passes the
    identity's gradient, and ``zero_where_ice_free_names`` its product's:
    the gradient of a weighted sum of the corrected fields against
    ``jax.grad``, with exact zeros where ``ace_tpu``'s ``stop_gradient``
    cuts."""
    config = {**CASES[case], "keep_gradient_through_clamps": True}
    jax_corrector, corrector = _correctors(config)
    inputs, gen = _data(4), _data(5)
    names = ["HI", "sea_ice_fraction"]
    rng = np.random.RandomState(6)
    weights = {k: rng.randn(*gen[k].shape).astype(np.float32)
               for k in names}

    def jax_loss(x):
        g = {**{k: jnp.asarray(v) for k, v in gen.items()}, **x}
        out = jax_corrector({k: jnp.asarray(v) for k, v in inputs.items()},
                            g, {}, {}).corrected
        return sum(jnp.sum(out[k] * weights[k]) for k in names)

    ref = jax.grad(jax_loss)({k: jnp.asarray(gen[k]) for k in names})
    x = {k: torch.from_numpy(gen[k]).requires_grad_() for k in names}
    out = corrector({k: torch.from_numpy(v) for k, v in inputs.items()},
                    {**{k: torch.from_numpy(v) for k, v in gen.items()}, **x},
                    {}, {}).corrected
    sum((out[k] * torch.from_numpy(weights[k])).sum() for k in names
        ).backward()
    for k in names:
        r = np.asarray(ref[k])
        g = x[k].grad.numpy()
        np.testing.assert_array_equal(g == 0, r == 0)
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=0)


def _ice_inputs(seed):
    rng = np.random.RandomState(seed)
    dt = TIMESTEP.total_seconds()
    shape = (2, 4, 8)
    gen = {}
    for var in ("simass", "siconc", "sisnmass"):
        gen[f"{var}_src"] = np.abs(rng.randn(*shape)) / dt
        gen[f"{var}_snk"] = -np.abs(rng.randn(*shape)) / dt
        gen[f"{var}_xprt"] = rng.randn(*shape) / dt
    old = {"simass": rng.uniform(0, 2, shape), "siconc": rng.uniform(0, 1, shape),
           "sisnmass": rng.uniform(0, 0.5, shape)}
    return ({k: v.astype(np.float32) for k, v in gen.items()},
            {k: v.astype(np.float32) for k, v in old.items()})


@pytest.mark.parametrize("variables", [
    ("siconc",), ("simass", "siconc"), ("simass", "siconc", "sisnmass")],
    ids=["siconc", "mass-and-concentration", "all"])
def test_ice_budget_correction_matches_ace_tpu(variables):
    """The budget correction of one, two and three variables (the later
    ones masked by the first's ice): every modified field."""
    corrected = {v: [f"{v}_src", f"{v}_snk", f"{v}_xprt"] for v in variables}
    gen, old = _ice_inputs(7)
    dt = TIMESTEP.total_seconds()
    ref = JaxIce(corrected_variables=corrected)(
        {k: jnp.asarray(v) for k, v in gen.items()},
        {k: jnp.asarray(v) for k, v in old.items()}, timestep=dt)
    out = IceBudgetCorrectionConfig(corrected_variables=corrected)(
        {k: torch.from_numpy(v) for k, v in gen.items()},
        {k: torch.from_numpy(v) for k, v in old.items()}, timestep=dt)
    assert set(out) == set(ref)
    for k, r in ref.items():
        r = np.asarray(r, np.float64)
        scale = max(np.abs(r).max(), 1e-30)
        assert np.abs(out[k].double().numpy() - r).max() <= TOL * scale, k
    for v in variables:
        assert float(out[v].min()) >= 0.0
        if v == "siconc":
            assert float(out[v].max()) <= 1.0


def test_ice_budget_rebalance_leaves_violation_free_cells_untouched():
    """tests/test_ocean_corrector.py's case: a cell without a violation
    passes through unchanged even with a positive sink; a violating cell
    ends at zero mass with the sign constraints held."""
    dt = 6 * 3600.0
    cfg = IceBudgetCorrectionConfig(
        corrected_variables={"siconc": ["src", "snk", "xprt"]})
    out = cfg({"src": torch.tensor([[[-0.05, 0.0]]]) / dt,
               "snk": torch.tensor([[[0.02, -0.9]]]) / dt,
               "xprt": torch.tensor([[[0.1, 0.1]]]) / dt},
              {"siconc": torch.tensor([[[0.5, 0.5]]])}, timestep=dt)
    torch.testing.assert_close(out["snk"][0, 0, 0] * dt, torch.tensor(0.02))
    torch.testing.assert_close(out["src"][0, 0, 0] * dt, torch.tensor(-0.05))
    assert abs(float(out["siconc"][0, 0, 1])) <= 1e-6
    assert float(out["src"][0, 0, 1]) >= -1e-9
    assert float(out["snk"][0, 0, 1]) <= 1e-9


@pytest.mark.parametrize("selector, cls, noop", [
    ({"type": "ocean_corrector", "config": CASES["all"]}, OceanCorrector,
     False),
    ({"type": "ocean_corrector", "config": {}}, None, True),
    ({"type": "ice_corrector", "config": {"budget_correction": {
        "corrected_variables": {"siconc": ["src", "snk", "xprt"]}}}},
     IceCorrector, False),
    ({"type": "atmosphere_corrector", "config": {
        "force_positive_names": ["siconc"]}}, AtmosphereCorrector, False),
], ids=["ocean", "ocean-noop", "ice", "atmosphere"])
def test_registry_dispatches_through_the_step(selector, cls, noop):
    """A ``{type, config}`` corrector in the single-module step builds the
    family's corrector (nothing for a no-op config), as ``ace_tpu``'s
    registry does; epoch-scheduled disabling reads through the
    selector."""
    import datetime

    from ace_tpu_torch.core.coordinates import LatLonCoordinates
    from ace_tpu_torch.core.dataset_info import DatasetInfo
    from ace_tpu_torch.core.step.single_module import SingleModuleStepConfig

    names = ["siconc", "src", "snk", "xprt", "HI", "sea_ice_fraction",
             "land_fraction", "sst", "hfds", "sea_surface_fraction"]
    config = from_dict(SingleModuleStepConfig, {
        "builder": {"type": "Linear", "config": {}},
        "in_names": names, "out_names": names,
        "normalization": {"network": {"means": dict.fromkeys(names, 0.0),
                                      "stds": dict.fromkeys(names, 1.0)}},
        "corrector": {**selector, "config": {
            **selector["config"], "corrector_disabled_epochs": 2}},
    })
    assert isinstance(config.corrector, CorrectorSelector)
    assert config.corrector.is_noop == noop
    assert config.corrector.corrector_disabled_epochs == 2
    info = DatasetInfo(
        horizontal_coordinates=LatLonCoordinates(
            lat=np.linspace(-60, 60, NLAT), lon=np.linspace(0, 360, NLON)),
        vertical_coordinate=_depth(DepthCoordinate),
        timestep=datetime.timedelta(days=5))
    step = config.get_step(info, device="cpu")
    if noop:
        assert step.corrector is None
    else:
        assert type(step.corrector) is cls
    jax_selector = jax_from_dict(JaxCorrectorSelector, selector)
    assert jax_selector.is_noop == noop
    assert config.get_state()["corrector"]["type"] == selector["type"]
