"""The port's coupled stepper (``ace_tpu_torch/coupled/stepper.py``) and
the coupled loss (``ace_tpu_torch/coupled/train.py``) against
``ace_tpu/coupled/``, float32 on the CPU.

- The name partition and the validation rules, case for case with
  ``tests/test_coupled.py`` (``Linear`` steps on both sides: the same
  names, the same errors with the same messages).
- The exchange with echo networks (a step that copies an input channel
  to an output): the ocean's SST prescribed onto the atmosphere's initial
  condition at every outer step, the fluxes averaged over the inner
  window, the predicted ocean fraction.
- A small coupled system of the CM4 coupled YAML's shape
  (``chip_smoke.coupled_stepper_dicts``: the SFNO at embed 32 with 2
  layers, Samudra at widths 16-32 over 3 levels, 16x32, 4 atmosphere steps
  an ocean step, 2 ocean steps, the ocean fraction predicted, NaN on the
  ocean's dry cells) from the same weights and inputs: the first
  atmosphere step within 1e-5 of each variable's largest value, both
  components' outputs over the rollout within ``ROLLOUT_TOL`` of it, NaN
  on the same cells (the moisture budget's precipitation and advection
  tendency within ``BUDGET_TOL``, 1e-3: ``ace_tpu``'s float32 global
  means, ROADMAP Queue 3), and the masking of ocean fields.
- The coupled training loss and every gradient against
  ``jax.value_and_grad(CoupledTrainer.loss_fn)`` within 1e-4 (relative;
  each gradient's norm, plus 1e-6 of the largest for the biases an
  instance norm removes), over the train YAML cut small on one file per
  component: the recipe (the atmosphere frozen, so without
  ``max_grad_norm`` the port computes no atmosphere gradient), the recipe
  with ``max_grad_norm`` (the frozen atmosphere's gradients computed, as
  they enter the global norm), and a copy that trains both components
  with L2-SP on the ocean; each component step recomputed in the backward
  pass and, in one test, not: the gradients equal. The atmosphere's loss
  is held against ``ace_tpu`` by ``tests/test_torch_coupled_train.py``
  (the finetune YAML)."""

import copy
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ace_tpu.core.config import from_dict as jax_from_dict
from ace_tpu.core.coordinates import LatLonCoordinates as JaxLatLon
from ace_tpu.core.coordinates import gaussian_latitudes
from ace_tpu.core.dataset_info import DatasetInfo as JaxDatasetInfo
from ace_tpu.coupled import stepper as jax_stepper
from ace_tpu.coupled.train import CoupledTrainConfig as JaxTrainConfig
from ace_tpu.coupled.train import CoupledTrainer as JaxTrainer
from ace_tpu.stepper.stepper import PrognosticState as JaxPrognosticState
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.coordinates import LatLonCoordinates
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.optimization import global_norm
from ace_tpu_torch.coupled import stepper as port_stepper
from ace_tpu_torch.coupled.train import CoupledTrainConfig, CoupledTrainer
from ace_tpu_torch.models.registry import register_prebuilt_module
from ace_tpu_torch.stepper.stepper import PrognosticState
from ace_tpu_torch.utils.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_variables,
)
from tests.test_torch_slab_ocean import BUDGET_NAMES, BUDGET_TOL

torch.set_num_threads(2)

PACKAGES = {"port": (port_stepper, from_dict, DatasetInfo, LatLonCoordinates),
            "ace_tpu": (jax_stepper, jax_from_dict, JaxDatasetInfo,
                        JaxLatLon)}
OUT_TOL = 1e-5
LOSS_TOL = 1e-4
GRAD_TOL = 1e-4


def _info(package, hours, nlat=8, nlon=16):
    _, _, info_cls, coords_cls = PACKAGES[package]
    return info_cls(
        horizontal_coordinates=coords_cls(
            lat=gaussian_latitudes(nlat),
            lon=np.linspace(0, 360, nlon, endpoint=False)),
        timestep=timedelta(hours=hours))


def _step(in_names, out_names, ocean=None, next_step_forcing_names=None,
          builder=None):
    names = sorted(set(in_names) | set(out_names))
    cfg = {
        "builder": builder or {"type": "Linear", "config": {}},
        "in_names": in_names,
        "out_names": out_names,
        "normalization": {"network": {
            "means": {n: 0.0 for n in names},
            "stds": {n: 1.0 for n in names}}},
    }
    if next_step_forcing_names:
        cfg["next_step_forcing_names"] = next_step_forcing_names
    if ocean is not None:
        cfg["ocean"] = ocean
    return {"step": {"type": "single_module", "config": cfg}}


OCEAN = {"surface_temperature_name": "surface_temperature",
         "ocean_fraction_name": "ocean_fraction"}


def _coupled(package, atmos, ocean, a_hours=6, o_hours=12, **fields):
    module, from_dict_, _, _ = PACKAGES[package]
    config = from_dict_(module.CoupledStepperConfig, {
        "atmosphere": {"stepper": atmos, "timedelta": fields.pop(
            "a_timedelta", None)},
        "ocean": {"stepper": ocean, "timedelta": fields.pop(
            "o_timedelta", None)},
        **fields})
    info = (_info(package, a_hours), _info(package, o_hours))
    if package == "port":
        return config.get_stepper(*info, device="cpu")
    return config.get_stepper(*info)


# (atmos_in, atmos_out, ocean_in, ocean_out) -> the expected partition
# (tests/test_coupled.py:FORCING_TEST_PARAMS; the configs add
# a_sfc_temp and frac to the atmosphere and o_sfc_temp to the ocean)
FORCING_TEST_PARAMS = [
    ((["a", "c"], ["a", "b"], ["a", "c"], ["c", "d"]),
     (["a", "b"], [], ["a"], ["c", "d"], [], ["c"])),
    ((["a", "c", "f"], ["a", "b"], ["a", "c"], ["c", "d"]),
     (["a", "b", "f"], ["f"], ["a"], ["c", "d"], [], ["c"])),
    ((["a", "c"], ["a", "b"], ["a", "c", "f"], ["c", "d"]),
     (["a", "b"], [], ["a"], ["c", "d", "f"], ["f"], ["c"])),
    ((["a", "c", "f"], ["a", "b"], ["b", "c", "f"], ["d"]),
     (["a", "b", "c", "f"], ["c", "f"], ["b"], ["d"], ["c", "f"], [])),
    ((["a", "c", "f"], ["a", "b"], ["b", "f"], ["d"]),
     (["a", "b", "c", "f"], ["c", "f"], ["b"], ["d"], ["f"], [])),
]
PARTITION = ("_atmosphere_forcing_exogenous_names",
             "_atmosphere_to_ocean_forcing_names",
             "_ocean_forcing_exogenous_names",
             "_ocean_to_atmosphere_forcing_names",
             "_shared_forcing_exogenous_names",
             "atmosphere_forcing_window_names", "ocean_forcing_window_names",
             "all_atmosphere_names", "all_ocean_names")


@pytest.mark.parametrize("names, expected", FORCING_TEST_PARAMS)
def test_name_partition_matches_ace_tpu(names, expected):
    """Every name set of the partition equals ``ace_tpu``'s and the
    expected table."""
    atmos_in, atmos_out, ocean_in, ocean_out = names
    all_atmos, atmos_exog, a2o, all_ocean, ocean_exog, o2a = expected
    built = {
        package: _coupled(
            package,
            _step(atmos_in + ["a_sfc_temp", "frac"],
                  atmos_out + ["a_sfc_temp"],
                  ocean={"surface_temperature_name": "a_sfc_temp",
                         "ocean_fraction_name": "frac"}),
            _step(ocean_in + ["o_sfc_temp"], ocean_out + ["o_sfc_temp"],
                  next_step_forcing_names=a2o),
            sst_name="o_sfc_temp")
        for package in PACKAGES}
    port = built["port"]
    for name in PARTITION:
        assert sorted(getattr(port, name)) == sorted(
            getattr(built["ace_tpu"], name)), name
    assert sorted(port._atmosphere_forcing_exogenous_names) == sorted(
        atmos_exog + ["frac"])
    assert port._atmosphere_to_ocean_forcing_names == sorted(a2o)
    assert port._ocean_forcing_exogenous_names == sorted(ocean_exog)
    assert port._ocean_to_atmosphere_forcing_names == sorted(
        o2a + ["o_sfc_temp"])
    assert port.all_ocean_names == sorted(all_ocean + ["o_sfc_temp"])
    assert port.all_atmosphere_names == sorted(
        all_atmos + ["frac", "a_sfc_temp"])


ST = "surface_temperature"
VALIDATION_CASES = {
    "ocean config missing": (
        _step(["ta"], ["ta"]), _step(["sst"], ["sst"]), 6, 12, {},
        "'ocean' config is missing"),
    "overlapping outputs": (
        _step(["ta", ST], ["ta", ST, "dup"], ocean=OCEAN),
        _step(["sst", "dup"], ["sst", "dup"]), 6, 12, {}, "cannot overlap"),
    "ocean diagnostic as forcing": (
        _step(["ta", ST, "o_diag"], ["ta", ST], ocean=OCEAN),
        _step(["sst"], ["sst", "o_diag"]), 6, 12, {}, "diagnostic"),
    "atmosphere step longer": (
        _step(["ta", ST], ["ta", ST], ocean=OCEAN), _step(["sst"], ["sst"]),
        24, 12, {}, "must not be larger"),
    "timedelta against the data": (
        _step(["ta", ST], ["ta", ST], ocean=OCEAN), _step(["sst"], ["sst"]),
        12, 12, {"a_timedelta": "PT6H", "o_timedelta": "PT12H"},
        "does not match"),
    "not an integer ratio": (
        _step(["ta", ST], ["ta", "flux", ST], ocean=OCEAN),
        _step(["sst", "flux"], ["sst"], next_step_forcing_names=["flux"]),
        7, 12, {}, "integer multiple"),
    "flux not a next-step forcing": (
        _step(["ta", ST], ["ta", "flux", ST], ocean=OCEAN),
        _step(["sst", "flux"], ["sst"]), 6, 12, {}, "next_step_forcing"),
    "sst not an ocean output": (
        _step(["ta", ST], ["ta", ST], ocean=OCEAN),
        _step(["temp"], ["temp"]), 6, 12, {}, "not in the ocean's output"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION_CASES))
def test_validation_errors_match_ace_tpu(case):
    """Each incompatible pair raises ``ValueError`` in both packages with
    the same message."""
    atmos, ocean, a_hours, o_hours, fields, match = VALIDATION_CASES[case]
    messages = {}
    for package in PACKAGES:
        with pytest.raises(ValueError, match=match) as info:
            _coupled(package, atmos, ocean, a_hours, o_hours, **dict(fields))
        messages[package] = str(info.value)
    assert messages["port"] == messages["ace_tpu"]


@pytest.mark.parametrize("hours, timedeltas, n_inner", [
    ((6, 12), {}, 2),
    ((6, 12), {"a_timedelta": "PT6H", "o_timedelta": "PT12H"}, 2),
    ((6, 120), {"a_timedelta": "6h", "o_timedelta": "5D"}, 20),
])
def test_n_inner_steps_from_timedeltas(hours, timedeltas, n_inner):
    """The ratio of the components' steps, from the datasets or the
    configured timedeltas (pandas' durations, as in ``ace_tpu``)."""
    for package in PACKAGES:
        coupled = _coupled(
            package, _step(["ta", ST], ["ta", "flux", ST], ocean=OCEAN),
            _step(["sst", "flux"], ["sst"], next_step_forcing_names=["flux"]),
            *hours, **dict(timedeltas))
        assert coupled.n_inner_steps == n_inner
        assert coupled.surface_temperature_name == ST


class _Echo(torch.nn.Module):
    """Each output channel copies an input channel (zero where unmapped):
    what the coupled exchange fed a component shows in its outputs."""

    def __init__(self, in_names, out_names, copy_map):
        super().__init__()
        self.dummy = torch.nn.Parameter(torch.zeros(1))
        self.index = [None if copy_map.get(n) is None
                      else in_names.index(copy_map[n]) for n in out_names]

    def forward(self, x, noise=None, generator=None, deterministic=True):
        return torch.cat([torch.zeros_like(x[..., :1]) if i is None
                          else x[..., i:i + 1] for i in self.index], dim=-1)


def _echo(key, in_names, out_names, copy_map, **step):
    register_prebuilt_module(key, _Echo(in_names, out_names, copy_map))
    return _step(in_names, out_names, builder={
        "type": "prebuilt", "config": {"module_key": key}}, **step)


def _echo_rollout(atmos, ocean, atmos_forcing, n_outer, sea_ice=None,
                  **fields):
    coupled = _coupled("port", atmos, ocean, **fields)
    coupled.init_params()
    rng = np.random.RandomState(0)
    shape = (1, 1, 8, 16)

    def draw():
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    ocean_ic = {"sst": draw()}
    if sea_ice is not None:
        ocean_ic["sea_ice_fraction"] = sea_ice
    ic = port_stepper.CoupledPrognosticState(
        atmosphere_data=PrognosticState(data={"ta": draw(), ST: draw()}),
        ocean_data=PrognosticState(data=ocean_ic))
    a_out, o_out, final = coupled.predict(ic, atmos_forcing, {})
    return coupled, ic, a_out, o_out, final


def test_ic_sst_prescribed_every_outer_step():
    """The first inner step of EVERY outer step sees the current ocean SST
    as its input surface temperature (where the ocean fraction is 1): the
    atmosphere echoes it into ``flux``, the ocean echoes the averaged flux
    into its SST."""
    atmos = _echo("coupled_ic_sst_atmos", ["ta", ST], ["ta", "flux", ST],
                  {"flux": ST, "ta": "ta", ST: ST}, ocean=OCEAN)
    ocean = _echo("coupled_ic_sst_ocean", ["sst", "flux"], ["sst"],
                  {"sst": "flux"}, next_step_forcing_names=["flux"])
    n_inner, n_outer = 2, 2
    forcing = {"ocean_fraction": torch.ones(1, n_outer * n_inner + 1, 8, 16)}
    coupled, ic, a_out, o_out, final = _echo_rollout(atmos, ocean, forcing,
                                                     n_outer)
    assert coupled.n_inner_steps == n_inner
    assert a_out["ta"].shape == (1, n_outer * n_inner, 8, 16)
    assert o_out["sst"].shape == (1, n_outer, 8, 16)
    sst0 = ic.ocean_data.data["sst"][:, 0]
    torch.testing.assert_close(a_out["flux"][:, 0], sst0)
    torch.testing.assert_close(o_out["sst"][:, 0], sst0)
    torch.testing.assert_close(a_out["flux"][:, n_inner], o_out["sst"][:, 0])
    assert "sst" in final.ocean_data.data and "ta" in final.atmosphere_data.data


def test_flux_averaging_across_inner_steps():
    """The ocean receives the mean of the atmosphere's fluxes over the
    inner window (the atmosphere echoes a time-varying forcing into
    ``flux``, the ocean its flux forcing into its SST)."""
    atmos = _echo("coupled_flux_atmos", ["ta", ST, "src"], ["ta", "flux", ST],
                  {"flux": "src", "ta": "ta", ST: ST}, ocean=OCEAN)
    ocean = _echo("coupled_flux_ocean", ["sst", "flux"], ["sst"],
                  {"sst": "flux"}, next_step_forcing_names=["flux"])
    n_inner, n_outer = 2, 2
    src = torch.from_numpy(np.random.RandomState(1).randn(
        1, n_outer * n_inner + 1, 8, 16).astype(np.float32))
    forcing = {"ocean_fraction": torch.ones(1, n_outer * n_inner + 1, 8, 16),
               "src": src}
    _, _, a_out, o_out, _ = _echo_rollout(atmos, ocean, forcing, n_outer)
    for i in range(n_outer):
        window = a_out["flux"][:, i * n_inner:(i + 1) * n_inner]
        torch.testing.assert_close(o_out["sst"][:, i], window.mean(1))


def test_ocean_fraction_prediction():
    """``ocean_fraction_prediction``: the atmosphere's ocean fraction is
    ``clip(1 - land - sea_ice, 0)`` from the ocean's sea ice (NaN as 0)
    and the window's land fraction, and leaves the atmosphere's data
    requirements."""
    atmos = _echo("coupled_ofrac_atmos",
                  ["ta", ST, "ocean_fraction", "land_fraction"],
                  ["ta", "ofrac_echo", ST],
                  {"ofrac_echo": "ocean_fraction", "ta": "ta", ST: ST},
                  ocean=OCEAN)
    ocean = _echo("coupled_ofrac_ocean", ["sst", "sea_ice_fraction"],
                  ["sst", "sea_ice_fraction"],
                  {"sst": "sst", "sea_ice_fraction": "sea_ice_fraction"})
    rng = np.random.RandomState(0)
    land = torch.from_numpy(np.clip(np.abs(rng.randn(1, 3, 8, 16)), 0, 1)
                            .astype(np.float32))
    ice = torch.from_numpy(np.clip(np.abs(rng.randn(1, 1, 8, 16)), 0, 1)
                           .astype(np.float32))
    ice[..., 0, 0] = float("nan")
    coupled, _, a_out, _, _ = _echo_rollout(
        atmos, ocean, {"land_fraction": land}, 1, sea_ice=ice,
        ocean_fraction_prediction={"sea_ice_fraction_name":
                                   "sea_ice_fraction",
                                   "land_fraction_name": "land_fraction"})
    assert "ocean_fraction" not in coupled.all_atmosphere_names
    assert "land_fraction" in coupled.all_atmosphere_names
    want = (1.0 - land[:, 0] - torch.nan_to_num(ice[:, 0])).clamp(min=0)
    torch.testing.assert_close(a_out["ofrac_echo"][:, 0], want)


def _small_pair(corrector):
    """Both packages' small coupled systems of the CM4 shape on the same
    weights, and inputs over 2 outer steps at batch 2; ``corrector``
    "no budget" turns the atmosphere corrector's dry-air and moisture
    budget off."""
    stepper, a_info, o_info = chip_smoke.coupled_stepper_dicts()
    if corrector == "no budget":
        correct = stepper["atmosphere"]["stepper"]["step"]["config"][
            "corrector"]
        correct.pop("moisture_budget_correction")
        correct["conserve_dry_air"] = False
    port = from_dict(port_stepper.CoupledStepperConfig,
                     copy.deepcopy(stepper)).get_stepper(a_info, o_info,
                                                         device="cpu")
    port.init_params(torch.Generator().manual_seed(3))
    jcoupled = jax_from_dict(jax_stepper.CoupledStepperConfig,
                             copy.deepcopy(stepper)).get_stepper(
        JaxDatasetInfo.from_state(a_info.get_state()),
        JaxDatasetInfo.from_state(o_info.get_state()))
    for c in ("atmosphere", "ocean"):
        getattr(jcoupled, c).params = jax.tree_util.tree_map(
            jnp.asarray, state_dict_to_flax_variables(
                getattr(port, c).module.state_dict()))
    inputs = chip_smoke.coupled_inputs(port, 2, 2,
                                       torch.Generator().manual_seed(4))
    return port, jcoupled, inputs


@pytest.fixture(scope="module")
def small_pair():
    return _small_pair("recipe")


def _to_jax_state(ic):
    def state(p):
        return JaxPrognosticState(data={k: jnp.asarray(v.numpy())
                                        for k, v in p.data.items()})
    return jax_stepper.CoupledPrognosticState(
        atmosphere_data=state(ic.atmosphere_data),
        ocean_data=state(ic.ocean_data))


# the rollout's tolerance, of each variable's largest value: without the
# atmosphere's budget corrections, 1e-4 (the ocean's first step puts its
# sea-ice fraction 2.1e-5 apart, float32 rounding through Samudra's
# instance norms, which the next outer step carries into the atmosphere
# through the ocean fraction: 3.7e-5 at most); with the recipe's
# corrector, BUDGET_TOL (ace_tpu's float32 global means put the first
# step's precipitation 1.1e-4 apart, and the next steps carry that into
# every field: 8.9e-5 at most)
ROLLOUT_TOL = {"no budget": 1e-4, "recipe": BUDGET_TOL}


@pytest.mark.parametrize("corrector", sorted(ROLLOUT_TOL))
def test_coupled_rollout_matches_ace_tpu(small_pair, corrector):
    """Both components' outputs of a 2-outer-step rollout, and the final
    states, equal ``ace_tpu``'s ``CoupledStepper.predict`` within
    ``ROLLOUT_TOL`` of each variable's largest value, with NaN on the same
    (dry) cells; the first atmosphere step within 1e-5 (``BUDGET_TOL``
    for the budget's fields)."""
    port, jcoupled, (ic, af, of, _, _) = (
        small_pair if corrector == "recipe" else _small_pair(corrector))
    a_out, o_out, final = port.predict(ic, af, of)
    ja, jo, jfinal = jcoupled.predict(
        _to_jax_state(ic), {k: jnp.asarray(v.numpy()) for k, v in af.items()},
        {k: jnp.asarray(v.numpy()) for k, v in of.items()})
    assert torch.isnan(o_out["sst"]).any()
    pairs = [(a_out, ja), (o_out, jo),
             (final.ocean_data.data, jfinal.ocean_data.data),
             (final.atmosphere_data.data, jfinal.atmosphere_data.data)]
    for got, ref in pairs:
        assert set(got) == set(ref)
        for k, r in ref.items():
            r = np.asarray(r)
            g = got[k].numpy()
            np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=k)
            scale = np.nanmax(np.abs(r))
            tol = max(ROLLOUT_TOL[corrector],
                      BUDGET_TOL if k in BUDGET_NAMES else 0.0)
            assert np.nanmax(np.abs(g - r)) <= tol * scale, k
    for k, r in ja.items():
        tol = BUDGET_TOL if k in BUDGET_NAMES else OUT_TOL
        err = np.abs(a_out[k][:, 0].numpy() - np.asarray(r)[:, 0]).max()
        assert err <= tol * np.abs(np.asarray(r)).max(), k


def test_mask_ocean_fields_matches_ace_tpu(small_pair):
    """The ocean-supplied forcings are zeroed on the ocean's dry cells
    (by name: level masks, else ``mask_2d``), NaN included, as in
    ``ace_tpu``."""
    port, jcoupled, (_, _, _, _, ocean) = small_pair
    fields = {k: ocean[k][:, :1] for k in ("sst", "so_2", "HI")}
    got = port._mask_ocean_fields(fields)
    want = jcoupled._mask_ocean_fields(
        {k: jnp.asarray(v.numpy()) for k, v in fields.items()})
    for k, v in got.items():
        assert not torch.isnan(v).any()
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))


def test_predict_with_grad_equals_predict(small_pair):
    """The training rollout (gradients on, each step recomputed) gives
    ``predict``'s values."""
    port, _, (ic, af, of, _, _) = small_pair
    a_out, o_out, _ = port.predict(ic, af, of)
    a_grad, o_grad, _ = port.predict_with_grad(ic, af, of)
    for got, want in ((a_grad, a_out), (o_grad, o_out)):
        for k, v in want.items():
            torch.testing.assert_close(got[k].detach(), v, equal_nan=True,
                                       rtol=0, atol=0)


# the trainer-level cases: the train YAML cut small, over one file per
# component (ace_tpu's merged loader fails, ROADMAP Queue 3)
SIZES = {"nlat": 16, "nlon": 32, "embed": 32, "layers": 2,
         "ch_width": [16, 24, 32], "dilation": [1, 2, 2], "n_inner": 4}
SPLITS = (("train", 3, "0151-01-06"), ("valid", 3, "0306-01-01"))


def single(config):
    """``config``'s merge lists as their first entry (the single file)."""
    for key in ("train_loader", "validation_loader", "loader"):
        if key in config:
            for comp in ("atmosphere", "ocean"):
                dataset = config[key]["dataset"]
                dataset[comp] = dataset[comp]["merge"][0]
    return config


@pytest.fixture(scope="module")
def coupled_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("coupled")
    paths, _ = chip_smoke.coupled_files(
        str(tmp), SIZES["nlat"], SIZES["nlon"],
        torch.Generator().manual_seed(11), "cpu", splits=SPLITS,
        n_inner=SIZES["n_inner"], single=True)
    base = chip_smoke.coupled_checkpoints(str(tmp), paths, "cpu", SIZES)
    return tmp, paths, base


def _trainer_config(files, case):
    tmp, paths, base = files
    config = single(chip_smoke._coupled_config(
        paths, str(tmp / case), SIZES, weights=base, n_coupled_steps=2))
    if case == "clipped":
        config["optimization"]["max_grad_norm"] = 0.5
    if case == "trained":
        training = config["stepper_training"]
        training["atmosphere"]["parameter_init"]["parameters"] = []
        training["ocean"]["parameter_init"]["alpha"] = 0.5
    return config


def _jax_value_and_grad(config):
    """``jax.value_and_grad(CoupledTrainer.loss_fn)`` on the first
    training pair, from the weights its ``train`` starts from."""
    trainer = JaxTrainer(jax_from_dict(JaxTrainConfig, copy.deepcopy(config)))
    params = trainer.coupled.init_params(jax.random.PRNGKey(0))
    for comp in ("atmosphere", "ocean"):
        pinit = getattr(trainer.config.stepper_training, comp).parameter_init
        params[comp], base = pinit.apply_weights(params[comp])
        if pinit.alpha or pinit.beta:
            trainer._l2sp[comp] = (pinit, base)
    batches = [{k: jnp.asarray(v[None]) for k, v in window[0][0].items()}
               for window in (trainer.atmos_window, trainer.ocean_window)]
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        trainer.loss_fn, has_aux=True))(params, *batches,
                                        jax.random.PRNGKey(1))
    return float(loss), {k: float(v) for k, v in metrics.items()}, {
        c: flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                            grads[c]))
        for c in grads}


@pytest.fixture(scope="module")
def jax_gradients(coupled_files):
    """``ace_tpu``'s loss and gradients of the recipe: the same in every
    case (a frozen parameter's gradient is computed all the same, and the
    L2-SP term and its gradient are 0 at the base weights)."""
    return _jax_value_and_grad(_trainer_config(coupled_files, "recipe"))


def _port_value_and_grad(config):
    trainer = CoupledTrainer(from_dict(CoupledTrainConfig,
                                       copy.deepcopy(config)), device="cpu")
    trainer.init_weights()
    loss, metrics = trainer.loss_fn(*trainer._batch([0]), trainer.generator)
    loss.backward()
    grads = {c: {k: p.grad for k, p in getattr(trainer.coupled, c).module
                 .named_parameters() if p.requires_grad}
             for c in ("atmosphere", "ocean")}
    return trainer, float(loss.detach()), {
        k: float(v.detach()) for k, v in metrics.items()}, grads


def _check_gradients(got, want):
    largest = max(float(v.double().norm()) for v in want.values())
    zero = chip_smoke._samudra_zero_gradients(want)
    for k, w in want.items():
        err = float((got[k].double() - w.double()).norm())
        allowed = (1e-6 * largest if k in zero
                   else GRAD_TOL * float(w.double().norm()) + 1e-6 * largest)
        assert err <= allowed, (k, err, allowed)


@pytest.mark.parametrize("case", ["recipe", "clipped", "trained"])
def test_coupled_loss_and_gradients_match_ace_tpu(coupled_files,
                                                  jax_gradients, case):
    """The loss, its parts and every gradient the port computes against
    ``ace_tpu``'s, through the atmosphere steps: the recipe computes no
    gradient of the frozen atmosphere, the recipe with ``max_grad_norm``
    computes them (they enter the global norm: equal to ``ace_tpu``'s),
    the copy that trains both components (with L2-SP on the ocean)
    both."""
    config = _trainer_config(coupled_files, case)
    trainer, loss, metrics, grads = _port_value_and_grad(config)
    want_loss, want_metrics, want = jax_gradients
    assert loss == pytest.approx(want_loss, rel=LOSS_TOL)
    for k, v in want_metrics.items():
        assert metrics[k] == pytest.approx(v, rel=LOSS_TOL, abs=1e-12), k
    _check_gradients(grads["ocean"], want["ocean"])
    frozen = case == "recipe"
    assert (not grads["atmosphere"]) == frozen
    if not frozen:
        _check_gradients(grads["atmosphere"], want["atmosphere"])
        every = [*grads["atmosphere"].values(), *grads["ocean"].values()]
        reference = [*want["atmosphere"].values(), *want["ocean"].values()]
        assert float(global_norm(every)) == pytest.approx(
            float(global_norm(reference)), rel=LOSS_TOL)
    if case == "clipped":
        # frozen, computed for the norm, and zeroed in the update
        assert trainer.optimization.frozen[:len(grads["atmosphere"])] == [
            True] * len(grads["atmosphere"])


def test_recompute_on_and_off_give_equal_gradients(coupled_files,
                                                   monkeypatch):
    """Each component step recomputed in the backward pass (the port's
    only way) gives the gradients of the rollout kept whole."""
    config = _trainer_config(coupled_files, "trained")
    _, loss, _, on = _port_value_and_grad(config)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *args, **kwargs: fn(*args))
    _, loss_off, _, off = _port_value_and_grad(config)
    assert loss_off == loss
    for c in on:
        for k, v in on[c].items():
            torch.testing.assert_close(off[c][k], v, rtol=1e-6, atol=0)
