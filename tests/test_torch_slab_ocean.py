"""The port's slab ocean against ace_tpu's: the mixed-layer tendency, the
slab and prescribed ``Ocean``, the ocean's forcing names as they flow
into the step's names, a slab-ocean step and a 4-step rollout of the
ACE2-SOM recipe's step at 16x32 (``chip_smoke.som_step_configs``, embed
32, 2 layers). The helpers here (the two packages' steppers on one
config with ace_tpu's weights, numpy draws of the recipe's variables)
serve the other tests of path M's slice too. float32 on both sides:
within 1e-5 of each variable's largest value, as
tests/test_torch_sfno.py holds the network."""

import copy
import functools
import json
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ace_tpu.core import coordinates as jax_coords
from ace_tpu.core import ocean as jax_ocean
from ace_tpu.core.dataset_info import DatasetInfo as JaxDatasetInfo
from ace_tpu.core.step import StepArgs as JaxStepArgs
from ace_tpu.core.step import StepSelector as JaxStepSelector
from ace_tpu.stepper.stepper import PrognosticState as JaxPrognosticState
from ace_tpu.stepper.stepper import StepperConfig as JaxStepperConfig
from ace_tpu_torch.core import ocean
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.constants import (
    DENSITY_OF_WATER,
    SPECIFIC_HEAT_OF_WATER,
)
from ace_tpu_torch.core.step import StepArgs, StepSelector
from ace_tpu_torch.stepper.stepper import PrognosticState, StepperConfig
from ace_tpu_torch.utils.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_variables,
)

torch.set_num_threads(2)

NLAT, NLON, NZ, B, EMBED = 16, 32, 2, 2, 32
F32_TOL = 1e-5
# the moisture budget rescales these two by a ratio of float32 global
# means: on the slab step's input ace_tpu's are 4.6e-5 of their largest
# value off a float64 evaluation, the port's 3.2e-6 (ROADMAP Queue 3,
# test_moisture_budget_against_float64); over rollouts of 2-4 steps the
# two packages' differ by up to 3.7e-4 (the SOM step over 3 seeds, the
# two-module steps). They are held within 1e-3
BUDGET_TOL = 1e-3
BUDGET_NAMES = ("PRATEsfc", "tendency_of_total_water_path_due_to_advection")
SLAB = {"mixed_layer_depth_name": "prescribed_mixed_layer_depth",
        "q_flux_name": "prescribed_qflux"}
FLUXES = ["DSWRFsfc", "USWRFsfc", "DLWRFsfc", "ULWRFsfc", "LHTFLsfc",
          "SHTFLsfc"]


def draw(names, shape, seed):
    """numpy float32 draws of ``names`` at the scales of
    ``chip_smoke._draw`` (the slab's depths and q-fluxes uniform in
    ``chip_smoke.SLAB_DRAWS``' ranges)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k in sorted(names):
        if k in chip_smoke.SLAB_DRAWS:
            low, high = chip_smoke.SLAB_DRAWS[k]
            v = rng.uniform(low, high, shape)
        else:
            mean, std, positive = chip_smoke._field_scale(k)
            v = rng.randn(*shape)
            v = (np.clip(np.abs(v), 0, 1) if k == "ocean_fraction"
                 else (np.abs(v) if positive else v) * std + mean)
        out[k] = v.astype(np.float32)
    return out


def jax_dataset_info():
    """ace_tpu's dataset info of ``chip_smoke.som_step_configs``' grid."""
    _, info = chip_smoke.som_step_configs(NLAT, NLON, nz=NZ)
    vc = info.vertical_coordinate
    return JaxDatasetInfo(
        horizontal_coordinates=jax_coords.LatLonCoordinates(
            lat=jax_coords.gaussian_latitudes(NLAT),
            lon=np.linspace(0, 360, NLON, endpoint=False)),
        vertical_coordinate=jax_coords.HybridSigmaPressureCoordinate(
            ak=np.asarray(vc.ak), bk=np.asarray(vc.bk)),
        timestep=timedelta(hours=6),
    )


def _perturb(params, seed):
    """The spectral filters at std 1/sqrt(in) (flax ``[I, O, L, 2]``) so
    that they show in the outputs."""
    rng = np.random.RandomState(seed)

    def visit(path, leaf):
        name = "/".join(str(p.key) for p in path)
        if name.endswith("filter/weight"):
            return jnp.asarray(rng.randn(*leaf.shape) * leaf.shape[0] ** -0.5,
                               leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(visit, params)


@functools.lru_cache
def _jax_stepper(selector_json: str, seed: int):
    """ace_tpu's stepper with the port's initial weights drawn from
    ``seed`` (the port draws them as flax does; flax's initializers
    compile once per shape, 5-10 s a stepper on XLA:CPU) in its tree,
    which must have ``init_params``' leaves, then perturbed."""
    jstepper = JaxStepperConfig(step=JaxStepSelector(
        **json.loads(selector_json))).get_stepper(jax_dataset_info())
    _, info = chip_smoke.som_step_configs(NLAT, NLON, nz=NZ)
    port = StepperConfig(step=StepSelector(
        **json.loads(selector_json))).get_stepper(info, device="cpu")
    port.init_params(torch.Generator().manual_seed(seed))
    params = state_dict_to_flax_variables(port.module.state_dict())
    shapes = jax.eval_shape(jstepper.init_params, jax.random.PRNGKey(seed))
    assert jax.tree_util.tree_map(np.shape, params) == (
        jax.tree_util.tree_map(lambda v: v.shape, shapes))
    jstepper.params = _perturb(params, seed + 1)
    return jstepper


def steppers(selector: dict, seed=0):
    """ace_tpu's stepper of the step ``selector`` (a ``{type, config}``
    dict) with its weights drawn (made once per selector and seed, and
    shared), and a new port stepper on the CPU with the same weights
    carried across by ``utils/convert.py``."""
    _, info = chip_smoke.som_step_configs(NLAT, NLON, nz=NZ)
    jstepper = _jax_stepper(json.dumps(selector, sort_keys=True), seed)
    stepper = StepperConfig(step=StepSelector(
        **copy.deepcopy(selector))).get_stepper(info, device="cpu")
    stepper.load_state_dict(flax_params_to_state_dict(jstepper.params))
    return jstepper, stepper


def som_case(case: str, dtype="float32") -> dict:
    cases, _ = chip_smoke.som_step_configs(NLAT, NLON, EMBED, 2, dtype,
                                           nz=NZ)
    return cases[case]


def som_recipe_step(dtype="float32") -> dict:
    """The ACE2-SOM YAML's step: the multi-call wrapper with no config
    around the slab-ocean step."""
    wrapped = som_case("multi_call slab", dtype)["config"]["wrapped_step"]
    return {"type": "multi_call", "config": {
        "wrapped_step": wrapped, "config": None,
        "include_multi_call_in_loss": False}}


def step_inputs(step, seed=0):
    """One step's input and next-step input of ``step`` (either package's),
    as numpy."""
    inputs = draw(step.input_names, (B, NLAT, NLON), seed)
    nxt = draw(step.next_step_input_names, (B, NLAT, NLON), seed + 1)
    return inputs, nxt


def jax_step(jstepper, inputs, nxt, deterministic=True, rng=None):
    jstep = jstepper.step
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    return jstep.step(jstepper.params, JaxStepArgs(
        input=jin,
        next_step_input_data={k: jnp.asarray(v) for k, v in nxt.items()},
        stepper_state=jstep.init_stepper_state(jin),
        deterministic=deterministic, rng=rng))


def port_step(stepper, inputs, nxt, deterministic=True, generator=None):
    step = stepper.step
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    return step.step(StepArgs(
        input=tin,
        next_step_input_data={k: torch.from_numpy(v) for k, v in nxt.items()},
        stepper_state=step.init_stepper_state(tin),
        deterministic=deterministic, generator=generator))


def assert_close(out, ref, tol=F32_TOL, names=None):
    """Each variable within ``tol`` of its largest value, or of its
    normalization std where that is larger (a diagnostic that the
    corrector clamps at zero, such as the frozen precipitation, can have
    a largest value far below the network's output unit); the moisture
    budget's ``BUDGET_NAMES`` within ``BUDGET_TOL`` where ``tol`` is
    smaller."""
    names = sorted(ref) if names is None else names
    for k in names:
        r = np.asarray(ref[k], np.float32)
        o = out[k].detach().float().numpy()
        assert o.shape == r.shape, k
        limit = max(tol, BUDGET_TOL) if k in BUDGET_NAMES else tol
        scale = max(float(np.abs(r).max()), chip_smoke._som_stats(k)[1])
        np.testing.assert_allclose(o, r, rtol=0, atol=limit * scale,
                                   err_msg=k)


def rollouts(jstepper, stepper, n_steps=4, seed=5):
    """``Stepper.predict`` of both packages from one initial condition and
    forcing: (the port's outputs, ace_tpu's)."""
    ic = draw(stepper.prognostic_names, (B, 1, NLAT, NLON), seed)
    forcing = draw(stepper.forcing_window_names,
                   (B, n_steps + 1, NLAT, NLON), seed + 1)
    assert sorted(jstepper.forcing_window_names) == sorted(forcing)
    ref, _ = jstepper.predict(
        JaxPrognosticState(data={k: jnp.asarray(v) for k, v in ic.items()}),
        {k: jnp.asarray(v) for k, v in forcing.items()})
    with torch.inference_mode():
        out, _ = stepper.predict(
            PrognosticState(data={k: torch.from_numpy(v)
                                  for k, v in ic.items()}),
            {k: torch.from_numpy(v) for k, v in forcing.items()})
    return out, {k: np.asarray(v) for k, v in ref.items()}


# --- the slab ocean -----------------------------------------------------


def test_mixed_layer_tendency_matches_ace_tpu():
    data = draw(["LHTFLsfc", "prescribed_qflux",
                 "prescribed_mixed_layer_depth"], (B, NLAT, NLON), 0)
    args = [data["LHTFLsfc"], data["prescribed_qflux"],
            data["prescribed_mixed_layer_depth"]]
    out = ocean.mixed_layer_temperature_tendency(*map(torch.from_numpy, args))
    ref = jax_ocean.mixed_layer_temperature_tendency(*map(jnp.asarray, args))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)
    want = (args[0].astype(np.float64) + args[1]) / (
        DENSITY_OF_WATER * SPECIFIC_HEAT_OF_WATER * args[2])
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("slab", [True, False], ids=["slab", "prescribed"])
@pytest.mark.parametrize("interpolate", [True, False])
def test_ocean_matches_ace_tpu(slab, interpolate):
    """The slab and the prescribed ``Ocean``, blended by the ocean fraction
    or replacing on its rounded mask, against ace_tpu's; the slab's SST
    also against its formula in float64."""
    fields = {"surface_temperature_name": "surface_temperature",
              "ocean_fraction_name": "ocean_fraction",
              "interpolate": interpolate}
    if slab:
        fields["slab"] = SLAB
    names = ["surface_temperature"]
    timestep = timedelta(hours=6)
    port = from_dict(ocean.OceanConfig, copy.deepcopy(fields)).build(
        names, names, timestep)
    jfields = dict(fields)
    if slab:
        jfields["slab"] = jax_ocean.SlabOceanConfig(**SLAB)
    ref_ocean = jax_ocean.OceanConfig(**jfields).build(names, names, timestep)
    inputs = draw(["surface_temperature"], (B, NLAT, NLON), 0)
    gen = draw(FLUXES + ["surface_temperature", "PRATEsfc"],
               (B, NLAT, NLON), 1)
    target = draw(["ocean_fraction", "surface_temperature",
                   *SLAB.values()], (B, NLAT, NLON), 2)
    out = port(*({k: torch.from_numpy(v) for k, v in d.items()}
                 for d in (inputs, gen, target)))
    ref = ref_ocean(*({k: jnp.asarray(v) for k, v in d.items()}
                      for d in (inputs, gen, target)))
    assert_close(out, ref, 1e-6)
    if slab:
        g = {k: v.astype(np.float64) for k, v in gen.items()}
        f_net = (g["DSWRFsfc"] - g["USWRFsfc"] + g["DLWRFsfc"]
                 - g["ULWRFsfc"] - g["LHTFLsfc"] - g["SHTFLsfc"])
        sst = inputs["surface_temperature"] + timestep.total_seconds() * (
            f_net + target["prescribed_qflux"]) / (
            DENSITY_OF_WATER * SPECIFIC_HEAT_OF_WATER
            * target["prescribed_mixed_layer_depth"])
        frac = target["ocean_fraction"]
        want = (frac * sst + (1 - frac) * g["surface_temperature"]
                if interpolate else
                np.where(np.round(frac) == 1, sst, g["surface_temperature"]))
        np.testing.assert_allclose(out["surface_temperature"].numpy(), want,
                                   rtol=0, atol=1e-6 * np.abs(want).max())


def test_prescriber_config_matches_ace_tpu():
    """``PrescriberConfig``: interpolation wants mask value 1, and the
    prescribed name must be an input and an output, in both packages."""
    for cls in (ocean.PrescriberConfig, jax_ocean.PrescriberConfig):
        with pytest.raises(ValueError, match="mask_value to be 1"):
            cls("a", "mask", 0, interpolate=True)
        with pytest.raises(ValueError, match="in_names and out_names"):
            cls("a", "mask", 1).build(["a"], ["b"])
        prescriber = cls("a", "mask", 1).build(["a"], ["a"])
        assert prescriber.prescribed_names == ["a"]
        assert prescriber.mask_names == ["mask"]


def test_forcing_names_flow_into_the_step_names():
    """A slab's forcing is the ocean fraction, the depth and the q-flux,
    without the SST; the SOM step's input, next-step and forcing-window
    names and the prognostic names agree with ace_tpu's."""
    cfg = ocean.OceanConfig("surface_temperature", "ocean_fraction",
                            slab=ocean.SlabOceanConfig(**SLAB))
    assert cfg.is_slab
    assert cfg.forcing_names == ["ocean_fraction",
                                 "prescribed_mixed_layer_depth",
                                 "prescribed_qflux"]
    prescribed = ocean.OceanConfig("surface_temperature", "ocean_fraction")
    assert not prescribed.is_slab
    assert prescribed.forcing_names == ["ocean_fraction",
                                        "surface_temperature"]
    jstepper, stepper = steppers(som_recipe_step())
    for name in ("input_names", "output_names", "next_step_input_names",
                 "prognostic_names", "next_step_forcing_names"):
        assert (sorted(getattr(stepper.step, name))
                == sorted(getattr(jstepper.step, name))), name
    assert (sorted(stepper.forcing_window_names)
            == sorted(jstepper.forcing_window_names))
    assert "surface_temperature" not in stepper.forcing_window_names
    assert {"prescribed_mixed_layer_depth", "prescribed_qflux"} <= set(
        stepper.step.next_step_input_names)


def test_slab_step_matches_ace_tpu():
    """One step of the SOM recipe's step (the multi-call wrapper with no
    config over the slab-ocean step with the energy-budget corrector):
    every output, the corrector's diagnostics and state."""
    jstepper, stepper = steppers(som_recipe_step())
    inputs, nxt = step_inputs(stepper.step)
    ref = jax_step(jstepper, inputs, nxt)
    out = port_step(stepper, inputs, nxt)
    assert sorted(out.output) == sorted(ref.output)
    assert_close(out.output, ref.output)
    assert sorted(out.corrector_diagnostics) == sorted(
        ref.corrector_diagnostics)
    assert "surface_temperature" not in out.corrector_diagnostics
    np.testing.assert_allclose(
        out.stepper_state["corrector"]["global_dry_air_mass"].numpy(),
        np.asarray(ref.stepper_state["corrector"]["global_dry_air_mass"]),
        rtol=1e-5)


def test_slab_rollout_matches_ace_tpu():
    """A 4-step ``Stepper.predict`` of the SOM recipe's step: the slab SST
    feeds the next step."""
    jstepper, stepper = steppers(som_recipe_step())
    out, ref = rollouts(jstepper, stepper)
    assert sorted(out) == sorted(ref)
    assert_close(out, ref)


def test_moisture_budget_against_float64():
    """The SOM corrector (the moisture budget closed through the
    precipitation and the advection tendency, the energy budget with 1.14
    W/m2 of unaccounted heating) in float32 within 1e-5 of each field's
    largest value of its float64 evaluation: the port's global means do
    not add to ace_tpu's float32 error there (``BUDGET_TOL``)."""
    _, stepper = steppers(som_recipe_step())
    inputs, nxt = step_inputs(stepper.step)
    gen = draw(stepper.step.output_names, (B, NLAT, NLON), 7)
    corrector = stepper.step.wrapped.corrector

    def run(dtype):
        def cast(d):
            return {k: torch.from_numpy(v).to(dtype) for k, v in d.items()}
        state = corrector.init_state(cast(inputs))
        return corrector(cast(inputs), cast(gen), cast(nxt), state).corrected

    out, ref = run(torch.float32), run(torch.float64)
    for k in BUDGET_NAMES + ("air_temperature_0", "air_temperature_1"):
        scale = float(ref[k].abs().max())
        assert float((out[k].double() - ref[k]).abs().max()) <= 1e-5 * scale, k
