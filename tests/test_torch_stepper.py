"""The port's step, rollout and checkpoint loading against ace_tpu, on a
small flagship-like configuration: NoiseConditionedSFNO in float32 with
prescribed SST and the dry-air corrector, 16x32 Gauss grid."""

import json
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.core import coordinates as jax_coords
from ace_tpu.core.config import from_dict as jax_from_dict
from ace_tpu.core.config import to_dict as jax_to_dict
from ace_tpu.core.dataset_info import DatasetInfo as JaxDatasetInfo
from ace_tpu.core.step import StepArgs as JaxStepArgs
from ace_tpu.core.step import StepSelector as JaxStepSelector
from ace_tpu.core.step.single_module import (
    SingleModuleStepConfig as JaxSingleModuleStepConfig,
)
from ace_tpu.models.conditional_sfno import (
    NoiseConditionedSFNO as JaxNoiseConditionedSFNO,
)
from ace_tpu.stepper import checkpoint as jax_checkpoint
from ace_tpu.stepper.stepper import PrognosticState as JaxPrognosticState
from ace_tpu.stepper.stepper import StepperConfig as JaxStepperConfig
from ace_tpu_torch.core import coordinates
from ace_tpu_torch.core.config import ConfigError
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.step import StepArgs, StepSelector
from ace_tpu_torch.models.conditional_sfno import NoiseConditionedSFNO
from ace_tpu_torch.stepper.checkpoint import load_stepper
from ace_tpu_torch.stepper.stepper import PrognosticState, StepperConfig
from ace_tpu_torch.utils.convert import flax_params_to_state_dict

torch.set_num_threads(2)

NLAT, NLON, NZ, B, N_FORWARD = 16, 32, 2, 2, 4
PROGNOSTIC = (
    [f"air_temperature_{k}" for k in range(NZ)]
    + [f"specific_total_water_{k}" for k in range(NZ)]
    + ["PRESsfc", "surface_temperature"]
)
DIAGNOSTIC = ["PRATEsfc", "LHTFLsfc"]
FORCING = ["DSWRFtoa", "ocean_fraction"]
MEANS = {"PRESsfc": 1.0e5, "surface_temperature": 280.0}
STDS = {"PRESsfc": 1000.0, "surface_temperature": 10.0}
AK = np.asarray([100.0, 5000.0, 0.0])
BK = np.asarray([0.0, 0.4, 1.0])


def _step_dict(**builder_overrides):
    names = sorted(set(PROGNOSTIC + DIAGNOSTIC + FORCING))
    builder = {
        "embed_dim": 16, "noise_embed_dim": 8, "noise_type": "isotropic",
        "num_layers": 2, "affine_norms": True, "normalize_big_skip": True,
        "compute_dtype": "float32",
    }
    builder.update(builder_overrides)
    return dict(
        builder={"type": "NoiseConditionedSFNO", "config": builder},
        in_names=PROGNOSTIC + FORCING,
        out_names=PROGNOSTIC + DIAGNOSTIC,
        normalization={"network": {
            "means": {n: MEANS.get(n, 0.0) for n in names},
            "stds": {n: STDS.get(n, 1.0) for n in names},
        }},
        ocean={"surface_temperature_name": "surface_temperature",
               "ocean_fraction_name": "ocean_fraction"},
        corrector={"conserve_dry_air": True,
                   "force_positive_names": ["specific_total_water_0"]},
    )


def _grid():
    return (jax_coords.gaussian_latitudes(NLAT),
            np.linspace(0, 360, NLON, endpoint=False))


def _jax_stepper():
    lat, lon = _grid()
    info = JaxDatasetInfo(
        horizontal_coordinates=jax_coords.LatLonCoordinates(lat=lat, lon=lon),
        vertical_coordinate=jax_coords.HybridSigmaPressureCoordinate(
            ak=AK, bk=BK),
        timestep=timedelta(hours=6),
    )
    step_cfg = jax_from_dict(JaxSingleModuleStepConfig, _step_dict())
    config = JaxStepperConfig(step=JaxStepSelector(
        type="single_module", config=jax_to_dict(step_cfg)))
    stepper = config.get_stepper(info)
    params = stepper.init_params(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)

    def perturb(path, leaf):
        # nonzero noise conditioning, so that path is compared too
        name = "/".join(str(p.key) for p in path)
        if "w_scale_2d" in name or "w_bias_2d" in name:
            return jnp.asarray(rng.randn(*leaf.shape) * 0.1, leaf.dtype)
        return leaf

    stepper.params = jax.tree_util.tree_map_with_path(perturb, params)
    return stepper, config


def _torch_stepper(params):
    lat, lon = _grid()
    info = DatasetInfo(
        horizontal_coordinates=coordinates.LatLonCoordinates(lat=lat, lon=lon),
        vertical_coordinate=coordinates.HybridSigmaPressureCoordinate(
            ak=AK, bk=BK),
        timestep=timedelta(hours=6),
    )
    config = StepperConfig(step=StepSelector(
        type="single_module", config=_step_dict()))
    stepper = config.get_stepper(info, device="cpu")
    stepper.load_state_dict(flax_params_to_state_dict(params))
    return stepper


def _data(n_time):
    rng = np.random.RandomState(0)
    ic = {k: rng.randn(B, 1, NLAT, NLON).astype(np.float32) for k in PROGNOSTIC}
    ic["PRESsfc"] = ic["PRESsfc"] * 1000 + 1.0e5
    ic["surface_temperature"] = ic["surface_temperature"] * 10 + 280
    for k in range(NZ):
        name = f"specific_total_water_{k}"
        ic[name] = np.abs(ic[name]) * 1e-3
    forcing = {
        k: rng.randn(B, n_time, NLAT, NLON).astype(np.float32)
        for k in FORCING + ["surface_temperature"]
    }
    forcing["ocean_fraction"] = np.clip(np.abs(forcing["ocean_fraction"]), 0, 1)
    forcing["surface_temperature"] = forcing["surface_temperature"] * 10 + 280
    noise = rng.randn(B, NLAT, NLON, 8).astype(np.float32)
    return ic, forcing, noise


def _patch_noise(monkeypatch, noise):
    """Both models condition on the same noise field."""
    monkeypatch.setattr(JaxNoiseConditionedSFNO, "_make_noise",
                        lambda self, batch: jnp.asarray(noise))
    monkeypatch.setattr(NoiseConditionedSFNO, "make_noise",
                        lambda self, batch, generator: torch.from_numpy(noise))


def _assert_outputs_close(out, ref, tol=1e-4):
    """Float32 on both sides, other summation order: within ``tol`` in
    normalized units (of the data's unit scale, or of the largest value
    where that is larger), plus 1e-5 of the largest raw value for the
    float32 resolution of global means of large fields (the dry-air
    target is a float32 mean of ~1e5 Pa surface pressures)."""
    assert set(out) >= set(ref)
    for name, r in ref.items():
        mean, std = MEANS.get(name, 0.0), STDS.get(name, 1.0)
        r = np.asarray(r)
        o = out[name].numpy()
        assert o.shape == r.shape, name
        scale = max(1.0, float(np.max(np.abs(r - mean))) / std)
        atol = tol * std * scale + 1e-5 * float(np.max(np.abs(r)))
        np.testing.assert_allclose(o, r, rtol=0, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def jax_rollout(tmp_path_factory):
    """ace_tpu's stepper, its checkpoint and its 4-step rollout."""
    ic, forcing, noise = _data(N_FORWARD + 1)
    with pytest.MonkeyPatch.context() as mp:
        _patch_noise(mp, noise)
        stepper, config = _jax_stepper()
        outputs, _ = stepper.predict(
            JaxPrognosticState(data={k: jnp.asarray(v) for k, v in ic.items()}),
            {k: jnp.asarray(v) for k, v in forcing.items()},
        )
    path = str(tmp_path_factory.mktemp("ckpt") / "stepper.msgpack")
    jax_checkpoint.save_stepper(path, stepper, config)
    return stepper, config, path, {k: np.asarray(v) for k, v in outputs.items()}


def test_single_step_with_ocean_and_corrector_matches_ace_tpu(
        jax_rollout, monkeypatch):
    jax_stepper = jax_rollout[0]
    ic, forcing, noise = _data(2)
    _patch_noise(monkeypatch, noise)
    step_in = {k: v[:, 0] for k, v in ic.items()}
    step_in.update({k: forcing[k][:, 0] for k in FORCING})
    next_in = {k: forcing[k][:, 1] for k in jax_stepper.step.next_step_input_names}

    jstep = jax_stepper.step
    jin = {k: jnp.asarray(v) for k, v in step_in.items()}
    ref = jstep.step(jax_stepper.params, JaxStepArgs(
        input=jin,
        next_step_input_data={k: jnp.asarray(v) for k, v in next_in.items()},
        stepper_state=jstep.init_stepper_state(jin),
        rng=jax.random.PRNGKey(1),
    ))

    step = _torch_stepper(jax_stepper.params).step
    tin = {k: torch.from_numpy(v) for k, v in step_in.items()}
    with torch.inference_mode():
        out = step.step(StepArgs(
            input=tin,
            next_step_input_data={k: torch.from_numpy(v)
                                  for k, v in next_in.items()},
            stepper_state=step.init_stepper_state(tin),
        ))
    _assert_outputs_close(out.output, ref.output)
    # a float32 global mean of ~1e5 Pa: on this input ace_tpu's reduction
    # is 2.3e-6 (0.23 Pa) off a float64 evaluation, the port's < 1e-7
    np.testing.assert_allclose(
        out.stepper_state["corrector"]["global_dry_air_mass"].numpy(),
        np.asarray(ref.stepper_state["corrector"]["global_dry_air_mass"]),
        rtol=1e-5,
    )
    # the corrector's modified fields are reported as diagnostics
    assert set(out.corrector_diagnostics) == set(ref.corrector_diagnostics)


def _torch_rollout(stepper, monkeypatch):
    ic, forcing, noise = _data(N_FORWARD + 1)
    _patch_noise(monkeypatch, noise)
    outputs, next_ic = stepper.predict(
        PrognosticState(data={k: torch.from_numpy(v) for k, v in ic.items()}),
        {k: torch.from_numpy(v) for k, v in forcing.items()},
    )
    assert next_ic.data["PRESsfc"].shape == (B, 1, NLAT, NLON)
    return outputs


def test_rollout_matches_ace_tpu(jax_rollout, monkeypatch):
    jax_stepper, _, _, ref = jax_rollout
    outputs = _torch_rollout(_torch_stepper(jax_stepper.params), monkeypatch)
    assert outputs["PRESsfc"].shape == (B, N_FORWARD, NLAT, NLON)
    _assert_outputs_close(outputs, ref)


def test_checkpoint_from_ace_tpu_gives_same_rollout(jax_rollout, monkeypatch):
    _, _, path, ref = jax_rollout
    stepper = load_stepper(path, device="cpu")
    assert stepper.device == torch.device("cpu")
    _assert_outputs_close(_torch_rollout(stepper, monkeypatch), ref)


def test_jax_checkpoint_config_parses(jax_rollout):
    """Every field that ace_tpu's get_state writes parses in the port."""
    config = jax_rollout[1]
    state = json.loads(json.dumps(config.get_state()))
    parsed = StepperConfig.from_state(state)
    assert parsed.step.instance.in_names == PROGNOSTIC + FORCING
    assert parsed.get_state()["step"]["config"]["builder"] == (
        state["step"]["config"]["builder"]
    )


# small configs of the builders ported since they were refused here (the
# graph builders at 2 mesh levels: ace_tpu's brute-force graph queries
# take minutes at the default 6)
_SWIN = {"embed_dim": 8, "num_heads": [2, 2, 2, 2], "window_size": [2, 4],
         "noise_embed_dim": 4}
_GRAPH = {"latent_dimension": 8, "meshes": 2, "M0": 1, "processor_steps": 1}


@pytest.mark.parametrize("override", [
    # the conditional SFNO's options, labels and missing variables, refused
    # here before they were ported, gave their places to the builders of
    # ace_tpu that were not ported yet; all are now (PORTED_SINCE)
    {"module": {"type": "SwinTransformer",
                "config": {k: v for k, v in _SWIN.items()
                           if k != "noise_embed_dim"}}},
    {"module": {"type": "NoiseConditionedSwinTransformer", "config": _SWIN}},
    {"module": {"type": "NoiseConditionedSwinTransformer",
                "conditional": True, "config": _SWIN}},
    {"module": {"type": "LandNet",
                "config": {"use_positional_embedding": True}}},
    {"module": {"type": "HEALPixUNet", "config": {}}},
    {"module": {"type": "FloeNet", "allow_missing_variables": True,
                "config": _GRAPH}},
    {"module": {"type": "GraphCast", "config": _GRAPH}},
])
def test_unported_options_are_refused(override):
    """Each builder of ace_tpu that the port lacked was refused here,
    naming that; each has been ported since, and its case holds it
    against ace_tpu (``_assert_builds_as_ace_tpu``)."""
    step = _step_dict(**override.get("builder", {}))
    step.update(override.get("step", {}))
    step["builder"].update(override.get("module", {}))
    if step["builder"]["type"] in PORTED_SINCE:
        _assert_builds_as_ace_tpu(step)
        return
    with pytest.raises((NotImplementedError, ConfigError)) as info:
        StepSelector(type="single_module", config=step)
    assert "not ported" in str(info.value)


PORTED_SINCE = ("HEALPixUNet", "SwinTransformer",
                "NoiseConditionedSwinTransformer", "LandNet", "FloeNet",
                "GraphCast")


def _assert_builds_as_ace_tpu(step):
    """The step config of ``step`` parses in both packages to the same
    builder state, and its network, built through both registries (on a
    HEALPix grid for HEALPixUNet, else on the 16x32 Gauss grid, with two
    labels for a conditional builder), has ace_tpu's parameters: every
    name and shape."""
    from ace_tpu.models.registry import ModuleSelector as JaxModuleSelector
    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.models.registry import ModuleSelector

    selector = StepSelector(type="single_module", config=step)
    jselector = jax_from_dict(JaxStepSelector,
                              {"type": "single_module", "config": step})
    builder = selector.get_state()["config"]["builder"]
    assert builder == jselector.get_state()["config"]["builder"]
    n_in, n_out = len(step["in_names"]), len(step["out_names"])
    labels = ("a", "b") if builder.get("conditional") else ()
    if builder["type"] == "HEALPixUNet":
        grid, jgrid = (c.HEALPixCoordinates.from_nside(4)
                       for c in (coordinates, jax_coords))
    else:
        grid, jgrid = (c.LatLonCoordinates(*_grid())
                       for c in (coordinates, jax_coords))
    net = from_dict(ModuleSelector, builder).build(
        n_in, n_out, DatasetInfo(horizontal_coordinates=grid,
                                 all_labels=labels), device="cpu")
    jnet = jax_from_dict(JaxModuleSelector, builder).build(
        n_in, n_out, JaxDatasetInfo(horizontal_coordinates=jgrid,
                                    all_labels=labels))
    x = jnp.zeros((1, *grid.shape, n_in))
    kwargs = {"labels": jnp.zeros((1, 2))} if labels else {}
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, **kwargs)
    ref = flax_params_to_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {
        k: tuple(v.shape) for k, v in ref.items()}


def test_dry_air_is_conserved_in_rollout(jax_rollout, monkeypatch):
    """The corrector pins the global dry-air mass to the IC's."""
    jax_stepper = jax_rollout[0]
    stepper = _torch_stepper(jax_stepper.params)
    outputs = _torch_rollout(stepper, monkeypatch)
    ic, _, _ = _data(N_FORWARD + 1)
    ops = stepper.dataset_info.gridded_operations
    vc = stepper.dataset_info.vertical_coordinate

    def dry_air(data, t):
        wat = torch.stack([torch.as_tensor(data[f"specific_total_water_{k}"][:, t])
                           for k in range(NZ)], dim=-1)
        ps = torch.as_tensor(data["PRESsfc"][:, t])
        return ops.area_weighted_mean(ps - 9.80665 * vc.vertical_integral(wat, ps))

    target = dry_air(ic, 0)
    for t in range(N_FORWARD):
        torch.testing.assert_close(dry_air(outputs, t), target, rtol=1e-6, atol=0)
