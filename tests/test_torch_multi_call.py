"""The port's multi-call step against ace_tpu's, over the slab-ocean step
of the ACE2-SOM recipe at 16x32 (``chip_smoke.som_step_configs``' case
``multi_call slab``: CO2 quadrupled, the six radiative fluxes kept under
``_4xCO2``): the names, the config's checks, a step's outputs, the loss
normalizer, a train step with the suffixed outputs in the loss,
``stepper_override.multi_call`` as None and as a dict, and
``include_multi_call_in_loss: false``. float32: outputs within 1e-5 of
each variable's largest value (tests/test_torch_slab_ocean.py's
``assert_close``)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ace_tpu.core.config import from_dict as jax_from_dict
from ace_tpu.core.loss import StepLossConfig as JaxStepLossConfig
from ace_tpu.core.optimization import EMAConfig as JaxEMAConfig
from ace_tpu.core.optimization import OptimizationConfig as JaxOptConfig
from ace_tpu.core.step import StepSelector as JaxStepSelector
from ace_tpu.core.step.multi_call import (
    get_multi_call_name as jax_get_multi_call_name,
)
from ace_tpu.stepper import checkpoint as jax_checkpoint
from ace_tpu.stepper.stepper import StepperConfig as JaxStepperConfig
from ace_tpu.stepper.stepper import (
    StepperOverrideConfig as JaxStepperOverrideConfig,
)
from ace_tpu.stepper.train import StepperTrainConfig as JaxTrainConfig
from ace_tpu.stepper.train import TrainStepper as JaxTrainStepper
from ace_tpu_torch import flagship
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.loss import StepLossConfig
from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
from ace_tpu_torch.core.step import StepSelector
from ace_tpu_torch.core.step.multi_call import get_multi_call_name
from ace_tpu_torch.stepper import checkpoint
from ace_tpu_torch.stepper.stepper import StepperOverrideConfig
from ace_tpu_torch.stepper.train import StepperTrainConfig, TrainStepper
from ace_tpu_torch.utils.convert import state_dict_to_flax_params
from tests.test_torch_slab_ocean import (
    B,
    NLAT,
    NLON,
    assert_close,
    draw,
    jax_step,
    port_step,
    rollouts,
    som_case,
    som_recipe_step,
    step_inputs,
    steppers,
)

torch.set_num_threads(2)

CASE = "multi_call slab"
SUFFIX = "_4xCO2"
OPT = dict(lr=1e-4, optimizer_type="AdamW")


@pytest.mark.parametrize("name, want", [
    ("ULWRFtoa", "ULWRFtoa_4xCO2"),
    ("air_temperature_0", "air_temperature_4xCO2_0"),
    ("specific_total_water_12", "specific_total_water_4xCO2_12"),
    ("TMP2m", "TMP2m_4xCO2"),
])
def test_multi_call_name_keeps_the_level_last(name, want):
    assert get_multi_call_name(name, SUFFIX) == want
    assert jax_get_multi_call_name(name, SUFFIX) == want


@pytest.mark.parametrize("change, match", [
    ({"forcing_name": "not_an_input"}, "not in input names"),
    ({"forcing_name": "PRESsfc"}, "must not be an output"),
    ({"output_names": ["not_an_output"]}, "not in output names"),
    ({"forcing_multipliers": {"": 4.0}}, "conflicts with existing names"),
    (None, "include_multi_call_in_loss is True, but config is None"),
])
def test_config_errors_match_ace_tpu(change, match):
    """Each check of ``MultiCallConfig.validate`` and of the step config
    refuses the same config in both packages."""
    selector = copy.deepcopy(som_case(CASE))
    config = selector["config"]
    if change is None:
        config["config"] = None
    else:
        config["config"] = {**config["config"], **change}
    for cls in (StepSelector, JaxStepSelector):
        with pytest.raises(ValueError, match=match):
            cls(**copy.deepcopy(selector))


@pytest.fixture(scope="module")
def multi_call():
    return steppers(som_case(CASE))


def test_step_outputs_match_ace_tpu(multi_call):
    """One step: the wrapped step's outputs and the suffixed ones, each
    within the tolerance; the suffixed ones equal the port's wrapped step
    called alone with the forcing quadrupled, and the stepper state and
    diagnostics are the first call's."""
    jstepper, stepper = multi_call
    inputs, nxt = step_inputs(stepper.step)
    ref = jax_step(jstepper, inputs, nxt)
    out = port_step(stepper, inputs, nxt)
    names = stepper.step.output_names
    assert sorted(out.output) == sorted(ref.output) == sorted(names)
    assert {get_multi_call_name(k, SUFFIX)
            for k in chip_smoke.M_FLUXES} <= set(names)
    assert_close(out.output, ref.output)
    wrapped = stepper.step.wrapped
    first = wrapped.step(_args(wrapped, inputs, nxt))
    scaled = [{**d, "global_mean_co2": 4 * d["global_mean_co2"]}
              if "global_mean_co2" in d else d for d in (inputs, nxt)]
    quadrupled = wrapped.step(_args(wrapped, *scaled))
    for k in chip_smoke.M_FLUXES:
        torch.testing.assert_close(out.output[get_multi_call_name(k, SUFFIX)],
                                   quadrupled.output[k], rtol=0, atol=0)
        torch.testing.assert_close(out.output[k], first.output[k],
                                   rtol=0, atol=0)
    torch.testing.assert_close(
        out.stepper_state["corrector"]["global_dry_air_mass"],
        first.stepper_state["corrector"]["global_dry_air_mass"])
    assert sorted(out.corrector_diagnostics) == sorted(
        first.corrector_diagnostics)


def _args(step, inputs, nxt):
    from ace_tpu_torch.core.step import StepArgs

    tin = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}
    return StepArgs(
        input=tin,
        next_step_input_data={k: torch.from_numpy(np.asarray(v))
                              for k, v in nxt.items()},
        stepper_state=step.init_stepper_state(tin))


def test_loss_normalizer_matches_ace_tpu(multi_call):
    """The suffixed outputs share their base variable's loss statistics
    (residual-scaled for the prognostics)."""
    jstepper, stepper = multi_call
    prognostic = stepper.prognostic_names
    out = stepper.step.config.get_loss_normalizer(
        residual_scaled_names=prognostic)
    ref = jstepper.step.config.get_loss_normalizer(
        residual_scaled_names=prognostic)
    assert set(out.means) == set(ref.means)
    for k in ref.means:
        assert out.means[k] == pytest.approx(float(ref.means[k]), rel=1e-6)
        assert out.stds[k] == pytest.approx(float(ref.stds[k]), rel=1e-6)
    for k in chip_smoke.M_FLUXES:
        mc = get_multi_call_name(k, SUFFIX)
        assert (out.means[mc], out.stds[mc]) == (out.means[k], out.stds[k])


def _train_steppers(jstepper, stepper):
    jts = JaxTrainStepper(
        jstepper,
        JaxTrainConfig(loss=jax_from_dict(JaxStepLossConfig, {"type": "MSE"}),
                       n_forward_steps=2),
        JaxOptConfig(**OPT), JaxEMAConfig())
    ts = TrainStepper(
        stepper,
        StepperTrainConfig(loss=from_dict(StepLossConfig, {"type": "MSE"}),
                           n_forward_steps=2),
        from_dict(OptimizationConfig, OPT), EMAConfig())
    return jts, ts


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float64)


def _batch(stepper, names, seed=3):
    return draw(sorted(set(stepper.step.input_names) | set(names)),
                (B, 3, NLAT, NLON), seed)


def _jax_loss(jts, params, batch):
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.jit(jax.value_and_grad(jts.loss_fn, has_aux=True),
                   static_argnums=3)(params, jbatch, jax.random.PRNGKey(1), 2)


def test_train_step_with_the_suffixed_outputs_matches_ace_tpu(multi_call):
    """The MSE over 2 forward steps with ``include_multi_call_in_loss``
    (both calls of each step in the graph) against ``jax.grad`` of
    ace_tpu's ``loss_fn``: the loss and per-step losses within 1e-5
    relative; every gradient within 1e-3 relative L2 plus 1e-6 of the
    largest gradient's norm (the moisture budget's float32 means,
    ``BUDGET_TOL``, reach the loss through the precipitation); the first
    block's output bias (zero true gradient, the next instance norm
    removes it) within 1e-5 of the largest norm on both sides."""
    jstepper, stepper = multi_call
    jts, ts = _train_steppers(jstepper, stepper)
    assert ts.step_loss.loss.out_names == stepper.step.output_names
    batch = _batch(stepper, stepper.step.output_names)
    (_, ref), ref_grads = _jax_loss(jts, jstepper.params, batch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, metrics = ts.loss_fn(tbatch, None)
    loss, grads = flagship.train_gradients(ts, tbatch)
    for k in ("loss", "loss_step_0", "loss_step_1"):
        np.testing.assert_allclose(float(metrics[k]), float(ref[k]),
                                   rtol=1e-5, err_msg=k)
    out = dict(_flat(state_dict_to_flax_params(grads)))
    ref_g = dict(_flat(ref_grads["params"]))
    assert set(out) == set(ref_g)
    largest = max(np.linalg.norm(r) for r in ref_g.values())
    for k, r in ref_g.items():
        err = np.linalg.norm(out[k] - r)
        if k == "block_0/mlp/fc2/bias":
            assert max(np.linalg.norm(out[k]), np.linalg.norm(r)) <= (
                1e-5 * largest), k
            continue
        assert err <= 1e-3 * np.linalg.norm(r) + 1e-6 * largest, (k, err)


def test_include_multi_call_in_loss_false(multi_call):
    """With a multi-call config and ``include_multi_call_in_loss: false``
    the port's loss is over the wrapped step's outputs and reads no
    suffixed target: it equals ace_tpu's loss of the wrapped step alone.
    ace_tpu builds its loss over every output and reads a target for each
    (``ace_tpu/stepper/train.py:133-137,263``), so on the same batch it
    raises for the missing suffixed targets (a behavior of the reference,
    ROADMAP Queue 3)."""
    jstepper, stepper = multi_call
    selector = copy.deepcopy(som_case(CASE))
    selector["config"]["include_multi_call_in_loss"] = False
    jstepper_f, stepper_f = steppers(selector)
    wrapped = stepper_f.step.config.wrapped_step.instance
    assert stepper_f.step.loss_names == wrapped.output_names
    _, ts = _train_steppers(jstepper_f, stepper_f)
    assert ts.step_loss.loss.out_names == stepper_f.step.loss_names
    batch = _batch(stepper_f, stepper_f.step.loss_names)
    assert not set(batch) & {get_multi_call_name(k, SUFFIX)
                             for k in chip_smoke.M_FLUXES}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = ts.loss_fn(tbatch, None)
    jts_f, _ = _train_steppers(jstepper_f, stepper_f)
    with pytest.raises(KeyError):
        _jax_loss(jts_f, jstepper_f.params, batch)
    alone, _ = steppers(som_recipe_step())
    jts_alone, _ = _train_steppers(alone, stepper)
    (ref, _), _ = _jax_loss(jts_alone, jstepper_f.params, batch)
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)


@pytest.mark.parametrize("override", ["none", "dict"])
def test_stepper_override_multi_call_matches_ace_tpu(override, tmp_path):
    """``stepper_override.multi_call`` on an ace_tpu checkpoint: None turns
    the multi-call off (the wrapped step's outputs only), a dict sets it
    on the SOM recipe's step (whose YAML has none); the port's 3-step
    rollout agrees with ace_tpu's under the same override."""
    selector = som_case(CASE) if override == "none" else som_recipe_step()
    value = None if override == "none" else chip_smoke.M_MULTI_CALL
    jstepper, _ = steppers(selector)
    path = str(tmp_path / "ace_tpu.msgpack")
    config = JaxStepperConfig(step=JaxStepSelector(**copy.deepcopy(selector)))
    jax_checkpoint.save_stepper(path, jstepper, config)
    ref_stepper = jax_checkpoint.load_stepper(
        path, override=JaxStepperOverrideConfig(multi_call=value))
    stepper = checkpoint.load_stepper(
        path, override=StepperOverrideConfig(multi_call=value), device="cpu")
    suffixed = {get_multi_call_name(k, SUFFIX) for k in chip_smoke.M_FLUXES}
    names = set(stepper.out_names)
    assert names == set(ref_stepper.out_names)
    assert (suffixed <= names) == (override == "dict")
    out, ref = rollouts(ref_stepper, stepper, n_steps=3)
    assert sorted(out) == sorted(ref)
    assert_close(out, ref)
