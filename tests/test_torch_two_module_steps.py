"""The two-module steps against ace_tpu's, at 16x32 over the ACE2-SOM
recipe's variables with its slab ocean and corrector
(``chip_smoke.som_step_configs``): ``separate_radiation`` with and
without ``detach_radiation`` and ``secondary_module`` with a secondary
decoder, their outputs and their gradients against ``jax.grad``
(including the zeros where ``stop_gradient`` cuts a path); the
converter's round trips of the prefixed parameter trees, the frozen
rules on prefixed flax names, and checkpoints of each multi-module step
loaded both ways. Tolerances as tests/test_torch_step_options.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.core import wildcard as jax_wildcard
from ace_tpu.core.step import StepArgs as JaxStepArgs
from ace_tpu.core.step import StepSelector as JaxStepSelector
from ace_tpu.stepper import checkpoint as jax_checkpoint
from ace_tpu.stepper.stepper import StepperConfig as JaxStepperConfig
from ace_tpu_torch.core import wildcard
from ace_tpu_torch.stepper import checkpoint
from ace_tpu_torch.stepper.stepper import StepperConfig
from ace_tpu_torch.utils.convert import (
    flax_name,
    flax_params_to_state_dict,
    state_dict_to_flax_variables,
)
from tests.test_torch_slab_ocean import (
    assert_close,
    jax_step,
    port_step,
    som_case,
    step_inputs,
    steppers,
)
from tests.test_torch_step_options import assert_gradients_close

torch.set_num_threads(2)

RADIATION = "separate_radiation"
DETACHED = "separate_radiation detached"
SECONDARY = "secondary_module with a decoder"
DECODER = "per-channel global-mean removal, secondary decoder"
KEYS = {RADIATION: ["main", "radiation"], DETACHED: ["main", "radiation"],
        SECONDARY: ["main", "secondary", "secondary_decoder"],
        DECODER: ["main", "secondary_decoder"]}


@pytest.fixture(scope="module", params=[RADIATION, DETACHED, SECONDARY])
def two_module(request):
    return request.param, steppers(som_case(request.param))


# main-module diagnostics that neither the corrector nor the ocean reads
# from the radiation's outputs: a loss over them reaches the radiation
# module through the main module's input alone (and not when detached)
MAIN_ONLY = ["LHTFLsfc", "SHTFLsfc", "TMP850", "h500"]


def _loss_names(step, case):
    if case in (RADIATION, DETACHED):
        return MAIN_ONLY
    return step.output_names


def test_outputs_and_gradients_match_ace_tpu(two_module):
    """A step's outputs, and the gradients of a mean square of its
    normalized outputs, against ``jax.grad`` of ace_tpu's step; with
    ``detach_radiation`` the radiation module's gradients are zero on
    both sides, and ``secondary_module``'s decoder sees the main outputs
    detached as ace_tpu's does."""
    case, (jstepper, stepper) = two_module
    step = stepper.step
    assert sorted(step.module.keys()) == KEYS[case]
    inputs, nxt = step_inputs(step)
    out = port_step(stepper, inputs, nxt)
    ref = jax_step(jstepper, inputs, nxt)
    assert sorted(out.output) == sorted(ref.output)
    assert_close(out.output, ref.output)
    names = _loss_names(step, case)
    stds = step.normalizer.stds

    def loss_of(output, square):
        return sum(square(output[k] / stds[k]).mean() for k in names)

    loss_of(out.output, torch.square).backward()

    def jax_loss(params):
        jin = {k: jnp.asarray(v) for k, v in inputs.items()}
        result = jstepper.step.step(params, JaxStepArgs(
            input=jin,
            next_step_input_data={k: jnp.asarray(v) for k, v in nxt.items()},
            stepper_state=jstepper.step.init_stepper_state(jin)))
        return loss_of(result.output, jnp.square)

    ref_grads = jax.grad(jax_loss)(jstepper.params)
    grads = state_dict_to_flax_variables(
        {k: p.grad for k, p in step.module.named_parameters()
         if p.grad is not None})
    zero = ("radiation",) if case == DETACHED else ()
    assert_gradients_close(grads, ref_grads, zero=zero)
    if case == RADIATION:
        assert all(p.grad is not None and p.grad.any()
                   for p in step.module["radiation"].parameters()
                   if p.dim() > 1)


@pytest.mark.parametrize("case", [RADIATION, SECONDARY, DECODER])
def test_converter_round_trips_the_prefixed_trees(case):
    """ace_tpu's parameter tree of a multi-module step (``{module:
    {"params": ...}}``) becomes the port's ``nn.ModuleDict`` state under
    the same keys and comes back equal leaf for leaf; ``flax_name`` gives
    ace_tpu's "/"-joined names, on which both packages' frozen rules
    select the same parameters."""
    jstepper, stepper = steppers(som_case(case))
    state = stepper.module.state_dict()
    assert sorted({k.split(".")[0] for k in state}) == KEYS[case]
    back = state_dict_to_flax_variables(state)
    flat = jax.tree_util.tree_flatten_with_path(jstepper.params)[0]
    names = ["/".join(str(p.key) for p in path) for path, _ in flat]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))
    assert sorted(flax_name(k, v) for k, v in state.items()) == sorted(names)
    assert sorted(wildcard.param_names(state)) == sorted(
        jax_wildcard.param_names(jstepper.params))
    for rules in ([f"{KEYS[case][-1]}/*"],
                  ["*/params/encoder*", "main/params/block_0/*"]):
        mask = wildcard.build_mask(state, include=rules)
        ref = dict(zip(names, jax.tree_util.tree_leaves(
            jax_wildcard.build_mask(jstepper.params, include=rules))))
        assert {flax_name(k, state[k]): v for k, v in mask.items()} == ref
    again = flax_params_to_state_dict(back)
    assert sorted(again) == sorted(state)
    for k, v in state.items():
        assert torch.equal(again[k], v), k


@pytest.mark.parametrize("case", [RADIATION, SECONDARY, DECODER])
def test_checkpoints_load_both_ways(case, tmp_path):
    """An ace_tpu checkpoint of the step loads in the port, whose step
    agrees with ace_tpu's; the port's ``save_stepper`` of it loads in
    ace_tpu with the weights bit for bit."""
    selector = som_case(case)
    jstepper, _ = steppers(selector)
    path = str(tmp_path / "ace_tpu.msgpack")
    config = JaxStepperConfig(step=JaxStepSelector(**selector))
    jax_checkpoint.save_stepper(path, jstepper, config)
    port = checkpoint.load_stepper(path, device="cpu")
    inputs, nxt = step_inputs(port.step)
    assert_close(port_step(port, inputs, nxt).output,
                 jax_step(jstepper, inputs, nxt).output)
    back = str(tmp_path / "port.msgpack")
    checkpoint.save_stepper(back, port, StepperConfig.from_state(
        config.get_state()))
    again = jax_checkpoint.load_stepper(back)
    assert (jax.tree_util.tree_structure(again.params)
            == jax.tree_util.tree_structure(jstepper.params))
    for a, b in zip(*map(jax.tree_util.tree_leaves,
                         (jstepper.params, again.params))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _find_adam(state):
    """optax's Adam state inside a chain's nested tuples."""
    if hasattr(state, "mu"):
        return state
    if isinstance(state, (tuple, list)):
        for part in state:
            found = _find_adam(part)
            if found is not None:
                return found
    return None


def test_train_checkpoints_of_a_multi_module_step_load_both_ways(tmp_path):
    """The port's training checkpoint of ``secondary_module`` with a
    decoder (three modules): ace_tpu restores its optimizer tree into
    optax's own state, and the weights, both Adam moments and the EMA, in
    ace_tpu's ``{module: {"params": ...}}`` trees, are the port's bit for
    bit; the port reads them back."""
    from flax import serialization

    from ace_tpu.core.optimization import OptimizationConfig as JaxOptConfig
    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
    from ace_tpu_torch.stepper.train import StepperTrainConfig, TrainStepper

    selector = som_case(SECONDARY)
    _, stepper = steppers(selector)
    opt_config = {"lr": 1e-4, "optimizer_type": "AdamW"}
    ts = TrainStepper(stepper, StepperTrainConfig(),
                      from_dict(OptimizationConfig, opt_config), EMAConfig())
    ts.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    opt = ts.optimization
    with torch.no_grad():
        for group in (opt.mu, opt.nu, ts.ema.ema_params):
            for t in group:
                t.copy_(torch.randn(t.shape, generator=gen).abs())
    opt._count = opt.adam_count = opt.schedule_count = 3
    names = ts.parameter_names()
    assert {n.split(".")[0] for n in names} == set(KEYS[SECONDARY])
    path = str(tmp_path / "port.msgpack")
    checkpoint.save_train_checkpoint(
        path, stepper, StepperConfig.from_state(
            {"step": selector}), optimization=opt, parameter_names=names,
        ema_state=dict(zip(names, ts.ema.ema_params)), extra={"epoch": 1})
    out = jax_checkpoint.load_train_checkpoint(path)
    params = out["stepper"].params
    assert sorted(params) == KEYS[SECONDARY]
    template = JaxOptConfig(**opt_config).build(max_epochs=1).init(params)
    adam = _find_adam(serialization.from_state_dict(
        template, out["optimizer_state_dict"]))
    assert int(adam.count) == 3
    for ref, tensors in ((adam.mu, opt.mu), (adam.nu, opt.nu),
                         (out["ema_params"], ts.ema.ema_params),
                         (params, ts.parameters())):
        want = dict(jax.tree_util.tree_flatten_with_path(
            state_dict_to_flax_variables(dict(zip(names, tensors))))[0])
        got = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]))
    back = checkpoint.read_train_checkpoint(path)
    for key, tensors in (("mu", opt.mu), ("nu", opt.nu)):
        for n, t in zip(names, tensors):
            assert torch.equal(back["optimizer"][key][n], t), (key, n)
    for n, t in zip(names, ts.ema.ema_params):
        assert torch.equal(back["ema_state"][n], t), n
