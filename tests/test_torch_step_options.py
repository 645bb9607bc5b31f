"""The single-module step's options against ace_tpu's, on the ACE2-SOM
recipe's slab-ocean step at 16x32 (``chip_smoke.som_step_configs``):
global-mean removal in both modes with ``append_as_input``, input
dropout (the presence passed in on both sides; the port's own draw held
to its statistics), channel-mask inputs, and the secondary decoder's
outputs and gradients against ``jax.grad``. float32: outputs within 1e-5
of each variable's largest value (tests/test_torch_slab_ocean.py's
``assert_close``), gradients within 1e-4 relative L2 plus 1e-6 of the
largest gradient's norm."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.core import masking as jax_masking
from ace_tpu.core.normalizer import StandardNormalizer as JaxNormalizer
from ace_tpu.core.step import StepArgs as JaxStepArgs
from ace_tpu.core.step.global_mean_removal import (
    GlobalMeanRemovalConfig as JaxGMRConfig,
)
from ace_tpu_torch.core import masking
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.step import StepArgs
from ace_tpu_torch.core.normalizer import StandardNormalizer
from ace_tpu_torch.core.step.global_mean_removal import (
    GlobalMeanRemovalConfig,
)
from ace_tpu_torch.utils.convert import state_dict_to_flax_variables
from tests.test_torch_slab_ocean import (
    B,
    NLAT,
    NLON,
    assert_close,
    draw,
    jax_step,
    port_step,
    som_case,
    step_inputs,
    steppers,
)

torch.set_num_threads(2)

GMR_DECODER = "per-channel global-mean removal, secondary decoder"
GMR_MASKS = "shared global-mean removal, channel masks, input dropout"
DROPPED = ("HGTsfc", "TMP2m", "air_temperature_0_global_mean")


# --- global-mean removal ------------------------------------------------


@pytest.mark.parametrize("append", [True, False])
@pytest.mark.parametrize("mode", ["per_channel", "shared"])
def test_global_mean_removal_transforms_match_ace_tpu(mode, append):
    """``forward_transform`` (the shifted fields, the offsets and the
    normalized extra channels) and ``inverse_transform``. An offset is
    the normalizer's mean less a float32 spatial mean of a ~250 K field,
    so it is held within 1e-6 of the field's largest value (and an extra
    channel within that over the field's std)."""
    names = ["TMP2m", "air_temperature_0", "air_temperature_1"]
    fields = {"names": names, "mode": mode, "append_as_input": append}
    if mode == "shared":
        fields["reference_field"] = "TMP2m"
    means = {"TMP2m": 285.0, "air_temperature_0": 210.0,
             "air_temperature_1": 220.0}
    stds = {"TMP2m": 10.0, "air_temperature_0": 5.0,
            "air_temperature_1": 4.0}
    port = from_dict(GlobalMeanRemovalConfig, fields).build(
        StandardNormalizer(means, stds))
    ref = JaxGMRConfig(**fields).build(JaxNormalizer(means, stds))
    assert port.extra_channel_names == ref.extra_channel_names
    data = draw(names + ["PRESsfc"], (B, NLAT, NLON), 0)
    out, state = port.forward_transform(
        {k: torch.from_numpy(v) for k, v in data.items()})
    want, want_state = ref.forward_transform(
        {k: jnp.asarray(v) for k, v in data.items()})
    assert_close(out, want, 1e-6)
    assert sorted(state.extras) == sorted(want_state.extras)
    for k, v in want_state.extras.items():
        source = k[: -len("_global_mean")]
        np.testing.assert_allclose(
            state.extras[k].numpy(), np.asarray(v), rtol=0,
            atol=1e-6 * np.abs(data[source]).max() / stds[source])
    assert sorted(state.shifts) == sorted(want_state.shifts)
    for k, v in want_state.shifts.items():
        np.testing.assert_allclose(state.shifts[k].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-6 * np.abs(data[k]).max())
    back = port.inverse_transform(out, state)
    assert_close(back, data, 1e-6)


@pytest.mark.parametrize("case", [GMR_DECODER, GMR_MASKS])
def test_global_mean_removal_step_matches_ace_tpu(case):
    """A deterministic step of each mode with its extra channels (the
    shared mode with channel-mask inputs too)."""
    jstepper, stepper = steppers(som_case(case))
    assert stepper.step.in_packer.names == jstepper.step.in_packer.names
    inputs, nxt = step_inputs(stepper.step)
    out = port_step(stepper, inputs, nxt)
    ref = jax_step(jstepper, inputs, nxt)
    assert sorted(out.output) == sorted(ref.output)
    assert_close(out.output, ref.output)


# --- input dropout and channel-mask inputs ------------------------------


def _fixed_presence(step, as_array):
    return {n: as_array(n not in DROPPED) for n in step.in_packer.names}


def _network_inputs(module):
    """A hook that keeps the network's packed input of each call."""
    seen = []
    module.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    return seen


def test_input_dropout_and_channel_masks_match_ace_tpu(monkeypatch):
    """A train-mode step with input dropout's presence passed in on both
    sides (the packages' random streams differ): the outputs agree; the
    dropped channels (one a global-mean channel) are zero for every
    sample and their presence channels zero, the others' one."""
    jstepper, stepper = steppers(som_case(GMR_MASKS))
    step = stepper.step
    monkeypatch.setattr(
        type(jstepper.step), "_draw_input_dropout_presence",
        lambda self, args: _fixed_presence(self, jnp.asarray))
    step.draw_input_dropout_presence = lambda args: (
        None if args.deterministic
        else _fixed_presence(step, torch.tensor))
    seen = _network_inputs(step.network)
    inputs, nxt = step_inputs(step)
    out = port_step(stepper, inputs, nxt, deterministic=False)
    ref = jax_step(jstepper, inputs, nxt, deterministic=False)
    assert_close(out.output, ref.output)
    (packed,) = seen
    names = step.in_packer.names
    assert packed.shape[-1] == 2 * len(names)
    for i, name in enumerate(names):
        dropped = name in DROPPED
        assert bool((packed[..., i] == 0).all()) == dropped, name
        assert bool((packed[..., len(names) + i] == (0 if dropped else 1))
                    .all()), name
    # deterministic: no dropout, every presence channel one
    seen.clear()
    port_step(stepper, inputs, nxt)
    assert bool((seen[0][..., len(names):] == 1).all())


def test_input_dropout_draw_statistics():
    """The port's own draw: a Bernoulli group drops all its channels
    together at its rate, the uniform default drops k of its n channels
    with k uniform in [0, max] (each channel at max / (2 n)), one draw
    for the whole batch; nothing is drawn in a deterministic step or
    without a generator."""
    names = [f"c{i}" for i in range(6)] + ["g0", "g1"]
    config = from_dict(masking.VariableMaskingConfig, {
        "default": {"max_masked_vars": 3},
        "override_groups": [{"variables": ["g0", "g1"],
                             "masking": {"rate": 0.3}}]})
    vm = config.build(names)
    gen = torch.Generator().manual_seed(0)
    n = 4000
    draws = torch.stack([vm.sample_presence(gen) for _ in range(n)])
    dropped = (~draws).float().mean(0)
    assert torch.equal(draws[:, 6], draws[:, 7])
    assert abs(float(dropped[6]) - 0.3) < 0.03
    np.testing.assert_allclose(dropped[:6].numpy(), 3 / (2 * 6), atol=0.03)
    counts = (~draws[:, :6]).sum(1)
    freq = torch.bincount(counts, minlength=4).float() / n
    np.testing.assert_allclose(freq.numpy(), 0.25, atol=0.03)
    assert int(counts.max()) == 3
    # ace_tpu's draw has the same law (its own stream)
    ref = jax_masking.VariableMaskingConfig(
        default=jax_masking.UniformMaskingConfig(3),
        override_groups=[jax_masking.MaskingGroupConfig(
            ["g0", "g1"], jax_masking.BernoulliMaskingConfig(0.3))],
    ).build(names)
    keys = jax.random.split(jax.random.PRNGKey(0), 1000)
    ref_dropped = (~np.stack([np.asarray(ref.sample_presence(k))
                              for k in keys])).mean(0)
    np.testing.assert_allclose(ref_dropped, dropped.numpy(), atol=0.06)

    _, stepper = steppers(som_case(GMR_MASKS))
    step = stepper.step
    inputs, nxt = step_inputs(step)
    gen = torch.Generator().manual_seed(1)
    state = gen.get_state()
    port_step(stepper, inputs, nxt, generator=gen)
    assert torch.equal(gen.get_state(), state)
    seen = _network_inputs(step.network)
    port_step(stepper, inputs, nxt, deterministic=False, generator=gen)
    assert not torch.equal(gen.get_state(), state)
    (packed,) = seen
    masks = packed[..., len(step.in_packer.names):]
    # one draw for the batch: every sample has the same presence
    assert torch.equal(masks[0], masks[1])
    assert step.draw_input_dropout_presence(
        type("Args", (), {"deterministic": False, "generator": None})()
    ) is None


# --- the secondary decoder ----------------------------------------------


def _loss_scales(stepper):
    return {k: float(v) for k, v in
            stepper.step.normalizer.stds.items()}


def test_secondary_decoder_outputs_and_gradients_match_ace_tpu():
    """The decoded diagnostics of a step, and the gradients of a loss over
    the decoded diagnostics only, against ``jax.grad``: the decoder reads
    the main module's outputs detached (``stop_gradient``), so the main
    module's gradients are zero on both sides and the decoder's agree."""
    jstepper, stepper = steppers(som_case(GMR_DECODER))
    step = stepper.step
    decoded = step.config.secondary_decoder.secondary_diagnostic_names
    assert sorted(step.module.keys()) == ["main", "secondary_decoder"]
    inputs, nxt = step_inputs(step)
    scales = _loss_scales(stepper)

    def loss_of(output, square):
        return sum(square(output[k] / scales[k]).mean() for k in decoded)

    out = port_step(stepper, inputs, nxt)
    ref = jax_step(jstepper, inputs, nxt)
    assert_close(out.output, ref.output)
    loss_of(out.output, torch.square).backward()

    def jax_loss(params):
        jin = {k: jnp.asarray(v) for k, v in inputs.items()}
        result = jstepper.step.step(params, JaxStepArgs(
            input=jin,
            next_step_input_data={k: jnp.asarray(v) for k, v in nxt.items()},
            stepper_state=jstepper.step.init_stepper_state(jin)))
        return loss_of(result.output, jnp.square)

    ref_grads = jax.grad(jax_loss)(jstepper.params)
    assert all(p.grad is None for p in step.network.parameters())
    grads = state_dict_to_flax_variables(
        {k: p.grad for k, p in step.module.named_parameters()
         if p.grad is not None})
    assert_gradients_close(grads, ref_grads, zero=("main",))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float64)


def assert_gradients_close(grads, ref_grads, zero=(), tol=1e-4):
    """Every gradient (flax names) within ``tol`` relative L2 plus 1e-6 of
    the largest gradient's norm; those of the ``zero`` modules exactly
    zero on both sides, those of a block's output bias whose next
    instance norm removes it below 1e-5 of the largest norm. A parameter
    without a gradient in the port (outside the graph) is zero in
    ace_tpu."""
    out = dict(_flat(grads))
    ref = dict(_flat(ref_grads))
    assert set(out) <= set(ref)
    largest = max(np.linalg.norm(r) for r in ref.values())
    assert largest > 0
    for k, r in ref.items():
        o = out.get(k, np.zeros_like(r))
        if k.split("/")[0] in zero:
            assert not r.any() and not o.any(), k
        elif k.endswith("block_0/mlp/fc2/bias"):
            assert max(np.linalg.norm(o), np.linalg.norm(r)) <= (
                1e-5 * largest), k
        else:
            err = np.linalg.norm(o - r)
            assert err <= tol * np.linalg.norm(r) + 1e-6 * largest, (k, err)


def test_data_mask_joins_input_dropout_as_in_ace_tpu(monkeypatch):
    """A train-mode step with a dataset presence per sample
    (``StepArgs.data_mask``: ``air_temperature_0`` missing from the first
    sample, ``HGTsfc`` from the second) and input dropout's presence
    passed in, on both sides: the outputs agree; a masked sample's channel
    is zero and so is its presence channel, the global-mean channel of
    ``air_temperature_0`` following its source's presence, and dropout's
    channels stay dropped for every sample."""
    jstepper, stepper = steppers(som_case(GMR_MASKS))
    step = stepper.step
    monkeypatch.setattr(
        type(jstepper.step), "_draw_input_dropout_presence",
        lambda self, args: _fixed_presence(self, jnp.asarray))
    step.draw_input_dropout_presence = lambda args: (
        None if args.deterministic
        else _fixed_presence(step, torch.tensor))
    seen = _network_inputs(step.network)
    inputs, nxt = step_inputs(step)
    mask = {"air_temperature_0": np.asarray([0.0, 1.0], np.float32),
            "HGTsfc": np.asarray([1.0, 0.0], np.float32)}
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    out = step.step(StepArgs(
        input=tin,
        next_step_input_data={k: torch.from_numpy(v) for k, v in nxt.items()},
        stepper_state=step.init_stepper_state(tin), deterministic=False,
        data_mask={k: torch.from_numpy(v) for k, v in mask.items()}))
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    ref = jstepper.step.step(jstepper.params, JaxStepArgs(
        input=jin,
        next_step_input_data={k: jnp.asarray(v) for k, v in nxt.items()},
        stepper_state=jstepper.step.init_stepper_state(jin),
        deterministic=False, rng=None,
        data_mask={k: jnp.asarray(v) for k, v in mask.items()}))
    assert_close(out.output, ref.output)
    (packed,) = seen
    names = step.in_packer.names
    missing = {"air_temperature_0": 0, "air_temperature_0_global_mean": 0,
               "HGTsfc": 1}
    for i, name in enumerate(names):
        for row in range(2):
            gone = name in DROPPED or missing.get(name) == row
            assert bool((packed[row, ..., i] == 0).all()) == gone, (name,
                                                                     row)
            assert bool((packed[row, ..., len(names) + i]
                         == (0 if gone else 1)).all()), (name, row)
