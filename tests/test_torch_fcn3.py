"""The port's FourCastNet3 (``ace_tpu_torch/models/fcn3.py``) and FCN3
step (``core/step/fcn3.py``) against ace_tpu's at 16x32, float32 on both
sides, with ace_tpu's weights carried across by ``utils/convert.py``
(the global filters drawn at std 1/sqrt(in) so that they show):
``GroupedDiscoConv``, ``DiscoEncoder``, ``DiscoDecoder`` (bilinear and
SHT), ``FCN3Block`` (global and local, layer norm on and off) and the
whole network (2 levels with a diagnostic in each, scale factor 2), each
output within 1e-4 of its channel's spatial anomaly plus 1e-5 of its
value; the step config's names; a step and a 3-step ``Stepper.predict``;
one train step under MSE (loss 1e-4 relative, each gradient 1e-3 of its
norm); the converter both ways, and a stepper checkpoint both ways."""

import json
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from ace_tpu.core import coordinates as jax_coords
from ace_tpu.core.config import from_dict as jax_from_dict
from ace_tpu.core.dataset_info import DatasetInfo as JaxDatasetInfo
from ace_tpu.core.loss import StepLossConfig as JaxStepLossConfig
from ace_tpu.core.optimization import EMAConfig as JaxEMAConfig
from ace_tpu.core.optimization import OptimizationConfig as JaxOptConfig
from ace_tpu.core.step import StepArgs as JaxStepArgs
from ace_tpu.core.step import StepSelector as JaxStepSelector
from ace_tpu.core.step.fcn3 import FCN3StepConfig as JaxFCN3StepConfig
from ace_tpu.models import fcn3 as jax_fcn3
from ace_tpu.ops import sht as jax_sht
from ace_tpu.stepper import checkpoint as jax_checkpoint
from ace_tpu.stepper.stepper import PrognosticState as JaxPrognosticState
from ace_tpu.stepper.stepper import StepperConfig as JaxStepperConfig
from ace_tpu.stepper.train import StepperTrainConfig as JaxTrainConfig
from ace_tpu.stepper.train import TrainStepper as JaxTrainStepper
from ace_tpu_torch import flagship
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.loss import StepLossConfig
from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
from ace_tpu_torch.core.step import StepArgs, StepSelector
from ace_tpu_torch.core.step.fcn3 import FCN3StepConfig
from ace_tpu_torch.models import fcn3
from ace_tpu_torch.ops import sht
from ace_tpu_torch.stepper import checkpoint
from ace_tpu_torch.stepper.stepper import PrognosticState, StepperConfig
from ace_tpu_torch.stepper.train import StepperTrainConfig, TrainStepper
from ace_tpu_torch.utils.convert import (
    flax_name,
    flax_params_to_state_dict,
    flax_view,
    state_dict_to_flax_params,
)

torch.set_num_threads(2)

NLAT, NLON, B = 16, 32, 2
# a small FCN3 of the recipe's shape: embeds 8, 4 layers (two global, two
# local), scale factor 2, 2 levels with a diagnostic in each
SIZES = {"atmo_embed_dim": 8, "surf_embed_dim": 8, "aux_embed_dim": 8,
         "num_layers": 4, "scale_factor": 2}
OUT_TOL = 1e-4
LOSS_TOL = 1e-4
GRAD_TOL = 1e-3
OPT = dict(lr=1e-4, optimizer_type="AdamW")


def _draw(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _assert_close(got, ref, tol=OUT_TOL, field=False):
    """``[..., H, W, C]`` (a variable's ``[..., H, W]`` with ``field``)
    within ``tol`` of each channel's largest spatial anomaly plus 1e-5 of
    its largest value."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    spatial = (-2, -1) if field else (-3, -2)
    anomaly = np.abs(ref - ref.mean(spatial, keepdims=True)).max(
        spatial, keepdims=True)
    allowed = tol * anomaly + 1e-5 * np.abs(ref).max(spatial, keepdims=True)
    assert (np.abs(got - ref) <= allowed).all(), float(
        (np.abs(got - ref) / allowed).max())


def _perturb(params, seed=1):
    """The global filters (flax ``[I, O, L, 2]``, init std 1/(I*O)) at std
    1/sqrt(I) so that they show in the outputs."""
    rng = np.random.RandomState(seed)

    def visit(path, leaf):
        name = "/".join(str(p.key) for p in path)
        if name.endswith("global_conv/weight"):
            return np.asarray(rng.randn(*leaf.shape) * leaf.shape[0] ** -0.5,
                              np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(visit, params)


def _pair(jmodule, module, *inputs):
    """ace_tpu's module initialized on ``inputs`` (the global filters
    perturbed), its output, and the port's module with those weights
    loaded and its output."""
    jin = [jnp.asarray(x) for x in inputs]
    params = _perturb(jmodule.init(jax.random.PRNGKey(0), *jin))
    module.load_state_dict(flax_params_to_state_dict(params))
    ref = jmodule.apply(params, *jin)
    with torch.no_grad():
        got = module(*(torch.from_numpy(x) for x in inputs))
    return got, ref, params


@pytest.mark.parametrize("case", [
    dict(in_shape=(16, 32), out_shape=(8, 16), in_chans=4, out_chans=6,
         groups=2, use_bias=True, grid_in="equiangular",
         grid_out="legendre-gauss"),
    dict(in_shape=(16, 32), out_shape=(16, 32), in_chans=6, out_chans=6,
         groups=1, theta_cutoff_factor=2.0, basis_type="morlet",
         grid_in="legendre-gauss", grid_out="legendre-gauss"),
], ids=["down-grouped-bias", "local-morlet"])
def test_grouped_disco_conv_matches_ace_tpu(case):
    """Its weight keeps flax's ``[K, G, Cin/G, Cout/G]``."""
    x = _draw((B, *case["in_shape"], case["in_chans"]))
    got, ref, params = _pair(jax_fcn3.GroupedDiscoConv(**case),
                             fcn3.GroupedDiscoConv(**case), x)
    _assert_close(got.numpy(), ref)
    assert params["params"]["weight"].shape[1] == case["groups"]


@pytest.mark.parametrize("use_mlp", [False, True])
def test_disco_encoder_matches_ace_tpu(use_mlp):
    kw = dict(inp_shape=(16, 32), out_shape=(8, 16), inp_chans=2,
              out_chans=8, grid_in="legendre-gauss",
              grid_out="legendre-gauss", groups=2, use_mlp=use_mlp,
              basis_type="morlet")
    got, ref, _ = _pair(jax_fcn3.DiscoEncoder(**kw), fcn3.DiscoEncoder(**kw),
                        _draw((B, 16, 32, 2)))
    _assert_close(got.numpy(), ref)


@pytest.mark.parametrize("upsample_sht, use_mlp",
                         [(False, False), (True, False), (False, True)],
                         ids=["bilinear", "sht", "bilinear-mlp"])
def test_disco_decoder_matches_ace_tpu(upsample_sht, use_mlp):
    kw = dict(inp_shape=(8, 16), out_shape=(16, 32), inp_chans=8,
              out_chans=3, grid_in="legendre-gauss",
              grid_out="legendre-gauss", groups=1, use_mlp=use_mlp,
              upsample_sht=upsample_sht, basis_type="morlet")
    got, ref, _ = _pair(jax_fcn3.DiscoDecoder(**kw), fcn3.DiscoDecoder(**kw),
                        _draw((B, 8, 16, 8)))
    _assert_close(got.numpy(), ref)


@pytest.mark.parametrize("conv_type", ["global", "local"])
@pytest.mark.parametrize("normalization", ["none", "layer_norm"])
def test_fcn3_block_matches_ace_tpu(conv_type, normalization):
    """24 channels in (the aux embedding appended), 16 out: the residual
    over the first 16."""
    h, w = 8, 16
    kw = dict(inp_chans=24, out_chans=16, conv_type=conv_type,
              basis_type="morlet", normalization=normalization)
    jblock = jax_fcn3.FCN3Block(
        forward_transform=jax_sht.build_sht(h, w, channels_last=True),
        inverse_transform=jax_sht.build_isht(h, w, channels_last=True), **kw)
    block = fcn3.FCN3Block(sht.build_sht(h, w), sht.build_isht(h, w), **kw)
    got, ref, params = _pair(jblock, block, _draw((B, h, w, 24)))
    _assert_close(got.numpy(), ref)
    assert set(params["params"]) == (
        {"global_conv" if conv_type == "global" else "local_conv", "mlp",
         "layer_scale"} | ({"norm"} if normalization == "layer_norm"
                           else set()))


def _network_kwargs():
    return dict(img_shape=(NLAT, NLON), n_atmo_channels=3, n_atmo_groups=2,
                n_surf_channels=3, n_aux_channels=2,
                n_atmo_diagnostic_channels=1, n_surf_diagnostic_channels=1,
                model_grid_type="legendre-gauss", filter_basis_type="morlet",
                **SIZES)


@pytest.fixture(scope="module")
def networks():
    kw = _network_kwargs()
    inputs = [_draw((B, NLAT, NLON, c), seed) for seed, c in
              enumerate((4, 2, 2))]
    jnet, net = jax_fcn3.FourCastNet3(**kw), fcn3.FourCastNet3(**kw)
    jin = [jnp.asarray(x) for x in inputs]
    params = _perturb(jax.jit(jnet.init)(jax.random.PRNGKey(0), *jin))
    net.load_state_dict(flax_params_to_state_dict(params))
    ref = jax.jit(jnet.apply)(params, *jin)
    return net, params, inputs, ref


def test_fourcastnet3_matches_ace_tpu(networks):
    """Both outputs: the atmosphere's level-major channels (3 a level, the
    diagnostic last) and the surface's."""
    net, _, inputs, (ref_atmo, ref_surf) = networks
    with torch.no_grad():
        atmo, surf = net(*(torch.from_numpy(x) for x in inputs))
    assert atmo.shape == (B, NLAT, NLON, 6) and surf.shape == (B, NLAT,
                                                               NLON, 3)
    _assert_close(atmo.numpy(), ref_atmo)
    _assert_close(surf.numpy(), ref_surf)


def test_weights_convert_both_ways(networks):
    """The global filter's ``global_conv/weight`` (flax ``[I, O, L, 2]``)
    becomes the port's ``[2, L, I, O]``; the grouped DISCO weights
    (``local_conv/weight``, an encoder's or decoder's ``conv/weight``, [K,
    G, cin, cout]) keep flax's layout; back to flax bit for bit;
    ``flax_name`` and ``flax_view`` give each leaf's flax name and
    layout."""
    net, params, _, _ = networks
    tree = params["params"]
    state = net.state_dict()
    w = state["block_0.global_conv.weight"]
    np.testing.assert_array_equal(
        w.numpy(), np.transpose(tree["block_0"]["global_conv"]["weight"],
                                (3, 2, 0, 1)))
    for key in ("block_1.local_conv.weight", "atmo_encoder.conv.weight",
                "atmo_decoder.conv.weight", "surf_decoder.conv.weight"):
        *path, name = key.split(".")
        leaf = tree
        for part in path:
            leaf = leaf[part]
        assert state[key].dim() == 4
        np.testing.assert_array_equal(state[key].numpy(), leaf[name])
        np.testing.assert_array_equal(flax_view(key, state[key]).numpy(),
                                      leaf[name])
    np.testing.assert_array_equal(
        flax_view("block_0.global_conv.weight", w).numpy(),
        tree["block_0"]["global_conv"]["weight"])
    assert flax_name("block_2.global_conv.weight", w) == (
        "params/block_2/global_conv/weight")
    back = state_dict_to_flax_params(state)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(state)
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)


# --- the step -----------------------------------------------------------


def _step_dict():
    return chip_smoke.fcn3_step_dict(levels=2, diagnostic=True, **SIZES)


def test_step_config_names_match_ace_tpu():
    """Level-major, variables fastest, as tests/test_fcn3.py checks
    ace_tpu's; every derived list and name set equal to ace_tpu's; the
    state drops the derived lists and builds the config again."""
    config = from_dict(FCN3StepConfig, _step_dict())
    jconfig = jax_from_dict(JaxFCN3StepConfig, _step_dict())
    assert config.atmosphere_input_names == [
        "air_temperature_0", "specific_total_water_0", "eastward_wind_0",
        "northward_wind_0", "air_temperature_1", "specific_total_water_1",
        "eastward_wind_1", "northward_wind_1"]
    assert config.atmosphere_output_names[:5] == (
        config.atmosphere_input_names[:4] + [f"{chip_smoke.N_DIAGNOSTIC}_0"])
    for name in ("atmosphere_input_names", "atmosphere_output_names",
                 "surface_input_names", "surface_output_names", "in_names",
                 "out_names", "input_names", "output_names",
                 "next_step_input_names", "prognostic_names",
                 "forcing_names", "_normalize_names"):
        assert getattr(config, name) == list(getattr(jconfig, name)), name
    assert sorted(set(config.output_names) - set(config.input_names)) == (
        sorted(jconfig.diagnostic_names))
    state = config.get_state()
    assert "in_names" not in state and "atmosphere_input_names" not in state
    assert from_dict(FCN3StepConfig, state).in_names == config.in_names
    with pytest.raises(ValueError, match="next_step_forcing_name"):
        from_dict(FCN3StepConfig, {**_step_dict(),
                                   "next_step_forcing_names": ["PRESsfc"]})
    with pytest.raises(ValueError, match="prescribed_prognostic_name"):
        from_dict(FCN3StepConfig, {**_step_dict(),
                                   "prescribed_prognostic_names": ["x"]})


def _jax_info():
    return JaxDatasetInfo(
        horizontal_coordinates=jax_coords.LatLonCoordinates(
            lat=jax_coords.gaussian_latitudes(NLAT),
            lon=np.linspace(0, 360, NLON, endpoint=False)),
        timestep=timedelta(hours=6))


def _data(names, n_times, seed):
    """numpy draws at ``chip_smoke._field_scale``'s scales (the ocean
    fraction in [0, 1])."""
    rng = np.random.RandomState(seed)
    out = {}
    for k in sorted(names):
        mean, std, positive = chip_smoke._field_scale(k)
        v = rng.randn(B, n_times, NLAT, NLON)
        v = (np.clip(np.abs(v), 0, 1) if k == "ocean_fraction"
             else (np.abs(v) if positive else v) * std + mean)
        out[k] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def steppers():
    """ace_tpu's stepper of the small FCN3 step (its global filters
    perturbed) and the port's, on the CPU, with the same weights."""
    selector = {"type": "FCN3", "config": _step_dict()}
    jstepper = JaxStepperConfig(step=JaxStepSelector(
        **json.loads(json.dumps(selector)))).get_stepper(_jax_info())
    jstepper.params = _perturb(jstepper.init_params(jax.random.PRNGKey(0)))
    config, info = chip_smoke.fcn3_stepper_config(NLAT, NLON, **SIZES)
    stepper = config.get_stepper(info, device="cpu")
    stepper.load_state_dict(flax_params_to_state_dict(jstepper.params))
    return jstepper, stepper, config


def test_ocean_and_corrector_options_match_ace_tpu():
    """The step's prescribed SST (``ocean``) and the atmosphere corrector
    (dry air, positive water), with a surface temperature among the
    surface prognostics, the ocean fraction among the forcings and the
    hybrid vertical coordinate of the 2 levels: one step against
    ace_tpu's (the surface pressure within 1e-5 of its value: each
    package's dry-air target is a float32 global mean, ace_tpu's a few
    1e-6 off float64, tests/test_torch_stepper.py), and the SST the
    prescribed one where the ocean fraction is 1."""
    from ace_tpu_torch.core.coordinates import (
        HybridSigmaPressureCoordinate,
        LatLonCoordinates,
        gaussian_latitudes,
    )
    from ace_tpu_torch.core.dataset_info import DatasetInfo

    step = _step_dict()
    step["surface_prognostic_names"] = ["PRESsfc", "surface_temperature"]
    step["forcing_names"] = step["forcing_names"] + ["ocean_fraction"]
    step["ocean"] = {"surface_temperature_name": "surface_temperature",
                     "ocean_fraction_name": "ocean_fraction"}
    step["corrector"] = {"conserve_dry_air": True,
                         "force_positive_names": ["specific_total_water_0"]}
    names = chip_smoke._fcn3_names(step)
    step["normalization"]["network"] = {
        "means": {k: chip_smoke._field_scale(k)[0] for k in names},
        "stds": {k: chip_smoke._field_scale(k)[1] for k in names}}
    ak, bk = np.asarray([100.0, 5000.0, 0.0]), np.asarray([0.0, 0.4, 1.0])
    jinfo = _jax_info()
    jinfo = JaxDatasetInfo(
        horizontal_coordinates=jinfo.horizontal_coordinates,
        vertical_coordinate=jax_coords.HybridSigmaPressureCoordinate(
            ak=ak, bk=bk), timestep=jinfo.timestep)
    jstepper = JaxStepperConfig(step=JaxStepSelector(
        type="FCN3", config=json.loads(json.dumps(step)))).get_stepper(jinfo)
    jstepper.params = _perturb(jstepper.init_params(jax.random.PRNGKey(2)))
    info = DatasetInfo(
        horizontal_coordinates=LatLonCoordinates(
            lat=gaussian_latitudes(NLAT),
            lon=np.linspace(0, 360, NLON, endpoint=False)),
        vertical_coordinate=HybridSigmaPressureCoordinate(ak=ak, bk=bk),
        timestep=timedelta(hours=6))
    stepper = StepperConfig(step=StepSelector(
        type="FCN3", config=step)).get_stepper(info, device="cpu")
    stepper.load_state_dict(flax_params_to_state_dict(jstepper.params))
    assert stepper.step.ocean is not None
    assert stepper.step.corrector is not None
    out, nxt = _compare_step(jstepper, stepper, seed=4)
    ocean = nxt["ocean_fraction"] == 1.0
    np.testing.assert_array_equal(out["surface_temperature"].numpy()[ocean],
                                  nxt["surface_temperature"][ocean])
    assert (out["specific_total_water_0"] >= 0).all()


def _compare_step(jstepper, stepper, seed=0):
    """One step of both packages' steps on the same inputs, each output
    within ``_assert_close``'s limits; returns the port's step output and
    the next-step inputs."""
    step, jstep = stepper.step, jstepper.step
    assert step.input_names == list(jstep.input_names)
    inputs = {k: v[:, 0] for k, v in _data(step.input_names, 1,
                                           seed).items()}
    nxt = {k: v[:, 0] for k, v in _data(step.next_step_input_names, 1,
                                        seed + 1).items()}

    def jax_step(params, jin, jnxt):
        return jstep.step(params, JaxStepArgs(
            input=jin, next_step_input_data=jnxt,
            stepper_state=jstep.init_stepper_state(jin))).output

    ref = jax.jit(jax_step)(
        jstepper.params, {k: jnp.asarray(v) for k, v in inputs.items()},
        {k: jnp.asarray(v) for k, v in nxt.items()})
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    args = StepArgs(input=tin,
                    next_step_input_data={k: torch.from_numpy(v)
                                          for k, v in nxt.items()},
                    stepper_state=step.init_stepper_state(tin))
    with torch.no_grad():
        out = step.step(args).output
    assert set(out) == set(ref) == set(step.output_names)
    for k in ref:
        _assert_close(out[k].numpy(), np.asarray(ref[k]), field=True)
    return out, nxt


def test_step_matches_ace_tpu(steppers):
    """One step, then the step refuses labels, as ace_tpu's does."""
    jstepper, stepper, _ = steppers
    _compare_step(jstepper, stepper)
    step = stepper.step
    inputs = {k: torch.from_numpy(v[:, 0])
              for k, v in _data(step.input_names, 1, 0).items()}
    args = StepArgs(input=inputs, next_step_input_data=inputs,
                    stepper_state={}, labels=torch.ones(B, 1))
    with pytest.raises(ValueError, match="Labels are not supported"):
        step.step(args)


def test_rollout_matches_ace_tpu(steppers):
    """A 3-step ``Stepper.predict`` from one initial condition and
    forcing."""
    jstepper, stepper, _ = steppers
    data = _data(set(stepper.prognostic_names)
                 | set(stepper.forcing_window_names), 4, 2)
    ic = {k: data[k][:, :1] for k in stepper.prognostic_names}
    forcing = {k: data[k] for k in stepper.forcing_window_names}
    assert sorted(jstepper.forcing_window_names) == sorted(forcing)
    ref, _ = jstepper.predict(
        JaxPrognosticState(data={k: jnp.asarray(v) for k, v in ic.items()}),
        {k: jnp.asarray(v) for k, v in forcing.items()})
    with torch.inference_mode():
        out, _ = stepper.predict(
            PrognosticState(data={k: torch.from_numpy(v)
                                  for k, v in ic.items()}),
            {k: torch.from_numpy(v) for k, v in forcing.items()})
    assert set(out) == set(ref)
    for k, r in ref.items():
        assert out[k].shape == (B, 3, NLAT, NLON)
        _assert_close(out[k].numpy(), np.asarray(r), field=True)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float64)


def test_train_step_matches_ace_tpu(steppers):
    """One ``train_step`` (MSE over 1 forward step, AdamW at 1e-4, the
    recipe's) from ace_tpu's weights against ace_tpu's jitted ``loss_fn``
    gradient and its optax update: the loss within 1e-4 relative, every
    gradient within 1e-3 of its norm (plus 1e-6 of the largest
    gradient's norm), each weight's update within 1e-2 relative L2
    (Adam's first update divides by the gradient's own size)."""
    jstepper, _, config = steppers
    params = jstepper.params
    names = sorted(set(jstepper.step.input_names)
                   | set(jstepper.step.output_names))
    batch = _data(names, 2, 3)
    loss = {"type": "MSE"}
    jts = JaxTrainStepper(
        jstepper, JaxTrainConfig(loss=jax_from_dict(JaxStepLossConfig, loss),
                                 n_forward_steps=1),
        JaxOptConfig(**OPT), JaxEMAConfig())
    (_, ref), ref_grads = jax.jit(jax.value_and_grad(
        jts.loss_fn, has_aux=True), static_argnums=3)(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(1), 1)
    updates, _ = jts.optimization.tx.update(
        ref_grads, jts.optimization.init(params), params)
    new_params = optax.apply_updates(params, updates)
    _, info = chip_smoke.fcn3_stepper_config(NLAT, NLON, **SIZES)
    stepper = config.get_stepper(info, device="cpu")
    stepper.load_state_dict(flax_params_to_state_dict(params))
    ts = TrainStepper(
        stepper, StepperTrainConfig(loss=from_dict(StepLossConfig, loss),
                                    n_forward_steps=1),
        from_dict(OptimizationConfig, OPT), EMAConfig())
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, grads = flagship.train_gradients(ts, tbatch)
    metrics = ts.train_step(tbatch, None)
    np.testing.assert_allclose(float(metrics["loss"]), float(ref["loss"]),
                               rtol=LOSS_TOL)
    out = dict(_flat(state_dict_to_flax_params(grads)))
    ref_g = dict(_flat(ref_grads["params"]))
    assert set(out) == set(ref_g)
    largest = max(np.linalg.norm(r) for r in ref_g.values())
    for k, r in ref_g.items():
        err = np.linalg.norm(out[k] - r)
        assert err <= GRAD_TOL * np.linalg.norm(r) + 1e-6 * largest, (k, err)
    before = dict(_flat(params["params"]))
    new = dict(_flat(state_dict_to_flax_params(ts.module.state_dict())))
    for k, r in _flat(new_params["params"]):
        step, ref_step = new[k] - before[k], r - before[k]
        assert (np.linalg.norm(step - ref_step)
                <= 1e-2 * np.linalg.norm(ref_step)), k


def test_checkpoints_load_both_ways(steppers, tmp_path):
    """ace_tpu's FCN3 stepper checkpoint loads in the port with its
    weights bit for bit; the port's ``save_stepper`` of it loads in
    ace_tpu and back in the port, bit for bit again, with the same step
    config."""
    jstepper, stepper, config = steppers
    path = str(tmp_path / "ace_tpu.msgpack")
    jax_checkpoint.save_stepper(
        path, jstepper, JaxStepperConfig(step=JaxStepSelector(
            type="FCN3", config=_step_dict())))
    port = checkpoint.load_stepper(path, device="cpu")
    for k, v in stepper.module.state_dict().items():
        torch.testing.assert_close(port.module.state_dict()[k], v, rtol=0,
                                   atol=0)
    back = str(tmp_path / "port.msgpack")
    checkpoint.save_stepper(back, port, config)
    again = jax_checkpoint.load_stepper(back)
    for a, b in zip(*map(jax.tree_util.tree_leaves,
                         (jstepper.params, again.params))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    reloaded = checkpoint.load_stepper(back, device="cpu")
    assert reloaded.step.config.in_names == stepper.step.config.in_names
    for k, v in port.module.state_dict().items():
        torch.testing.assert_close(reloaded.module.state_dict()[k], v,
                                   rtol=0, atol=0)
