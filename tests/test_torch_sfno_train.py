"""SphericalFourierNeuralOperatorNet in the port's stepper, trainer and
entries against ace_tpu's: checkpoints both ways, one ``TrainStepper``
train step (MSE over 2 forward steps: loss, every gradient, the updated
weights), and ``tests/test_train_integration.py``'s SFNO config through
both training entries from the same initial weights
(tests/test_torch_shield_path.py runs ``chip_smoke.py``'s path S on the
CPU)."""

import json
import os
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from ace_tpu.core import coordinates as jax_coords
from ace_tpu.core.config import from_dict as jax_from_dict
from ace_tpu.core.config import to_dict as jax_to_dict
from ace_tpu.core.dataset_info import DatasetInfo as JaxDatasetInfo
from ace_tpu.core.loss import StepLossConfig as JaxStepLossConfig
from ace_tpu.core.optimization import EMAConfig as JaxEMAConfig
from ace_tpu.core.optimization import OptimizationConfig as JaxOptConfig
from ace_tpu.core.step import StepSelector as JaxStepSelector
from ace_tpu.core.step.single_module import (
    SingleModuleStepConfig as JaxSingleModuleStepConfig,
)
from ace_tpu.stepper import checkpoint as jax_checkpoint
from ace_tpu.stepper import train as jax_train
from ace_tpu.stepper.stepper import PrognosticState as JaxPrognosticState
from ace_tpu.stepper.stepper import StepperConfig as JaxStepperConfig
from ace_tpu.stepper.train import StepperTrainConfig as JaxTrainConfig
from ace_tpu.stepper.train import TrainStepper as JaxTrainStepper
from ace_tpu.testing import SyntheticData
from ace_tpu.train.train import main as jax_main
from ace_tpu_torch import flagship
from ace_tpu_torch.core import coordinates
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.loss import StepLossConfig
from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
from ace_tpu_torch.core.step import StepSelector
from ace_tpu_torch.stepper import checkpoint
from ace_tpu_torch.stepper import train as port_train
from ace_tpu_torch.stepper.checkpoint import read_train_checkpoint
from ace_tpu_torch.stepper.stepper import PrognosticState, StepperConfig
from ace_tpu_torch.stepper.train import StepperTrainConfig, TrainStepper
from ace_tpu_torch.train.train import main
from ace_tpu_torch.utils.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)

torch.set_num_threads(2)

NLAT, NLON, B = 16, 32, 2
PROGNOSTIC = ["air_temperature_0", "air_temperature_1",
              "specific_total_water_0", "specific_total_water_1", "PRESsfc",
              "surface_temperature"]
DIAGNOSTIC = ["PRATEsfc", "LHTFLsfc"]
FORCING = ["DSWRFtoa", "ocean_fraction"]
NAMES = sorted(PROGNOSTIC + DIAGNOSTIC + FORCING)
MEANS = {"PRESsfc": 1.0e5, "surface_temperature": 280.0}
STDS = {"PRESsfc": 1000.0, "surface_temperature": 10.0}
AK = np.asarray([100.0, 5000.0, 0.0])
BK = np.asarray([0.0, 0.4, 1.0])
OPT = dict(lr=1e-4, optimizer_type="AdamW", max_grad_norm=0.01)
# the learning rate of tests/test_train_integration.py's config
LR = 1e-3


def _step_dict():
    """The SHiELD recipe's network (dhconv, instance norms, learned
    position embedding, big skip, f32) at embed 32 and 2 layers, with the
    dry-air corrector, prescribed SST and residual loss statistics."""
    return dict(
        builder={"type": "SphericalFourierNeuralOperatorNet", "config": {
            "embed_dim": 32, "num_layers": 2, "operator_type": "dhconv",
            "normalization_layer": "instance_norm", "pos_embed": True,
            "spectral_layers": 3, "hard_thresholding_fraction": 1.0}},
        in_names=PROGNOSTIC + FORCING,
        out_names=PROGNOSTIC + DIAGNOSTIC,
        normalization={
            "network": {"means": {n: MEANS.get(n, 0.0) for n in NAMES},
                        "stds": {n: STDS.get(n, 1.0) for n in NAMES}},
            "residual": {"means": {n: 0.1 for n in NAMES},
                         "stds": {n: 2.0 * STDS.get(n, 1.0) for n in NAMES}},
        },
        ocean={"surface_temperature_name": "surface_temperature",
               "ocean_fraction_name": "ocean_fraction"},
        corrector={"conserve_dry_air": True,
                   "force_positive_names": ["specific_total_water_0"]},
    )


def _grid():
    return (jax_coords.gaussian_latitudes(NLAT),
            np.linspace(0, 360, NLON, endpoint=False))


@pytest.fixture(scope="module")
def jax_side():
    """ace_tpu's stepper, its config and its parameters, the filters drawn
    at std 1/sqrt(in) so that they show in the outputs."""
    lat, lon = _grid()
    info = JaxDatasetInfo(
        horizontal_coordinates=jax_coords.LatLonCoordinates(lat=lat, lon=lon),
        vertical_coordinate=jax_coords.HybridSigmaPressureCoordinate(
            ak=AK, bk=BK),
        timestep=timedelta(hours=6),
    )
    step = jax_from_dict(JaxSingleModuleStepConfig, _step_dict())
    config = JaxStepperConfig(step=JaxStepSelector(
        type="single_module", config=jax_to_dict(step)))
    stepper = config.get_stepper(info)
    params = stepper.init_params(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)

    def perturb(path, leaf):
        name = "/".join(str(p.key) for p in path)
        if name.endswith("filter/weight"):
            return jnp.asarray(rng.randn(*leaf.shape) * leaf.shape[0] ** -0.5,
                               leaf.dtype)
        return leaf

    stepper.params = jax.tree_util.tree_map_with_path(perturb, params)
    return stepper, config, stepper.params


def _data(n_forward, seed=0):
    rng = np.random.RandomState(seed)
    batch = {k: rng.randn(B, n_forward + 1, NLAT, NLON).astype(np.float32)
             for k in NAMES}
    batch["PRESsfc"] = batch["PRESsfc"] * 1000 + 1.0e5
    batch["surface_temperature"] = batch["surface_temperature"] * 10 + 280
    for k in ("specific_total_water_0", "specific_total_water_1"):
        batch[k] = np.abs(batch[k]) * 1e-3
    batch["ocean_fraction"] = np.clip(np.abs(batch["ocean_fraction"]), 0, 1)
    return batch


def _predict(stepper, batch, jax_side):
    ic = {k: batch[k][:, :1] for k in PROGNOSTIC}
    forcing = {k: batch[k] for k in stepper.forcing_window_names}
    if jax_side:
        out, _ = stepper.predict(
            JaxPrognosticState(data={k: jnp.asarray(v)
                                     for k, v in ic.items()}),
            {k: jnp.asarray(v) for k, v in forcing.items()})
        return {k: np.asarray(v) for k, v in out.items()}
    out, _ = stepper.predict(
        PrognosticState(data={k: torch.from_numpy(v) for k, v in ic.items()}),
        {k: torch.from_numpy(v) for k, v in forcing.items()})
    return {k: v.numpy() for k, v in out.items()}


def _assert_predictions_close(out, ref):
    """float32 on both sides in another summation order: each variable
    within 1e-4 of its normalization std (the network's output unit) plus
    1e-5 of its largest value, as tests/test_torch_stepper.py holds the
    conditional SFNO's steps. The second term is the dry-air target's:
    ace_tpu's float32 global mean of ~1e5 Pa is a few 1e-6 off a float64
    evaluation (0.3 Pa measured here)."""
    assert set(out) == set(ref)
    for k, r in ref.items():
        tol = 1e-4 * STDS.get(k, 1.0) + 1e-5 * float(np.abs(r).max())
        np.testing.assert_allclose(out[k], r, rtol=0, atol=tol, err_msg=k)


def test_checkpoints_load_both_ways_and_predict_alike(jax_side, tmp_path):
    """An ace_tpu SFNO stepper checkpoint loads in the port, whose 3-step
    rollout agrees with ace_tpu's; the port's ``save_stepper`` of it loads
    in ace_tpu, which predicts the same again, and its weights are
    ace_tpu's bit for bit."""
    stepper, config, params = jax_side
    path = str(tmp_path / "ace_tpu.msgpack")
    jax_checkpoint.save_stepper(path, stepper, config)
    port = checkpoint.load_stepper(path, device="cpu")
    batch = _data(3)
    ref = _predict(stepper, batch, True)
    _assert_predictions_close(_predict(port, batch, False), ref)
    back = str(tmp_path / "port.msgpack")
    port_config = checkpoint.StepperConfig.from_state(
        json.loads(checkpoint.load_msgpack(path)["stepper"]["config"]))
    checkpoint.save_stepper(back, port, port_config)
    again = jax_checkpoint.load_stepper(back)
    for a, b in zip(*map(jax.tree_util.tree_leaves, (params, again.params))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _assert_predictions_close(_predict(again, batch, True), ref)


def _torch_train_stepper(params):
    lat, lon = _grid()
    info = DatasetInfo(
        horizontal_coordinates=coordinates.LatLonCoordinates(lat=lat, lon=lon),
        vertical_coordinate=coordinates.HybridSigmaPressureCoordinate(
            ak=AK, bk=BK),
        timestep=timedelta(hours=6),
    )
    stepper = StepperConfig(step=StepSelector(
        type="single_module", config=_step_dict())).get_stepper(
        info, device="cpu")
    stepper.load_state_dict(flax_params_to_state_dict(params))
    return TrainStepper(
        stepper,
        StepperTrainConfig(loss=from_dict(StepLossConfig, {"type": "MSE"}),
                           n_forward_steps=2),
        from_dict(OptimizationConfig, OPT), EMAConfig())


# a block's output bias adds a per-channel constant that the next block's
# instance norm removes: its true gradient is zero (2 layers)
ZERO_GRADIENT = {"block_0/mlp/fc2/bias"}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float64)


def test_train_step_matches_ace_tpu(jax_side):
    """One ``train_step`` (MSE over 2 forward steps, AdamW clipped at 0.01)
    from ace_tpu's weights, against ace_tpu's jitted ``loss_fn`` gradient
    and ``build_train_step``'s update of it: the loss, the per-step losses and the
    gradient norm within 1e-4 relative; every gradient within 3e-4
    relative L2 plus 1e-6 of the largest gradient's norm (7e-5 to 1.5e-4
    measured, 5.6e-4 on ``block_0/norm0/bias`` whose norm is 5e-5 of the
    largest; the first block's output bias gets a zero gradient, see
    ``test_torch_sfno.py::test_sfno_gradients_match_jax_grad``); each
    weight's update within 1e-2 relative L2 (Adam's first update divides
    by the gradient's own size, so where it is near eps, rounding moves
    single elements by a few percent of the learning rate, as in
    ``test_torch_train.py``), but for that bias's, whose update is the
    sign of rounding on both sides."""
    stepper, _, params = jax_side
    batch = _data(2)
    jts = JaxTrainStepper(
        stepper,
        JaxTrainConfig(loss=jax_from_dict(JaxStepLossConfig, {"type": "MSE"}),
                       n_forward_steps=2),
        JaxOptConfig(**OPT), JaxEMAConfig())
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, ref), ref_grads = jax.jit(jax.value_and_grad(
        jts.loss_fn, has_aux=True), static_argnums=3)(
        params, jbatch, jax.random.PRNGKey(1), 2)
    # build_train_step's update, on the same gradients
    updates, _ = jts.optimization.tx.update(
        ref_grads, jts.optimization.init(params), params)
    new_params = optax.apply_updates(params, updates)
    ref["grad_norm"] = optax.global_norm(ref_grads)
    ts = _torch_train_stepper(params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, grads = flagship.train_gradients(ts, tbatch)
    metrics = ts.train_step(tbatch, None)
    assert float(ref["grad_norm"]) > 0.01
    for k in ("loss", "loss_step_0", "loss_step_1", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(ref[k]),
                                   rtol=1e-4, err_msg=k)
    out = dict(_flat(state_dict_to_flax_params(grads)))
    ref_g = dict(_flat(ref_grads["params"]))
    assert set(out) == set(ref_g)
    largest = max(np.linalg.norm(r) for r in ref_g.values())
    for k, r in ref_g.items():
        err = np.linalg.norm(out[k] - r)
        assert err <= 3e-4 * np.linalg.norm(r) + 1e-6 * largest, (k, err)
    before = dict(_flat(params["params"]))
    new = dict(_flat(state_dict_to_flax_params(ts.module.state_dict())))
    for k, r in _flat(new_params["params"]):
        if k in ZERO_GRADIENT:
            continue
        step, ref_step = new[k] - before[k], r - before[k]
        assert (np.linalg.norm(step - ref_step)
                <= 1e-2 * np.linalg.norm(ref_step)), k


@pytest.fixture(scope="module")
def entry_runs(tmp_path_factory):
    """``tests/test_train_integration.py``'s SFNO config (embed 8, 2
    layers, dhconv, equiangular data grid, MSE over 2 steps, AdamW) for
    one epoch, plus one inline-inference entry, through each package's
    training ``main``; the port starts from ace_tpu's initial weights."""
    from tests.test_train_integration import ALL_NAMES, _config

    tmp = tmp_path_factory.mktemp("sfno_trainer")
    data = SyntheticData(tmp / "data", ALL_NAMES, n_time=10)
    init = {}
    jax_init = jax_train.TrainStepper.init

    def capture(self, rng):
        params, opt_state = jax_init(self, rng)
        init["params"] = flax_params_to_state_dict(
            jax.tree_util.tree_map(np.asarray, params))
        return params, opt_state

    def from_ace_tpu(self, generator=None):
        self.stepper.load_state_dict(init["params"])
        params = self.parameters()
        self.optimization.init(params)
        self.ema.init(params)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train.TrainStepper, "init", capture)
        mp.setattr(port_train.TrainStepper, "init", from_ace_tpu)
        for name, run in (("ace_tpu", lambda p: jax_main([p])),
                          ("port", lambda p: main([p], device="cpu"))):
            cfg = _config(tmp / name, data, max_epochs=1)
            cfg["inference"] = {
                "loader": {"dataset": {"data_path": str(data.data_dir)},
                           "start_indices": {"list": [0]}},
                "n_forward_steps": 4, "forward_steps_in_memory": 2,
            }
            path = tmp / f"{name}.yaml"
            with open(path, "w") as f:
                yaml.safe_dump(cfg, f)
            run(str(path))
            out_dir = cfg["experiment_dir"]
            with open(os.path.join(out_dir, "metrics.jsonl")) as f:
                metrics = [json.loads(line) for line in f]
            ckpt = read_train_checkpoint(os.path.join(
                out_dir, "training_checkpoints", "ckpt.msgpack"))
            out[name] = dict(metrics=metrics, ckpt=ckpt)
    return out, init["params"]


def test_training_entries_agree_on_the_sfno_config(entry_runs):
    """metrics.jsonl: the same keys; the losses and the inline-inference
    error within 1e-5 relative, every other value within 1e-4 relative
    (plus 1e-7), as tests/test_torch_trainer.py holds the conditional
    SFNO; the weights and EMA in ``ckpt.msgpack``, each tensor's change
    from the common initial weights within 1e-3 relative L2 (Adam's
    first updates, see that file's checkpoint test; at most 9e-5
    measured). A tensor that moved less than 5% of the way Adam's updates
    move a tensor whose gradient keeps its sign (``LR`` a step and an
    element) has gradients that change sign between updates, near zero
    and so mostly rounding, which Adam scales up to the learning rate: it
    is held within 1e-1 (``block_0.norm0.bias``: 3.3e-2 measured, moved
    2.8% of the way). The first block's output bias, whose true gradient
    is zero (``ZERO_GRADIENT``), moves by the sign of rounding on both
    sides and is not compared."""
    out, init = entry_runs
    (ref,), (got,) = out["ace_tpu"]["metrics"], out["port"]["metrics"]
    assert set(got) == set(ref)
    for k in ("train/loss", "val/loss", "inference/inference_error"):
        assert np.isfinite(ref[k])
        assert got[k] == pytest.approx(ref[k], rel=1e-5), k
    for k, r in ref.items():
        assert got[k] == pytest.approx(r, rel=1e-4, abs=1e-7), k
    ref_ckpt, got_ckpt = out["ace_tpu"]["ckpt"], out["port"]["ckpt"]
    assert got_ckpt["extra"]["optimization"] == ref_ckpt["extra"][
        "optimization"]
    n_updates = ref_ckpt["extra"]["num_batches_seen"]
    assert got_ckpt["extra"]["num_batches_seen"] == n_updates > 0
    for key in ("params", "ema_state"):
        assert set(got_ckpt[key]) == set(ref_ckpt[key]) == set(init)
        for k, v in init.items():
            if k.replace(".", "/") in ZERO_GRADIENT:
                continue
            d_ref = ref_ckpt[key][k].double() - v.double()
            d_got = got_ckpt[key][k].double() - v.double()
            err = float((d_got - d_ref).norm() / d_ref.norm().clamp_min(
                1e-30))
            full_rate = n_updates * LR * v.numel() ** 0.5
            tol = 1e-3 if d_ref.norm() >= 0.05 * full_rate else 1e-1
            assert err <= tol, (key, k, err)


def test_a_train_step_after_a_rollout(jax_side):
    """The constants that device math reads each step (the vertical
    coordinate's ``ak`` and ``bk`` in the dry-air corrector, the area
    weights) are made outside inference mode even where a rollout, under
    ``torch.inference_mode``, is the first to need them: a train step
    after it saves them for its backward pass. (Made as inference
    tensors, they made that train step raise.)"""
    ts = _torch_train_stepper(jax_side[2])
    batch = {k: torch.from_numpy(v) for k, v in _data(2).items()}
    ic = PrognosticState(data={k: batch[k][:, :1] for k in PROGNOSTIC})
    ts.stepper.predict(ic, {k: batch[k]
                            for k in ts.stepper.forcing_window_names})
    metrics = ts.train_step(batch, None)
    assert np.isfinite(float(metrics["loss"]))
