"""The port's training entry (``ace_tpu_torch.train``) against
``ace_tpu.train`` on one config and one synthetic dataset: one epoch of
both trainers from the same initial weights, with the noise fixed, gives
the same per-epoch losses, inline-inference error and metrics.jsonl, and
the same weights and EMA in ``ckpt.msgpack``; validation runs with the
EMA's weights and leaves the training weights as they were."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ace_tpu.models.conditional_sfno import (
    NoiseConditionedSFNO as JaxNoiseConditionedSFNO,
)
from ace_tpu.stepper import train as jax_train
from ace_tpu.testing import SyntheticData
from ace_tpu.train.train import main as jax_main
from ace_tpu_torch.models.conditional_sfno import NoiseConditionedSFNO
from ace_tpu_torch.stepper import train as port_train
from ace_tpu_torch.stepper.checkpoint import read_train_checkpoint
from ace_tpu_torch.train.train import main
from ace_tpu_torch.utils.convert import flax_params_to_state_dict

torch.set_num_threads(2)

NLAT, NLON, NOISE = 16, 32, 8
PROGNOSTIC = ["air_temperature_0", "air_temperature_1",
              "specific_total_water_0", "specific_total_water_1", "PRESsfc",
              "surface_temperature"]
DIAGNOSTIC = ["PRATEsfc", "LHTFLsfc"]
FORCING = ["DSWRFtoa", "ocean_fraction"]
NAMES = PROGNOSTIC + DIAGNOSTIC + FORCING


def _noise(batch: int) -> np.ndarray:
    return np.random.RandomState(batch).randn(
        batch, NLAT, NLON, NOISE).astype(np.float32)


def config(data: SyntheticData, out_dir) -> dict:
    """A NoiseConditionedSFNO config of ``tests/test_train_integration.py``'s
    shape (tests/test_torch_sfno_train.py runs that file's
    SphericalFourierNeuralOperatorNet config itself), MSE loss,
    AdamW with clipping, the default EMA, and one inline-inference entry."""
    loader = {"dataset": {"data_path": str(data.data_dir)}, "batch_size": 2,
              "num_data_workers": 1}
    return {
        "experiment_dir": str(out_dir), "max_epochs": 1, "seed": 0,
        "logging": {"log_to_screen": False, "log_to_file": False},
        "train_loader": loader, "validation_loader": loader,
        "optimization": {"lr": 1e-3, "optimizer_type": "AdamW",
                         "max_grad_norm": 1.0},
        "stepper_training": {"n_forward_steps": 1, "loss": {"type": "MSE"}},
        "inference": {
            "loader": {"dataset": {"data_path": str(data.data_dir)},
                       "start_indices": {"list": [0, 1]}},
            "n_forward_steps": 4, "forward_steps_in_memory": 2,
        },
        "stepper": {"step": {"type": "single_module", "config": dict(
            builder={"type": "NoiseConditionedSFNO", "config": {
                "embed_dim": 16, "noise_embed_dim": NOISE,
                "noise_type": "isotropic", "num_layers": 2,
                "affine_norms": True, "normalize_big_skip": True,
                "data_grid": "equiangular"}},
            in_names=PROGNOSTIC + FORCING, out_names=PROGNOSTIC + DIAGNOSTIC,
            normalization={"network": {
                "global_means_path": str(data.mean_path),
                "global_stds_path": str(data.std_path)}},
            ocean={"surface_temperature_name": "surface_temperature",
                   "ocean_fraction_name": "ocean_fraction"},
            corrector={"conserve_dry_air": True},
        )}},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One epoch of each package's ``main`` on the same config: the port
    starts from ace_tpu's initial weights, and both models condition on
    the same noise (the packages' random streams differ)."""
    tmp = tmp_path_factory.mktemp("trainer")
    data = SyntheticData(tmp / "data", NAMES, n_time=12, nlat=NLAT,
                         nlon=NLON)
    init = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(JaxNoiseConditionedSFNO, "_make_noise",
               lambda self, batch: jnp.asarray(_noise(batch)))
    mp.setattr(NoiseConditionedSFNO, "make_noise",
               lambda self, batch, generator: torch.from_numpy(_noise(batch)))
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

    init_mp = pytest.MonkeyPatch()
    init_mp.setattr(jax_train.TrainStepper, "init", capture)
    init_mp.setattr(port_train.TrainStepper, "init", from_ace_tpu)
    out = {}
    try:
        for name, run in (("ace_tpu", lambda p: jax_main([p])),
                          ("port", lambda p: main([p], device="cpu"))):
            path = tmp / f"{name}.yaml"
            with open(path, "w") as f:
                yaml.safe_dump(config(data, tmp / name), f)
            trainer = run(str(path))
            with open(tmp / name / "metrics.jsonl") as f:
                metrics = [json.loads(line) for line in f]
            ckpt = read_train_checkpoint(str(
                tmp / name / "training_checkpoints" / "ckpt.msgpack"))
            out[name] = dict(trainer=trainer, metrics=metrics, ckpt=ckpt)
        init_mp.undo()
        yield out, init["params"]
    finally:
        init_mp.undo()
        mp.undo()


def test_epoch_losses_and_metrics_match_ace_tpu(runs):
    """metrics.jsonl: the same keys, and every value within 1e-4 relative
    (float32 in another summation order over 5 AdamW updates; measured
    under 5e-5, on a derived variable of the inline inference), the
    losses and the inline-inference error within 1e-5 (measured under
    1e-6)."""
    out, _ = runs
    ref, got = out["ace_tpu"]["metrics"], out["port"]["metrics"]
    assert len(ref) == len(got) == 1
    ref, got = ref[0], got[0]
    assert set(got) == set(ref)
    for k in ("train/loss", "val/loss", "inference/inference_error"):
        assert np.isfinite(ref[k])
        assert got[k] == pytest.approx(ref[k], rel=1e-5), k
    for k, r in ref.items():
        assert got[k] == pytest.approx(r, rel=1e-4, abs=1e-7), k


def test_checkpoint_weights_and_ema_match_ace_tpu(runs):
    """The weights and the EMA in ``ckpt.msgpack``, compared as each
    tensor's change from the common initial weights: AdamW's first update
    moves each weight by about the learning rate whatever the gradient's
    size (it divides by the root of the second moment), so a gradient
    component near zero, whose float32 value differs by summation order,
    moves its weight by a different amount; each tensor's change agrees
    within 1e-3 relative L2 (measured 1.4e-5 at most), and the moments'
    count and the optimizer's extra state exactly."""
    out, init = runs
    ref, got = out["ace_tpu"]["ckpt"], out["port"]["ckpt"]
    assert got["extra"]["num_batches_seen"] == ref["extra"][
        "num_batches_seen"] == 5
    assert got["extra"]["optimization"] == ref["extra"]["optimization"]
    assert got["extra"]["ema"] == ref["extra"]["ema"]
    errs = {}
    for key in ("params", "ema_state"):
        assert set(got[key]) == set(ref[key]) == set(init)
        for k, v in init.items():
            d_ref = ref[key][k].double() - v.double()
            d_got = got[key][k].double() - v.double()
            scale = d_ref.norm()
            errs[f"{key}/{k}"] = float((d_got - d_ref).norm()
                                       / scale.clamp_min(1e-30))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])


def test_validation_uses_the_ema_and_keeps_the_weights(runs):
    """The port validates with the EMA's weights: the loss differs from
    the training weights' and matches ace_tpu's (within the float32
    tolerance of the metrics test); the swap leaves the module's weights
    and the EMA bit for bit as they were."""
    out, _ = runs
    trainer = out["port"]["trainer"]
    before = {k: v.clone() for k, v in
              trainer.stepper.module.state_dict().items()}
    ema_before = [e.clone() for e in trainer.train_stepper.ema.ema_params]
    with_ema = trainer.validate()["loss"]
    trainer.config.validate_using_ema = False
    try:
        with_weights = trainer.validate()["loss"]
    finally:
        trainer.config.validate_using_ema = True
    ref = out["ace_tpu"]["metrics"][0]["val/loss"]
    assert with_ema == pytest.approx(ref, rel=1e-5)
    assert abs(with_weights - with_ema) > 1e-3 * abs(with_ema)
    for k, v in trainer.stepper.module.state_dict().items():
        assert torch.equal(v, before[k]), k
    for e, b in zip(trainer.train_stepper.ema.ema_params, ema_before):
        assert torch.equal(e, b)


def test_bf16_weight_caches_follow_the_ema_swap():
    """In bf16 the model keeps bf16 copies of its filter weights for calls
    without grad; validating with the EMA swapped in gives, bit for bit,
    the loss of a module that holds the EMA's weights, and after the swap
    the training weights' loss of before (port only: no ace_tpu in it)."""
    from ace_tpu_torch import flagship

    ts = flagship.build_train_stepper(16, 32, nz=2, embed=32, layers=2,
                                      device="cpu")
    ts.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for e in ts.ema.ema_params:
            e.add_(torch.randn(e.shape, generator=gen) * 0.1)
    batch = flagship.synthetic_batch(ts.stepper, 2, generator=gen)
    noise = torch.randn(4, 16, 32, ts.module.noise_embed_dim, generator=gen)
    flagship.fixed_noise(ts.stepper, noise)

    def loss(train_stepper):
        return train_stepper.valid_step(batch, None)["loss"]

    before = loss(ts)
    with ts.weights_swapped(ts.ema.ema_params):
        with_ema = loss(ts)
    after = loss(ts)
    other = flagship.build_train_stepper(16, 32, nz=2, embed=32, layers=2,
                                         device="cpu")
    other.stepper.load_state_dict(dict(zip(ts.parameter_names(),
                                           ts.ema.ema_params)))
    flagship.fixed_noise(other.stepper, noise)
    assert torch.equal(with_ema, loss(other))
    assert torch.equal(after, before) and not torch.equal(with_ema, before)
