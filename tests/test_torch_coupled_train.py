"""The CM4 coupled recipes (``configs/baselines/cm4-piControl/``) through
both packages' coupled entries, float32 on the CPU.

The three coupled YAMLs and both uncoupled-atmosphere YAMLs build in the
port's schema as shipped (Weights & Biases off). The training YAML runs
one epoch through ``ace_tpu.coupled.train``'s ``main`` and the port's,
with path C-R's cuts at a small size (the SFNO at embed 32 with 1 layer,
Samudra at widths 16-24 over 2 levels, 16x32, 4 atmosphere steps an ocean
step through the ocean's ``timedelta``, 2 coupled steps, 2 batches of 1
and 1 validation pair) over ``chip_smoke.coupled_files``' synthetic
stores, from one pair of component checkpoints: ``ace_tpu`` over one file
a component (its merged loader fails, ROADMAP Queue 3), the port over the
YAML's merged stores. Each package reads the other's four checkpoint
files. ``tests/test_torch_coupled_finetune.py`` runs the finetune and
evaluator YAMLs."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from ace_tpu.coupled import train as jax_train
from ace_tpu.stepper.checkpoint import load_stepper as jax_load_stepper
from ace_tpu_torch.core.cli import prepare_config
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.coupled.inference import CoupledInferenceConfig
from ace_tpu_torch.coupled.train import CoupledTrainConfig
from ace_tpu_torch.coupled.train import main as train_main
from ace_tpu_torch.data.dataset import MergeDatasetConfig
from ace_tpu_torch.inference.evaluator import EvaluatorConfig
from ace_tpu_torch.stepper.checkpoint import load_stepper
from ace_tpu_torch.train.trainer import TrainConfig
from ace_tpu_torch.utils.convert import flax_params_to_state_dict
from tests.test_torch_coupled import single

torch.set_num_threads(2)

SIZES = {"nlat": 16, "nlon": 32, "embed": 32, "layers": 1,
         "ch_width": [16, 24], "dilation": [1, 2], "n_inner": 4}
N_COUPLED = 2
SPLITS = (("train", 4, "0151-01-06"), ("valid", 3, "0306-01-01"),
          ("evaluator", chip_smoke.C_E_STEPS + 1, "0311-01-01"))
LOSS_TOL = 1e-4
COMPONENTS = ("atmosphere", "ocean")
FILES = [f"{c}{s}.msgpack" for c in COMPONENTS for s in ("_ckpt",
                                                         "_ema_ckpt")]


@pytest.mark.parametrize("path, schema", [
    (os.path.join(os.path.dirname(os.path.dirname(chip_smoke.C_DIR)),
                  "coupled-train.yaml"), CoupledTrainConfig),
    (chip_smoke.C_TRAIN, CoupledTrainConfig),
    (chip_smoke.C_FINETUNE, CoupledTrainConfig),
    (chip_smoke.C_EVALUATOR, CoupledInferenceConfig),
    (chip_smoke.C_ATMOS_TRAIN, TrainConfig),
    (os.path.join(chip_smoke.C_DIR, "uncoupled-atmos",
                  "evaluator-config.yaml"), EvaluatorConfig),
])
def test_coupled_yamls_build_as_shipped(path, schema):
    """Each YAML (the three CM4 coupled ones, both uncoupled-atmosphere
    ones and the repo's own ``configs/coupled-train.yaml``), with only
    ``logging.log_to_wandb=false``, builds in the port's schema; the CM4
    training YAML reads merged stores, freezes the whole atmosphere and
    predicts the ocean fraction."""
    config = from_dict(schema, prepare_config(path,
                                              ["logging.log_to_wandb=false"]))
    if path == chip_smoke.C_TRAIN:
        assert config.n_coupled_steps == 4
        assert isinstance(config.train_loader.dataset.atmosphere,
                          MergeDatasetConfig)
        pinit = config.stepper_training.atmosphere.parameter_init
        assert pinit.frozen_parameters.include == ["*"]
        assert config.stepper.ocean_fraction_prediction is not None
    if path == chip_smoke.C_EVALUATOR:
        assert config.evaluate and config.n_coupled_steps == 2920


def _metrics(directory):
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def coupled_runs(tmp_path_factory):
    """One epoch of both packages' training entries from one pair of
    component checkpoints."""
    tmp = tmp_path_factory.mktemp("coupled")
    files = coupled_files(tmp)
    base = chip_smoke.coupled_checkpoints(str(tmp), files[False], "cpu",
                                          SIZES)
    out = {"base": base}
    for name, train, one in (
            ("ace_tpu", jax_train.main, True),
            ("port", lambda a: train_main(a, device="cpu"), False)):
        config = chip_smoke._coupled_config(
            files[one], str(tmp / name), SIZES, weights=base,
            n_coupled_steps=N_COUPLED)
        train([chip_smoke._write_yaml(str(tmp / f"{name}.yaml"),
                                      single(config) if one else config)])
        out[name] = _metrics(tmp / name)
    return tmp, out


def coupled_files(tmp):
    """``chip_smoke.coupled_files`` at ``SIZES`` and ``SPLITS``: the
    merged stores (``False``) and one file a component (``True``), the
    same draws."""
    return {one: chip_smoke.coupled_files(
        str(tmp / f"files_{one}"), SIZES["nlat"], SIZES["nlon"],
        torch.Generator().manual_seed(11), "cpu", splits=SPLITS,
        n_inner=SIZES["n_inner"], single=one)[0] for one in (False, True)}


def test_training_entry_matches_ace_tpu(coupled_runs):
    """metrics.jsonl: the same keys; the loss, the ocean's and the
    validation loss within 1e-4 relative; the atmosphere's loss 0 (its
    ``n_steps`` is 0)."""
    _, out = coupled_runs
    (ref,), (got,) = out["ace_tpu"], out["port"]
    assert set(got) == set(ref)
    for k in ("loss", "ocean_loss", "val_loss"):
        assert np.isfinite(ref[k])
        assert got[k] == pytest.approx(ref[k], rel=LOSS_TOL), k
    assert got["atmosphere_loss"] == ref["atmosphere_loss"] == 0


def _weights(path):
    from ace_tpu_torch.stepper.checkpoint import load_msgpack

    return flax_params_to_state_dict(load_msgpack(path)["stepper"]["params"])


# the share of the ocean's weights (but the convolution biases an
# instance norm removes) whose change over the epoch's two Adam updates
# may differ from ace_tpu's by more than 1e-2 of the learning rate: Adam
# moves a weight by the learning rate times its gradient's sign, and the
# first convolution's gradient is a product with the fluxes the ocean
# receives, which carry ace_tpu's float32 budget means (ROADMAP Queue 3)
# at up to 1e-4 of their value; measured 0.52% (down_0.conv1's kernel
# 2.8%)
FLIPPED_SHARE = 1e-2


def test_weights_after_an_epoch_match_ace_tpu(coupled_runs):
    """The atmosphere's weights in both packages' files bit-equal to the
    checkpoint they started from (frozen); the ocean's after the epoch's
    two updates: each weight's change within 1e-2 of the learning rate of
    ``ace_tpu``'s but where a gradient at float32's rounding flips its
    sign under Adam (at most ``FLIPPED_SHARE`` of the weights; the
    convolution biases an instance norm removes throughout), none apart
    by more than the updates' largest move, and every tensor moved."""
    tmp, out = coupled_runs
    lr = chip_smoke._yaml(chip_smoke.C_TRAIN)["optimization"]["lr"]
    base_atmos = _weights(out["base"]["atmosphere"])
    base_ocean = _weights(out["base"]["ocean"])
    weights = {name: {c: _weights(str(tmp / name / "training_checkpoints"
                                      / f"{c}_ckpt.msgpack"))
                      for c in COMPONENTS}
               for name in ("ace_tpu", "port")}
    for name, w in weights.items():
        assert set(w["atmosphere"]) == set(base_atmos)
        for k, v in w["atmosphere"].items():
            assert torch.equal(v, base_atmos[k]), (name, k)
    flipped, total = 0, 0
    for k, w0 in base_ocean.items():
        ref = weights["ace_tpu"]["ocean"][k].double() - w0.double()
        got = weights["port"]["ocean"][k].double() - w0.double()
        assert float((got - ref).abs().max()) <= 2 * 2.01 * lr, k
        assert float(ref.abs().max()) > 0, k
        if not k.endswith((".conv1.bias", ".conv2.bias")):
            flipped += int(((got - ref).abs() > 1e-2 * lr).sum())
            total += ref.numel()
    assert flipped <= FLIPPED_SHARE * total, (flipped, total)


def test_each_package_reads_the_others_checkpoints(coupled_runs):
    """The four files of each package load in the other (``load_stepper``)
    with the weights as written."""
    tmp, _ = coupled_runs
    for name in ("ace_tpu", "port"):
        directory = tmp / name / "training_checkpoints"
        assert sorted(os.listdir(directory)) == sorted(FILES)
        for filename in FILES:
            path = str(directory / filename)
            written = _weights(path)
            port_read = load_stepper(path, device="cpu").module.state_dict()
            jax_read = flax_params_to_state_dict(jax.tree_util.tree_map(
                np.asarray, jax_load_stepper(path).params))
            for k, v in written.items():
                assert torch.equal(port_read[k], v), (name, filename, k)
                assert torch.equal(jax_read[k], v), (name, filename, k)
