"""The ACE2-SOM slab-ocean recipe (``configs/baselines/shield-som/``)
through both packages' entries at 16x32 (embed 16, 2 layers), and
``chip_smoke.py``'s path M and reference phase M on the CPU, as
tests/test_torch_shield_path.py runs path S.

The three YAMLs build in the port as shipped (Weights & Biases off). The
training YAML runs one epoch through ``ace_tpu.train`` and the port's
``main`` from the same initial weights over ``chip_smoke.py``'s
synthetic files of path M-R; the inference YAML (4 initial conditions,
3 steps, its ``overwrite.constant`` and ``stepper_override``) and the
evaluator YAML (4 steps) run through both packages' entries over
ace_tpu's best checkpoint. float32 on both sides: files within
tests/test_torch_inference.py's ``_tol``, metrics within ``_metric_tol``."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ace_tpu.inference import evaluator as jax_evaluator
from ace_tpu.inference import inference as jax_inference
from ace_tpu.stepper import stepper as jax_stepper
from ace_tpu.train.train import main as jax_train_main
from ace_tpu_torch.core.cli import prepare_config
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.inference import evaluator
from ace_tpu_torch.inference import inference
from ace_tpu_torch.inference.evaluator import EvaluatorConfig
from ace_tpu_torch.inference.inference import InferenceConfig
from ace_tpu_torch.stepper import checkpoint
from ace_tpu_torch.stepper import train as port_train
from ace_tpu_torch.stepper.stepper import StepperOverrideConfig
from ace_tpu_torch.train.train import main as train_main
from ace_tpu_torch.train.trainer import TrainConfig
from ace_tpu_torch.utils.convert import state_dict_to_flax_variables
from tests.test_torch_inference import _assert_files_close, _tol

torch.set_num_threads(2)

NLAT, NLON = 16, 32
SIZES = dict(nlat=NLAT, nlon=NLON, embed=16, layers=2)
N_STEPS = 3
# the physical scale of the fields some metrics are computed from: ace_tpu
# takes float32 global means of the surface pressure (the dry-air target,
# 0.23 Pa off float64), the energy paths (~2.5e9 J/m2; the energy budget)
# and the water paths (the moisture budget) that are off float64 by a few
# 1e-6 of these scales (ROADMAP Queue 3), which moves a bias, an RMSE or a
# tendency derived from them by more than its own 1e-3: such a metric may
# also differ by 1e-5 of its field's scale (a percent difference of
# gradient magnitudes by 1e-5 of 100%)
SCALES = {"PRESsfc": 1e5, "surface_pressure_due_to_dry_air": 1e5,
          "air_temperature": 300.0, "total_energy_ace2_path": 2.5e9,
          "total_energy_ace2_path_tendency": 2.5e9 / 21600,
          "implied_tendency_of_total_energy_ace2_path_due_to_advection":
              2.5e9 / 21600}


def _metric_tol(key, ref):
    """``_tol`` of the value, 1e-3 of it, and 1e-5 of its field's scale
    (``SCALES``)."""
    name = key.split("/")[-1]
    scale = max([v for k, v in SCALES.items()
                 if name == k or name.startswith(k + "_")]
                + [100.0 if "percent_diff" in key else 0.0])
    return _tol(np.asarray(ref)) + 1e-3 * abs(ref) + 1e-5 * scale


@pytest.mark.parametrize("path, schema", [
    (chip_smoke.SOM_TRAIN, TrainConfig),
    (chip_smoke.SOM_INFERENCE, InferenceConfig),
    (chip_smoke.SOM_EVALUATOR, EvaluatorConfig),
])
def test_som_yamls_build_as_shipped(path, schema):
    """Each SOM YAML, with only ``logging.log_to_wandb=false``, builds in
    the port's schema; the training YAML's step (the multi-call wrapper
    around the slab-ocean step) builds in the port's step registry."""
    config = from_dict(schema, prepare_config(path,
                                              ["logging.log_to_wandb=false"]))
    if schema is TrainConfig:
        step = config.stepper.step
        assert step.type == "multi_call"
        wrapped = step.instance.wrapped_step.instance
        assert wrapped.ocean.is_slab and wrapped.ocean.interpolate
        assert (wrapped.corrector.total_energy_budget_correction
                .constant_unaccounted_heating == 1.14)
        assert "surface_temperature" not in (
            step.instance.next_step_input_names)
    if schema is InferenceConfig:
        assert config.stepper_override.multi_call is None


@pytest.fixture(scope="module", autouse=True)
def _no_figures():
    """The entries' figures left out (both packages skip a figure they
    cannot draw, and no test here reads one): rendering them is most of
    what an evaluator run costs at this size."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        yield


@pytest.fixture(scope="module")
def som_runs(tmp_path_factory):
    """One epoch of both training entries on the SOM training YAML with
    path M-R's cuts at ``SIZES`` (ace_tpu from the port's initial
    weights), then both inference and evaluator entries on their YAMLs
    over ace_tpu's ``best_ckpt.msgpack``."""
    tmp = tmp_path_factory.mktemp("som")
    names = chip_smoke._som_names()
    paths = chip_smoke._training_files(
        str(tmp), names, NLAT, NLON, torch.Generator().manual_seed(11),
        "cpu", splits=chip_smoke.M_SPLITS)
    init = {}
    port_init = port_train.TrainStepper.init

    def capture(self, generator=None):
        port_init(self, generator)
        init["params"] = {k: v.detach().clone()
                          for k, v in self.stepper.module.state_dict().items()}

    def from_port(self, rng):
        # ace_tpu's weights made from the port's (no compile of flax's
        # initializers)
        self.params = jax.tree_util.tree_map(
            jnp.asarray, state_dict_to_flax_variables(init["params"]))
        return self.params

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_train.TrainStepper, "init", capture)
        mp.setattr(jax_stepper.Stepper, "init_params", from_port)
        for name, run in (("port", lambda a: train_main(a, device="cpu")),
                          ("ace_tpu", jax_train_main)):
            config = chip_smoke._som_config(paths, str(tmp / name), str(tmp),
                                            names, SIZES)
            run([chip_smoke._write_yaml(str(tmp / f"{name}.yaml"), config)])
            with open(tmp / name / "metrics.jsonl") as f:
                out[name] = [json.loads(line) for line in f]
    ckpt = str(tmp / "ace_tpu" / "training_checkpoints" / "best_ckpt.msgpack")
    stepper = checkpoint.load_stepper(
        ckpt, override=StepperOverrideConfig(multi_call=None), device="cpu")
    files = chip_smoke.som_inference_files(str(tmp / "m_i"), stepper, "cpu",
                                           N_STEPS)
    for name, run in (("ace_tpu", jax_inference.main),
                      ("port", lambda a: inference.main(a, device="cpu"))):
        run([chip_smoke.som_inference_config(
            str(tmp / f"inference_{name}.yaml"), str(tmp / f"inf_{name}"),
            ckpt, files, N_STEPS, True)])
    for name, run in (("ace_tpu", jax_evaluator.main),
                      ("port", lambda a: evaluator.main(a, device="cpu"))):
        config = chip_smoke._yaml(chip_smoke.SOM_EVALUATOR)
        config.update(experiment_dir=str(tmp / f"eval_{name}"),
                      checkpoint_path=ckpt, n_forward_steps=4,
                      forward_steps_in_memory=4)
        config["logging"].update(log_to_wandb=False, log_to_screen=False)
        chip_smoke._som_dataset(config["loader"]["dataset"],
                                paths["inference"])
        path = chip_smoke._write_yaml(str(tmp / f"eval_{name}.yaml"), config)
        out[f"eval_{name}"] = run([path])
    return tmp, out


def test_som_training_entry_matches_ace_tpu(som_runs):
    """metrics.jsonl: the same keys; the train and validation losses and
    the inline-inference error within 1e-4 relative, every value within
    ``_metric_tol``."""
    _, out = som_runs
    (ref,), (got,) = out["ace_tpu"], out["port"]
    assert set(got) == set(ref)
    for k in ("train/loss", "val/loss", "inference/inference_error"):
        assert np.isfinite(ref[k])
        assert got[k] == pytest.approx(ref[k], rel=1e-4), k
    for k, r in ref.items():
        assert abs(got[k] - r) <= _metric_tol(k, r), (k, got[k], r)


def test_som_inference_entry_matches_ace_tpu(som_runs):
    """The predictions of the inference YAML (the slab SST from the
    overwritten CO2) and every diagnostics file, file for file."""
    tmp, _ = som_runs
    names = ["autoregressive_predictions.nc"] + [
        os.path.join("diagnostics", n)
        for n in sorted(os.listdir(tmp / "inf_ace_tpu" / "diagnostics"))]
    assert (sorted(os.listdir(tmp / "inf_port" / "diagnostics"))
            == sorted(os.listdir(tmp / "inf_ace_tpu" / "diagnostics")))
    for name in names:
        _assert_files_close(tmp / "inf_port" / name,
                            tmp / "inf_ace_tpu" / name)


def test_som_evaluator_entry_matches_ace_tpu(som_runs):
    """The evaluator YAML's logs against its dataset's targets, within
    ``_metric_tol``."""
    _, out = som_runs
    logs, ref = out["eval_port"]["logs"], out["eval_ace_tpu"]["logs"]
    assert set(logs) == set(ref)
    for k, r in ref.items():
        assert abs(logs[k] - r) <= _metric_tol(k, r), (k, logs[k], r)


def test_chip_smoke_path_m_runs_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s reference phase M (the CPU on both sides: equal
    exactly) and paths M-R, M-I and M-bf16 over the shipped SOM YAMLs at
    16x32, embed 16, 2 layers, their files held in host memory as where
    h5py is missing: every gate holds, with no launch (the plain versions
    on the CPU)."""
    from ace_tpu_torch.ops import dhconv_filter as k1

    present, _ = chip_smoke.inference_packages()
    present.pop("h5py")
    monkeypatch.setattr(chip_smoke, "inference_packages",
                        lambda: (present, ["h5py"]))
    counters = [k1.dhconv_filter, k1.dhconv_filter_dx, k1.dhconv_filter_dw]
    out = chip_smoke.som_paths(counters, "cpu", sizes=SIZES, device="cpu")
    none = {c.__name__: 0 for c in counters}
    assert out == {"M-R": none, "M-I": none, "M-bf16": none}
    text = capsys.readouterr().out
    for case in chip_smoke.som_step_configs()[0]:
        for dtype in ("float32", "bfloat16"):
            assert f"reference M ({case}, {dtype}): cpu vs CPU" in text
    for line in ("path M-R: train/loss", "path M-I: forcing global_mean_co2",
                 "path M-bf16: 3 train steps", "largest error 0 of the field"):
        assert line in text, line
    assert text.count("relative error 0 (tol") == 12


def test_profile_flagship_som_runners_run_on_the_cpu():
    """``profile_flagship --som``'s rollout (the slab-ocean step at batch
    4) and bf16 multi-call train step at 16x32, embed 16, 2 layers: the
    rollout's outputs are finite, the loss finite and falling over 4
    steps on one batch."""
    from ace_tpu_torch import profile_flagship

    train, rollout = profile_flagship._som_runners("cpu", NLAT, NLON, 16, 2)
    losses = [float(m["loss"]) for m in train(4)]
    assert all(map(np.isfinite, losses)) and losses[-1] < losses[0], losses
    outputs = rollout(2)
    for k, v in outputs.items():
        assert v.shape == (4, 2, NLAT, NLON) and torch.isfinite(v).all(), k
    assert "ULWRFtoa_4xCO2" not in outputs
