"""The port's entries over two processes on the CPU (gloo), launched as a
user launches them: ``python -m ace_tpu_torch.<entry> <yaml> --device
cpu`` with the ``ACE_TPU_*`` variables and ``mesh: {data_parallel: 2}``
(matplotlib left out, as on the card). Two ranks at a global batch of 2
(one row each) give what one process gives at the same global batch,
with the noise drawn: the training entry's metrics, weights and EMA (the
ensemble loss over drawn noise members, the rotation augmentation), the
evaluator's files over ensemble members; and what ``ace_tpu`` gives on
one device: the training entry on a deterministic SFNO config, the
inference entry's files over two initial conditions. Only the first
process writes files, and its checkpoint resumes on one process or two
alike. Small sizes (8x16, embed 16)."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ace_tpu.stepper.stepper import Stepper as JaxStepper
from ace_tpu.testing import SyntheticData
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.stepper.checkpoint import read_train_checkpoint
from ace_tpu_torch.train.trainer import TrainConfig
from ace_tpu_torch.utils.convert import state_dict_to_flax_variables
from tests.test_torch_inference import _assert_files_close, _read
from tests.test_torch_sfno_train import LR, ZERO_GRADIENT
from tests.test_train_integration import ALL_NAMES
from tests.test_train_integration import _config as sfno_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = {"data_parallel": 2}
DIAGNOSTICS = ["autoregressive_predictions.nc", "restart.nc",
               "diagnostics/time_mean_diagnostics.nc",
               "diagnostics/mean_diagnostics.nc"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(entry: str, config: dict, path, n: int = 2):
    """``python -m ace_tpu_torch.<entry> <path> --device cpu`` in ``n``
    processes joined by the ``ACE_TPU_*`` variables, started now (on a
    port found free just before); ``_wait`` collects them."""
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("ACE_TPU_", "XLA_", "JAX_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               ACE_TPU_COORDINATOR_ADDRESS=f"localhost:{_free_port()}",
               ACE_TPU_NUM_PROCESSES=str(n))
    # the module run as ``python -m`` runs it, with matplotlib left out
    code = ("import runpy, sys; sys.modules['matplotlib'] = None; "
            f"runpy.run_module('ace_tpu_torch.{entry}', "
            "run_name='__main__', alter_sys=True)")
    return [subprocess.Popen(
        [sys.executable, "-c", code, str(path), "--device", "cpu"],
        cwd=REPO, env={**env, "ACE_TPU_PROCESS_ID": str(i)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(n)]


def _wait(procs):
    outputs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out[-4000:]


def _metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _ckpt(out_dir):
    return read_train_checkpoint(os.path.join(
        out_dir, "training_checkpoints", "ckpt.msgpack"))


def _files(out_dir):
    return sorted(os.path.relpath(os.path.join(d, f), out_dir)
                  for d, _, fs in os.walk(out_dir) for f in fs)


def _initial_weights(config) -> dict[str, torch.Tensor]:
    """The weights a training run of ``config`` starts from: the first
    draw of its seeded generator, on any number of processes."""
    trainer = from_dict(TrainConfig, config).build_trainer(device="cpu")
    trainer.train_stepper.init(torch.Generator().manual_seed(config["seed"]))
    return {k: v.clone() for k, v in
            trainer.stepper.module.state_dict().items()}


def _assert_metrics_close(got, ref):
    """tests/test_torch_trainer.py's limits: the losses and the
    inline-inference error within 1e-5 relative, every other value within
    1e-4 relative (plus 1e-7)."""
    assert len(got) == len(ref) == 1
    got, ref = got[0], ref[0]
    assert set(got) == set(ref)
    for k in ("train/loss", "val/loss", "inference/inference_error"):
        assert np.isfinite(ref[k])
        assert got[k] == pytest.approx(ref[k], rel=1e-5), k
    for k, r in ref.items():
        assert got[k] == pytest.approx(r, rel=1e-4, abs=1e-7), k


def _assert_changes_close(got, ref, init, skip=()):
    """Each tensor's change from ``init`` (weights and EMA) within 1e-3
    relative L2 (tests/test_torch_sfno_train.py's limits: 1e-1 for a
    tensor that moved less than 5% of the way of Adam's steady updates);
    the optimizer's counters equal."""
    assert got["extra"]["optimization"] == ref["extra"]["optimization"]
    n_updates = ref["extra"]["num_batches_seen"]
    assert got["extra"]["num_batches_seen"] == n_updates > 0
    for key in ("params", "ema_state"):
        assert set(got[key]) == set(ref[key]) == set(init)
        for k, v in init.items():
            if k.replace(".", "/") in skip:
                continue
            d_ref = ref[key][k].double() - v.double()
            d_got = got[key][k].double() - v.double()
            err = float((d_got - d_ref).norm()
                        / d_ref.norm().clamp_min(1e-30))
            full_rate = n_updates * LR * v.numel() ** 0.5
            tol = 1e-3 if d_ref.norm() >= 0.05 * full_rate else 1e-1
            assert err <= tol, (key, k, err)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data_parallel")
    return tmp, SyntheticData(tmp / "data", ALL_NAMES, n_time=10)


def _inline(data):
    return {"loader": {"dataset": {"data_path": str(data.data_dir)},
                       "start_indices": {"list": [0, 1]}},
            "n_forward_steps": 4, "forward_steps_in_memory": 2}


def noise_config(out_dir, data) -> dict:
    """A NoiseConditionedSFNO with isotropic noise under the flagship's
    ensemble loss (2 members, CRPS and energy score), the rotation
    augmentation, one epoch of 4 batches of 2 and an inline-inference
    entry from 2 initial conditions."""
    config = sfno_config(out_dir, data, max_epochs=1)
    config["logging"]["log_to_file"] = True
    config["train_loader"]["augmentation"] = {"rotate_probability": 0.5}
    config["stepper_training"] = {
        "n_forward_steps": 1, "n_ensemble": 2,
        "loss": {"type": "EnsembleLoss", "kwargs": {
            "crps_weight": 0.9, "energy_score_weight": 0.1}}}
    config["stepper"]["step"]["config"]["builder"] = {
        "type": "NoiseConditionedSFNO", "config": {
            "embed_dim": 16, "noise_embed_dim": 8, "noise_type": "isotropic",
            "num_layers": 2, "data_grid": "equiangular"}}
    config["inference"] = _inline(data)
    return config


@pytest.fixture(scope="module")
def noise_runs(data):
    """The noise-conditioned recipe on two processes and on one."""
    tmp, synthetic = data
    two = noise_config(tmp / "noise2", synthetic)
    procs = _launch("train", {**two, "mesh": MESH}, tmp / "noise2.yaml")
    one = noise_config(tmp / "noise1", synthetic)
    with open(tmp / "noise1.yaml", "w") as f:
        yaml.safe_dump(one, f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        from ace_tpu_torch.train.train import main

        main([str(tmp / "noise1.yaml")], device="cpu")
    init = _initial_weights(one)
    _wait(procs)
    return tmp, init


def test_two_ranks_train_as_one_with_the_noise_drawn(noise_runs):
    """Every draw of the recipe (the model's noise over the ensemble
    members, the rotation) is the global batch's: two processes give one
    process's metrics.jsonl, and its weights' and EMA's changes, at the
    float32 limits of the parity tests (the means over the batch and
    over the ranks sum in another order)."""
    tmp, init = noise_runs
    _assert_metrics_close(_metrics(tmp / "noise2" / "output"),
                          _metrics(tmp / "noise1" / "output"))
    _assert_changes_close(_ckpt(tmp / "noise2" / "output"),
                          _ckpt(tmp / "noise1" / "output"), init)


def test_only_the_root_writes(noise_runs):
    """The two processes' experiment directory holds the files one
    process writes; metrics.jsonl has one line and out.log one start of
    the epoch (a second writer would double them)."""
    tmp, _ = noise_runs
    two, one = tmp / "noise2" / "output", tmp / "noise1" / "output"
    assert _files(two) == _files(one)
    assert len(_metrics(two)) == 1
    with open(two / "out.log") as f:
        assert f.read().count("Epoch 0 starting") == 1


@pytest.fixture(scope="module")
def sfno_runs(data):
    """``tests/test_train_integration.py``'s SFNO config with an inline
    inference entry: the port on two processes, ``ace_tpu`` on one
    device, from the port's initial weights."""
    tmp, synthetic = data
    config = sfno_config(tmp / "sfno2", synthetic, max_epochs=1)
    config["inference"] = _inline(synthetic)
    procs = _launch("train", {**config, "mesh": MESH}, tmp / "sfno2.yaml")
    init = _initial_weights(config)
    ref = sfno_config(tmp / "jax", synthetic, max_epochs=1)
    ref["inference"] = config["inference"]
    with open(tmp / "jax.yaml", "w") as f:
        yaml.safe_dump(ref, f)
    variables = state_dict_to_flax_variables(init)

    def init_params(self, rng):
        self.params = jax.tree_util.tree_map(jnp.asarray, variables)
        return self.params

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxStepper, "init_params", init_params)
        from ace_tpu.train.train import main as jax_main

        jax_main([str(tmp / "jax.yaml")])
    _wait(procs)
    return tmp, init


def test_two_ranks_train_as_ace_tpu_on_one_device(sfno_runs):
    """The port's training entry on two processes against ``ace_tpu``'s
    on one device (which tests/test_parallel.py holds mesh-invariant):
    tests/test_torch_sfno_train.py's limits on metrics.jsonl and on the
    weights' and EMA's changes."""
    tmp, init = sfno_runs
    _assert_metrics_close(_metrics(tmp / "sfno2" / "output"),
                          _metrics(tmp / "jax" / "output"))
    _assert_changes_close(_ckpt(tmp / "sfno2" / "output"),
                          _ckpt(tmp / "jax" / "output"), init,
                          skip=ZERO_GRADIENT)


def _inference_config(out_dir, data, ckpt, **extra) -> dict:
    return {"experiment_dir": str(out_dir), "checkpoint_path": str(ckpt),
            "n_forward_steps": 4, "forward_steps_in_memory": 2,
            "logging": {"log_to_screen": False, "log_to_file": False},
            "forcing_loader": {"dataset": {"data_path": str(data.data_dir)},
                               "start_indices": {"list": [0, 1]}},
            **extra}


def test_two_ranks_infer_as_one_and_as_ace_tpu(sfno_runs, data):
    """The inference entry over the two processes' SFNO checkpoint (which
    ``ace_tpu`` reads) from 2 initial conditions, one a process: the
    predictions, the restart file and the diagnostics of one process and
    of ``ace_tpu`` (tests/test_torch_inference.py's limits), written by
    the first process alone."""
    tmp, _ = sfno_runs
    _, synthetic = data
    ckpt = tmp / "sfno2" / "output" / "training_checkpoints" / (
        "best_ckpt.msgpack")
    procs = _launch("inference", _inference_config(
        tmp / "infer2", synthetic, ckpt, mesh=MESH), tmp / "infer2.yaml")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        from ace_tpu.inference.inference import main as jax_main
        from ace_tpu_torch.inference.inference import main

        for name, run in (("infer1", lambda p: main([p], device="cpu")),
                          ("jax_infer", lambda p: jax_main([p]))):
            path = tmp / f"{name}.yaml"
            with open(path, "w") as f:
                yaml.safe_dump(_inference_config(tmp / name, synthetic,
                                                 ckpt), f)
            run(str(path))
    _wait(procs)
    assert _files(tmp / "infer2") == _files(tmp / "infer1")
    for name in DIAGNOSTICS:
        for ref in ("infer1", "jax_infer"):
            _assert_files_close(tmp / "infer2" / name, tmp / ref / name)
    assert _read(tmp / "infer2" / "restart.nc")["prog_a"].shape[0] == 2


def test_two_ranks_evaluate_ensemble_members_as_one(noise_runs, data):
    """The evaluator entry over the noise-conditioned checkpoint, one
    initial condition of 2 members (one a process) with the noise drawn:
    the files of one process."""
    tmp, _ = noise_runs
    _, synthetic = data
    ckpt = tmp / "noise1" / "output" / "training_checkpoints" / (
        "best_ckpt.msgpack")

    def config(name, **extra):
        cfg = _inference_config(tmp / name, synthetic, ckpt,
                                n_ensemble_per_ic=2, **extra)
        cfg["loader"] = cfg.pop("forcing_loader")
        cfg["loader"]["start_indices"] = {"list": [0]}
        return cfg

    procs = _launch("evaluator", config("eval2", mesh=MESH),
                    tmp / "eval2.yaml")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        from ace_tpu_torch.inference.evaluator import main

        with open(tmp / "eval1.yaml", "w") as f:
            yaml.safe_dump(config("eval1"), f)
        main([str(tmp / "eval1.yaml")], device="cpu")
    _wait(procs)
    assert _files(tmp / "eval2") == _files(tmp / "eval1")
    for name in DIAGNOSTICS[:1] + DIAGNOSTICS[2:]:  # no restart file
        _assert_files_close(tmp / "eval2" / name, tmp / "eval1" / name)


def test_a_checkpoint_resumes_on_another_number_of_ranks(noise_runs):
    """The root's checkpoint of the two processes' first epoch holds the
    whole training state (the generator's too): resumed on one process
    and on two (each from a copy of the run's directory), it gives the
    same second epoch at the limits above (the changes from the initial
    weights)."""
    import shutil

    tmp, init = noise_runs
    config = yaml.safe_load(open(tmp / "noise2.yaml"))
    config["max_epochs"] = 2
    configs = {}
    for n in (1, 2):
        shutil.copytree(tmp / "noise2", tmp / f"resumed{n}")
        configs[n] = {**config,
                      "experiment_dir": str(tmp / f"resumed{n}" / "output")}
    configs[1].pop("mesh")
    procs = _launch("train", configs[2], tmp / "resumed2.yaml")
    with open(tmp / "resumed1.yaml", "w") as f:
        yaml.safe_dump(configs[1], f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        from ace_tpu_torch.train.train import main

        trainer = main([str(tmp / "resumed1.yaml")], device="cpu")
    assert trainer.start_epoch == 1
    _wait(procs)
    got, ref = (_metrics(tmp / f"resumed{n}" / "output") for n in (2, 1))
    assert len(got) == len(ref) == 2 and got[0] == ref[0]
    _assert_metrics_close(got[1:], ref[1:])
    _assert_changes_close(_ckpt(tmp / "resumed2" / "output"),
                          _ckpt(tmp / "resumed1" / "output"), init)
