"""The port's training entry on its own: a run stopped and resumed (at an
epoch's end, mid-epoch from a ``checkpoint_every_n_batches`` checkpoint,
and from the SIGTERM save) ends bit for bit where an uninterrupted run
ends; the entry needs CUDA unless the CPU is asked for; and
``chip_smoke.py``'s path R and reference phase R run on the CPU at a
small size."""

import json
import os
import signal
import subprocess
import sys

import pytest
import torch
import yaml

from ace_tpu.testing import SyntheticData
from ace_tpu_torch.stepper import train as port_train
from ace_tpu_torch.stepper.checkpoint import read_train_checkpoint
from ace_tpu_torch.train.train import main

torch.set_num_threads(2)

NLAT, NLON = 16, 32
PROGNOSTIC = ["air_temperature_0", "air_temperature_1",
              "specific_total_water_0", "specific_total_water_1", "PRESsfc",
              "surface_temperature"]
FORCING = ["DSWRFtoa", "ocean_fraction"]
NAMES = PROGNOSTIC + ["PRATEsfc"] + FORCING


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """12 times: 11 windows of 2, so 5 batches of 2 an epoch."""
    return SyntheticData(tmp_path_factory.mktemp("resume") / "data", NAMES,
                         n_time=12, nlat=NLAT, nlon=NLON)


def _config(data, out_dir, **extra) -> dict:
    """A small NoiseConditionedSFNO that draws its noise from the
    trainer's generator, with inline inference, for two epochs."""
    loader = {"dataset": {"data_path": str(data.data_dir)}, "batch_size": 2,
              "num_data_workers": 1}
    return {
        "experiment_dir": str(out_dir), "max_epochs": 2, "seed": 3,
        "logging": {"log_to_screen": False, "log_to_file": False},
        "train_loader": loader, "validation_loader": loader,
        "optimization": {"lr": 1e-3, "optimizer_type": "AdamW",
                         "max_grad_norm": 1.0,
                         "first_moment_dtype": "bfloat16"},
        "stepper_training": {"n_forward_steps": 1, "loss": {"type": "MSE"}},
        "inference": {
            "loader": {"dataset": {"data_path": str(data.data_dir)},
                       "start_indices": {"list": [0, 1]}},
            "n_forward_steps": 2,
        },
        "stepper": {"step": {"type": "single_module", "config": dict(
            builder={"type": "NoiseConditionedSFNO", "config": {
                "embed_dim": 16, "noise_embed_dim": 4, "num_layers": 2,
                "data_grid": "equiangular"}},
            in_names=PROGNOSTIC + FORCING, out_names=PROGNOSTIC + ["PRATEsfc"],
            normalization={"network": {
                "global_means_path": str(data.mean_path),
                "global_stds_path": str(data.std_path)}},
            corrector={"conserve_dry_air": True},
        )}},
        **extra,
    }


def _write(path, config) -> str:
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return str(path)


def _state(trainer) -> dict[str, torch.Tensor]:
    ts = trainer.train_stepper
    out = {}
    for label, group in (("param", ts.parameters()),
                         ("mu", ts.optimization.mu),
                         ("nu", ts.optimization.nu),
                         ("ema", ts.ema.ema_params)):
        for name, t in zip(ts.parameter_names(), group):
            out[f"{label}/{name}"] = t.detach().clone()
    return out


def _metrics(out_dir) -> list[dict]:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


class _Preempted(Exception):
    pass


@pytest.mark.parametrize("stop", ["epoch", "mid_epoch", "sigterm",
                                  "sigterm_in_update"])
def test_resume_equals_an_uninterrupted_run(data, tmp_path, monkeypatch,
                                            stop):
    """Two epochs in one run against a run that stops and is run again:
    after its first epoch (``max_epochs=1``, then 2); at the start of the
    fourth step of the first epoch, from the checkpoint that
    ``checkpoint_every_n_batches=2`` wrote after the second (steps 3 and 4
    are trained again); at a SIGTERM before the fourth step, whose
    handler saves the three steps done and exits with 143; or at a
    SIGTERM in the fourth step between its optimizer and EMA updates,
    whose handler waits for the step and its counters and saves four
    steps. The weights, Adam moments, EMA, update count and batches seen
    come out bit for bit, and so does the last epoch's line of
    metrics.jsonl."""
    whole = main([_write(tmp_path / "whole.yaml",
                         _config(data, tmp_path / "whole"))], device="cpu")
    want, want_metrics = _state(whole), _metrics(tmp_path / "whole")
    extra = ({"checkpoint_every_n_batches": 2} if stop == "mid_epoch"
             else {})
    path = _write(tmp_path / "parts.yaml",
                  _config(data, tmp_path / "parts", **extra))
    if stop == "epoch":
        first = main([path, "--override", "max_epochs=1"], device="cpu")
        assert first.num_batches_seen == 5
    elif stop == "sigterm_in_update":
        from ace_tpu_torch.core.optimization import EMATracker

        update, calls = EMATracker.__call__, [0]

        def interrupted(self, params):
            calls[0] += 1
            if calls[0] == 4:
                os.kill(os.getpid(), signal.SIGTERM)
            return update(self, params)

        monkeypatch.setattr(EMATracker, "__call__", interrupted)
        with pytest.raises(SystemExit) as info:
            main([path], device="cpu")
        assert info.value.code == 128 + signal.SIGTERM
        monkeypatch.setattr(EMATracker, "__call__", update)
        saved = read_train_checkpoint(str(
            tmp_path / "parts" / "training_checkpoints" / "ckpt.msgpack"))
        assert saved["extra"]["num_batches_seen"] == 4
        assert saved["optimizer"]["count"] == 4
    else:
        train_step = port_train.TrainStepper.train_step
        calls = [0]

        def interrupted(self, *args, **kwargs):
            calls[0] += 1
            if calls[0] == 4:
                if stop == "sigterm":
                    os.kill(os.getpid(), signal.SIGTERM)
                raise _Preempted
            return train_step(self, *args, **kwargs)

        monkeypatch.setattr(port_train.TrainStepper, "train_step",
                            interrupted)
        error = SystemExit if stop == "sigterm" else _Preempted
        with pytest.raises(error) as info:
            main([path], device="cpu")
        if stop == "sigterm":
            assert info.value.code == 128 + signal.SIGTERM
        assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
        monkeypatch.setattr(port_train.TrainStepper, "train_step",
                            train_step)
    resumed = main([path], device="cpu")
    assert resumed.start_epoch == (1 if stop == "epoch" else 0)
    assert resumed.num_batches_seen == whole.num_batches_seen == 10
    assert resumed.train_stepper.optimization._count == 10
    got = _state(resumed)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert _metrics(tmp_path / "parts")[-1] == want_metrics[-1]
    files = sorted(os.listdir(tmp_path / "parts" / "training_checkpoints"))
    assert files == ["best_ckpt.msgpack", "best_inference_ckpt.msgpack",
                     "ckpt.msgpack", "ema_ckpt.msgpack"]


@pytest.mark.parametrize("phase", ["validate", "inference"])
def test_sigterm_with_the_ema_swapped_in_saves_the_training_weights(
        data, tmp_path, monkeypatch, phase):
    """A SIGTERM while validation or inline inference runs with the EMA's
    weights swapped into the module: the handler's ``ckpt.msgpack`` holds
    the training weights as the parameters and the EMA's as the EMA, with
    the moments and the count, each bit for bit as they stood when the
    epoch's steps were done; a run from it skips the trained batches and
    ends after two epochs' steps."""
    from ace_tpu_torch.inference import loop as loop_module
    from ace_tpu_torch.train.trainer import Trainer

    path = _write(tmp_path / "c.yaml", _config(data, tmp_path / "out"))
    seen = {}
    train_batches = Trainer._train_batches

    def snapshot(self, epoch):
        result = train_batches(self, epoch)
        seen.setdefault("state", _state(self))
        seen["names"] = self.train_stepper.parameter_names()
        return result

    def interrupted(*args, **kwargs):
        os.kill(os.getpid(), signal.SIGTERM)
        raise AssertionError("the SIGTERM handler did not run")

    monkeypatch.setattr(Trainer, "_train_batches", snapshot)
    if phase == "validate":
        monkeypatch.setattr(port_train.TrainStepper, "valid_step",
                            interrupted)
    else:
        monkeypatch.setattr(loop_module, "run_inference", interrupted)
    with pytest.raises(SystemExit) as info:
        main([path], device="cpu")
    assert info.value.code == 128 + signal.SIGTERM
    monkeypatch.undo()
    want = seen["state"]
    out = read_train_checkpoint(str(tmp_path / "out" / "training_checkpoints"
                                    / "ckpt.msgpack"))
    assert out["optimizer"]["count"] == 5
    assert out["extra"]["num_batches_seen"] == 5
    for label, got in (("param", out["params"]), ("ema", out["ema_state"]),
                       ("mu", out["optimizer"]["mu"]),
                       ("nu", out["optimizer"]["nu"])):
        for name in seen["names"]:
            assert torch.equal(got[name], want[f"{label}/{name}"]), (
                label, name)
    resumed = main([path], device="cpu")
    assert resumed.start_epoch == 0
    assert resumed.num_batches_seen == 10
    assert resumed.train_stepper.optimization.count == 10


def test_train_entry_needs_cuda_unless_cpu_is_asked(data, tmp_path,
                                                    monkeypatch):
    """``main`` stops without CUDA unless the CPU is asked for, and so
    does ``python -m ace_tpu_torch.train`` where CUDA is missing."""
    path = _write(tmp_path / "c.yaml",
                  _config(data, tmp_path / "c", max_epochs=1))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    result = subprocess.run(
        [sys.executable, "-m", "ace_tpu_torch.train", path],
        capture_output=True, text=True, cwd=root)
    if not torch.cuda.is_available():
        assert result.returncode != 0
        assert "device='cpu'" in result.stderr
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([path])
    assert not (tmp_path / "c").exists()
    trainer = main([path, "--device", "cpu"])
    assert trainer.num_batches_seen == 5


@pytest.mark.parametrize("route", ["files", "memory"])
def test_chip_smoke_path_r_runs_on_the_cpu(route, monkeypatch, capsys):
    """``chip_smoke.py``'s path R at a small size on the CPU: the shipped
    training config's variables and corrector at 16x32, embed 16, 2
    layers, through ``main`` on netCDF files (written with h5py or held in
    host memory by the script's stand-in) and a resume; its gates hold;
    then path P-1 on a gloo process group of one rank, bit for bit as the
    first run's epoch."""
    import chip_smoke
    from ace_tpu_torch.ops import dhconv_filter as k1

    if route == "memory":
        present, _ = chip_smoke.inference_packages()
        present.pop("h5py")
        monkeypatch.setattr(chip_smoke, "inference_packages",
                            lambda: (present, ["h5py"]))
    counters = [k1.dhconv_filter, k1.dhconv_filter_dx, k1.dhconv_filter_dw]
    launches, rates, _, free = chip_smoke.train_entry_path(
        counters, device="cpu",
        sizes=dict(nlat=16, nlon=32, embed=16, layers=2))
    assert launches == {c.__name__: 0 for c in counters}  # plain versions
    assert len(rates) == 2 and min(rates) > 0 and free > 0
    out = capsys.readouterr().out
    assert "checksums equal" in out and "write ckpt.msgpack" in out
    assert "path P-1" in out and "on a gloo group of one rank" in out
    assert ("held in host memory" in out) == (route == "memory")
    assert sys.modules["h5py"].__name__ == "h5py"


def test_chip_smoke_reference_r_runs_on_the_cpu(capsys):
    """Reference phase R with the CPU on both sides agrees exactly: the
    losses and every tensor's change over the epoch."""
    import chip_smoke

    errs = chip_smoke.reference_train_entry_phase(
        device="cpu", sizes=dict(nlat=16, nlon=32, embed=32, layers=2))
    assert (errs["train_loss"], errs["val_loss"], errs["change"]) == (
        0.0, 0.0, 0.0)
    assert errs["moved"] == errs["tensors"] > 0
    assert "reference R" in capsys.readouterr().out


@pytest.mark.parametrize("threshold, adopted", [(-1e9, True), (1.0, False)])
def test_lr_tuning_trial_adopts_by_its_threshold(data, tmp_path, monkeypatch,
                                                 threshold, adopted):
    """An epoch with ``lr_tuning``: the trial trains copies of the weights
    at the current and the reduced rate and leaves the weights as they
    were; the reduced rate is adopted (the schedule scaled by
    ``lr_factor``) when the candidate wins by the threshold: always at
    -1e9, never at 1.0 (a loss below 0 would be needed)."""
    from ace_tpu_torch.train import trainer as trainer_module

    trial = trainer_module.run_lr_tuning_trial
    seen = {}

    def checked(config, train_stepper, *args):
        before = [p.detach().clone() for p in train_stepper.parameters()]
        result = trial(config, train_stepper, *args)
        seen["restored"] = all(torch.equal(p, b) for p, b in
                               zip(train_stepper.parameters(), before))
        return result

    monkeypatch.setattr(trainer_module, "run_lr_tuning_trial", checked)
    config = _config(data, tmp_path / "out", max_epochs=1,
                     lr_tuning={"enabled": True, "lr_factor": 0.5,
                                "num_batches": 2,
                                "improvement_threshold": threshold})
    trainer = main([_write(tmp_path / "c.yaml", config)], device="cpu")
    assert seen["restored"]
    lr = _metrics(tmp_path / "out")[-1]["lr"]
    assert lr == pytest.approx(5e-4 if adopted else 1e-3)
    assert trainer.train_stepper.optimization.get_state()["lr_scale"] == (
        0.5 if adopted else 1.0)
