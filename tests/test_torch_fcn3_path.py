"""``chip_smoke.py``'s path N and reference phase N on the CPU, at 16x32
(FourCastNet3's recipe, ``configs/fcn3-train.yaml``, at embeds 8 with 4
layers and a scale factor of 2), their files held in host memory as where
h5py is missing: the port's training entry over a small copy of the YAML
for one epoch, a resume that must be bit-equal, then the inference entry
from its best checkpoint, equal to ``Stepper.predict``; and
``profile_flagship --fcn3``'s runners and its DISCO attribution at the
same size. No JAX runs here."""

import json
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke

torch.set_num_threads(2)

SIZES = {"nlat": 16, "nlon": 32, "embed": 8, "layers": 4, "scale_factor": 2}


def test_chip_smoke_path_n_runs_on_the_cpu(monkeypatch, capsys):
    """Reference phase N (the CPU on both sides: equal exactly), then
    paths N-R and N-I over the shipped YAML, TF32 turned on before each
    entry and off after it."""
    from ace_tpu_torch.ops import dhconv_filter as k1

    present, _ = chip_smoke.inference_packages()
    present.pop("h5py", None)
    monkeypatch.setattr(chip_smoke, "inference_packages",
                        lambda: (present, ["h5py"]))
    # no figures, as on the card
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    counters = [k1.dhconv_filter, k1.dhconv_filter_dx, k1.dhconv_filter_dw]
    out = chip_smoke.fcn3_paths(counters, "cpu", sizes=SIZES, device="cpu")
    none = {c.__name__: 0 for c in counters}
    assert out == {"N-R": none, "N-I": none}
    text = capsys.readouterr().out
    for line in ("cpu vs CPU: 0 of the largest output",
                 "cpu vs CPU: rollout error 0 of the allowed",
                 "set on before it: [(False, False), (False, False)]",
                 "set on before it: [(False, False)]",
                 "resumed state against the first run's end",
                 "checkpoint files ['best_ckpt.msgpack', 'ckpt.msgpack', "
                 "'ema_ckpt.msgpack']",
                 "largest error 0 of the channel's spatial std"):
        assert line in text, line


def test_fcn3_config_keeps_the_recipe_but_for_its_cuts(tmp_path):
    """``_fcn3_config`` changes only the placeholder paths, the epochs
    and the screen logging of the shipped YAML (and, for the CPU, the
    widths): the step, the model's other fields, the loss, the optimizer
    and both batch sizes stay as shipped."""
    shipped = chip_smoke._yaml(chip_smoke.FCN3_CONFIG)
    paths = {"train": "a", "valid": "b", "centering": "m",
             "scaling-full-field": "s"}
    config = chip_smoke._fcn3_config(paths, str(tmp_path))
    assert config["max_epochs"] == 1
    for key in ("optimization", "stepper_training"):
        assert config[key] == shipped[key]
    for loader in ("train_loader", "validation_loader"):
        assert config[loader]["batch_size"] == chip_smoke.N_BATCH == (
            shipped[loader]["batch_size"])
    step, want = (c["stepper"]["step"]["config"] for c in (config, shipped))
    assert step["normalization"]["network"] == {
        "global_means_path": "m", "global_stds_path": "s"}
    assert {k: v for k, v in step.items() if k != "normalization"} == {
        k: v for k, v in want.items() if k != "normalization"}
    assert len(chip_smoke._fcn3_names()) == 37


def test_profile_flagship_fcn3_runners_and_disco_attribution(tmp_path):
    """``profile_flagship --fcn3``'s train step and rollout window at
    16x32: finite losses falling over 3 steps on one batch, the window's
    outputs finite; in a CPU trace of a train step, ``disco_relabel``
    names the DISCO contractions' forward matmuls and the backward of
    them, and not the processor's dense layers."""
    from ace_tpu_torch import profile_flagship

    train, rollout = profile_flagship._fcn3_runners(
        "cpu", SIZES["nlat"], SIZES["nlon"], embed=SIZES["embed"],
        layers=SIZES["layers"], scale_factor=SIZES["scale_factor"])
    losses = [float(m["loss"]) for m in train(3)]
    assert all(map(np.isfinite, losses)) and losses[-1] < losses[0], losses
    out = rollout(1)
    assert out["air_temperature_0"].shape == (
        2, profile_flagship.FCN3_WINDOW, 16, 32)
    assert all(torch.isfinite(v).all() for v in out.values())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train(1)
    path = str(tmp_path / "fcn3_cpu_trace.json")
    prof.export_chrome_trace(path)
    relabel = profile_flagship.disco_relabel(path)
    with open(path) as f:
        ops = [e for e in json.load(f)["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    named = {e["name"] for e in ops if relabel(e)}
    assert {"aten::bmm", "aten::index"} <= named, named
    backward = [e for e in ops if relabel(e)
                and e["name"].startswith("autograd::engine::evaluate_")]
    assert any("BmmBackward" in e["name"] for e in backward)
    dense = [e for e in ops if e["name"] == "aten::addmm"]
    assert dense and not any(map(relabel, dense))
