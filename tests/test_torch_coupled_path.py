"""``chip_smoke.py``'s path C and reference phase C on the CPU, at 16x32
(the SFNO at embed 32 with 2 layers, Samudra at widths 16-32 over 3
levels, 4 atmosphere steps an ocean step), their files held in host
memory as where h5py is missing, and ``profile_flagship --coupled``'s
runners at the same size: every gate holds, with no launch (the CPU takes
the kernels' plain versions)."""

import sys

import numpy as np
import torch

import chip_smoke

torch.set_num_threads(2)

SIZES = {"nlat": 16, "nlon": 32, "embed": 32, "layers": 2,
         "ch_width": [16, 24, 32], "dilation": [1, 2, 2], "n_inner": 4}


def test_chip_smoke_path_c_runs_on_the_cpu(monkeypatch, capsys):
    """Reference phase C (the CPU on both sides: equal exactly), then
    paths C-R, C-F, C-E and C-bf16 over the shipped YAMLs."""
    from ace_tpu_torch.ops import dhconv_filter as k1

    present, _ = chip_smoke.inference_packages()
    present.pop("h5py", None)
    monkeypatch.setattr(chip_smoke, "inference_packages",
                        lambda: (present, ["h5py"]))
    # no figures, as on the card
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    counters = [k1.dhconv_filter, k1.dhconv_filter_dx, k1.dhconv_filter_dw]
    out = chip_smoke.coupled_paths(counters, "cpu", sizes=SIZES,
                                   device="cpu")
    none = {c.__name__: 0 for c in counters}
    assert out == {"C-R": none, "C-F": none, "C-E": none, "C-bf16": none}
    text = capsys.readouterr().out
    for line in ("cpu vs CPU: outputs 0 of the allowed",
                 "non-finite cells in the atmosphere's state and inputs "
                 "after the exchange 0",
                 "the atmosphere's weights differing from its checkpoint: "
                 "[] (want none)",
                 "checksums equal to the files", "unchanged components []",
                 "largest error 0 of the variable's largest value",
                 "NaN other than on the masked variables []"):
        assert line in text, line


def test_profile_flagship_coupled_runners_run_on_the_cpu():
    """``profile_flagship --coupled``'s train step and rollout window at
    16x32: finite losses falling over 3 steps on one batch (the ocean
    alone trains), the atmosphere frozen, the window's ocean outputs NaN
    exactly on the dry cells."""
    from ace_tpu_torch import profile_flagship

    train, rollout = profile_flagship._coupled_runners(
        "cpu", SIZES["nlat"], SIZES["nlon"], embed=SIZES["embed"],
        layers=SIZES["layers"], ch_width=SIZES["ch_width"],
        dilation=SIZES["dilation"], n_inner=SIZES["n_inner"])
    metrics = train(3)
    losses = [float(m["loss"]) for m in metrics]
    assert all(map(np.isfinite, losses)) and losses[-1] < losses[0], losses
    assert all(float(m["atmosphere_loss"]) == 0 for m in metrics)
    a_out, o_out, _ = rollout(1)
    window = profile_flagship.COUPLED_WINDOW
    assert a_out["PRESsfc"].shape == (1, window * SIZES["n_inner"], 16, 32)
    sst = o_out["sst"]
    assert sst.shape == (1, window, 16, 32)
    assert torch.isnan(sst).any() and torch.isfinite(sst[~sst.isnan()]).all()
