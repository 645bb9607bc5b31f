"""``chip_smoke.py``'s path S (reference phase S and paths S-R, S-I and
S-bf16 over ``configs/baselines/amip-c96-shield/train-ace2.yaml``, the
ACE2-SHiELD AMIP recipe) at a small size on the CPU, where the kernels'
plain versions run, as tests/test_torch_baselines.py runs paths E and F."""

import sys

import numpy as np
import torch

torch.set_num_threads(2)

NLAT, NLON = 16, 32


def test_chip_smoke_path_s_runs_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s reference phase S (the CPU on both sides: equal
    exactly) and paths S-R, S-I and S-bf16 over the shipped SHiELD YAML
    at 16x32, embed 16, 2 layers, its files held in host memory as where
    h5py is missing: every gate holds, with no launch (the plain versions
    on the CPU)."""
    import chip_smoke
    from ace_tpu_torch.ops import dhconv_filter as k1

    present, _ = chip_smoke.inference_packages()
    present.pop("h5py")
    monkeypatch.setattr(chip_smoke, "inference_packages",
                        lambda: (present, ["h5py"]))
    # no figures, as on the card
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    counters = [k1.dhconv_filter, k1.dhconv_filter_dx, k1.dhconv_filter_dw]
    out = chip_smoke.shield_paths(
        counters, "cpu", sizes=dict(nlat=NLAT, nlon=NLON, embed=16,
                                    layers=2), device="cpu")
    none = {c.__name__: 0 for c in counters}
    assert out == {"S-R": none, "S-I": none, "S-bf16": none}
    text = capsys.readouterr().out
    for line in ("reference S (f32 dhconv)", "reference S (bf16 dhconv)",
                 "path S-R: train/loss", "path S-I: written predictions",
                 "path S-bf16: 3 train steps"):
        assert line in text, line
    assert "relative error 0 (tol" in text


def test_profile_flagship_shield_runners_run_on_the_cpu():
    """``profile_flagship --shield``'s train step and rollout of the SHiELD
    recipe at 16x32, embed 16, 2 layers: the loss is finite and falls
    over 4 steps on one batch, the rollout's outputs are finite."""
    from ace_tpu_torch import profile_flagship

    train, rollout = profile_flagship._shield_runners("cpu", NLAT, NLON, 16,
                                                      2)
    losses = [float(m["loss"]) for m in train(4)]
    assert all(map(np.isfinite, losses)) and losses[-1] < losses[0], losses
    outputs = rollout(2)
    assert len(outputs) == 50
    for k, v in outputs.items():
        assert v.shape == (1, 2, NLAT, NLON) and torch.isfinite(v).all(), k
