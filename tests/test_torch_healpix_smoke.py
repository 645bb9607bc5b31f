"""``chip_smoke.py``'s path H and reference phase H on the CPU, at nside 8
(DLWP-HPX's recipe, ``configs/dlwp-hpx64-train.yaml``, with the network
at the defaults' structure and widths up to 16), its files held in host
memory as where h5py is missing: reference H's grid parts at nside 64 and
its small networks, the training entry for one epoch and a resume that
must be bit-equal, then the inference entry from its best checkpoint with
the initial condition given as a ``file://`` URL, equal to
``Stepper.predict``; the recipe's cuts; and ``profile_flagship
--healpix``'s runners and families at the same size. No JAX runs
here."""

import sys

import numpy as np
import torch

import chip_smoke

torch.set_num_threads(2)

NSIDE = 8
BUILDER = chip_smoke.healpix_unet_configs()["defaults-structure"]


def test_chip_smoke_path_h_runs_on_the_cpu(monkeypatch, capsys):
    """Reference phase H (the CPU on both sides: equal exactly; the
    transforms against float64), then paths H-R and H-I over the shipped
    YAML, TF32 turned on before each entry and off after it."""
    from ace_tpu_torch.ops import dhconv_filter as k1

    present, _ = chip_smoke.inference_packages()
    present.pop("h5py", None)
    monkeypatch.setattr(chip_smoke, "inference_packages",
                        lambda: (present, ["h5py"]))
    # no figures, as on the card
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    counters = [k1.dhconv_filter, k1.dhconv_filter_dx, k1.dhconv_filter_dw]
    out = chip_smoke.healpix_paths(counters, "cpu", device="cpu",
                                   nside=NSIDE, builder=BUILDER)
    none = {c.__name__: 0 for c in counters}
    assert out == {"H-R": none, "H-I": none}
    text = capsys.readouterr().out
    for line in ("equal to the CPU at p = 1, 2, 3: {1: True, 2: True, "
                 "3: True}",
                 "reference H (defaults-structure): cpu vs CPU: rollout "
                 "error 0 of the allowed",
                 "reference H (every-block): cpu vs CPU",
                 "reference H (maxpool-interpolate): cpu vs CPU",
                 "reference H (defaults-structure, ensemble loss): cpu vs "
                 "CPU: rollout error 0",
                 "set on before it: [(False, False), (False, False)]",
                 "set on before it: [(False, False)]",
                 "resumed state against the first run's end",
                 "diagnostics/spectrum_diagnostics.nc",
                 "largest error 0 of the channel's spatial std"):
        assert line in text, line


def test_healpix_config_keeps_the_recipe_but_for_its_cuts(tmp_path):
    """``_healpix_config`` changes only the placeholder paths, the epochs,
    the screen logging and the inline inference of the shipped YAML (and,
    for the CPU, the network's config): the step, the loss, the optimizer
    and both batch sizes stay as shipped."""
    shipped = chip_smoke._yaml(chip_smoke.HPX_CONFIG)
    paths = {"train": "a", "valid": "b", "centering": "m", "scaling": "s"}
    config = chip_smoke._healpix_config(paths, str(tmp_path))
    assert config["max_epochs"] == 1
    assert config["inference"]["n_forward_steps"] == 4
    for key in ("optimization", "stepper_training"):
        assert config[key] == shipped[key]
    for loader in ("train_loader", "validation_loader"):
        assert config[loader]["batch_size"] == chip_smoke.H_BATCH == (
            shipped[loader]["batch_size"])
    step, want = (c["stepper"]["step"]["config"] for c in (config, shipped))
    assert step["builder"] == {"type": "HEALPixUNet", "config": {}}
    assert step["normalization"]["network"] == {
        "global_means_path": "m", "global_stds_path": "s"}
    assert {k: v for k, v in step.items() if k != "normalization"} == {
        k: v for k, v in want.items() if k != "normalization"}
    assert len(chip_smoke._healpix_names()) == 11


def test_recipe_network_has_its_published_size():
    """HEALPixUNet at its builder's defaults with the recipe's 11 inputs
    and 8 outputs: 9.54 M parameters."""
    config, info = chip_smoke.healpix_stepper_config(nside=4, builder={})
    stepper = config.get_stepper(info, device="cpu")
    n = sum(p.numel() for p in stepper.module.parameters())
    assert round(n / 1e6, 2) == 9.54, n


def test_profile_flagship_healpix_runners_and_families():
    """``profile_flagship --healpix``'s train step and rollout window at
    nside 8: finite losses falling over 3 steps on one batch, the
    window's outputs finite; the convolutions' operations counted from
    their shapes; ``healpix_family`` names cuDNN's convolutions and the
    pad's gathers and leaves the rest to ``FAMILIES``."""
    from ace_tpu_torch import profile_flagship

    train, rollout = profile_flagship._healpix_runners("cpu", NSIDE, BUILDER)
    losses = [float(m["loss"]) for m in train(3)]
    assert all(map(np.isfinite, losses)) and losses[-1] < losses[0], losses
    out = rollout(1)
    assert out["z500"].shape == (1, profile_flagship.HEALPIX_WINDOW, 12,
                                 NSIDE, NSIDE)
    assert all(torch.isfinite(v).all() for v in out.values())
    assert profile_flagship.convolution_flop(rollout) > 0
    family = profile_flagship.healpix_family
    for name, want in (
            ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc",
             "convolutions (cuDNN, f32)"),
            ("cudnn::engines_precompiled::nchwToNhwcKernel",
             "convolutions (cuDNN, f32)"),
            ("sm80_xmma_gemm_cf32cf32_f32f32_cf32_nt_n_tilesize64x32x8",
             "convolutions (cuDNN, f32)"),
            ("void fft2d_r2c_32x32<float, false, 0u, false>",
             "convolutions (cuDNN, f32)"),
            ("void at::native::indexSelectLargeIndex<float, long>",
             "neighbour pad (gathers, their backward)"),
            ("void at::native::indexFuncLargeIndex<float>",
             "neighbour pad (gathers, their backward)"),
            ("void at::native::vectorized_gather_kernel<16, long>",
             "neighbour pad (gathers, their backward)"),
            ("void at::native::vectorized_elementwise_kernel<4>", None)):
        assert family({"name": name}) == want, name
