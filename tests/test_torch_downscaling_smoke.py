"""``chip_smoke.py``'s path D at a tiny size on the CPU (reference phase D,
D-R with its bit-equal resume, D-G, D-E), and the downscaling entries'
options that path D does not reach: a resume equal to an uninterrupted
run, ``segment_epochs``, the deterministic models (SwinIR and the
interpolation baseline) through the training and downscaler entries, a
mixture-of-experts bundle written and read by the port. No JAX."""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from ace_tpu_torch.data.store import open_file_dataset
from ace_tpu_torch.downscaling import diffusion, models, predict, train
from ace_tpu_torch.ops import dhconv_filter as k1

torch.set_num_threads(2)

SIZES = {"nlat": 8, "nlon": 16, "factor": 2, "patch": 4, "batch": 2,
         "batches": 2, "train_times": 4, "valid_times": 2, "samples": 2,
         "steps": 3}
MODULE = {"type": "unet_diffusion_song", "config": {
    "model_channels": 8, "channel_mult": [1, 2], "num_blocks": 1,
    "attn_resolutions": [], "channel_mult_emb": 2}}


def test_chip_smoke_path_d_runs_on_the_cpu(capsys):
    """Reference D (card against CPU, here CPU against CPU), D-R (one
    epoch, then a bit-equal resume), D-G (the written samples equal to
    ``PatchPredictor.generate`` on the same draws, 2 steps - 1 network
    calls a patch-sample) and D-E, with the recipe's dropout, no launch."""
    launches = chip_smoke.downscaling_paths([k1.dhconv_filter], "smi",
                                            device="cpu", sizes=SIZES,
                                            module=MODULE)
    assert launches == {p: {"dhconv_filter": 0} for p in
                        ("D-R", "D-G", "D-E")}
    out = capsys.readouterr().out
    assert "5.0 network evaluations per patch-sample (want 5)" in out


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("files"))
    return chip_smoke.downscaling_files(
        tmp, torch.Generator().manual_seed(5), "cpu", SIZES)


def _config(paths, out_dir, **extra):
    config = chip_smoke._downscaling_config(paths, out_dir, SIZES, MODULE)
    config.update(extra)
    return config


def _run(tmp_path, name, config, overrides=()):
    path = chip_smoke._write_yaml(str(tmp_path / f"{name}.yaml"), config)
    argv = [path] + (["--override", *overrides] if overrides else [])
    return train.main(argv, device="cpu")


def _weights(trainer):
    return [p.detach().clone() for p in trainer.params] + [
        e.clone() for e in trainer.ema.ema_params]


def test_resume_equals_an_uninterrupted_run(paths, tmp_path):
    """Two epochs in one run, and one epoch then a resume to two: the
    same weights, EMA and losses, bit for bit."""
    straight = _run(tmp_path, "straight",
                    _config(paths, str(tmp_path / "a"), max_epochs=2))
    config = _config(paths, str(tmp_path / "b"))
    _run(tmp_path, "first", config)
    resumed = _run(tmp_path, "second", config, ["max_epochs=2"])
    assert resumed.start_epoch == 1
    for a, b in zip(_weights(straight), _weights(resumed)):
        assert torch.equal(a, b)
    lines = [open(str(tmp_path / d / "metrics.jsonl")).read().splitlines()
             for d in ("a", "b")]
    assert lines[0] == lines[1]


def test_segment_epochs_count_from_the_resumed_epoch(paths, tmp_path):
    config = _config(paths, str(tmp_path / "run"), max_epochs=3,
                     segment_epochs=2)
    first = _run(tmp_path, "one", config)
    assert (first.start_epoch, first.optimization.adam_count) == (
        0, 2 * SIZES["batches"])
    second = _run(tmp_path, "two", config)
    assert (second.start_epoch, second.optimization.adam_count) == (
        2, 3 * SIZES["batches"])


def test_a_checkpoint_without_training_state_is_not_resumed(paths,
                                                            tmp_path):
    """An ``ema_ckpt.msgpack`` (no training state) in the place of
    ``ckpt.msgpack`` is refused, not silently restarted."""
    config = _config(paths, str(tmp_path / "run"))
    _run(tmp_path, "one", config)
    ckpt_dir = tmp_path / "run" / "checkpoints"
    os.replace(ckpt_dir / "ema_ckpt.msgpack", ckpt_dir / "ckpt.msgpack")
    with pytest.raises(ValueError, match="no training state"):
        _run(tmp_path, "two", config)


@pytest.mark.parametrize("module", ["SwinIR", "interpolate"])
def test_deterministic_models_train_and_downscale(paths, tmp_path, module):
    """The deterministic model (SwinIR, and the bilinear baseline with no
    weights) through the training entry (one epoch) and the downscaler
    entry over two full-grid times: finite losses, the predictions'
    shape, equal samples."""
    config = _config(paths, str(tmp_path / "train"))
    config["model"] = {
        "in_names": ["PRATEsfc", "eastward_wind_at_ten_meters"],
        "out_names": ["PRATEsfc"], "module": module,
        "normalization": config["model"]["normalization"],
        "downscale_factor": SIZES["factor"], "embed_dim": 8, "depths": [2],
        "num_heads": 2, "window_size": [2, 2]}
    config.pop("static_inputs")
    trainer = _run(tmp_path, "train", config)
    assert isinstance(trainer.model, models.DeterministicModel)
    ckpt = str(tmp_path / "train" / "checkpoints" / "ckpt.msgpack")
    out = str(tmp_path / "predict")
    predict_config = {
        "experiment_dir": out, "checkpoint_path": ckpt,
        "coarse_data": {"data_path": paths["coarse_valid"],
                        "file_pattern": "data.nc"},
        "n_samples": 2, "n_timesteps": 2,
        "logging": {"log_to_screen": False, "log_to_file": False}}
    path = predict.main([chip_smoke._write_yaml(
        str(tmp_path / "predict.yaml"), predict_config)], device="cpu")
    field = np.asarray(open_file_dataset(path)["PRATEsfc"].read(()))
    f = SIZES["factor"]
    assert field.shape == (2, 2, (SIZES["nlat"] + 2) * f, SIZES["nlon"] * f)
    assert np.isfinite(field).all()
    np.testing.assert_array_equal(field[:, 0], field[:, 1])


def test_the_ports_moe_bundle_round_trips(paths, tmp_path):
    """Two experts bundled by the port and read back generate the same
    fields from the same generator; each sampler call routes its noise
    levels to the expert whose range holds them."""
    config = _config(paths, str(tmp_path / "run"))
    config["model"]["use_fine_topography"] = False
    config.pop("static_inputs")
    trainer = _run(tmp_path, "run", config)
    ckpt = str(tmp_path / "run" / "checkpoints")
    moe = models.DenoisingMoEConfig(
        denoising_expert_configs=[
            models.DenoisingExpertCheckpointConfig(
                os.path.join(ckpt, "ckpt.msgpack"), 1.0, 150.0),
            models.DenoisingExpertCheckpointConfig(
                os.path.join(ckpt, "ema_ckpt.msgpack"), 0.002, 1.0)],
        num_diffusion_generation_steps=SIZES["steps"]).build(device="cpu")
    assert [tuple(r) for r in moe._sigma_ranges] == [(0.002, 1.0),
                                                     (1.0, 150.0)]
    bundle = str(tmp_path / "moe.msgpack")
    moe.save(bundle)
    again = models.DenoisingMoEPredictor.load(bundle, device="cpu")
    coarse = {k: torch.randn(1, 4, 4, generator=torch.Generator()
                             .manual_seed(i)) * 1e-5
              for i, k in enumerate(trainer.model.config.in_names)}
    calls = []
    for i, expert in enumerate(again.experts):
        forward = expert.net.forward
        expert.net.forward = (lambda *a, i=i, forward=forward, **k:
                              calls.append(i) or forward(*a, **k))
    a = moe.generate(coarse, torch.Generator().manual_seed(3), n_samples=2)
    b = again.generate(coarse, torch.Generator().manual_seed(3),
                       n_samples=2)
    assert torch.equal(a["PRATEsfc"], b["PRATEsfc"])
    schedule = diffusion.karras_schedule(SIZES["steps"], 0.002, 150.0)
    # per sample: t0 and t1 (Heun), t1 and t2, then t2 alone (to 0)
    levels = [schedule[0], schedule[1], schedule[1], schedule[2],
              schedule[2]]
    assert calls == [0 if s <= 1.0 else 1 for s in levels] * 2


def test_profile_flagship_downscaling_runners_run_on_the_cpu():
    """``profile_flagship --downscaling``'s runners (the recipe's model,
    loss, Adam and EMA; a sampler step) and its operation count at a small
    size: 2 train steps move the weights, a sampler step is finite, and the
    convolutions' count agrees with torch's flop counter."""
    from ace_tpu_torch import profile_flagship

    train, sample = profile_flagship._downscaling_runners(
        "cpu", module=MODULE, batch=2, patch=4, factor=2)
    before = [p.detach().clone() for p in sample.model.net.parameters()]
    losses = train(2)
    assert all(torch.isfinite(x) for x in losses)
    assert any(not torch.equal(a, b) for a, b in
               zip(before, sample.model.net.parameters()))
    assert torch.isfinite(sample(1)).all()
    # the 3x3 and 1x1 convolutions: all of torch's count of the forward's
    # convolutions but the depthwise resampling's few
    from torch.utils.flop_counter import FlopCounterMode

    flop = profile_flagship.song_unet_flop(sample.model)
    net = sample.model.net
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(torch.zeros(1, 8, 8, 1), torch.zeros(1, 8, 8, 4),
            torch.zeros(1))
    total = counter.get_flop_counts()["Global"][
        torch.ops.aten.convolution]
    assert 0.95 * total < flop <= total
    assert profile_flagship.downscaling_family(
        {"name": "sm80_xmma_fprop_implicit_gemm_f32"}) == (
        "convolutions (cuDNN, f32)")
    assert profile_flagship.downscaling_family(
        {"name": "RowwiseMomentsCUDAKernel"}) == "group norms"
