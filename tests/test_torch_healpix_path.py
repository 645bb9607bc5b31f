"""HEALPix data through both packages' entries on ``ace_tpu``'s own
HEALPix config (``tests/test_hpx.py:test_healpix_unet_trains_end_to_end``:
HEALPixUNet with ConvNeXt blocks, average pooling and transposed-conv
upsampling at nside 8, MSE), over one synthetic store on (face, height,
width) dims: one epoch of one update of each training entry from the same
initial weights, with the losses within 1e-4 and each weight's change
within 1e-3; the converter through ``load_stepper`` on ``ace_tpu``'s
checkpoint (every leaf equal, the transposed convolution's kernel
included); and both inference entries over that checkpoint, their
predictions, restart and diagnostics files within 1e-5 of the
reference's scale."""

import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from ace_tpu.data.store import write_h5
from ace_tpu.data.time import TimeCoord
from ace_tpu.inference.inference import main as jax_inference_main
from ace_tpu.stepper import checkpoint as jax_checkpoint
from ace_tpu.stepper import train as jax_train
from ace_tpu.testing import save_stats_files
from ace_tpu.train.train import main as jax_train_main
from ace_tpu_torch.data.store import open_file_dataset
from ace_tpu_torch.inference.inference import main as inference_main
from ace_tpu_torch.models.healpix import TransposedConvUpsample
from ace_tpu_torch.stepper import checkpoint
from ace_tpu_torch.stepper import train as port_train
from ace_tpu_torch.stepper.checkpoint import read_train_checkpoint
from ace_tpu_torch.train.train import main as train_main
from ace_tpu_torch.utils.convert import flax_params_to_state_dict

torch.set_num_threads(2)

NSIDE = 8
# three times: two windows of a forward step, one batch of 2, one update
N_TIME = 3
N_INFERENCE = 4


def _files(tmp):
    """``ace_tpu``'s test's store (``prog``, ``forc`` on face, height,
    width) and its stats files."""
    rng = np.random.RandomState(0)
    data_dir = tmp / "data"
    data_dir.mkdir()
    arrays = {name: rng.randn(N_INFERENCE + 2, 12, NSIDE, NSIDE).astype(
        np.float32) for name in ("prog", "forc")}
    dims = {name: ("time", "face", "height", "width") for name in arrays}
    arrays.update({k: np.arange(n, dtype=np.float64) for k, n in (
        ("face", 12), ("height", NSIDE), ("width", NSIDE))})
    dims.update({"face": ("face",), "height": ("height",),
                 "width": ("width",)})
    write_h5(str(data_dir / "d.nc"), arrays, dims,
             time=TimeCoord.from_range("2000-01-01T00:00", N_INFERENCE + 2,
                                       21600))
    save_stats_files(tmp / "stats-mean.nc", tmp / "stats-std.nc",
                     ["prog", "forc"])
    return data_dir


def _train_config(tmp, data_dir, out_dir):
    """``tests/test_hpx.py:175``'s config, its loaders over the first
    ``N_TIME`` times."""
    loader = {"dataset": {"data_path": str(data_dir),
                          "subset": {"stop": N_TIME - 1}},
              "batch_size": 2, "num_data_workers": 1}
    conv = {"block_type": "ConvNeXtBlock", "activation": {"cap_value": 10}}
    return {
        "experiment_dir": str(out_dir), "max_epochs": 1,
        "save_checkpoint": True,
        "logging": {"log_to_screen": False, "log_to_file": False},
        "train_loader": loader, "validation_loader": loader,
        "optimization": {"lr": 1e-3},
        "stepper_training": {"n_forward_steps": 1, "loss": {"type": "MSE"}},
        "stepper": {"step": {"type": "single_module", "config": {
            "builder": {"type": "HEALPixUNet", "config": {
                "encoder": {"conv_block": conv,
                            "down_sampling_block": {"block_type": "AvgPool"},
                            "n_channels": [8, 16], "n_layers": [1, 1]},
                "decoder": {"conv_block": conv,
                            "up_sampling_block": {
                                "block_type": "TransposedConvUpsample"},
                            "output_layer": {"block_type": "BasicConvBlock",
                                             "kernel_size": 1,
                                             "n_layers": 1},
                            "n_channels": [16, 8], "n_layers": [1, 1]}}},
            "in_names": ["prog", "forc"], "out_names": ["prog"],
            "normalization": {"network": {
                "global_means_path": str(tmp / "stats-mean.nc"),
                "global_stds_path": str(tmp / "stats-std.nc")}}}}},
    }


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of each package's training ``main``; the port starts
    from ``ace_tpu``'s initial weights."""
    tmp = tmp_path_factory.mktemp("healpix")
    data_dir = _files(tmp)
    init = {}
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

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train.TrainStepper, "init", capture)
        mp.setattr(port_train.TrainStepper, "init", from_ace_tpu)
        for name, run in (("ace_tpu", lambda p: jax_train_main([p])),
                          ("port", lambda p: train_main([p], device="cpu"))):
            path = tmp / f"{name}.yaml"
            with open(path, "w") as f:
                yaml.safe_dump(_train_config(tmp, data_dir, tmp / name), f)
            run(str(path))
            with open(tmp / name / "metrics.jsonl") as f:
                metrics = [json.loads(line) for line in f]
            ckpt_dir = tmp / name / "training_checkpoints"
            out[name] = dict(metrics=metrics, ckpt_dir=ckpt_dir,
                             ckpt=read_train_checkpoint(
                                 str(ckpt_dir / "ckpt.msgpack")))
    return tmp, data_dir, out, init["params"]


def test_one_update_of_each_training_entry_agrees(trained):
    """The same metrics, the losses within 1e-4, one update seen by each,
    and each tensor's change from the common initial weights within 1e-3
    relative L2 (AdamW's first step moves a weight by about the learning
    rate whatever its gradient's size)."""
    _, _, out, init = trained
    ref, got = out["ace_tpu"], out["port"]
    assert len(ref["metrics"]) == len(got["metrics"]) == 1
    r, g = ref["metrics"][0], got["metrics"][0]
    assert set(g) == set(r)
    for k in ("train/loss", "val/loss"):
        assert np.isfinite(r[k])
        assert g[k] == pytest.approx(r[k], rel=1e-4), k
    assert got["ckpt"]["extra"]["num_batches_seen"] == ref["ckpt"]["extra"][
        "num_batches_seen"] == 1
    for k, v in init.items():
        d_ref = ref["ckpt"]["params"][k].double() - v.double()
        d_got = got["ckpt"]["params"][k].double() - v.double()
        assert float((d_got - d_ref).norm()) <= 1e-3 * float(d_ref.norm()), k


def test_load_stepper_reads_ace_tpus_healpix_checkpoint(trained):
    """``load_stepper`` on ``ace_tpu``'s ``best_ckpt.msgpack``: the step's
    HEALPix grid, and every weight equal to the checkpoint's flax tree
    converted, the transposed convolution's ``kernel`` ``[out, in, r, r]``
    from flax's ``[r, r, in, out]``."""
    _, _, out, _ = trained
    path = str(out["ace_tpu"]["ckpt_dir"] / "best_ckpt.msgpack")
    stepper = checkpoint.load_stepper(path, device="cpu")
    assert stepper.dataset_info.img_shape == (12, NSIDE, NSIDE)
    jax_stepper = jax_checkpoint.load_stepper(path)
    ref = flax_params_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jax_stepper.params))
    got = stepper.module.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    up = stepper.module.decoder_up_1
    assert isinstance(up, TransposedConvUpsample)
    flax_kernel = jax_stepper.params["params"]["decoder_up_1"]["kernel"]
    np.testing.assert_array_equal(
        up.kernel.detach().numpy(), np.transpose(np.asarray(flax_kernel),
                                        (3, 2, 0, 1)))


def _read(path) -> dict[str, np.ndarray]:
    ds = open_file_dataset(str(path))
    return {k: np.asarray(ds[k].read(())) for k in ds.keys()}


@pytest.mark.parametrize("name", [
    "autoregressive_predictions.nc", "restart.nc",
    "diagnostics/time_mean_diagnostics.nc",
    "diagnostics/spectrum_diagnostics.nc",
])
def test_inference_entries_agree_on_ace_tpus_checkpoint(trained, name):
    """Both inference entries over ``ace_tpu``'s checkpoint from start
    indices [0, 1] for 4 steps in windows of 2 (the spectrum aggregator
    on the HEALPix SHT): each file's fields within 1e-5 of the
    reference's scale (at least 1)."""
    tmp, data_dir, out, _ = trained
    runs = tmp / "inference"
    if not runs.exists():
        ckpt = str(out["ace_tpu"]["ckpt_dir"] / "best_ckpt.msgpack")
        for side, run in (("jax", lambda p: jax_inference_main([p])),
                          ("torch", lambda p: inference_main(
                              [p], device="cpu"))):
            path = tmp / f"inference_{side}.yaml"
            with open(path, "w") as f:
                yaml.safe_dump({
                    "experiment_dir": str(runs / side),
                    "checkpoint_path": ckpt,
                    "n_forward_steps": N_INFERENCE,
                    "forward_steps_in_memory": 2,
                    "logging": {"log_to_screen": False,
                                "log_to_file": False},
                    "forcing_loader": {
                        "dataset": {"data_path": str(data_dir)},
                        "start_indices": {"list": [0, 1]}},
                }, f)
            run(str(path))
    got, ref = _read(runs / "torch" / name), _read(runs / "jax" / name)
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert got[k].shape == r.shape, k
        if r.dtype.kind == "f":
            scale = max(1.0, float(np.max(np.abs(r))))
            np.testing.assert_allclose(got[k], r, rtol=0, atol=1e-5 * scale,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], r, err_msg=k)


# the evaluator flags that ace_tpu's evaluator takes on HEALPix (the ENSO
# index reads latitudes, the trends broadcast over a lat-lon rank, the
# zonal means are lat-lon only)
EVALUATOR_FLAGS = {
    "log_histograms": True, "log_seasonal_means": True,
    "log_near_zero_fraction": True, "log_video": True,
    "log_extended_video": True, "log_step_means": [{"step": 2}],
}


def test_evaluator_entries_agree_on_healpix(trained):
    """Both evaluator entries over ``ace_tpu``'s checkpoint with every
    flag above (the video's faces folded as ``ace_tpu`` folds them):
    the same log keys, each value within 1e-5 of its scale (at least 1),
    the same diagnostics files, the video's within 1e-5."""
    from ace_tpu.inference.evaluator import main as jax_evaluator_main
    from ace_tpu_torch.inference.evaluator import main as evaluator_main

    tmp, data_dir, out, _ = trained
    ckpt = str(out["ace_tpu"]["ckpt_dir"] / "best_ckpt.msgpack")
    logs = {}
    for side, run in (("jax", lambda p: jax_evaluator_main([p])),
                      ("torch", lambda p: evaluator_main([p],
                                                         device="cpu"))):
        path = tmp / f"evaluator_{side}.yaml"
        with open(path, "w") as f:
            yaml.safe_dump({
                "experiment_dir": str(tmp / f"evaluator_{side}"),
                "checkpoint_path": ckpt,
                "n_forward_steps": N_INFERENCE,
                "forward_steps_in_memory": 2,
                "logging": {"log_to_screen": False, "log_to_file": False},
                "loader": {"dataset": {"data_path": str(data_dir)},
                           "start_indices": {"list": [0, 1]}},
                "aggregator": EVALUATOR_FLAGS,
            }, f)
        logs[side] = run(str(path))["logs"]
    assert set(logs["torch"]) == set(logs["jax"])
    for k, r in logs["jax"].items():
        np.testing.assert_allclose(logs["torch"][k], r, rtol=0,
                                   atol=1e-5 * max(1.0, abs(r)), err_msg=k)
    files = {side: sorted(os.listdir(tmp / f"evaluator_{side}" /
                                     "diagnostics"))
             for side in ("jax", "torch")}
    assert files["torch"] == files["jax"]
    assert "video_diagnostics.nc" in files["jax"]
    got, ref = (_read(tmp / f"evaluator_{side}" / "diagnostics"
                      / "video_diagnostics.nc") for side in ("torch", "jax"))
    assert set(got) == set(ref)
    for k, r in ref.items():
        if r.dtype.kind == "f":
            scale = max(1.0, float(np.nanmax(np.abs(r))))
            np.testing.assert_allclose(got[k], r, rtol=0, atol=1e-5 * scale,
                                       err_msg=k)
