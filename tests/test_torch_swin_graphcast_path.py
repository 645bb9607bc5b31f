"""The last models through both packages' entries, at small sizes:

- a small NoiseConditionedSwinTransformer (widths 8, windows 2x4, earth
  padding, the cos-lat bias) on a 16x32 store: one epoch of one update of
  each training entry from the same initial weights and the same noise,
  the losses within 1e-4 and each weight's change within 1e-3 (but the
  bias MLPs' output biases, whose gradient is zero but for rounding); both
  inference entries over ``ace_tpu``'s checkpoint, their predictions
  within 1e-5;
- FloeNet on the sea-ice recipe of ``tests/test_ice_train.py`` (fme's
  ``test_ice_train.py``: four ice variables with a land mask, input
  masking, the ``ice_corrector`` budget, MSE, AdamW; meshes 3): the same
  training comparison, and both evaluator entries over ``ace_tpu``'s
  checkpoint with ``fill_nans: 0.0`` (logs and predictions within 1e-5,
  NaN on the same cells);
- LandNet with its positional embedding on the same store, trained
  through both entries;
- ``load_stepper`` on ``ace_tpu``'s checkpoint of each of the three:
  every weight equal to the flax tree converted (Swin's ``tau`` and 3x3
  kernels, LandNet's 4-D ``pos_embed`` untouched)."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ace_tpu.data.store import write_h5
from ace_tpu.data.time import TimeCoord
from ace_tpu.inference.evaluator import main as jax_evaluator_main
from ace_tpu.inference.inference import main as jax_inference_main
from ace_tpu.models import swin as jax_swin
from ace_tpu.stepper import checkpoint as jax_checkpoint
from ace_tpu.stepper import train as jax_train
from ace_tpu.testing import save_stats_files
from ace_tpu.train.train import main as jax_train_main
from ace_tpu_torch.data.store import open_file_dataset
from ace_tpu_torch.inference.evaluator import main as evaluator_main
from ace_tpu_torch.inference.inference import main as inference_main
from ace_tpu_torch.models import swin
from ace_tpu_torch.stepper import checkpoint
from ace_tpu_torch.stepper import train as port_train
from ace_tpu_torch.stepper.checkpoint import read_train_checkpoint
from ace_tpu_torch.train.train import main as train_main
from ace_tpu_torch.utils.convert import flax_params_to_state_dict

torch.set_num_threads(2)

N_INFERENCE = 4
# the Swin store: 16x32, three times for training (one batch of 2, one
# update), N_INFERENCE + 2 in all
SWIN_NAMES = ["a", "b", "forc"]
SWIN_SHAPE = (16, 32)
# the ice store of tests/test_ice_train.py
ICE_NAMES = ["siconc", "LSRCc", "LSNKc", "XPRTc"]
ICE_SHAPE = (12, 24)


def _noise(shape):
    """A fixed noise field of ``shape`` for both packages' Swin (their
    random streams differ)."""
    return np.random.default_rng(list(shape)).standard_normal(shape).astype(
        np.float32)


def _swin_files(tmp):
    rng = np.random.RandomState(0)
    data_dir = tmp / "swin_data"
    data_dir.mkdir()
    n = N_INFERENCE + 2
    lat = np.linspace(-84.375, 84.375, SWIN_SHAPE[0])
    lon = np.linspace(0.0, 348.75, SWIN_SHAPE[1])
    arrays = {k: rng.randn(n, *SWIN_SHAPE).astype(np.float32)
              for k in SWIN_NAMES}
    write_h5(str(data_dir / "d.nc"), arrays,
             {k: ("time", "lat", "lon") for k in arrays},
             coords={"lat": lat, "lon": lon},
             time=TimeCoord.from_range("2000-01-01T00:00", n, 21600))
    save_stats_files(tmp / "swin-mean.nc", tmp / "swin-std.nc", SWIN_NAMES)
    return data_dir


def _ice_files(tmp):
    """``tests/test_ice_train.py:_save_ice_dataset`` and its stats."""
    rng = np.random.RandomState(0)
    data_dir = tmp / "ice_data"
    data_dir.mkdir()
    nlat, nlon = ICE_SHAPE
    n = N_INFERENCE + 2
    mask = np.ones(ICE_SHAPE, np.float32)
    mask[1, 1] = 0.0
    mask[:2, :] = 0.0

    def masked(field):
        return np.where(mask[None] > 0, field, np.nan).astype(np.float32)

    shape = (n, nlat, nlon)
    data = {
        "siconc": masked(rng.uniform(0.0, 1.0, shape)),
        "LSRCc": masked(1e-6 * rng.rand(*shape)),
        "LSNKc": masked(-1e-6 * rng.rand(*shape)),
        "XPRTc": masked(1e-7 * rng.randn(*shape)),
        "mask_2d": mask,
    }
    dims = {k: ("time", "lat", "lon") for k in data}
    dims["mask_2d"] = ("lat", "lon")
    write_h5(str(data_dir / "data.nc"), data, dims,
             coords={"lat": np.linspace(-80.0, 80.0, nlat),
                     "lon": np.linspace(0.0, 360.0 - 360.0 / nlon, nlon)},
             time=TimeCoord.from_range("2000-01-01T00:00", n, 86400))
    means = {"siconc": 0.5, "LSRCc": 0.0, "LSNKc": 0.0, "XPRTc": 0.0}
    stds = {"siconc": 0.3, "LSRCc": 1e-6, "LSNKc": 1e-6, "XPRTc": 1e-7}
    for name, stats in (("ice-mean.nc", means), ("ice-std.nc", stds)):
        write_h5(str(tmp / name),
                 {k: np.asarray(np.float32(v)) for k, v in stats.items()},
                 dims={k: () for k in stats})
    return data_dir


def _config(tmp, data_dir, out_dir, model):
    loader = {"dataset": {"data_path": str(data_dir),
                          "subset": {"stop": 2}},
              "batch_size": 2, "num_data_workers": 1}
    config = {
        "experiment_dir": str(out_dir), "max_epochs": 1,
        "save_checkpoint": True, "seed": 0,
        "logging": {"log_to_screen": False, "log_to_file": False},
        "train_loader": loader, "validation_loader": loader,
        "optimization": {"lr": 1e-3, "optimizer_type": "AdamW"},
        "stepper_training": {"n_forward_steps": 1, "loss": {"type": "MSE"}},
    }
    if model == "swin":
        step = {
            "builder": {"type": "NoiseConditionedSwinTransformer", "config": {
                "embed_dim": 8, "num_heads": [2, 2, 2, 2],
                "window_size": [2, 4], "noise_embed_dim": 4,
                "drop_path_rate": 0.0, "cpb_hidden_dim": 16,
                "padding_conf": {"activate": True, "mode": "earth",
                                 "pad_lat": [2, 2], "pad_lon": [4, 4]}}},
            "in_names": SWIN_NAMES, "out_names": ["a", "b"],
            "normalization": {"network": {
                "global_means_path": str(tmp / "swin-mean.nc"),
                "global_stds_path": str(tmp / "swin-std.nc")}},
        }
        config["stepper"] = {"step": {"type": "single_module",
                                      "config": step}}
        return config
    builder = {
        "floenet": {"type": "FloeNet", "config": {
            "latent_dimension": 4, "activation": "SiLU", "meshes": 3,
            "M0": 4, "bias": True, "radius_fraction": 1, "layernorm": True,
            "processor_steps": 1, "residual": True}},
        "landnet": {"type": "LandNet", "config": {
            "hidden_dims": [16, 16], "use_positional_embedding": True}},
    }[model]
    config["stepper"] = {
        "input_masking": {"mask_value": 0, "fill_value": 0.0},
        "step": {"type": "single_module", "config": {
            "builder": builder, "in_names": ICE_NAMES,
            "out_names": ICE_NAMES,
            "normalization": {"network": {
                "global_means_path": str(tmp / "ice-mean.nc"),
                "global_stds_path": str(tmp / "ice-std.nc")}},
            "corrector": {"type": "ice_corrector", "config": {
                "budget_correction": {"corrected_variables": {
                    "siconc": ["LSRCc", "LSNKc", "XPRTc"]}}}}}},
    }
    return config


@pytest.fixture(scope="module", autouse=True)
def _no_figures():
    """The entries' figures left out (both packages skip a figure they
    cannot draw, and no test here reads one): rendering them is most of
    what an evaluator run costs at this size."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        yield


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of each package's training ``main`` for each model; the
    port starts from ``ace_tpu``'s initial weights, the Swin noise fixed
    on both sides."""
    tmp = tmp_path_factory.mktemp("last_models")
    data = {"swin": _swin_files(tmp), "ice": _ice_files(tmp)}
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
        mp.setattr(jax_swin.SwinTransformerNet, "_make_noise",
                   lambda self, x: jnp.asarray(_noise(
                       (*x.shape[:3], self.noise_embed_dim))))
        mp.setattr(swin.SwinTransformerNet, "make_noise",
                   lambda self, x, generator=None: torch.from_numpy(_noise(
                       (*x.shape[:3], self.noise_embed_dim))))
        for model in ("swin", "floenet", "landnet"):
            data_dir = data["swin" if model == "swin" else "ice"]
            for name, run in (
                    ("ace_tpu", lambda p: jax_train_main([p])),
                    ("port", lambda p: train_main([p], device="cpu"))):
                path = tmp / f"{model}-{name}.yaml"
                with open(path, "w") as f:
                    yaml.safe_dump(_config(tmp, data_dir,
                                           tmp / f"{model}-{name}", model), f)
                run(str(path))
                with open(tmp / f"{model}-{name}" / "metrics.jsonl") as f:
                    metrics = [json.loads(line) for line in f]
                ckpt_dir = tmp / f"{model}-{name}" / "training_checkpoints"
                out[model, name] = dict(
                    metrics=metrics, ckpt_dir=ckpt_dir,
                    ckpt=read_train_checkpoint(str(ckpt_dir /
                                                   "ckpt.msgpack")))
            out[model, "init"] = init["params"]
        yield tmp, data, out


@pytest.mark.parametrize("model", ["swin", "floenet", "landnet"])
def test_one_update_of_each_training_entry_agrees(trained, model):
    """The same metrics, the losses within 1e-4, one update seen by each,
    and each tensor's change from the common initial weights within 1e-3
    relative L2."""
    _, _, out = trained
    ref, got = out[model, "ace_tpu"], out[model, "port"]
    assert len(ref["metrics"]) == len(got["metrics"]) == 1
    r, g = ref["metrics"][0], got["metrics"][0]
    assert set(g) == set(r)
    for k in ("train/loss", "val/loss"):
        assert np.isfinite(r[k])
        assert g[k] == pytest.approx(r[k], rel=1e-4), k
    assert got["ckpt"]["extra"]["num_batches_seen"] == ref["ckpt"]["extra"][
        "num_batches_seen"] == 1
    for k, v in out[model, "init"].items():
        d_ref = ref["ckpt"]["params"][k].double() - v.double()
        d_got = got["ckpt"]["params"][k].double() - v.double()
        if k.endswith("cpb_fc2.bias"):
            # the bias MLP's output bias shifts every logit of a softmax
            # row alike: its gradient is 0 but for rounding, which AdamW's
            # first step scales up to at most the learning rate, whatever
            # its sign
            for d in (d_ref, d_got):
                assert float(d.abs().max()) <= 1.001e-3, k
            continue
        assert float((d_got - d_ref).norm()) <= 1e-3 * float(
            d_ref.norm()), k


@pytest.mark.parametrize("model", ["swin", "floenet", "landnet"])
def test_load_stepper_reads_ace_tpus_checkpoint(trained, model):
    """``load_stepper`` on ``ace_tpu``'s ``best_ckpt.msgpack``: every
    weight equal to the checkpoint's flax tree converted; Swin's ``tau``
    ``[1, heads, 1, 1]`` and LandNet's ``pos_embed`` ``[1, H, W, dim]`` keep
    flax's layout, the 3x3 encoder's kernel is F.conv2d's."""
    _, _, out = trained
    path = str(out[model, "ace_tpu"]["ckpt_dir"] / "best_ckpt.msgpack")
    stepper = checkpoint.load_stepper(path, device="cpu")
    jax_stepper = jax_checkpoint.load_stepper(path)
    flax = jax.tree_util.tree_map(np.asarray, jax_stepper.params)
    ref = flax_params_to_state_dict(flax)
    got = stepper.module.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    params = flax["params"]
    if model == "swin":
        tau = params["layer1"]["blocks_0"]["attn"]["tau"]
        assert tau.shape == (1, 2, 1, 1)
        np.testing.assert_array_equal(
            stepper.module.layer1.blocks_0.attn.tau.detach().numpy(), tau)
        np.testing.assert_array_equal(
            stepper.module.encoder.kernel.detach().numpy(),
            np.transpose(params["encoder"]["kernel"], (3, 2, 0, 1)))
    elif model == "landnet":
        assert params["pos_embed"].shape == (1, *ICE_SHAPE, 16)
        np.testing.assert_array_equal(
            stepper.module.pos_embed.detach().numpy(), params["pos_embed"])


def _read(path) -> dict[str, np.ndarray]:
    ds = open_file_dataset(str(path))
    return {k: np.asarray(ds[k].read(())) for k in ds.keys()}


def _files_close(got, ref):
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert got[k].shape == r.shape, k
        if r.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(r),
                                          err_msg=k)
            scale = max(1.0, float(np.nanmax(np.abs(r))))
            np.testing.assert_allclose(got[k], r, rtol=0,
                                       atol=1e-5 * scale, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], r, err_msg=k)


def test_swin_inference_entries_agree(trained, monkeypatch):
    """Both inference entries over ``ace_tpu``'s Swin checkpoint from start
    indices [0, 1], 4 steps in windows of 2, the noise fixed: the
    predictions and restart within 1e-5 of their scale."""
    tmp, data, out = trained
    monkeypatch.setattr(jax_swin.SwinTransformerNet, "_make_noise",
                        lambda self, x: jnp.asarray(_noise(
                            (*x.shape[:3], self.noise_embed_dim))))
    monkeypatch.setattr(swin.SwinTransformerNet, "make_noise",
                        lambda self, x, generator=None: torch.from_numpy(
                            _noise((*x.shape[:3], self.noise_embed_dim))))
    ckpt = str(out["swin", "ace_tpu"]["ckpt_dir"] / "best_ckpt.msgpack")
    runs = tmp / "swin_inference"
    for side, run in (("jax", lambda p: jax_inference_main([p])),
                      ("torch", lambda p: inference_main([p],
                                                         device="cpu"))):
        path = tmp / f"swin_inference_{side}.yaml"
        with open(path, "w") as f:
            yaml.safe_dump({
                "experiment_dir": str(runs / side),
                "checkpoint_path": ckpt,
                "n_forward_steps": N_INFERENCE,
                "forward_steps_in_memory": 2,
                "logging": {"log_to_screen": False, "log_to_file": False},
                "forcing_loader": {
                    "dataset": {"data_path": str(data["swin"])},
                    "start_indices": {"list": [0, 1]}},
            }, f)
        run(str(path))
    for name in ("autoregressive_predictions.nc", "restart.nc"):
        _files_close(_read(runs / "torch" / name), _read(runs / "jax" / name))


def test_floenet_evaluator_entries_agree(trained):
    """Both evaluator entries over ``ace_tpu``'s FloeNet checkpoint with
    the ice test's settings (4 steps in windows of 2 from [0, 1],
    ``fill_nans: 0.0``): the same log keys, each within 1e-5 of its scale,
    finite time-mean RMSEs, and the predictions within 1e-5 with NaN on
    the same (masked) cells."""
    tmp, data, out = trained
    ckpt = str(out["floenet", "ace_tpu"]["ckpt_dir"] / "best_ckpt.msgpack")
    logs = {}
    for side, run in (("jax", lambda p: jax_evaluator_main([p])),
                      ("torch", lambda p: evaluator_main([p],
                                                         device="cpu"))):
        path = tmp / f"ice_evaluator_{side}.yaml"
        with open(path, "w") as f:
            yaml.safe_dump({
                "experiment_dir": str(tmp / f"ice_evaluator_{side}"),
                "checkpoint_path": ckpt,
                "n_forward_steps": N_INFERENCE,
                "forward_steps_in_memory": 2,
                "logging": {"log_to_screen": False, "log_to_file": False},
                "loader": {"dataset": {"data_path": str(data["ice"]),
                                       "fill_nans": 0.0},
                           "start_indices": {"list": [0, 1]}},
                "aggregator": {"log_step_means": [], "log_spectra": False},
            }, f)
        logs[side] = run(str(path))["logs"]
    assert set(logs["torch"]) == set(logs["jax"])
    for k, r in logs["jax"].items():
        np.testing.assert_allclose(logs["torch"][k], r, rtol=0,
                                   atol=1e-5 * max(1.0, abs(r)), err_msg=k)
    assert np.isfinite(logs["torch"]["time_mean/rmse/siconc"])
    got, ref = (_read(tmp / f"ice_evaluator_{side}"
                      / "autoregressive_predictions.nc")
                for side in ("torch", "jax"))
    _files_close(got, ref)
    for name in ICE_NAMES:
        assert np.isnan(got[name]).any() and not np.isnan(got[name]).all()
