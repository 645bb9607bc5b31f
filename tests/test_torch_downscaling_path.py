"""Both packages' downscaling entries (training, downscaler, evaluator) on
one tiny copy of the HiRO-ACE recipe (``chip_smoke._downscaling_config``:
8x16 coarse cells inside the recipe's lat_extent, x2, 4x4 patches, a small
SongUNet, 3 Heun steps), on the CPU. The draw-free parts are held equal:
the batches and their patch origins, the normalized conditioning and
target, the checkpoints' contents both ways, the metric keys, the output
files and their shapes (events, time ranges in zarr). The port's
``load_downscaling_model`` and ``DenoisingMoEPredictor.load`` read
``ace_tpu``'s files and, from ``ace_tpu``'s draws (reproduced with
``jax.random`` from the entry's keys), generate its fields within 3e-4 of
their std (the recipe's sigma_max of 150 carries float32 rounding of
1.0-1.6e-4 of the std through the sampler; ``test_torch_diffusion.py``
holds ``generate`` to 1e-4 of the std at sigma_max 80). ``ace_tpu``'s
trainer starts from the port's initial weights (its ``init`` is not
compiled)."""

import json
import os
import unittest.mock
import zlib

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from ace_tpu.data.store import open_file_dataset as jax_open
from ace_tpu.downscaling import evaluator as jax_evaluator
from ace_tpu.downscaling import models as jax_models
from ace_tpu.downscaling import predict as jax_predict
from ace_tpu.downscaling import train as jax_train
from ace_tpu_torch.data.store import open_file_dataset
from ace_tpu_torch.downscaling import evaluator, models, predict, train
from ace_tpu_torch.utils.convert import state_dict_to_flax_params

torch.set_num_threads(2)

# of the generated field's std, at the recipe's sigma_max of 150: the
# largest errors read 1.54e-4 (event) and 1.02e-4 (MoE) of it on the CPU
GENERATE_TOL = 3e-4
SIZES = {"nlat": 8, "nlon": 16, "factor": 2, "patch": 4, "batch": 2,
         "batches": 2, "train_times": 4, "valid_times": 2, "samples": 2,
         "steps": 3}
MODULE = {"type": "unet_diffusion_song", "config": {
    "model_channels": 8, "channel_mult": [1], "num_blocks": 1,
    "attn_resolutions": [], "channel_mult_emb": 2, "dropout": 0.0}}
EVENT_DATE = "2023-01-01T06:00"


def _assert_generated(ours, ref):
    """``ours`` within ``GENERATE_TOL`` of ``ref``'s std."""
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=GENERATE_TOL * float(ref.std()))


def _yaml(tmp, name, config):
    return chip_smoke._write_yaml(os.path.join(tmp, f"{name}.yaml"), config)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The files, then both training entries on one YAML (each in its own
    experiment directory), ``ace_tpu``'s from the port's initial
    weights."""
    tmp = str(tmp_path_factory.mktemp("downscaling"))
    paths = chip_smoke.downscaling_files(
        tmp, torch.Generator().manual_seed(23), "cpu", SIZES)
    out = {"paths": paths, "tmp": tmp}
    for side in ("port", "jax"):
        config = chip_smoke._downscaling_config(
            paths, os.path.join(tmp, side), SIZES, MODULE)
        # the recipe's p_mean/p_std in their other spelling: ace_tpu
        # cannot read back a checkpoint of the first
        model = config["model"]
        model["training_noise_distribution"] = {
            "p_mean": model.pop("p_mean"), "p_std": model.pop("p_std")}
        out[f"{side}_yaml"] = _yaml(tmp, side, config)
    out["port"] = train.main([out["port_yaml"]], device="cpu")
    port_init = _port_initial_weights(out["port_yaml"])

    def init_params(self, rng, img_shape=None):
        self.params = port_init
        return self.params

    with unittest.mock.patch.object(jax_models.DiffusionModel, "init_params",
                                    init_params):
        out["jax"] = jax_train.main([out["jax_yaml"]])
    return out


def _port_initial_weights(yaml_path):
    """The flax tree of the port's trainer's initial weights (its seed)."""
    from ace_tpu_torch.core.cli import prepare_config

    config = train.from_dict(train.DownscalingTrainConfig,
                             prepare_config(yaml_path, None))
    config.experiment_dir = os.path.join(os.path.dirname(yaml_path), "init")
    trainer = train.DownscalingTrainer(config, device="cpu")
    return {"params": state_dict_to_flax_params(
        trainer.model.net.state_dict())}


def _ckpt(run, side, name="ckpt.msgpack"):
    return os.path.join(run["tmp"], side, "checkpoints", name)


def test_batches_and_normalization_match_ace_tpu(run):
    """The epoch's batches from the same seed (times drawn with
    replacement, patch origins, the static field's window), and each
    batch's normalized conditioning (bilinear upsampling, the static
    channel) and target."""
    port, jax_trainer = run["port"], run["jax"]
    ours = [port._batch(idx, origin) for idx, origin in
            port.batch_indices(np.random.RandomState(0), shuffle=True)]
    ref = list(jax_trainer._batches(np.random.RandomState(0), shuffle=True))
    assert len(ours) == len(ref) == SIZES["batches"]
    for (c, f, s), (rc, rf, rs) in zip(ours, ref):
        for a, b in ((c, rc), (f, rf)):
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        cond, target = port.model._pack(c, f, static=s)
        rcond, rtarget = jax_trainer.model._pack(rc, rf, static=rs)
        np.testing.assert_allclose(cond.numpy(), np.asarray(rcond), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(target.numpy(), np.asarray(rtarget),
                                   rtol=0, atol=1e-6)
        base = port.model._residual_base(c)
        np.testing.assert_allclose(
            base.numpy(), np.asarray(jax_trainer.model._residual_base(rc)),
            rtol=0, atol=1e-6)


def test_checkpoints_and_metrics_match_ace_tpu_in_contents(run):
    """The same files, keys, config, dataset info, static fields and
    parameter tree (the port's ``ckpt.msgpack`` also holds its training
    state), and the same metric keys, one line an epoch."""
    from ace_tpu.stepper.checkpoint import load_msgpack

    for name in ("ckpt.msgpack", "ema_ckpt.msgpack"):
        ours, ref = (load_msgpack(_ckpt(run, side, name))
                     for side in ("port", "jax"))
        assert set(ours) - set(ref) == (
            {"training_state"} if name == "ckpt.msgpack" else set())
        assert json.loads(ours["config"]) == json.loads(ref["config"])
        assert ours["model_type"] == ref["model_type"]
        assert json.loads(ours["dataset_info"]) == json.loads(
            ref["dataset_info"])
        np.testing.assert_array_equal(ours["static_inputs"],
                                      ref["static_inputs"])
        assert (jax.tree_util.tree_map(np.shape, ours["params"])
                == jax.tree_util.tree_map(np.shape, ref["params"]))
    lines = {}
    for side in ("port", "jax"):
        with open(os.path.join(run["tmp"], side, "metrics.jsonl")) as fh:
            lines[side] = [json.loads(line) for line in fh]
    assert [sorted(x) for x in lines["port"]] == [
        sorted(x) for x in lines["jax"]]
    assert all(np.isfinite(v) for x in lines["port"] for v in x.values())


def test_each_package_reads_the_others_checkpoint(run):
    """``ace_tpu`` loads the port's weights (its template from ``init``)
    and the port loads ``ace_tpu``'s, both exactly."""
    from ace_tpu_torch.stepper.checkpoint import load_msgpack

    ours = jax_train.load_downscaling_model(_ckpt(run, "port"))
    want = load_msgpack(_ckpt(run, "port"))["params"]
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.device_get(ours.params), want)
    model = train.load_downscaling_model(_ckpt(run, "jax"), device="cpu")
    ref = load_msgpack(_ckpt(run, "jax"))
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           state_dict_to_flax_params(model.net.state_dict()),
                           ref["params"]["params"])
    np.testing.assert_array_equal(model.static_inputs.numpy(),
                                  ref["static_inputs"])


def _sample_draws(rng, n_samples, shape, steps):
    """``generate``'s latents and the sampler's noise from ``rng``."""
    latents, eps = [], []
    for _ in range(n_samples):
        rng, k_lat, k_samp = jax.random.split(rng, 3)
        latents.append(torch.as_tensor(np.array(jax.random.normal(k_lat,
                                                                  shape))))
        steps_eps, k = [], k_samp
        for _ in range(steps):
            k, k_eps = jax.random.split(k)
            steps_eps.append(torch.as_tensor(np.array(
                jax.random.normal(k_eps, shape))))
        eps.append(steps_eps)
    return {"latents": latents, "eps": eps}


def _patched_draws(key, n_patches, n_samples, shape, steps):
    """``PatchPredictor.generate``'s draws: one key a patch."""
    draws, rng = [], key
    for _ in range(n_patches):
        rng, sub = jax.random.split(rng)
        draws.append(_sample_draws(sub, n_samples, shape, steps))
    return draws


def _downscaler_config(run, side, ckpt):
    paths = run["paths"]
    lat_ext, lon_ext, _ = chip_smoke._event_region(
        paths, chip_smoke.D_SIZES | SIZES, 2)
    return {
        "experiment_dir": os.path.join(run["tmp"], f"predict_{side}"),
        "checkpoint_path": ckpt,
        "coarse_data": {"data_path": paths["coarse_valid"],
                        "file_pattern": "data.nc"},
        # the static field covers the recipe's region: no full-grid times
        "n_samples": 2, "n_timesteps": 0,
        "coarse_patch_extent_lat": SIZES["patch"],
        "coarse_patch_extent_lon": SIZES["patch"],
        "events": [{"name": "storm", "date": EVENT_DATE,
                    "lat_extent": lat_ext, "lon_extent": lon_ext,
                    "n_samples": 2, "save_generated_samples": True}],
        "time_ranges": [{"name": "segment",
                         "time_range": {"start": 0, "stop": 2},
                         "n_samples": 2, "lat_extent": lat_ext}],
        "logging": {"log_to_screen": False, "log_to_file": False},
    }


def test_downscaler_entries_write_the_same_files(run):
    """Both downscaler entries over ``ace_tpu``'s checkpoint: the same
    files, variables and shapes (predictions, the event's mean, std and
    samples, the time range's zarr); the port's event samples from
    ``ace_tpu``'s draws are ``ace_tpu``'s."""
    ckpt = _ckpt(run, "jax")
    written = {}
    for side, main in (("port", predict.main), ("jax", jax_predict.main)):
        config = _downscaler_config(run, side, ckpt)
        path = _yaml(run["tmp"], f"predict_{side}", config)
        kwargs = {"device": "cpu"} if side == "port" else {}
        main([path], **kwargs)
        out = config["experiment_dir"]
        opener = open_file_dataset if side == "port" else jax_open
        written[side] = {
            name: {k: np.asarray(opener(os.path.join(out, name))[k].read(()))
                   for k in ("PRATEsfc", "PRATEsfc_mean", "PRATEsfc_std")
                   if k in opener(os.path.join(out, name)).variables}
            for name in ("storm_event.nc", "segment.zarr")}
    for name, ref in written["jax"].items():
        ours = written["port"][name]
        assert sorted(ours) == sorted(ref), name
        for k in ref:
            assert ours[k].shape == ref[k].shape, (name, k)
            assert np.isfinite(ours[k]).all(), (name, k)

    # the event's samples from ace_tpu's draws
    model = train.load_downscaling_model(ckpt, device="cpu")
    paths = run["paths"]
    lat_ext, lon_ext, n = chip_smoke._event_region(
        paths, chip_smoke.D_SIZES | SIZES, 2)
    ds = predict.XarrayDataConfig(data_path=paths["coarse_valid"],
                                  file_pattern="data.nc").build()
    window, _ = ds.get_window(1, 1, model.config.in_names)
    hc = ds.dataset_info.horizontal_coordinates
    y0, y1, xs, contiguous = predict._region_indices(hc.lat, hc.lon,
                                                     lat_ext, lon_ext)
    coarse = predict._crop_window(window, y0, y1, xs, contiguous, "cpu")
    static = predict._crop_static(model, y0, y1, xs, contiguous)
    key = jax.random.PRNGKey(zlib.crc32(b"storm") % 2 ** 16)
    _, sub = jax.random.split(key)
    f, steps = SIZES["factor"], SIZES["steps"]
    shape = (1, SIZES["patch"] * f, SIZES["patch"] * f, 1)
    draws = _patched_draws(sub, 4, 2, shape, steps)
    ours = models.PatchPredictor(model, (SIZES["patch"],) * 2).generate(
        coarse, n_samples=2, static=static, draws=draws)["PRATEsfc"][0]
    ref = written["jax"]["storm_event.nc"]["PRATEsfc"]
    assert ours.shape == ref.shape == (2, n * f, n * f)
    _assert_generated(ours.numpy(), ref)


def test_evaluator_entries_log_the_same_metrics(run):
    """Both evaluator entries (the paired-data block cropped to one
    patch, one time, an event): the same finite log keys and the
    diagnostics file."""
    paths = run["paths"]
    lat_ext, lon_ext, _ = chip_smoke._event_region(
        paths, chip_smoke.D_SIZES | SIZES, 1)
    logs = {}
    for side, main in (("port", evaluator.main),
                       ("jax", jax_evaluator.main)):
        config = {
            "experiment_dir": os.path.join(run["tmp"], f"eval_{side}"),
            "checkpoint_path": _ckpt(run, "jax"),
            "data": {"coarse": [{"data_path": paths["coarse_valid"],
                                 "file_pattern": "data.nc"}],
                     "fine": [{"data_path": paths["fine_valid"],
                               "file_pattern": "data.nc"}],
                     "lat_extent": {"start": lat_ext[0], "stop": lat_ext[1]},
                     "lon_extent": {"start": lon_ext[0],
                                    "stop": lon_ext[1]}},
            "events": [{"name": "storm", "date": EVENT_DATE,
                        "n_samples": 2}],
            "n_samples": 2, "n_timesteps": 1,
            "coarse_patch_extent_lat": SIZES["patch"],
            "coarse_patch_extent_lon": SIZES["patch"],
            "logging": {"log_to_screen": False, "log_to_file": False}}
        kwargs = {"device": "cpu"} if side == "port" else {}
        logs[side] = main([_yaml(run["tmp"], f"eval_{side}", config)],
                          **kwargs)
        assert os.path.exists(os.path.join(config["experiment_dir"],
                                           "generation_diagnostics.nc"))
    assert sorted(logs["port"]) == sorted(logs["jax"])
    assert all(np.isfinite(v) for v in logs["port"].values())


def test_port_reads_ace_tpus_moe_bundle(run):
    """``ace_tpu``'s bundle of two experts (the recipe's model without the
    static field, which ``ace_tpu``'s bundles do not keep; weights drawn by
    the port) over two sigma ranges: the port's
    ``DenoisingMoEPredictor.load`` generates ``ace_tpu``'s fields from its
    draws, each expert routed."""
    from ace_tpu.core.config import from_dict as jax_from_dict
    from ace_tpu_torch.core.cli import prepare_config
    from ace_tpu_torch.models.layers import init_weights

    model_dict = prepare_config(run["port_yaml"], None)["model"]
    model_dict["use_fine_topography"] = False
    info = train.load_downscaling_model(_ckpt(run, "port"),
                                       device="cpu").dataset_info
    jax_info = jax_train.load_downscaling_model(
        _ckpt(run, "port")).dataset_info
    experts = []
    for seed in (1, 2):
        port = train.from_dict(models.DiffusionModelConfig,
                               dict(model_dict)).build(info, device="cpu")
        init_weights(port.net, torch.Generator().manual_seed(seed))
        expert = jax_from_dict(jax_models.DiffusionModelConfig,
                               dict(model_dict)).build(jax_info)
        expert.params = {"params": state_dict_to_flax_params(
            port.net.state_dict())}
        experts.append(expert)
    moe = jax_models.DenoisingMoEPredictor(
        experts, [(0.002, 1.0), (1.0, 150.0)],
        num_diffusion_generation_steps=SIZES["steps"], churn=0.5)
    bundle = os.path.join(run["tmp"], "moe.msgpack")
    moe.save(bundle)
    ours = models.DenoisingMoEPredictor.load(bundle, device="cpu")
    assert [tuple(r) for r in ours._sigma_ranges] == moe._sigma_ranges
    coarse = {k: np.random.default_rng(i).standard_normal(
        (1, SIZES["patch"], SIZES["patch"])).astype(np.float32) * 1e-5
        for i, k in enumerate(ours.config.in_names)}
    key = jax.random.PRNGKey(8)
    ref = np.asarray(moe.generate(coarse, key, n_samples=2)["PRATEsfc"])
    shape = (1, SIZES["patch"] * SIZES["factor"],
             SIZES["patch"] * SIZES["factor"], 1)
    got = ours.generate({k: torch.as_tensor(v) for k, v in coarse.items()},
                        n_samples=2,
                        **_sample_draws(key, 2, shape, SIZES["steps"]))
    _assert_generated(got["PRATEsfc"].numpy(), ref)
