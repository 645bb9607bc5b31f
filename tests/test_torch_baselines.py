"""The repo's baseline YAMLs in the port's schema, and ``chip_smoke.py``'s
paths E and F, phase E-agg and reference phase F at small sizes on the
CPU (the plain versions of the kernels), as the path I and R tests run
theirs."""

import os
import sys

import pytest
import torch

from ace_tpu_torch.core.cli import prepare_config
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.inference.evaluator import EvaluatorConfig
from ace_tpu_torch.train.trainer import TrainConfig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINES = os.path.join(ROOT, "configs", "baselines")
SMALL = dict(nlat=16, nlon=32, nz=2, embed=16, layers=2)


@pytest.mark.parametrize("name, schema", [
    ("era5/ace-train-config-1-step-pretrain.yaml", TrainConfig),
    ("era5/ace-train-config-multi-step-finetuning.yaml", TrainConfig),
    ("era5/ace-evaluator-config.yaml", EvaluatorConfig),
    ("shield-som/ace-2pctCO2-evaluator-config.yaml", EvaluatorConfig),
    ("amip-c96-shield/train-ace2.yaml", TrainConfig),
])
def test_baseline_configs_build_in_the_port(name, schema):
    """Each YAML, with Weights & Biases off as the port needs, builds in
    the port's schema, fine-tuning and aggregator options included."""
    data = prepare_config(os.path.join(BASELINES, name),
                          ["logging.log_to_wandb=false"])
    config = from_dict(schema, data)
    if schema is TrainConfig:
        pinit = config.stepper_training.parameter_init
        if "amip" in name:
            builder = config.stepper.step.config["builder"]
            assert builder["type"] == "SphericalFourierNeuralOperatorNet"
            entry = config.inference_entries[0]
            assert entry.aggregator.monthly_reference_data
        if "finetuning" in name:
            assert pinit.weights_path and (
                config.stepper_training.optimize_last_step_only)
            assert config.inference_entries[0].aggregator.log_histograms
    else:
        assert config.n_forward_steps > 0


@pytest.mark.parametrize("name", [
    "baselines/downscaling-hiro-global/train.yaml",
    "baselines/downscaling/train-conus-100km-to-25km-augusta.yaml",
    "baselines/downscaling/train-conus-25km-to-3km-augusta.yaml",
    "baselines/downscaling/eval-ca-25km-to-3km-augusta.yaml",
    "baselines/downscaling/eval-conus-25km-to-3km-augusta.yaml",
    "baselines/downscaling/eval-fl-25km-to-3km-augusta.yaml",
    "downscaling-train.yaml",
])
def test_downscaling_configs_build_in_the_port(name):
    """Each downscaling YAML, Weights & Biases off, builds in the port's
    schema (the training or the evaluator entry's), its model config and
    network options included."""
    from ace_tpu_torch.downscaling.evaluator import DownscalingEvaluatorConfig
    from ace_tpu_torch.downscaling.models import (
        DiffusionModelConfig,
        DiffusionModuleSelector,
        LogNormalNoiseDistribution,
    )
    from ace_tpu_torch.downscaling.train import DownscalingTrainConfig

    data = prepare_config(os.path.join(ROOT, "configs", name),
                          ["logging.log_to_wandb=false"])
    if "eval" in os.path.basename(name):
        config = from_dict(DownscalingEvaluatorConfig, data)
        assert config.events and config.data.lat_extent is not None
        return
    config = from_dict(DownscalingTrainConfig, data)
    model = config.model
    assert isinstance(model, DiffusionModelConfig)
    assert config.coarse_patch_extent_lat is not None
    if "hiro" in name:
        assert isinstance(model.module, DiffusionModuleSelector)
        song = model.module.instance
        assert (song.model_channels, song.channel_mult, song.num_blocks) == (
            128, [1, 2, 2, 2, 2, 2, 2], 1)
        assert model.training_noise_distribution == (
            LogNormalNoiseDistribution(-1.2, 1.8))
        assert model.predict_residual and model.use_fine_topography
        assert config.train_data.sample_with_replacement == 160


def _flagship_checkpoint(path):
    from ace_tpu_torch import flagship
    from ace_tpu_torch.stepper import checkpoint

    config, info = flagship.stepper_config(**SMALL)
    stepper = config.get_stepper(info, device="cpu")
    flagship.draw_check_weights(stepper, torch.Generator().manual_seed(0))
    checkpoint.save_stepper(path, stepper, config)


@pytest.fixture
def small_checkpoint(tmp_path):
    path = str(tmp_path / "flagship.msgpack")
    _flagship_checkpoint(path)
    return path


def _memory_route(monkeypatch, chip_smoke):
    present, _ = chip_smoke.inference_packages()
    present.pop("h5py")
    monkeypatch.setattr(chip_smoke, "inference_packages",
                        lambda: (present, ["h5py"]))


@pytest.mark.parametrize("route", ["files", "memory"])
def test_chip_smoke_path_e_runs_on_the_cpu(small_checkpoint, route,
                                           monkeypatch, capsys):
    """Path E at 16x32 through the evaluator's ``main`` on the shipped
    evaluator YAML: its gates hold, with the YAML's histograms and zonal
    means, by both file routes."""
    import chip_smoke
    from ace_tpu_torch.ops import dhconv_filter as k1

    if route == "memory":
        _memory_route(monkeypatch, chip_smoke)
    # no figures, as on the card
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    launches, summary, phases, _ = chip_smoke.evaluator_path(
        [k1.dhconv_filter], small_checkpoint, device="cpu", n_steps=6,
        in_memory=3)
    assert launches == {"dhconv_filter": 0}  # plain versions on the CPU
    assert summary["total_steps"] == 6
    assert summary["histogram_host_seconds"] > 0
    assert {"histogram/99.9999th-percentile/PRESsfc",
            "time_mean/rmse/PRESsfc"} <= set(summary["logs"])
    assert {"forward_prediction", "aggregator"} <= set(phases)
    assert "path E" in capsys.readouterr().out
    assert sys.modules["h5py"].__name__ == "h5py"


def test_chip_smoke_aggregator_phase_runs_on_the_cpu(small_checkpoint,
                                                     capsys):
    """Phase E-agg with the CPU on both sides: every output equal."""
    import chip_smoke

    err, worst, seconds = chip_smoke.aggregator_phase(
        small_checkpoint, device="cpu", window=3)
    assert err == 0.0 and min(seconds.values()) > 0
    assert "histogram arrays equal" in capsys.readouterr().out


def test_chip_smoke_paths_r_and_f_run_on_the_cpu(monkeypatch, capsys):
    """Path R at a small size, then path F from its best checkpoint
    through the training entry's ``main`` on the shipped fine-tuning
    YAML (held in host memory as where h5py is missing): its gates hold,
    the start weights are the base's and the longest train step runs."""
    import chip_smoke
    from ace_tpu_torch.ops import dhconv_filter as k1

    _memory_route(monkeypatch, chip_smoke)
    counters = [k1.dhconv_filter, k1.dhconv_filter_dx, k1.dhconv_filter_dw]
    sizes = dict(nlat=16, nlon=32, embed=16, layers=2)
    out = {}

    def then(paths, best):
        assert os.listdir(os.path.dirname(best)) == ["best_ckpt.msgpack"]
        out["f"] = chip_smoke.finetune_entry_path(counters, paths, best,
                                                  device="cpu", sizes=sizes)

    chip_smoke.train_entry_path(counters, device="cpu", sizes=sizes,
                                then=then)
    launches, peaks, seconds = out["f"]
    assert launches == {c.__name__: 0 for c in counters}
    assert seconds > 0
    text = capsys.readouterr().out
    assert "checksums equal" in text and "sampled rollout lengths" in text
    assert "one train_step of 20 steps" in text


def test_chip_smoke_reference_f_runs_on_the_cpu(capsys):
    """Reference phase F with the CPU on both sides agrees exactly, and
    its frozen and copied weights stay the base's."""
    import chip_smoke

    errs = chip_smoke.reference_finetune_phase(
        device="cpu", sizes=dict(nlat=16, nlon=32, embed=32, layers=2))
    assert (errs["train_loss"], errs["val_loss"], errs["change"]) == (
        0.0, 0.0, 0.0)
    assert errs["moved"] > 0
    assert errs["counts"][0] == 2 * errs["counts"][2] + 1
    assert "reference F" in capsys.readouterr().out
