"""The port's evaluator entry (``python -m ace_tpu_torch.evaluator``) against
``ace_tpu``'s on one ``ace_tpu`` checkpoint and one synthetic dataset,
with every aggregator flag on: the logs, every diagnostics file and the
predictions, within ``tests/test_torch_inference.py``'s ``_tol``
(``tests/test_torch_aggregators.py`` holds the histograms to equal counts
on equal inputs; here the two rollouts differ in their last float32 bits,
so a value may cross a bin's edge: the counts must agree within 1% of
their total); ``run_dataset_comparison`` of both packages; the CUDA rule
and the mesh refusal."""

import os

import numpy as np
import pytest
import torch
import yaml

from ace_tpu.inference import evaluator as jax_evaluator
from ace_tpu_torch.inference import evaluator
from tests.test_torch_inference import (
    N_FORWARD,
    NAMES,
    _assert_files_close,
    _patch_noise,
    _read,
    _tol,
    setup,  # noqa: F401 (the fixture)
)

torch.set_num_threads(2)

AGGREGATOR = {
    "log_histograms": True, "log_enso_index": True,
    "log_seasonal_means": True, "log_near_zero_fraction": True,
    "log_video": True, "log_extended_video": True, "log_trends": True,
    "log_step_means": [{"step": 3}],
}


def _config(path, out_dir, data, ckpt, **extra) -> str:
    config = {
        "experiment_dir": str(out_dir),
        "checkpoint_path": ckpt,
        "n_forward_steps": N_FORWARD,
        "forward_steps_in_memory": 2,
        "logging": {"log_to_screen": False, "log_to_file": False},
        "loader": {"dataset": {"data_path": str(data.data_dir)},
                   "start_indices": {"list": [0, 1]}},
        "aggregator": AGGREGATOR,
        "data_writer": {"save_prediction_files": True},
        **extra,
    }
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return str(path)


@pytest.fixture(scope="module")
def runs(setup):  # noqa: F811
    """Both packages' evaluator CLIs on one config, the noise fixed."""
    tmp, data, ckpt = setup
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _patch_noise(mp)
        out["jax"] = jax_evaluator.main([_config(
            tmp / "eval_jax.yaml", tmp / "eval_jax", data, ckpt)])
        out["torch"] = evaluator.main([_config(
            tmp / "eval_torch.yaml", tmp / "eval_torch", data, ckpt)],
            device="cpu")
    return tmp, out


def _diagnostics(tmp):
    return sorted(os.listdir(tmp / "eval_jax" / "diagnostics"))


def test_evaluator_logs_match_ace_tpu(runs):
    tmp, out = runs
    logs, ref = out["torch"]["logs"], out["jax"]["logs"]
    assert set(logs) == set(ref), set(logs) ^ set(ref)
    prefixes = {k.split("/")[0] for k in logs}
    assert {"histogram", "enso", "seasonal", "near_zero_fraction", "video",
            "trend", "mean_step_3", "time_mean"} <= prefixes
    for k, r in ref.items():
        assert abs(logs[k] - r) <= _tol(np.asarray(r)), (k, logs[k], r)
    assert out["torch"]["histogram_host_seconds"] > 0
    assert (sorted(os.listdir(tmp / "eval_torch" / "diagnostics"))
            == _diagnostics(tmp))
    for name in ("histogram", "enso", "seasonal", "trend", "video"):
        assert f"{name}_diagnostics.nc" in _diagnostics(tmp)


@pytest.mark.parametrize("name", [
    "autoregressive_predictions.nc", "histogram_diagnostics.nc",
    "enso_diagnostics.nc", "seasonal_diagnostics.nc",
    "trend_diagnostics.nc", "video_diagnostics.nc",
    "time_mean_diagnostics.nc", "mean_step_diagnostics.nc",
    "zonal_mean_diagnostics.nc", "spectrum_diagnostics.nc",
])
def test_evaluator_files_match_ace_tpu(runs, name):
    """The predictions and each diagnostics file; the histograms' counts
    within 1% of their total (a derived tendency moved 2 of 1536)."""
    tmp, _ = runs
    sub = "" if name.startswith("autoregressive") else "diagnostics"
    out_path = tmp / "eval_torch" / sub / name
    ref_path = tmp / "eval_jax" / sub / name
    if name == "histogram_diagnostics.nc":
        out, ref = _read(out_path), _read(ref_path)
        assert set(out) == set(ref)
        for k, r in ref.items():
            if "counts" in k:
                assert out[k].sum() == r.sum(), k
                assert np.abs(out[k] - r).sum() <= 1e-2 * r.sum(), k
            else:
                np.testing.assert_allclose(out[k], r, rtol=0, atol=_tol(r),
                                           err_msg=k)
    else:
        _assert_files_close(out_path, ref_path)


def test_evaluator_writes_the_videos_and_images(runs):
    tmp, _ = runs
    plots = os.listdir(tmp / "eval_torch" / "plots")
    ref = os.listdir(tmp / "eval_jax" / "plots")
    assert sorted(plots) == sorted(ref)


def test_dataset_comparison_matches_ace_tpu(setup, tmp_path):  # noqa: F811
    """The same dataset as prediction and as target, shifted by a start
    index: both packages' aggregators agree."""
    _, data, _ = setup
    config = {
        "n_forward_steps": 4, "forward_steps_in_memory": 2,
        "variable_names": NAMES,
        "logging": {"log_to_screen": False, "log_to_file": False},
        "prediction_loader": {"dataset": {"data_path": str(data.data_dir)},
                              "start_indices": {"list": [1]}},
        "target_loader": {"dataset": {"data_path": str(data.data_dir)},
                          "start_indices": {"list": [0]}},
        "aggregator": AGGREGATOR,
    }
    from ace_tpu.core.config import from_dict as jax_from_dict
    from ace_tpu_torch.core.config import from_dict

    ref = jax_evaluator.run_dataset_comparison(jax_from_dict(
        jax_evaluator.DatasetComparisonConfig,
        {**config, "experiment_dir": str(tmp_path / "jax")}))
    out = evaluator.run_dataset_comparison(from_dict(
        evaluator.DatasetComparisonConfig,
        {**config, "experiment_dir": str(tmp_path / "torch")}), device="cpu")
    assert out["n_windows"] == ref["n_windows"] == 2
    assert set(out["logs"]) == set(ref["logs"])
    for k, r in ref["logs"].items():
        assert abs(out["logs"][k] - r) <= _tol(np.asarray(r)), k
    names = sorted(os.listdir(tmp_path / "jax" / "diagnostics"))
    assert sorted(os.listdir(tmp_path / "torch" / "diagnostics")) == names
    for name in names:
        _assert_files_close(tmp_path / "torch" / "diagnostics" / name,
                            tmp_path / "jax" / "diagnostics" / name)


def test_evaluator_needs_cuda_unless_cpu_is_asked(setup, tmp_path,  # noqa
                                                  monkeypatch):
    _, data, ckpt = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _config(tmp_path / "c.yaml", tmp_path / "c", data, ckpt,
                   aggregator={})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluator.main([path])
    assert not (tmp_path / "c").exists()
    summary = evaluator.main([path, "--device", "cpu"])
    assert summary["total_steps"] == 2 * N_FORWARD


def test_evaluator_refuses_a_mesh(setup, tmp_path):  # noqa: F811
    _, data, ckpt = setup
    path = _config(tmp_path / "c.yaml", tmp_path / "c", data, ckpt,
                   mesh={"data": 2})
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        evaluator.main([path], device="cpu")
