"""The port's inference entry (``ace_tpu_torch.inference``) against
``ace_tpu``'s on one checkpoint and one synthetic dataset: the predictions,
the restart file, the diagnostics and the logs; then, on the port alone,
windowing invariance, segmented runs, ensembles, and checkpoints written
by either package and read by the other."""

import json
import os
import sys
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ace_tpu.core.config import from_dict as jax_from_dict
from ace_tpu.core.config import to_dict as jax_to_dict
from ace_tpu.core.step import StepSelector as JaxStepSelector
from ace_tpu.core.step.single_module import (
    SingleModuleStepConfig as JaxSingleModuleStepConfig,
)
from ace_tpu.data.dataset import XarrayDataConfig as JaxXarrayDataConfig
from ace_tpu.data.store import open_file_dataset
from ace_tpu.models.conditional_sfno import (
    NoiseConditionedSFNO as JaxNoiseConditionedSFNO,
)
from ace_tpu.stepper import checkpoint as jax_checkpoint
from ace_tpu.stepper.stepper import PrognosticState as JaxPrognosticState
from ace_tpu.stepper.stepper import StepperConfig as JaxStepperConfig
from ace_tpu.testing import SyntheticData
from ace_tpu_torch.inference.inference import main
from ace_tpu_torch.models.conditional_sfno import NoiseConditionedSFNO
from ace_tpu_torch.stepper import checkpoint
from ace_tpu_torch.stepper.stepper import PrognosticState

torch.set_num_threads(2)

NLAT, NLON, N_TIME, N_FORWARD, NOISE = 8, 16, 12, 6, 8
PROGNOSTIC = ["air_temperature_0", "air_temperature_1",
              "specific_total_water_0", "specific_total_water_1", "PRESsfc",
              "surface_temperature"]
DIAGNOSTIC = ["PRATEsfc", "LHTFLsfc"]
FORCING = ["DSWRFtoa", "ocean_fraction"]
NAMES = PROGNOSTIC + DIAGNOSTIC + FORCING


@pytest.fixture(scope="module", autouse=True)
def _no_figures():
    """The entries' figures left out, as on the card, which has no
    matplotlib (both packages skip a figure they cannot draw, and no test
    here reads one)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        yield


def _noise(batch: int) -> np.ndarray:
    """The conditioning noise both packages see, for a batch size."""
    return np.random.RandomState(batch).randn(
        batch, NLAT, NLON, NOISE).astype(np.float32)


def _patch_noise(mp):
    """Both models condition on the same noise (the packages' random
    streams differ), as tests/test_torch_stepper.py fixes it."""
    mp.setattr(JaxNoiseConditionedSFNO, "_make_noise",
               lambda self, batch: jnp.asarray(_noise(batch)))
    mp.setattr(NoiseConditionedSFNO, "make_noise",
               lambda self, batch, generator: torch.from_numpy(_noise(batch)))


@pytest.fixture
def fixed_noise(monkeypatch):
    _patch_noise(monkeypatch)


def _step_dict():
    return dict(
        builder={"type": "NoiseConditionedSFNO", "config": {
            "embed_dim": 16, "noise_embed_dim": NOISE,
            "noise_type": "isotropic", "num_layers": 2,
            "affine_norms": True, "normalize_big_skip": True,
            "data_grid": "equiangular",
        }},
        in_names=PROGNOSTIC + FORCING,
        out_names=PROGNOSTIC + DIAGNOSTIC,
        normalization={"network": {"means": {n: 0.0 for n in NAMES},
                                   "stds": {n: 1.0 for n in NAMES}}},
        ocean={"surface_temperature_name": "surface_temperature",
               "ocean_fraction_name": "ocean_fraction"},
        corrector={"conserve_dry_air": True},
    )


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Synthetic data (8x16, 12 times) and an ace_tpu checkpoint of a
    NoiseConditionedSFNO on its grid, with nonzero noise conditioning."""
    tmp = tmp_path_factory.mktemp("torch_inference")
    data = SyntheticData(tmp / "data", NAMES, n_time=N_TIME, nlat=NLAT,
                         nlon=NLON)
    info = JaxXarrayDataConfig(data_path=str(data.data_dir)).build(
    ).dataset_info
    step = jax_from_dict(JaxSingleModuleStepConfig, _step_dict())
    config = JaxStepperConfig(step=JaxStepSelector(
        type="single_module", config=jax_to_dict(step)))
    stepper = config.get_stepper(info)
    params = stepper.init_params(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)

    def perturb(path, leaf):
        name = "/".join(str(p.key) for p in path)
        if "w_scale_2d" in name or "w_bias_2d" in name:
            return jnp.asarray(rng.randn(*leaf.shape) * 0.1, leaf.dtype)
        return leaf

    stepper.params = jax.tree_util.tree_map_with_path(perturb, params)
    ckpt = str(tmp / "stepper.msgpack")
    jax_checkpoint.save_stepper(ckpt, stepper, config)
    return tmp, data, ckpt


def _write_config(path, out_dir, data, ckpt, fsm=2, **extra) -> str:
    config = {
        "experiment_dir": str(out_dir),
        "checkpoint_path": ckpt,
        "n_forward_steps": N_FORWARD,
        "forward_steps_in_memory": fsm,
        "logging": {"log_to_screen": False, "log_to_file": False},
        "forcing_loader": {
            "dataset": {"data_path": str(data.data_dir)},
            "start_indices": {"list": [0, 1]},
        },
        **extra,
    }
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return str(path)


def _read(path) -> dict[str, np.ndarray]:
    ds = open_file_dataset(str(path))
    return {k: np.asarray(ds[k].read(())) for k in ds.keys()}


def _tol(ref) -> float:
    """tests/test_torch_stepper.py's tolerance (``_assert_outputs_close``)
    at unit statistics: float32 on both sides in another summation order,
    1e-4 of the reference's scale (at least 1) plus 1e-5 of its largest
    value."""
    big = float(np.max(np.abs(ref))) if np.size(ref) else 0.0
    return 1e-4 * max(1.0, big) + 1e-5 * big


def _assert_files_close(out_path, ref_path):
    out, ref = _read(out_path), _read(ref_path)
    assert set(out) == set(ref), set(out) ^ set(ref)
    for k, r in ref.items():
        o = out[k]
        assert o.shape == r.shape, k
        if r.dtype.kind in "fc":
            finite = np.isfinite(r)
            np.testing.assert_array_equal(np.isfinite(o), finite, err_msg=k)
            np.testing.assert_allclose(o[finite], r[finite], rtol=0,
                                       atol=_tol(r[finite]), err_msg=k)
        else:
            np.testing.assert_array_equal(o, r, err_msg=k)


@pytest.fixture(scope="module")
def runs(setup):
    """ace_tpu's and the port's runs of one config, noise fixed."""
    tmp, data, ckpt = setup
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _patch_noise(mp)
        from ace_tpu.inference.inference import main as jax_main

        out["jax"] = jax_main([_write_config(
            tmp / "jax.yaml", tmp / "jax", data, ckpt)])
        out["torch"] = main([_write_config(
            tmp / "torch.yaml", tmp / "torch", data, ckpt)], device="cpu")
    return tmp, out


@pytest.mark.parametrize("name", [
    "autoregressive_predictions.nc", "restart.nc",
    "diagnostics/time_mean_diagnostics.nc", "diagnostics/mean_diagnostics.nc",
    "diagnostics/zonal_mean_diagnostics.nc",
    "diagnostics/spectrum_diagnostics.nc",
    "diagnostics/annual_diagnostics.nc",
    "diagnostics/mean_step_diagnostics.nc",
    "diagnostics/mean_norm_diagnostics.nc",
])
def test_entry_files_match_ace_tpu(runs, name):
    tmp, _ = runs
    _assert_files_close(tmp / "torch" / name, tmp / "jax" / name)


def test_entry_diagnostics_and_logs_match_ace_tpu(runs):
    tmp, out = runs
    assert (sorted(os.listdir(tmp / "torch" / "diagnostics"))
            == sorted(os.listdir(tmp / "jax" / "diagnostics")))
    logs, ref = out["torch"]["logs"], out["jax"]["logs"]
    assert set(logs) == set(ref), set(logs) ^ set(ref)
    for k, r in ref.items():
        assert abs(logs[k] - r) <= _tol(np.asarray(r)), (k, logs[k], r)
    assert out["torch"]["total_steps"] == out["jax"]["total_steps"] == 12
    # derived variables are written beside the model's outputs
    predictions = _read(tmp / "torch" / "autoregressive_predictions.nc")
    assert "total_water_path" in predictions
    assert predictions["PRESsfc"].shape == (2, N_FORWARD, NLAT, NLON)


def _predictions(tmp, tag, data, ckpt, argv=(), **extra):
    out_dir = tmp / tag
    main([_write_config(tmp / f"{tag}.yaml", out_dir, data, ckpt, **extra),
          *argv], device="cpu")
    return out_dir


def test_windowing_invariance(setup, tmp_path, fixed_noise):
    """The port's form of tests/test_inference_integration.py:79: the
    model's outputs do not depend on forward_steps_in_memory (derived
    tendencies do: they are 0 at the first step of each window)."""
    _, data, ckpt = setup
    two = _read(_predictions(tmp_path, "fsm2", data, ckpt, fsm=2)
                / "autoregressive_predictions.nc")
    six = _read(_predictions(tmp_path, "fsm6", data, ckpt, fsm=6)
                / "autoregressive_predictions.nc")
    for k in PROGNOSTIC + DIAGNOSTIC + ["total_water_path", "time"]:
        np.testing.assert_allclose(two[k], six[k], rtol=0,
                                   atol=_tol(six[k]), err_msg=k)


def test_serial_loop_matches_the_pipeline(setup):
    """``run_inference(pipeline=False)``, which finishes each window before
    it reads the next, writes and aggregates exactly what the pipelined
    loop does (one window behind) from the same seed."""
    from ace_tpu_torch.aggregator.inference import InferenceAggregatorConfig
    from ace_tpu_torch.data.dataset import XarrayDataConfig
    from ace_tpu_torch.data.inference import (
        ExplicitIndices,
        InferenceDataLoaderConfig,
    )
    from ace_tpu_torch.inference.loop import run_inference

    class Writer:
        def __init__(self):
            self.windows = []

        def append_batch(self, data, time):
            self.windows.append((data, time.values))

        def flush(self):
            pass

    _, data, ckpt = setup
    stepper = checkpoint.load_stepper(ckpt, device="cpu")
    loader = InferenceDataLoaderConfig(
        dataset=XarrayDataConfig(data_path=str(data.data_dir)),
        start_indices=ExplicitIndices(list=[0, 1]))
    ic = PrognosticState(data={
        k: torch.from_numpy(np.asarray(v)) for k, v in loader.build(
            stepper.forcing_window_names, stepper.prognostic_names,
            N_FORWARD, 2).initial_condition().data.items()})
    out = {}
    for pipeline in (True, False):
        forcing = loader.build(stepper.forcing_window_names,
                               stepper.prognostic_names, N_FORWARD, 2)
        writer = Writer()
        aggregator = InferenceAggregatorConfig().build(
            forcing.dataset_info, n_timesteps=N_FORWARD,
            normalizer=stepper.step.normalizer)
        summary = run_inference(stepper, ic, forcing, writer=writer,
                                aggregator=aggregator, pipeline=pipeline)
        out[pipeline] = (writer.windows, aggregator.get_logs(),
                         summary["final_state"].data)
    (windows, logs, final), (s_windows, s_logs, s_final) = out[True], out[False]
    assert len(windows) == len(s_windows) == N_FORWARD // 2
    for (w, t), (sw, st) in zip(windows, s_windows):
        np.testing.assert_array_equal(t, st)
        for k in w:
            np.testing.assert_array_equal(w[k], sw[k], err_msg=k)
    assert logs.keys() == s_logs.keys()
    for k in logs:
        np.testing.assert_array_equal(logs[k], s_logs[k], err_msg=k)
    for k in final:
        torch.testing.assert_close(final[k], s_final[k], rtol=0, atol=0)


def test_segments_match_one_run(setup, tmp_path, fixed_noise):
    """Two chained segments of 5 steps (``--segments 2``, the second
    starting from the first's restart.nc) end where one run of 10 steps
    ends, and the second segment predicts the one run's last 5 steps."""
    _, data, ckpt = setup
    one = _predictions(tmp_path, "one", data, ckpt, fsm=5, n_forward_steps=10)
    seg = _predictions(tmp_path, "seg", data, ckpt, argv=["--segments", "2"],
                       fsm=5, n_forward_steps=5)
    last = seg / "segment_0001"
    whole = _read(one / "autoregressive_predictions.nc")
    second = _read(last / "autoregressive_predictions.nc")
    for k, r in whole.items():
        r = r[:, 5:] if r.ndim >= 2 and r.shape[1] == 10 else r
        np.testing.assert_allclose(second[k], r, rtol=0, atol=_tol(r),
                                   err_msg=k)
    restart, ref = _read(last / "restart.nc"), _read(one / "restart.nc")
    for k, r in ref.items():
        np.testing.assert_allclose(restart[k], r, rtol=0, atol=_tol(r),
                                   err_msg=k)


def test_ensemble_tiles_members(setup, tmp_path):
    """n_ensemble_per_ic=2 runs 4 samples, member-major, from the port's
    own noise generator: the two members of an initial condition start
    alike and then differ, and the ensemble metrics are logged."""
    tmp, data, ckpt = setup
    out_dir = tmp_path / "ens"
    summary = main([_write_config(tmp_path / "ens.yaml", out_dir, data, ckpt,
                                  n_ensemble_per_ic=2)], device="cpu")
    pred = _read(out_dir / "autoregressive_predictions.nc")["PRESsfc"]
    assert pred.shape == (4, N_FORWARD, NLAT, NLON)
    assert not np.allclose(pred[0], pred[1])
    restart = _read(out_dir / "restart.nc")
    assert restart["PRESsfc"].shape[0] == 4
    np.testing.assert_array_equal(restart["time"][0], restart["time"][1])
    assert restart["time"][1, 0] != restart["time"][2, 0]
    assert summary["logs"]["ensemble/spread/PRESsfc"] > 0
    assert np.isfinite(summary["logs"]["ensemble/spread/PRESsfc"])


def _one_step(stepper, ic, forcing, jax_side):
    if jax_side:
        out, _ = stepper.predict(
            JaxPrognosticState(data={k: jnp.asarray(v) for k, v in ic.items()}),
            {k: jnp.asarray(v) for k, v in forcing.items()})
        return {k: np.asarray(v) for k, v in out.items()}
    out, _ = stepper.predict(
        PrognosticState(data={k: torch.from_numpy(v) for k, v in ic.items()}),
        {k: torch.from_numpy(v) for k, v in forcing.items()})
    return {k: v.numpy() for k, v in out.items()}


def test_ace_tpu_loads_the_port_checkpoint(setup, tmp_path, fixed_noise):
    """The port reads ace_tpu's checkpoint and writes its own with
    ``save_stepper``; ace_tpu loads that file, and its one-step prediction
    matches the port's."""
    _, data, ckpt = setup
    stepper = checkpoint.load_stepper(ckpt, device="cpu")
    config = checkpoint.StepperConfig.from_state(
        json.loads(checkpoint.load_msgpack(ckpt)["stepper"]["config"]))
    path = str(tmp_path / "port.msgpack")
    checkpoint.save_stepper(path, stepper, config)
    jax_stepper = jax_checkpoint.load_stepper(path)
    assert jax_stepper.dataset_info.timestep == timedelta(hours=6)
    rng = np.random.RandomState(3)
    ic = {k: rng.randn(2, 1, NLAT, NLON).astype(np.float32)
          for k in PROGNOSTIC}
    forcing = {k: rng.randn(2, 2, NLAT, NLON).astype(np.float32)
               for k in stepper.forcing_window_names}
    ref = _one_step(jax_stepper, ic, forcing, jax_side=True)
    out = _one_step(stepper, ic, forcing, jax_side=False)
    assert set(out) == set(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(out[k], r, rtol=0, atol=_tol(r),
                                   err_msg=k)


def test_port_checkpoint_round_trip_is_exact(setup, tmp_path):
    _, _, ckpt = setup
    stepper = checkpoint.load_stepper(ckpt, device="cpu")
    state = checkpoint.load_msgpack(ckpt)["stepper"]
    config = checkpoint.StepperConfig.from_state(json.loads(state["config"]))
    path = str(tmp_path / "port.msgpack")
    checkpoint.save_stepper(path, stepper, config)
    again = checkpoint.load_stepper(path, device="cpu")
    ref = stepper.module.state_dict()
    out = again.module.state_dict()
    assert list(out) == list(ref)
    for k, v in ref.items():
        assert out[k].dtype == v.dtype and torch.equal(out[k], v), k
    saved = checkpoint.load_msgpack(path)["stepper"]
    assert json.loads(saved["config"]) == json.loads(state["config"])
    assert (json.loads(saved["dataset_info"])
            == json.loads(state["dataset_info"]))


def test_entry_needs_cuda_unless_cpu_is_asked(setup, tmp_path, monkeypatch):
    """``python -m ace_tpu_torch.inference <yaml>`` stops without CUDA
    unless ``--device cpu`` is given; no environment variable is read."""
    _, data, ckpt = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _write_config(tmp_path / "c.yaml", tmp_path / "c", data, ckpt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([path])
    assert not (tmp_path / "c").exists()
    summary = main([path, "--device", "cpu"])
    assert summary["total_steps"] == 2 * N_FORWARD


@pytest.mark.parametrize("extra, match", [
    ({"mesh": {"data": 2}}, "Multi-GPU"),
])
def test_entry_refuses_what_is_not_ported(setup, tmp_path, extra, match):
    _, data, ckpt = setup
    path = _write_config(tmp_path / "c.yaml", tmp_path / "c", data, ckpt,
                         **extra)
    with pytest.raises(NotImplementedError, match=match):
        main([path], device="cpu")


@pytest.mark.parametrize("route", ["files", "memory"])
def test_chip_smoke_path_i_runs_on_the_cpu(route, monkeypatch, capsys):
    """``chip_smoke.py``'s path I at a small size on the CPU, through
    ``main`` on netCDF files, written with h5py or (as where h5py is
    missing) held in host memory by the script's stand-in; its gates hold,
    and the stand-in gives h5py back."""
    import sys

    import chip_smoke
    from ace_tpu_torch.ops import dhconv_filter as k1

    if route == "memory":
        present, _ = chip_smoke.inference_packages()
        present.pop("h5py")
        monkeypatch.setattr(chip_smoke, "inference_packages",
                            lambda: (present, ["h5py"]))
    launches, rate, phases, _ = chip_smoke.inference_path(
        [k1.dhconv_filter], device="cpu",
        sizes=dict(nlat=16, nlon=32, nz=2, embed=16, layers=2),
        n_steps=6, in_memory=2, n_times=9)
    assert launches == {"dhconv_filter": 0}  # plain versions on the CPU
    assert rate > 0 and {"forward_prediction", "aggregator"} <= set(phases)
    out = capsys.readouterr().out
    assert "largest error 0 of the channel's spatial std" in out
    assert ("missing package h5py" in out) == (route == "memory")
    assert "restart.nc" in out and "files finite" in out
    assert sys.modules["h5py"].__name__ == "h5py"
    assert hasattr(sys.modules["h5py"], "Dataset")
