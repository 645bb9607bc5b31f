"""Four trainer options of the port's training entry against
``ace_tpu.train`` on tests/test_torch_trainer.py's config (the noise fixed,
the port started from ace_tpu's initial weights), all on in one run of
``max_epochs: 2``:

- ``segment_epochs: 1``: each ``main`` call trains one epoch and stops;
  the second resumes at epoch 1;
- ``evaluate_before_training``: validation and inline inference before
  the first epoch, logged as ``valid_pre/...``;
- ``train_evaluation_batches: 1``: each epoch's
  ``train/loss_independent_shuffle``;
- ``save_per_epoch_diagnostics``: the validation and inline-inference
  diagnostics of each epoch under ``output/{val,inference}/epoch_NNNN``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ace_tpu.core.wandb import WandB as JaxWandB
from ace_tpu.data.store import open_file_dataset
from ace_tpu.models.conditional_sfno import (
    NoiseConditionedSFNO as JaxNoiseConditionedSFNO,
)
from ace_tpu.stepper import train as jax_train
from ace_tpu.testing import SyntheticData
from ace_tpu.train.train import main as jax_main
from ace_tpu_torch.core.wandb import WandB
from ace_tpu_torch.models.conditional_sfno import NoiseConditionedSFNO
from ace_tpu_torch.stepper import train as port_train
from ace_tpu_torch.train.train import main
from ace_tpu_torch.utils.convert import flax_params_to_state_dict
from tests.test_torch_trainer import NAMES, NLAT, NLON, _noise, config

torch.set_num_threads(2)

OPTIONS = {"max_epochs": 2, "segment_epochs": 1,
           "evaluate_before_training": True, "train_evaluation_batches": 1,
           "save_per_epoch_diagnostics": True}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``main`` twice on the same config with ``OPTIONS``;
    what each call logged (metrics.jsonl, the Weights & Biases calls, the
    start epoch) and the diagnostics files."""
    tmp = tmp_path_factory.mktemp("trainer_options")
    data = SyntheticData(tmp / "data", NAMES, n_time=12, nlat=NLAT,
                         nlon=NLON)
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

    logged: dict[str, list] = {"ace_tpu": [], "port": []}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxNoiseConditionedSFNO, "_make_noise",
                   lambda self, batch: jnp.asarray(_noise(batch)))
        mp.setattr(NoiseConditionedSFNO, "make_noise",
                   lambda self, batch, generator: torch.from_numpy(
                       _noise(batch)))
        mp.setattr(jax_train.TrainStepper, "init", capture)
        mp.setattr(port_train.TrainStepper, "init", from_ace_tpu)
        for name, cls in (("ace_tpu", JaxWandB), ("port", WandB)):
            mp.setattr(cls, "log", lambda self, data, step=None, _n=name:
                       logged[_n].append((step, dict(data))))
        for name, run in (("ace_tpu", lambda p: jax_main([p])),
                          ("port", lambda p: main([p], device="cpu"))):
            path = tmp / f"{name}.yaml"
            with open(path, "w") as f:
                yaml.safe_dump({**config(data, tmp / name), **OPTIONS}, f)
            calls = []
            for _ in range(2):
                trainer = run(str(path))
                with open(tmp / name / "metrics.jsonl") as f:
                    lines = [json.loads(line) for line in f]
                calls.append((trainer.start_epoch, len(lines)))
            out[name] = dict(calls=calls, metrics=lines, dir=tmp / name)
    return out, logged


def test_segment_epochs_stops_and_resumes_as_ace_tpu(runs):
    """Each call trains one epoch: the first starts at epoch 0 and leaves
    one metrics line, the second resumes at epoch 1 and leaves two, in
    both packages; every metric of both epochs agrees within 1e-4
    relative (plus 1e-7), the losses within 1e-5, as
    tests/test_torch_trainer.py holds one epoch."""
    out, _ = runs
    assert out["port"]["calls"] == out["ace_tpu"]["calls"] == [(0, 1), (1, 2)]
    for ref, got in zip(out["ace_tpu"]["metrics"], out["port"]["metrics"]):
        assert set(got) == set(ref)
        for k, r in ref.items():
            rel = 1e-5 if k in ("train/loss", "val/loss") else 1e-4
            assert got[k] == pytest.approx(r, rel=rel, abs=1e-7), k


def test_train_evaluation_batches_match_ace_tpu(runs):
    """``train/loss_independent_shuffle`` in each epoch's line, finite and
    within 1e-5 of ace_tpu's (the same shuffle, offset from the epoch's
    seed, and the validation weights)."""
    out, _ = runs
    for ref, got in zip(out["ace_tpu"]["metrics"], out["port"]["metrics"]):
        key = "train/loss_independent_shuffle"
        assert np.isfinite(ref[key])
        assert got[key] == pytest.approx(ref[key], rel=1e-5)


def test_evaluate_before_training_logs_as_ace_tpu(runs):
    """Before the first epoch (and only in the first call) both log the
    same ``valid_pre/...`` keys at step 0 (validation and the inline
    entry's logs), within 1e-4 relative (plus 1e-7)."""
    _, logged = runs
    pre = {}
    for name, calls in logged.items():
        pre[name] = [(step, data) for step, data in calls
                     if any(k.startswith("valid_pre/") for k in data)]
        assert len(pre[name]) == 1 and pre[name][0][0] == 0
    ref, got = pre["ace_tpu"][0][1], pre["port"][0][1]
    assert set(got) == set(ref)
    assert "valid_pre/loss" in ref and any(
        k.startswith("valid_pre/inference/") for k in ref)
    for k, r in ref.items():
        assert got[k] == pytest.approx(r, rel=1e-4, abs=1e-7), k


def test_per_epoch_diagnostics_match_ace_tpu(runs):
    """The same files under ``output/val/epoch_0001``, ``epoch_0002`` and
    ``output/inference/...``, with the same variables; every float array
    within 1e-4 of its largest value (plus 1e-6)."""
    out, _ = runs

    def files(root):
        found = set()
        for dirpath, _, names in os.walk(root / "output"):
            for n in names:
                found.add(os.path.relpath(os.path.join(dirpath, n), root))
        return found

    ref_files, got_files = files(out["ace_tpu"]["dir"]), files(
        out["port"]["dir"])
    assert got_files == ref_files
    assert {"output/val/epoch_0001", "output/val/epoch_0002",
            "output/inference/epoch_0001"} <= {os.path.dirname(f)
                                               for f in ref_files}
    for rel in sorted(ref_files):
        ref = open_file_dataset(str(out["ace_tpu"]["dir"] / rel))
        got = open_file_dataset(str(out["port"]["dir"] / rel))
        assert set(got.keys()) == set(ref.keys()), rel
        for k in ref.keys():
            r = np.asarray(ref[k].read(()))
            g = np.asarray(got[k].read(()))
            assert g.shape == r.shape, (rel, k)
            if r.dtype.kind != "f":
                continue
            scale = float(np.nanmax(np.abs(r))) if r.size else 0.0
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * scale + 1e-6,
                                       err_msg=f"{rel} {k}")
