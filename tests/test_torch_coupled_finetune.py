"""The CM4 coupled finetune and evaluator YAMLs
(``configs/baselines/cm4-piControl/``) through both packages' coupled
entries, float32 on the CPU, at the sizes and over the synthetic stores
of ``tests/test_torch_coupled_train.py`` (``ace_tpu`` over one file a
component, the port over the YAMLs' merged stores), from a coupled
checkpoint directory that holds ``chip_smoke.coupled_checkpoints``'
component weights as ``atmosphere_ckpt.msgpack`` and
``ocean_ckpt.msgpack``: the finetune YAML (both components trained, the
atmosphere's loss over its first 2 steps, ``CosineAnnealingLR``) for one
epoch of 2 coupled steps, and the evaluator YAML over the directory (4
coupled steps in windows of 2, ``EVAL_AGGREGATOR``)."""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from ace_tpu.coupled import evaluator as jax_evaluator
from ace_tpu.coupled import train as jax_train
from ace_tpu_torch.core.cli import prepare_config
from ace_tpu_torch.coupled import evaluator
from ace_tpu_torch.coupled.train import main as train_main
from tests.test_torch_coupled import single
from tests.test_torch_coupled_train import (
    LOSS_TOL,
    N_COUPLED,
    SIZES,
    _metrics,
    coupled_files,
)

torch.set_num_threads(2)

# the evaluator's aggregators here: the YAML's defaults but the spectra,
# zonal means and annual means, which cost ace_tpu's eager evaluator 80 s
# of compiles at this size (tests/test_torch_aggregators.py and
# tests/test_torch_evaluator.py hold every aggregator against ace_tpu;
# path C-E of chip_smoke.py runs the YAML's)
EVAL_AGGREGATOR = {"log_spectra": False, "log_zonal_mean_images": False,
                   "log_annual_means": False}


@pytest.fixture(scope="module", autouse=True)
def _no_figures():
    """The entries' figures left out (both packages skip a figure they
    cannot draw), but the port's evaluator's (``finetune_runs``):
    rendering them is most of what an evaluator run costs at this size.
    Yields matplotlib."""
    import matplotlib

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        yield matplotlib


@pytest.fixture(scope="module")
def finetune_runs(tmp_path_factory, _no_figures):
    """Both packages' finetune and evaluator entries from one coupled
    checkpoint directory, the port's evaluator drawing its figures; the
    port's learning rate at each update."""
    tmp = tmp_path_factory.mktemp("coupled_finetune")
    files = coupled_files(tmp)
    base = chip_smoke.coupled_checkpoints(str(tmp), files[False], "cpu",
                                          SIZES)
    ckpt = tmp / "coupled_checkpoint"
    ckpt.mkdir()
    for component, path in base.items():
        shutil.copy(path, ckpt / f"{component}_ckpt.msgpack")
    out = {"lrs": [], "files": files[False]}
    for name, train, evaluate, one in (
            ("ace_tpu", jax_train.main, jax_evaluator.main, True),
            ("port", lambda a: train_main(a, device="cpu"),
             lambda a: evaluator.main(a, device="cpu"), False)):
        config = chip_smoke._coupled_config(
            files[one], str(tmp / f"finetune_{name}"), SIZES,
            source=chip_smoke.C_FINETUNE, checkpoint_path=str(ckpt),
            n_coupled_steps=N_COUPLED)
        path = chip_smoke._write_yaml(str(tmp / f"finetune_{name}.yaml"),
                                      single(config) if one else config)
        if name == "port":
            with chip_smoke._learning_rates(out["lrs"]):
                train([path])
        else:
            train([path])
        out[f"finetune_{name}"] = _metrics(tmp / f"finetune_{name}")
        config = chip_smoke._coupled_evaluator_config(
            files[one], str(ckpt), str(tmp / f"eval_{name}"))
        config["aggregator"] = EVAL_AGGREGATOR
        with pytest.MonkeyPatch.context() as figures:
            if name == "port":
                figures.setitem(sys.modules, "matplotlib", _no_figures)
            out[f"eval_{name}"] = evaluate([chip_smoke._write_yaml(
                str(tmp / f"eval_{name}.yaml"),
                single(config) if one else config)])
    return tmp, out


def test_finetune_entry_matches_ace_tpu(finetune_runs):
    """The losses (the atmosphere's over its first 2 steps) within 1e-4
    relative, both components' weights changed, and each update's
    learning rate ``ace_tpu``'s ``CosineAnnealingLR`` (T_max the epochs,
    counted in updates) at its count."""
    tmp, out = finetune_runs
    (ref,), (got,) = out["finetune_ace_tpu"], out["finetune_port"]
    assert set(got) == set(ref)
    for k in ("loss", "atmosphere_loss", "ocean_loss", "val_loss"):
        assert ref[k] > 0
        assert got[k] == pytest.approx(ref[k], rel=LOSS_TOL), k
    from tests.test_torch_coupled_train import _weights

    for component in ("atmosphere", "ocean"):
        before = _weights(str(tmp / "coupled_checkpoint"
                              / f"{component}_ckpt.msgpack"))
        after = _weights(str(tmp / "finetune_port" / "training_checkpoints"
                             / f"{component}_ckpt.msgpack"))
        assert any(not torch.equal(v, before[k]) for k, v in after.items())
    config = jax_train.from_dict(jax_train.CoupledTrainConfig,
                                 prepare_config(chip_smoke.C_FINETUNE))
    schedule = config.optimization.scheduler.build(config.optimization.lr, 1)
    want = [float(schedule(i)) for i in range(len(out["lrs"]))]
    assert len(out["lrs"]) == 2
    np.testing.assert_allclose(out["lrs"], want, rtol=1e-7, atol=0)


# the evaluator's logs: EVAL_TOL of ace_tpu's value (the spectrum's
# logs, ratios and logarithms of powers that a deep level or a moisture
# variable keeps small, SPECTRUM_TOL, as tests/test_torch_ocean_path.py
# holds the normalized biases; measured 1.3e-5) plus EVAL_SCALE_TOL of the
# variable's scale (its stats' |mean| + std: 16 steps of the recipe's
# corrector carry ace_tpu's float32 dry-air and budget means into every
# field, ROADMAP Queue 3; measured 4e-6 of it, PRESsfc's bias 0.18 Pa)
EVAL_TOL = 1e-5
SPECTRUM_TOL = 1e-3
EVAL_SCALE_TOL = 1e-5


def test_evaluator_entry_matches_ace_tpu(finetune_runs):
    """The evaluator YAML through both entries: the same keys, NaN on the
    same ones (every ``inference/ocean`` statistic: a mean over the dry
    cells' NaN, in both packages), the rest within ``EVAL_TOL`` relative
    plus ``EVAL_SCALE_TOL`` of the variable's scale."""
    from ace_tpu_torch.core.normalizer import load_scalar_dict_from_file

    tmp, out = finetune_runs
    logs, ref = out["eval_port"], out["eval_ace_tpu"]
    assert set(logs) == set(ref)
    ocean = [k for k in ref if k.startswith("inference/ocean/")]
    assert ocean and all(np.isnan(ref[k]) for k in ocean)
    scale = {}
    for component in ("ocean", "atmosphere"):
        paths = out["files"][component]
        means = load_scalar_dict_from_file(paths["centering"])
        stds = load_scalar_dict_from_file(paths["scaling-full-field"])
        scale.update({k: abs(float(v)) + float(stds[k])
                      for k, v in means.items()})
    bad = []
    for k, r in ref.items():
        if np.isnan(r):
            if not np.isnan(logs[k]):
                bad.append((k, logs[k], r))
            continue
        rel = SPECTRUM_TOL if "/spectrum/" in k else EVAL_TOL
        allowed = (rel * abs(r)
                   + EVAL_SCALE_TOL * scale.get(k.rsplit("/", 1)[-1], 0.0))
        if abs(logs[k] - r) > allowed:
            bad.append((k, logs[k], r))
    assert not bad, bad[:5]


@pytest.mark.parametrize("component", ["atmosphere", "ocean"])
def test_the_port_draws_every_coupled_figure(finetune_runs, component):
    """The port's coupled evaluator draws each map of each component's
    diagnostics (the ocean's NaN on the dry cells), none failing."""
    from tests.test_torch_ocean_path import expected_figures

    tmp, _ = finetune_runs
    drawn = set(os.listdir(tmp / "eval_port" / "plots" / component))
    want = expected_figures(tmp / "eval_port" / "diagnostics" / component)
    assert want
    assert drawn == want, sorted(drawn ^ want)
