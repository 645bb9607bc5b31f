"""The uncoupled-ocean CM4 recipe
(``configs/baselines/cm4-piControl/uncoupled-ocean/``: Samudra, the ocean
corrector, input and output masking) through both packages' entries at
16x32, and ``chip_smoke.py``'s path O and reference phase O on the CPU.

Both YAMLs build in the port as shipped (Weights & Biases off). The
training YAML runs one epoch of one batch (the cuts of path O-R, at
Samudra widths 16-24 over 2 levels, over ``chip_smoke.ocean_files``'
synthetic stores) through ``ace_tpu.train`` and the port's ``main`` from
the same initial weights: ``ace_tpu`` over one file that holds every
variable (its merged loader reads a ``_start_indices`` it never sets,
ROADMAP Queue 3), the port over the YAML's three merged stores, which a
test holds equal to the single file. The evaluator YAML (4 steps, every
aggregator flag of path O-E) runs through both packages' entries over
``ace_tpu``'s best checkpoint on the single file. float32 on both sides.

One batch an epoch: with the recipe's fill of 0 in physical units the
network sees inputs tens of standard deviations from their means on the
dry cells, and a rollout from random weights amplifies rounding by about
10 a step; Adam's first update moves each weight by the learning rate
times the sign of its gradient, so a weight whose true gradient is zero
(a bias that an instance norm removes) moves by the rounding's sign.
After one update the packages stay within 1e-4 of each other; after four
the rollout's amplification puts their losses 1e-3 apart."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ace_tpu.inference import evaluator as jax_evaluator
from ace_tpu.stepper import stepper as jax_stepper
from ace_tpu.train.train import main as jax_train_main
from ace_tpu_torch.core.cli import prepare_config
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.data.dataset import MergeDatasetConfig, XarrayDataConfig
from ace_tpu_torch.inference import evaluator
from ace_tpu_torch.inference.evaluator import EvaluatorConfig
from ace_tpu_torch.stepper import train as port_train
from ace_tpu_torch.stepper.checkpoint import load_msgpack
from ace_tpu_torch.train.train import main as train_main
from ace_tpu_torch.train.trainer import TrainConfig
from ace_tpu_torch.utils.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_variables,
)

torch.set_num_threads(2)

NLAT, NLON = 16, 32
SIZES = dict(nlat=NLAT, nlon=NLON, ch_width=[16, 24], dilation=[1, 2])
# one training batch of 4 windows of 5 times, one validation batch, the
# inline entry's 8 initial conditions and 4 steps, the evaluator's 4 steps
E_STEPS = 4
SPLITS = (("train", 8, "0305-01-01"), ("valid", 8, "0306-01-01"),
          ("inference", 12, "0151-01-06"),
          ("evaluator", E_STEPS + 1, "0311-01-01"))
LOSS_TOL = 1e-4
METRIC_TOL = 1e-4


def _single(config):
    """``config``'s merge lists as their first entry (the single file)."""
    for loader in ("train_loader", "validation_loader"):
        if loader in config:
            config[loader]["dataset"] = config[loader]["dataset"]["merge"][0]
    for entry in config.get("inference", []):
        entry["loader"]["dataset"] = entry["loader"]["dataset"]["merge"][0]
    if "loader" in config:
        config["loader"]["dataset"] = config["loader"]["dataset"]["merge"][0]
    return config


@pytest.mark.parametrize("path, schema", [
    (chip_smoke.OCEAN_TRAIN, TrainConfig),
    (chip_smoke.OCEAN_EVALUATOR, EvaluatorConfig),
])
def test_ocean_yamls_build_as_shipped(path, schema):
    """Each YAML, with only ``logging.log_to_wandb=false``, builds in the
    port's schema, its loaders the three-store merge; the training YAML's
    step is Samudra with the ocean corrector and input masking."""
    config = from_dict(schema, prepare_config(path,
                                              ["logging.log_to_wandb=false"]))
    if schema is TrainConfig:
        assert isinstance(config.train_loader.dataset, MergeDatasetConfig)
        assert len(config.train_loader.dataset.merge) == 3
        step = config.stepper.step.instance
        assert step.builder.type == "Samudra"
        assert step.corrector.type == "ocean_corrector"
        assert config.stepper.input_masking.exclude_names_and_prefixes == [
            "land_fraction"]
        assert len(step.in_names) == 90 and len(step.out_names) == 80
    else:
        assert len(config.loader.dataset.merge) == 3


class _EagerJax:
    """``jax`` with ``jit`` the identity: for ``ace_tpu``'s aggregators,
    whose jitted updates over this recipe's 80 outputs take XLA:CPU 35-45
    s each to compile (the spectrum's flood fills and transforms, one per
    variable, unrolled), which op by op run in seconds. Same operations,
    not compiled."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, *args, **kwargs):
        return fn


def _eager_aggregators(mp):
    from ace_tpu.aggregator import inference as jax_inference_aggregators
    from ace_tpu.aggregator import one_step as jax_one_step

    for module in (jax_inference_aggregators, jax_one_step):
        mp.setattr(module, "jax", _EagerJax())


@pytest.fixture(scope="module")
def ocean_runs(tmp_path_factory):
    """One epoch of both training entries (ace_tpu from the port's initial
    weights), then both evaluator entries over ace_tpu's best
    checkpoint; ``ace_tpu``'s aggregators run eagerly
    (``_eager_aggregators``)."""
    tmp = tmp_path_factory.mktemp("ocean")
    files = {}
    for single in (False, True):
        files[single], _ = chip_smoke.ocean_files(
            str(tmp / f"files_{single}"), NLAT, NLON,
            torch.Generator().manual_seed(11), "cpu", splits=SPLITS,
            single=single)
    init = {}
    port_init = port_train.TrainStepper.init

    def capture(self, generator=None):
        port_init(self, generator)
        init["params"] = {k: v.detach().clone()
                          for k, v in self.stepper.module.state_dict().items()}

    def from_port(self, rng):
        # ace_tpu's weights made from the port's (no compile of flax's
        # initializers)
        self.params = jax.tree_util.tree_map(
            jnp.asarray, state_dict_to_flax_variables(init["params"]))
        return self.params

    out = {"init": init}
    import matplotlib

    with pytest.MonkeyPatch.context() as mp:
        _eager_aggregators(mp)
        # the port's evaluator alone draws its figures (both packages skip
        # a figure they cannot draw): drawing them all took a minute
        mp.setitem(sys.modules, "matplotlib", None)
        mp.setattr(port_train.TrainStepper, "init", capture)
        mp.setattr(jax_stepper.Stepper, "init_params", from_port)
        for name, run, single in (
                ("port", lambda a: train_main(a, device="cpu"), False),
                ("ace_tpu", jax_train_main, True)):
            config = chip_smoke._ocean_config(files[single], str(tmp / name),
                                              str(tmp), None, SIZES)
            if single:
                _single(config)
            run([chip_smoke._write_yaml(str(tmp / f"{name}.yaml"), config)])
            with open(tmp / name / "metrics.jsonl") as f:
                out[name] = [json.loads(line) for line in f]
        ckpt = str(tmp / "ace_tpu" / "training_checkpoints"
                   / "best_ckpt.msgpack")
        for name, run in (("ace_tpu", jax_evaluator.main),
                          ("port", lambda a: evaluator.main(a,
                                                            device="cpu"))):
            config = chip_smoke._yaml(chip_smoke.OCEAN_EVALUATOR)
            config.update(experiment_dir=str(tmp / f"eval_{name}"),
                          checkpoint_path=ckpt, n_forward_steps=E_STEPS)
            config["logging"].update(log_to_wandb=False, log_to_screen=False)
            chip_smoke._ocean_dataset(config["loader"]["dataset"]["merge"],
                                      files[True]["evaluator"])
            config["aggregator"].update(chip_smoke.O_E_FLAGS)
            config["aggregator"]["log_step_means"] = [{"step": 2}]
            _single(config)
            path = chip_smoke._write_yaml(str(tmp / f"eval_{name}.yaml"),
                                          config)
            with pytest.MonkeyPatch.context() as figures:
                if name == "port":
                    figures.setitem(sys.modules, "matplotlib", matplotlib)
                out[f"eval_{name}"] = run([path])
    return tmp, files, out


def _close(got, ref, tol):
    """Equal NaN, else within ``tol`` of the value plus 1e-6 absolute."""
    if np.isnan(ref):
        return np.isnan(got)
    return abs(got - ref) <= tol * abs(ref) + 1e-6


def test_ocean_training_entry_matches_ace_tpu(ocean_runs):
    """metrics.jsonl: the same keys, NaN on the same ones (a gradient
    magnitude of a level without a wet neighbour pair, the spectrum of a
    tendency that is zero at the first step); the losses and the
    inline-inference error within 1e-4 relative, every other value within
    1e-4 relative plus 1e-6."""
    _, _, out = ocean_runs
    (ref,), (got,) = out["ace_tpu"], out["port"]
    assert set(got) == set(ref)
    for k in ("train/loss", "val/loss", "inference/inference_error"):
        assert np.isfinite(ref[k])
        assert got[k] == pytest.approx(ref[k], rel=LOSS_TOL), k
    bad = [(k, got[k], r) for k, r in ref.items()
           if not _close(got[k], r, METRIC_TOL)]
    assert not bad, bad[:5]


def test_ocean_weights_after_an_epoch_match_ace_tpu(ocean_runs):
    """The weights of both ``ckpt.msgpack`` files after the epoch's one
    update, which moves each weight by about the learning rate times the
    sign of its gradient (Adam's first step, with the weight decay):
    each weight's change within 1e-2 of the learning rate of
    ``ace_tpu``'s but where the gradient's sign differs, a weight whose
    gradient is at float32's rounding; those at most 1e-3 of all weights,
    and no change apart by more than twice the learning rate. The wide
    convolutions' biases, whose true gradient is zero, are such weights
    throughout."""
    tmp, _, out = ocean_runs
    init = out["init"]["params"]
    weights = {}
    for name in ("ace_tpu", "port"):
        payload = load_msgpack(str(tmp / name / "training_checkpoints"
                                   / "ckpt.msgpack"))
        weights[name] = flax_params_to_state_dict(
            payload["stepper"]["params"])
    lr = chip_smoke._yaml(chip_smoke.OCEAN_TRAIN)["optimization"]["lr"]
    assert set(weights["port"]) == set(weights["ace_tpu"]) == set(init)
    flipped, total = 0, 0
    for k, w0 in init.items():
        ref = weights["ace_tpu"][k].double() - w0.double()
        got = weights["port"][k].double() - w0.double()
        assert float((got - ref).abs().max()) <= 2.01 * lr, k
        if not k.endswith((".conv1.bias", ".conv2.bias")):
            flipped += int(((got - ref).abs() > 1e-2 * lr).sum())
            total += ref.numel()
    assert flipped <= 1e-3 * total, (flipped, total)


def test_ocean_evaluator_matches_ace_tpu(ocean_runs):
    """The evaluator's logs with every aggregator flag: the same keys, NaN
    on the same ones (a mean without the masks' weights over the dry
    cells' NaN, in both packages), the rest within 1e-5 relative plus
    1e-5 of the variable's global mean (a bias is a difference of two
    float32 means of the field); the spectrum's normalized biases, which
    divide by a deep level's small target power, within 1e-3 relative (as
    tests/test_torch_som_path.py holds every metric). The ocean's derived
    heat content and its tendency are among them."""
    _, _, out = ocean_runs
    logs, ref = out["eval_port"]["logs"], out["eval_ace_tpu"]["logs"]
    assert set(logs) == set(ref)
    derived = [k for k in ref if k.endswith("/ocean_heat_content")]
    assert derived and all(np.isfinite(ref[k]) for k in derived
                           if k.startswith("time_mean/"))

    def tol(key, r):
        name = key.rsplit("/", 1)[-1]
        scale = abs(ref.get(f"mean_step_2/weighted_mean_gen/{name}", 0.0))
        rel = 1e-3 if "norm_bias" in key else 1e-5
        return rel * abs(r) + 1e-5 * np.nan_to_num(scale) + 1e-6

    bad = [(k, logs[k], r) for k, r in ref.items()
           if not (np.isnan(logs[k]) if np.isnan(r)
                   else abs(logs[k] - r) <= tol(k, r))]
    assert not bad, bad[:5]


def expected_figures(diagnostics_dir) -> set[str]:
    """The files ``InferenceAggregator.flush_images`` draws from the
    diagnostics that ``flush_diagnostics`` wrote to ``diagnostics_dir``:
    a GIF for each video, a PNG for each map (2D, or 12 HEALPix faces),
    none for the step means."""
    from ace_tpu_torch.data.store import open_file_dataset

    names = set()
    for file in os.listdir(diagnostics_dir):
        label = file.removesuffix("_diagnostics.nc")
        if label in ("mean_step", "mean_norm"):
            continue
        ds = open_file_dataset(os.path.join(diagnostics_dir, file))
        for key in ds.keys():
            shape = np.shape(ds[key].read(()))
            safe = f"{label}.{key}".replace("/", "_")
            if key.startswith("video-"):
                names.add(safe + ".gif")
            elif len(shape) == 2 or (len(shape) == 3 and shape[0] == 12):
                names.add(safe + ".png")
    return names


def test_the_port_draws_every_masked_ocean_figure(ocean_runs):
    """The port's evaluator draws each map and video of its diagnostics
    of the masked ocean fields (NaN on the dry cells), none failing."""
    tmp, _, _ = ocean_runs
    drawn = set(os.listdir(tmp / "eval_port" / "plots"))
    want = expected_figures(tmp / "eval_port" / "diagnostics")
    assert any(n.endswith(".gif") for n in want)
    assert drawn == want, sorted(drawn ^ want)


def test_merged_loader_equals_single_file_loader(ocean_runs):
    """The port's loader over the YAML's three merged stores gives the
    same windows (NaN on the same cells) and dataset info (the depth
    coordinate and the masks of the first store) as over one file."""
    _, files, _ = ocean_runs
    names = chip_smoke._ocean_names()
    for split in ("train", "evaluator"):
        merged = from_dict(MergeDatasetConfig, {"merge": [
            {"data_path": files[False][split][s], "file_pattern": "data.nc"}
            for s in chip_smoke.O_SOURCES]}).build()
        single = from_dict(XarrayDataConfig, {
            "data_path": files[True][split]["ocean"],
            "file_pattern": "data.nc"}).build()
        assert merged.get_window(0, 3, names)[0].keys() == set(names)
        got, time = merged.get_window(1, 3, names)
        want, want_time = single.get_window(1, 3, names)
        np.testing.assert_array_equal(time.values, want_time.values)
        for k in names:
            np.testing.assert_array_equal(got[k], want[k])
        assert (merged.dataset_info.get_state()
                == single.dataset_info.get_state())
        assert merged.n_windows(5) == single.n_windows(5)


def test_chip_smoke_path_o_runs_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s reference phase O (the CPU on both sides:
    equal exactly) and paths O-R and O-E over the shipped YAMLs at 16x32
    (Samudra widths 16-24, 2 levels), their files held in host memory as
    where h5py is missing, and without matplotlib, as on the card (the
    evaluator's maps and videos are skipped there: their rendering took
    45 of this test's 70 s): every gate holds, with no launch."""
    import sys

    from ace_tpu_torch.ops import dhconv_filter as k1

    present, _ = chip_smoke.inference_packages()
    present.pop("h5py")
    monkeypatch.setattr(chip_smoke, "inference_packages",
                        lambda: (present, ["h5py"]))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    counters = [k1.dhconv_filter, k1.dhconv_filter_dx, k1.dhconv_filter_dw]
    out = chip_smoke.ocean_paths(counters, "cpu", sizes=SIZES, device="cpu")
    none = {c.__name__: 0 for c in counters}
    assert out == {"O-R": none, "O-E": none}
    text = capsys.readouterr().out
    for line in ("reference O (Samudra, f32): cpu vs CPU: rollout error 0",
                 "relative error 0 (tol", "failing: []",
                 "checksums equal", "largest error 0 of the channel"):
        assert line in text, line


def test_profile_flagship_ocean_runners_run_on_the_cpu():
    """``profile_flagship --ocean``'s train step (batch 4, 4 steps) and
    rollout at 16x32: finite losses falling over 3 steps on one batch,
    the rollout NaN exactly on the dry cells of each output's mask."""
    from ace_tpu_torch import profile_flagship

    train, rollout = profile_flagship._ocean_runners(
        "cpu", NLAT, NLON, SIZES["ch_width"], SIZES["dilation"])
    losses = [float(m["loss"]) for m in train(3)]
    assert all(map(np.isfinite, losses)) and losses[-1] < losses[0], losses
    assert profile_flagship.convolution_flop(rollout) > 0
    outputs = rollout(2)
    for k, v in outputs.items():
        assert v.shape == (1, 2, NLAT, NLON), k
    sst = outputs["sst"]
    assert torch.isnan(sst).any() and torch.isfinite(sst[~sst.isnan()]).all()
