"""Dataset labels and missing variables through the port's entries, and
``chip_smoke.py``'s path L at 16x32 on the CPU (the flagship recipe with
local blocks, conditioned on two concatenated sources' labels, one
output-only variable absent from both; its files held in host memory as
where h5py is missing): one epoch and a bit-equal resume with the missing
variable's loss term masked, the inference entry against
``Stepper.predict``, the fused tail's first step, LocalNet in the same
config, and reference phase L (the CPU on both sides). Then the four
behaviors of ace_tpu that the port keeps, and one ``TrainStepper.loss_fn``
with labels and a data mask against ace_tpu's."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from ace_tpu_torch import flagship
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.step import StepArgs, StepSelector
from ace_tpu_torch.data.loading import DataLoaderConfig
from ace_tpu_torch.data.requirements import DataRequirements
from ace_tpu_torch.models.registry import ModuleSelector
from ace_tpu_torch.stepper.stepper import StepperConfig
from tests.test_torch_conditional_options import (
    B,
    LABEL_ROWS,
    NOISE_FIELD,
    _batch,
    _patch_noise,
    _steppers,
)

torch.set_num_threads(2)

SIZES = {"nlat": 16, "nlon": 32, "embed": 32, "layers": 4}


@pytest.fixture(scope="module", autouse=True)
def _no_figures():
    """The entries' figures left out, as on the card, which has no
    matplotlib (both packages skip a figure they cannot draw, and no test
    here reads one)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        yield


def _in_memory(monkeypatch):
    present, _ = chip_smoke.inference_packages()
    present.pop("h5py", None)
    monkeypatch.setattr(chip_smoke, "inference_packages",
                        lambda: (present, ["h5py"]))


def test_chip_smoke_path_l_runs_on_the_cpu(monkeypatch, capsys):
    """Reference phase L, then L-R (one epoch, a resume bit for bit, the
    missing variable's loss term masked), L-I, L-A and L-N at 16x32."""
    from ace_tpu_torch.ops import dhconv_filter as k1

    _in_memory(monkeypatch)
    monkeypatch.setattr(chip_smoke, "local_net_path", _small_local_net(
        chip_smoke.local_net_path))
    counters = [k1.dhconv_filter, k1.dhconv_filter_dx, k1.dhconv_filter_dw]
    out, rows = chip_smoke.local_paths(counters, "cpu", sizes=SIZES,
                                       device="cpu")
    none = {c.__name__: 0 for c in counters}
    assert out == {"L-R": none, "L-I": none, "L-A": none, "L-N": none}
    assert rows == {}
    text = capsys.readouterr().out
    for line in ("cpu vs CPU: rollout error 0 of the allowed",
                 "sources ['era5', 'shield'] concatenated, USWRFsfc absent",
                 "'conditional': True, 'allow_missing_variables': True",
                 "resumed state against the first run's end",
                 "a validation batch's loss with its data mask "
                 "{'USWRFsfc': [0.0, 0.0]}",
                 "not finite: ['val/one_step/bias/USWRFsfc'",
                 "largest error 0 of the channel's spatial std",
                 "path L-A: first step, fused vs unfused",
                 "path L-N: builder {'type': 'LocalNet'"):
        assert line in text, line


def _small_local_net(local_net_path):
    """L-N at embed 16 with 8 noise channels on the CPU."""
    def run(counters, device, sizes):
        return local_net_path(counters, device,
                              dict(sizes, embed_dim=16, noise_embed_dim=8))
    return run


@pytest.fixture(scope="module")
def local_data(tmp_path_factory):
    """Path L's two sources at 16x32 on the disk and its config."""
    tmp = str(tmp_path_factory.mktemp("local"))
    paths = chip_smoke.local_files(tmp, 16, 32, torch.Generator().manual_seed(
        13), "cpu")
    config, _ = chip_smoke._local_config(
        paths, tmp + "/experiment", SIZES)
    return paths, config


def _batch_of(config, loader="train_loader"):
    step = config["stepper"]["step"]["config"]
    requirements = DataRequirements(
        names=sorted(set(step["in_names"]) | set(step["out_names"])),
        n_timesteps=2, allow_missing_variables=True)
    data = from_dict(DataLoaderConfig, config[loader]).build(
        requirements, train=False, device="cpu")
    return next(iter(data.loader)), data


def test_every_label_of_the_union_is_set_in_every_row(local_data):
    """Kept: ``_attach_labels`` sets every label of the sources' union to 1
    in every row, not per source (ace_tpu/data/loading.py:297-303)."""
    _, config = local_data
    batch, _ = _batch_of(config)
    assert torch.equal(batch.labels, torch.ones(B, 2))


def test_the_port_reports_the_union_of_its_sources_labels(local_data):
    """The port's own departure: the dataset info of differently labelled
    concatenated sources holds the union of their labels, where ace_tpu's
    holds the first source's (so a conditional model built from it takes
    fewer labels than its loader gives)."""
    _, config = local_data
    _, data = _batch_of(config)
    assert data.dataset_info.all_labels == ("era5", "shield")


@pytest.mark.parametrize("combine", ["concat", "merge"])
def test_sources_with_the_same_labels_report_ace_tpus_labels(local_data,
                                                             combine):
    """Where every source carries the same labels, the union is the first
    source's labels: the port's concatenated and merged datasets report
    what ace_tpu's do."""
    from ace_tpu.data import dataset as jax_dataset
    from ace_tpu_torch.data import dataset

    paths, _ = local_data
    # a merge's sources share their times: the first source twice
    stores = (paths["sources"] if combine == "concat"
              else [paths["sources"][0]] * 2)
    sources = [{"data_path": source["train"], "labels": ["shield", "era5"]}
               for source in stores]
    config = {combine: sources}
    ported = from_dict(dataset.ConcatDatasetConfig if combine == "concat"
                       else dataset.MergeDatasetConfig, config).build()
    reference = {"concat": jax_dataset.ConcatDatasetConfig,
                 "merge": jax_dataset.MergeDatasetConfig}[combine](
        [jax_dataset.XarrayDataConfig(**s) for s in sources]).build()
    assert (ported.dataset_info.all_labels
            == reference.dataset_info.all_labels == ("era5", "shield"))


def test_a_missing_variable_is_missing_from_the_whole_dataset(local_data):
    """Kept: a variable a dataset lacks is missing from every sample
    (ace_tpu/data/loading.py:118-127): NaN placeholders and a presence of
    0 in every row."""
    _, config = local_data
    batch, _ = _batch_of(config, "validation_loader")
    missing = chip_smoke.L_MISSING
    assert set(batch.data_mask) == {missing}
    assert torch.equal(batch.data_mask[missing], torch.zeros(B))
    assert torch.isnan(batch.data[missing]).all()


def test_a_conditional_local_net_ignores_its_labels():
    """Kept: LocalNet is a conditional builder, but its builder passes no
    labels and the module has no ``n_labels`` (ace_tpu's does not either),
    so the step does not give it the batch's labels."""
    config, info = chip_smoke.local_stepper_config("localnet")
    info = dataclasses.replace(info, all_labels=("era5", "shield"))
    selector = config.step.config["builder"]
    selector["conditional"] = True
    module = ModuleSelector(**selector).build(4, 2, info, device="cpu")
    assert not hasattr(module, "n_labels")
    stepper = StepperConfig(step=StepSelector(
        type="single_module", config=config.step.config)).get_stepper(
        info, device="cpu")
    assert stepper.step.config.builder.conditional
    stepper.init_params(torch.Generator().manual_seed(0))
    ic, forcing = flagship.synthetic_inputs(
        stepper, 1, batch=2, generator=torch.Generator().manual_seed(1))
    args = dict(input={**{k: v[:, 0] for k, v in ic.data.items()},
                       **{k: v[:, 0] for k, v in forcing.items()}},
                next_step_input_data={k: v[:, 1] for k, v in
                                      forcing.items()},
                stepper_state=stepper.step.init_stepper_state(
                    {k: v[:, 0] for k, v in ic.data.items()}))
    with torch.no_grad():
        plain = stepper.step.step(StepArgs(**args)).output
        labelled = stepper.step.step(StepArgs(
            **args, labels=torch.ones(2, 2))).output
    for k, v in plain.items():
        assert torch.equal(v, labelled[k]), k


def test_a_conditional_rollout_has_zero_labels():
    """Kept: ``Stepper.predict`` (and so the inference entry) passes no
    labels (ace_tpu/stepper/stepper.py:209-216): a conditional model rolls
    out as with labels of zero, unlike with the loader's labels of one."""
    config, info = chip_smoke.local_stepper_config("sfno")
    stepper = config.get_stepper(info, device="cpu")
    flagship.draw_check_weights(
        stepper, torch.Generator().manual_seed(0))
    network = stepper.step.network
    assert network.n_labels == 2
    seen = []
    forward = network.forward

    def recording(*args, labels=None, **kwargs):
        seen.append(labels)
        return forward(*args, labels=labels, **kwargs)

    network.forward = recording
    ic, forcing = flagship.synthetic_inputs(
        stepper, 2, batch=2, generator=torch.Generator().manual_seed(1))
    stepper.predict(ic, forcing)
    assert seen == [None, None]
    x = torch.randn(2, 16, 32, network.in_chans,
                    generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        none = forward(x)
        zeros = forward(x, labels=torch.zeros(2, 2))
        ones = forward(x, labels=torch.ones(2, 2))
    assert torch.equal(none, zeros)
    assert not torch.equal(none, ones)


def test_loss_with_labels_and_a_data_mask_matches_ace_tpu(monkeypatch):
    """One ``TrainStepper.loss_fn`` (2 ensemble members) with each row's
    own labels and a data mask that drops the output-only variable ``d``
    from the second row, whose targets there are NaN: within 1e-4 of
    ace_tpu's; the NaN row's term is masked on both sides."""
    _patch_noise(monkeypatch, NOISE_FIELD)
    jts, params, ts = _steppers("local-blocks-labels", "float32")
    batch = _batch()
    batch["d"][1] = np.nan
    mask = {"d": np.asarray([1.0, 0.0], np.float32)}
    with pytest.MonkeyPatch.context() as mp:
        _patch_noise(mp, NOISE_FIELD)
        ref, _ = jax.jit(jts.loss_fn, static_argnums=3)(
            params, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(1), 1, jnp.asarray(LABEL_ROWS),
            data_mask={k: jnp.asarray(v) for k, v in mask.items()})
    with torch.no_grad():
        loss, _ = ts.loss_fn(
            {k: torch.from_numpy(v) for k, v in batch.items()}, None,
            labels=torch.from_numpy(LABEL_ROWS),
            data_mask={k: torch.from_numpy(v) for k, v in mask.items()})
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-4)


def test_the_path_l_config_keeps_the_recipe_but_for_its_settings(
        local_data):
    """``_local_config`` adds path L's settings to path R's cuts of the
    shipped recipe: the local blocks, ``conditional``,
    ``allow_missing_variables`` and the concatenated labelled sources; the
    rest of the network, the loss and the optimizer stay as shipped."""
    _, config = local_data
    with open(chip_smoke.TRAIN_CONFIG) as f:
        shipped = yaml.safe_load(f)
    for key in ("optimization", "stepper_training", "ema"):
        assert config[key] == shipped[key]
    selector = config["stepper"]["step"]["config"]["builder"]
    assert selector["conditional"] and selector["allow_missing_variables"]
    builder = selector["config"]
    assert builder["local_blocks"] == [1, 3]
    want = dict(shipped["stepper"]["step"]["config"]["builder"]["config"],
                embed_dim=SIZES["embed"], num_layers=SIZES["layers"],
                checkpointing=1, local_blocks=[1, 3])
    assert builder == want
    concat = config["train_loader"]["dataset"]["concat"]
    assert [c["labels"] for c in concat] == [["era5"], ["shield"]]
    assert chip_smoke.L_MISSING in shipped["stepper"]["step"]["config"][
        "out_names"]
    assert chip_smoke.L_MISSING not in shipped["stepper"]["step"]["config"][
        "in_names"]


def test_profile_flagship_local_runners_and_disco_attribution(tmp_path):
    """``profile_flagship --local``'s train step (labels, the data mask)
    and rollout window at 16x32: finite losses, finite outputs; in a CPU
    trace of a train step ``disco_relabel`` names the local blocks' DISCO
    (the weight's matmul in ``DiscoConvS2.mixed`` and its backward), and
    not the blocks' MLPs."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from ace_tpu_torch import profile_flagship

    train, rollout = profile_flagship._local_runners("cpu", 16, 32, embed=64,
                                                     layers=4)
    losses = [float(m["loss"]) for m in train(2)]
    assert all(map(np.isfinite, losses)), losses
    out = rollout(1)
    assert out["air_temperature_0"].shape == (
        1, profile_flagship.INFERENCE_STEPS_IN_MEMORY, 16, 32)
    assert all(torch.isfinite(v).all() for v in out.values())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train(1)
    path = str(tmp_path / "local_cpu_trace.json")
    prof.export_chrome_trace(path)
    relabel = profile_flagship.disco_relabel(path)
    with open(path) as f:
        ops = [e for e in json.load(f)["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    named = {e["name"] for e in ops if relabel(e)}
    assert {"aten::mm", "aten::index"} <= named, named
    backward = [e for e in ops if relabel(e)
                and e["name"].startswith("autograd::engine::evaluate_")]
    assert any("MmBackward" in e["name"] for e in backward)
    dense = [e for e in ops if e["name"] == "aten::addmm"]
    assert dense and not any(map(relabel, dense))
