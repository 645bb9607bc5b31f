"""``chip_smoke.py``'s paths W and G with reference phases W and G on the
CPU, at small sizes, the files held in host memory as where h5py is
missing: the flagship recipe with a small NoiseConditionedSwinTransformer
at 16x32 (W-R, an epoch and a bit-equal resume; W-I equal to
``Stepper.predict``; W-A, a small AdaLN Swin over two labelled sources),
the sea-ice recipe with a small FloeNet at 16x32 (G-R with a bit-equal
resume, G-E with NaN exactly on land, G-L), the graph queries at meshes 4
on 512 points of the 1° grid; the recipes' cuts and the published
sizes of the networks at their builders' defaults. No JAX runs here."""

import numpy as np
import pytest
import sys
import torch

import chip_smoke

torch.set_num_threads(2)

SIZES = {"nlat": 16, "nlon": 32}
# width 16: at width 8 the recipe's rollout from a 4-batch model grows
# without bound within W-I's 20 steps (its energy spectrum overflows)
SMALL_SWIN = {"embed_dim": 16, "num_heads": [2, 2, 2, 2],
              "window_size": [2, 4], "cpb_hidden_dim": 16,
              "noise_embed_dim": 8}
SMALL_GRAPH = {"latent_dimension": 8, "meshes": 3, "M0": 1,
               "processor_steps": 1}


@pytest.fixture(scope="module", autouse=True)
def _no_figures():
    """The entries' figures left out, as on the card, which has no
    matplotlib (both packages skip a figure they cannot draw, and no test
    here reads one)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        yield


@pytest.fixture
def no_h5py(monkeypatch):
    present, _ = chip_smoke.inference_packages()
    present.pop("h5py", None)
    monkeypatch.setattr(chip_smoke, "inference_packages",
                        lambda: (present, ["h5py"]))


def _counters():
    from ace_tpu_torch.ops import dhconv_filter as k1

    return [k1.dhconv_filter, k1.dhconv_filter_dx, k1.dhconv_filter_dw]


def test_chip_smoke_path_w_runs_on_the_cpu(no_h5py, capsys):
    """Reference W (the CPU on both sides), then W-R, W-I and W-A, TF32
    turned on before each entry and off after it."""
    counters = _counters()
    out = chip_smoke.swin_paths(
        counters, "cpu", device="cpu", sizes=SIZES, builders={
            "W-R": {"type": "NoiseConditionedSwinTransformer",
                    "config": SMALL_SWIN},
            "W-A": {"type": "SwinTransformer", "config": {
                **{k: v for k, v in SMALL_SWIN.items()
                   if k != "noise_embed_dim"},
                "padding_conf": {"activate": True, "pad_lat": [2, 2],
                                 "pad_lon": [3, 3]}}}})
    none = {c.__name__: 0 for c in counters}
    assert out == {"W-R": none, "W-I": none, "W-A": none}
    text = capsys.readouterr().out
    for line in ("reference W (cln-cosl-earth): cpu vs CPU: rollout error 0",
                 "reference W (cln-labels-swiglu-noskip-mirror): cpu vs CPU",
                 "reference W (adaln-labels-earth): cpu vs CPU",
                 "set on before it: [(False, False), (False, False)]",
                 "resumed state against the first run's end",
                 "largest error 0 of the channel's spatial std",
                 "path W-A: ", "2 batches at"):
        assert line in text, line


def test_chip_smoke_path_g_runs_on_the_cpu(no_h5py, capsys):
    """Reference G (the queries at meshes 4 on 512 points; the networks
    the CPU on both sides), then G-R, G-E and G-L."""
    counters = _counters()
    out = chip_smoke.graphcast_paths(
        counters, "cpu", device="cpu", nlat=16, nlon=32, builders={
            "G-R": {"type": "FloeNet", "config": SMALL_GRAPH},
            "G-L": {"type": "LandNet", "config": {
                "hidden_dims": [8, 8], "use_positional_embedding": True}}},
        query=(512, 4))
    none = {c.__name__: 0 for c in counters}
    assert out == {"G-R": none, "G-E": none, "G-L": none}
    text = capsys.readouterr().out
    for line in ("equal to the brute force in order: True",
                 "equal to the brute force on cpu: 512 of 512",
                 "reference G (GraphCast, no mask): cpu vs CPU",
                 "equal bit for bit: True; zeros off the mask: True",
                 "reference G (FloeNet step): cpu vs CPU: rollout error 0",
                 "resumed state against the first run's end",
                 "path G-R: build_graphs [",
                 "'XPRTc': True}", "path G-L: builder", "2 batches at"):
        assert line in text, line


def test_recipes_keep_their_sources_but_for_their_cuts(tmp_path):
    """W-R's config is path R's with the network replaced; G-R's keeps the
    ice test's settings with FloeNet at its defaults and the recipe's
    batch of 2."""
    paths = {k: str(tmp_path / k) for k in (
        "train", "valid", "inference", "centering", "scaling-full-field",
        "scaling-residual", "scaling")}
    swin, _ = chip_smoke._train_config(paths, str(tmp_path))
    config = chip_smoke._swin_config(paths, str(tmp_path))
    assert config["stepper"]["step"]["config"]["builder"] == {
        "type": "NoiseConditionedSwinTransformer", "config": {}}
    for key in ("stepper_training", "optimization", "train_loader",
                "validation_loader", "inference"):
        assert config[key] == swin[key]
    ice = chip_smoke._ice_config(paths, str(tmp_path))
    assert ice["train_loader"]["batch_size"] == chip_smoke.G_BATCH == 2
    step = ice["stepper"]["step"]["config"]
    assert step["builder"] == {"type": "FloeNet", "config": {}}
    assert step["in_names"] == step["out_names"] == list(chip_smoke.G_NAMES)
    assert ice["stepper"]["input_masking"] == {"mask_value": 0,
                                               "fill_value": 0.0}
    assert ice["optimization"] == {"lr": 1e-3, "optimizer_type": "AdamW"}


def test_recipe_networks_have_their_published_sizes():
    """NoiseConditionedSwinTransformer at its builder's defaults on the
    flagship recipe's 38 inputs and 45 outputs at 180x360 has 10,192,629
    parameters (the count ``jax.eval_shape`` gives ``ace_tpu``'s); its
    stages attend over the padded 184x368 grid and 92x184."""
    from ace_tpu_torch.core.coordinates import LatLonCoordinates
    from ace_tpu_torch.core.dataset_info import DatasetInfo
    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.models.registry import ModuleSelector

    info = DatasetInfo(horizontal_coordinates=LatLonCoordinates(
        np.linspace(-89.5, 89.5, 180), np.arange(360.0)))
    step = chip_smoke._yaml(chip_smoke.TRAIN_CONFIG)["stepper"]["step"][
        "config"]
    n_in, n_out = len(step["in_names"]), len(step["out_names"])
    assert (n_in, n_out) == (38, 45)
    with torch.device("meta"):
        net = from_dict(ModuleSelector, chip_smoke.W_BUILDER).build(
            n_in, n_out, info)
    assert sum(p.numel() for p in net.parameters()) == 10_192_629
    assert net.layer1.blocks_0.input_resolution == (184, 368)
    assert net.layer2.blocks_0.input_resolution == (92, 184)


def test_operation_counts_of_the_recipe_networks():
    """``profile_flagship``'s counts, which PERF.md's predictions use: the
    Swin's 0.5586 TFLOP a sample-step forward (1.5077 with the backward);
    FloeNet's graphs on the 1° grid at meshes 6 (280,212, 322,560 and
    194,400 edges) and its 1.0656 TFLOP a sample-step forward."""
    from ace_tpu_torch import profile_flagship as pf
    from ace_tpu_torch.models import graphcast

    fwd, both = pf.swin_flop()
    assert (round(fwd / 1e12, 4), round(both / 1e12, 4)) == (0.5586, 1.5077)
    coords, _, _, _ = chip_smoke.ocean_grid_and_masks(180, 360)
    lat2d, lon2d = np.meshgrid(coords["lat"], coords["lon"], indexing="ij")
    graphs = graphcast.build_graphs(lat2d, lon2d)
    assert (len(graphs.g2m_senders), len(graphs.m2m_senders),
            len(graphs.m2g_senders)) == (280_212, 322_560, 194_400)
    fwd, shared = pf.graphcast_flop(graphs)
    assert (round(fwd / 1e12, 4), round(shared / 1e12, 4)) == (1.0656,
                                                                0.1116)


def test_profile_runners_and_families_on_the_cpu():
    """``profile_flagship --swin`` and ``--graphcast``'s runners at 16x32
    with small networks: a train step gives a finite loss, a rollout
    window finite outputs (NaN on land for the ice recipe); the family
    tables name the Swin's softmax and layer norms and GraphCast's
    gathers and segment sums."""
    from ace_tpu_torch import profile_flagship as pf

    train, rollout = pf._swin_runners("cpu", 16, 32, SMALL_SWIN)
    assert type(rollout.stepper.module).__name__ == "SwinTransformerNet"
    assert np.isfinite(float(train(1)[0]["loss"]))
    out = rollout(1)
    assert all(torch.isfinite(v).all() for v in out.values())
    train, rollout = pf._graphcast_runners("cpu", 16, 32, SMALL_GRAPH)
    assert np.isfinite(float(train(1)[0]["loss"]))
    siconc = rollout(1)["siconc"]
    assert siconc.shape == (1, pf.INFERENCE_STEPS_IN_MEMORY, 16, 32)
    assert torch.isnan(siconc).any() and torch.isfinite(siconc).any()
    for relabel, name, want in (
            (pf.swin_family, "void at::native::softmax_warp_forward", "softmax"),
            (pf.swin_family, "vectorized_layer_norm_kernel", "layer norms"),
            (pf.graphcast_family, "index_elementwise_kernel", "gathers"),
            (pf.graphcast_family, "segment_reduce_forward_kernel",
             "segment sums"),
            (pf.graphcast_family, "sgemm_128x64", None)):
        assert relabel({"name": name}) == want
