"""The port's LocalNet family (``ace_tpu_torch/models/localnet.py``)
against ace_tpu's at 16x32, float32 on both sides, ace_tpu's weights
carried across by ``utils/convert.py`` (the zero-initialized LoRA factors
and noise conditioning drawn so that they show): ``LoRADense`` (rank 0
and 2), ``DiscoFilterLayer``, ``GroupedDiscoFilterLayer``, ``LocalBlock``
(both filter types), ``LocalNet`` (gaussian, isotropic and no noise, the
noise passed in) and ``AnkurLocalNet`` (with and without the DISCO
encoder and the position embedding), each output within 1e-4 of its
channel's spatial anomaly plus 1e-5 of its value; both builders through
``ModuleSelector``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.core import coordinates as jax_coords
from ace_tpu.core.dataset_info import DatasetInfo as JaxDatasetInfo
from ace_tpu.models import localnet as jax_localnet
from ace_tpu.models.registry import ModuleSelector as JaxModuleSelector
from ace_tpu_torch.core import coordinates
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.models import localnet
from ace_tpu_torch.models.registry import ModuleSelector
from ace_tpu_torch.models.layers import init_weights
from ace_tpu_torch.utils.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)

torch.set_num_threads(2)

NLAT, NLON, B, C = 16, 32, 2, 6
OUT_TOL = 1e-4


def _draw(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _assert_close(got, ref, tol=OUT_TOL):
    """``[..., H, W, C]`` within ``tol`` of each channel's largest spatial
    anomaly plus 1e-5 of its largest value."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    spatial = (-3, -2)
    anomaly = np.abs(ref - ref.mean(spatial, keepdims=True)).max(
        spatial, keepdims=True)
    allowed = tol * anomaly + 1e-5 * np.abs(ref).max(spatial, keepdims=True)
    assert (np.abs(got - ref) <= allowed).all(), float(
        (np.abs(got - ref) / allowed).max())


def _perturb(params, seed=1):
    """The zero-initialized leaves (``lora_b``, the noise conditioning)
    drawn at std 0.1 so that they show in the outputs."""
    rng = np.random.RandomState(seed)

    def visit(path, leaf):
        name = "/".join(str(p.key) for p in path)
        if "lora_b" in name or "w_scale_2d" in name or "w_bias_2d" in name:
            return np.asarray(rng.randn(*leaf.shape) * 0.1, np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(visit, params)


def _pair(jmodule, module, inputs, kwargs=None):
    """The port's module with its weights drawn (as flax draws them) and
    perturbed, and its output; ``ace_tpu``'s module on the same tree,
    which must have ``jmodule.init``'s leaves, and its output. Drawing
    them in flax compiles its initializers once per shape."""
    jin = [jnp.asarray(x) for x in inputs]
    init_weights(module, torch.Generator().manual_seed(0))
    params = _perturb({"params": state_dict_to_flax_params(
        module.state_dict())})
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), *jin)
    assert jax.tree_util.tree_map(np.shape, params) == (
        jax.tree_util.tree_map(lambda v: v.shape, dict(shapes)))
    module.load_state_dict(flax_params_to_state_dict(params))
    ref = jax.jit(jmodule.apply)(params, *jin)
    with torch.no_grad():
        got = module(*(torch.from_numpy(x) for x in inputs),
                     **(kwargs or {}))
    return got, ref, params


@pytest.mark.parametrize("rank", [0, 2])
def test_lora_dense_matches_ace_tpu(rank):
    """flax's names ``base``, ``lora_a``, ``lora_b`` (2-D kernels)."""
    x = _draw((B, NLAT, NLON, C))
    got, ref, params = _pair(
        jax_localnet.LoRADense(8, lora_rank=rank, lora_alpha=3.0),
        localnet.LoRADense(C, 8, lora_rank=rank, lora_alpha=3.0), [x])
    _assert_close(got.numpy(), ref)
    want = {"base"} | ({"lora_a", "lora_b"} if rank else set())
    assert set(params["params"]) == want


@pytest.mark.parametrize("basis", ["morlet", "piecewise linear"])
def test_disco_filter_layer_matches_ace_tpu(basis):
    """The weight ``[K, C, C]`` applied before the inverse DFT, at twice
    the cutoff radius, on the Gauss grid."""
    x = _draw((B, NLAT, NLON, C))
    kw = dict(kernel_shape=(3, 3), basis_type=basis,
              data_grid="legendre-gauss")
    got, ref, params = _pair(
        jax_localnet.DiscoFilterLayer(img_shape=(NLAT, NLON), channels=C,
                                      **kw),
        localnet.DiscoFilterLayer((NLAT, NLON), C, **kw), [x])
    _assert_close(got.numpy(), ref)
    assert params["params"]["weight"].ndim == 3


def test_disco_filter_layer_keeps_a_bf16_input_dtype():
    """DISCO computes in float32 and casts back to the input's dtype."""
    layer = localnet.DiscoFilterLayer((NLAT, NLON), C)
    layer.weight.data.normal_()
    x = torch.from_numpy(_draw((B, NLAT, NLON, C))).to(torch.bfloat16)
    out = layer(x)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, layer(x.float()).to(torch.bfloat16))


def test_grouped_disco_filter_layer_matches_ace_tpu():
    """``gcd(in, out)`` groups, the single cutoff radius."""
    x = _draw((B, NLAT, NLON, 4))
    got, ref, params = _pair(
        jax_localnet.GroupedDiscoFilterLayer(img_shape=(NLAT, NLON),
                                             in_chans=4, out_chans=6),
        localnet.GroupedDiscoFilterLayer((NLAT, NLON), 4, 6), [x])
    _assert_close(got.numpy(), ref)
    assert params["params"]["weight"].shape[1] == 2


@pytest.mark.parametrize("filter_type", ["disco", "conv1x1"])
def test_local_block_matches_ace_tpu(filter_type):
    """Both filters, LoRA rank 2 and the noise."""
    x, noise = _draw((B, NLAT, NLON, C)), _draw((B, NLAT, NLON, 3), 1)
    kw = dict(embed_dim=C, embed_dim_noise=3, filter_type=filter_type,
              lora_rank=2)
    got, ref, _ = _pair(
        jax_localnet.LocalBlock(img_shape=(NLAT, NLON), **kw),
        localnet.LocalBlock((NLAT, NLON), **kw), [x, noise])
    _assert_close(got.numpy(), ref)


def _patch_noise(monkeypatch, noise):
    monkeypatch.setattr(jax_localnet.LocalNet, "_make_noise",
                        lambda self, batch: jnp.asarray(noise))


@pytest.mark.parametrize("noise_type,noise_dim", [
    ("gaussian", 4), ("isotropic", 4), ("gaussian", 0)],
    ids=["gaussian", "isotropic", "no-noise"])
def test_local_net_matches_ace_tpu(monkeypatch, noise_type, noise_dim):
    """Both block types with LoRA rank 2 and the global layer norm; the
    noise passed in (the port's isotropic draw is its own
    ``isotropic_noise``); without noise channels there is none."""
    x = _draw((B, NLAT, NLON, 3))
    noise = _draw((B, NLAT, NLON, noise_dim), 2) if noise_dim else None
    if noise is not None:
        _patch_noise(monkeypatch, noise)
    kw = dict(in_chans=3, out_chans=2, embed_dim=8,
              noise_embed_dim=noise_dim, noise_type=noise_type,
              block_types=("disco", "conv1x1"), lora_rank=2,
              global_layer_norm=noise_type == "isotropic")
    module = localnet.LocalNet((NLAT, NLON), **kw)
    got, ref, _ = _pair(
        jax_localnet.LocalNet(img_shape=(NLAT, NLON), **kw), module, [x],
        kwargs={"noise": None if noise is None else torch.from_numpy(noise)})
    _assert_close(got.numpy(), ref)
    assert not hasattr(module, "n_labels")
    if noise_dim:
        drawn = module.make_noise(B, torch.Generator().manual_seed(0))
        assert drawn.shape == (B, NLAT, NLON, noise_dim)
        assert torch.equal(module.make_noise(B, None),
                           torch.zeros_like(drawn))
    else:
        assert module.make_noise(B, torch.Generator()) is None


@pytest.mark.parametrize("disco,pos_embed", [(True, True), (False, False)])
def test_ankur_local_net_matches_ace_tpu(disco, pos_embed):
    x = _draw((B, NLAT, NLON, 3))
    kw = dict(in_chans=3, out_chans=2, embed_dim=6,
              use_disco_encoder=disco, pos_embed=pos_embed)
    got, ref, params = _pair(
        jax_localnet.AnkurLocalNet(img_shape=(NLAT, NLON), **kw),
        localnet.AnkurLocalNet((NLAT, NLON), **kw), [x])
    _assert_close(got.numpy(), ref)
    assert ("disco_encoder" in params["params"]) == disco


@pytest.mark.parametrize("builder", [
    {"type": "LocalNet", "config": {"embed_dim": 8, "noise_embed_dim": 0,
                                    "block_types": ["disco", "conv1x1"]}},
    {"type": "AnkurLocalNet", "config": {"embed_dim": 6}},
], ids=["LocalNet", "AnkurLocalNet"])
def test_builders_through_module_selector(builder):
    """Both builders keep ace_tpu's fields and defaults and take the data
    grid from the dataset: the port's network holds ace_tpu's parameter
    tree (names and shapes through the converter)."""
    lat = jax_coords.gaussian_latitudes(NLAT)
    lon = np.linspace(0, 360, NLON, endpoint=False)
    jinfo = JaxDatasetInfo(horizontal_coordinates=(
        jax_coords.LatLonCoordinates(lat=lat, lon=lon)))
    info = DatasetInfo(horizontal_coordinates=(
        coordinates.LatLonCoordinates(lat=lat, lon=lon)))
    jsel, sel = JaxModuleSelector(**builder), ModuleSelector(**builder)
    assert sel.get_state() == jsel.get_state()
    jmodule = jsel.build(3, 2, jinfo)
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, NLAT, NLON, 3)))
    zeros = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), shapes)
    module = sel.build(3, 2, info, device="cpu")
    want = {k: tuple(v.shape)
            for k, v in flax_params_to_state_dict(zeros).items()}
    assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == want
    assert jmodule.data_grid == "legendre-gauss"
