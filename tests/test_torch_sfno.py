"""The port's SphericalFourierNeuralOperatorNet against ace_tpu's on shared
weights, over its options in float32 and bfloat16, with its gradients;
the builders and the converter's rules for the new leaves
(tests/test_torch_sfno_layers.py holds the layers, the spectral
convolution and the FFT pair). Inputs are drawn with numpy from seeds;
where bfloat16 meets a dhconv filter at width 128, the JAX side runs its
Pallas filter in the interpreter, as tests/test_torch_models.py does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.models import registry as jax_registry
from ace_tpu.models.sfno import (
    SphericalFourierNeuralOperatorNet as JaxSFNO,
)
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.coordinates import LatLonCoordinates
from ace_tpu_torch.models import layers, registry
from ace_tpu_torch.models.sfno import (
    SpectralConvS2,
    SphericalFourierNeuralOperatorNet,
)
from ace_tpu_torch.ops import sht
from ace_tpu_torch.utils.convert import (
    flax_name,
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)

torch.set_num_threads(2)

NLAT, NLON = 16, 32
# float32 on both sides, sums in another order: 1e-5 of the largest
# output (at most 5.3e-7 measured over the network's options)
F32_TOL = 1e-5
# bfloat16: the two frameworks round at other points (and below width 128
# JAX's einsum filter returns float32 where the port's filter rounds its
# outputs to bf16, one more rounding): 2e-2 of the largest output, as
# tests/test_torch_models.py holds the conditional SFNO
BF16_TOL = 2e-2


def _close(out, ref, tol):
    out = out.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=tol * float(np.max(np.abs(ref))))


def _shapes(net_j, x):
    """The leaves' shapes of ``net_j.init``'s tree, traced only."""
    return jax.tree_util.tree_map(
        lambda v: v.shape,
        dict(jax.eval_shape(net_j.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))))


def _port_params(net_j, net, x):
    """``net``'s initial weights (the port draws them as flax does; flax's
    initializers compile once per shape) as ``ace_tpu``'s tree, which must
    have ``net_j.init``'s leaves, ``_perturb``ed."""
    layers.init_weights(net, torch.Generator().manual_seed(0))
    params = {"params": state_dict_to_flax_params(net.state_dict())}
    assert jax.tree_util.tree_map(np.shape, params) == _shapes(net_j, x)
    return _perturb(params)


def _perturb(params, seed=1):
    """Random values where flax starts at zeros or ones (biases, norm
    scales) and spectral weights large enough to show in the outputs."""
    rng = np.random.RandomState(seed)

    def visit(path, leaf):
        name = "/".join(str(p.key) for p in path)
        if leaf.ndim <= 1 or "norm" in name:
            return jnp.asarray(leaf + 0.1 * rng.randn(*leaf.shape),
                               leaf.dtype)
        if "filter/" in name or name.endswith("/weight") or "cp_factor" in name:
            return jnp.asarray(rng.randn(*leaf.shape) * 0.3, leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(visit, params)


def _x(c, seed=0, shape=(2, NLAT, NLON)):
    return np.random.RandomState(seed).randn(*shape, c).astype(np.float32)


# --- the network --------------------------------------------------------

NET_CASES = {
    "direct": {},
    "frequency": {"pos_embed": "frequency"},
    "no_pos_embed": {"pos_embed": "none"},
    "residual_filter_factor": {"residual_filter_factor": 2},
    "scale_factor": {"scale_factor": 2},
    "encoder_layers": {"encoder_layers": 2},
    "repeat_layers": {"repeat_layers": 2},
    "fft": {"spectral_transform": "fft"},
    "equiangular": {"data_grid": "equiangular"},
    "layer_norm": {"normalization_layer": "layer_norm"},
    "no_norm": {"normalization_layer": "none"},
    "diagonal": {"operator_type": "diagonal"},
    "bf16_dhconv": {"dtype": "bfloat16"},
    "bf16_diagonal": {"dtype": "bfloat16", "operator_type": "diagonal"},
}


def _nets(extra, embed=None):
    extra = dict(extra)
    dtype = extra.pop("dtype", "float32")
    op = extra.setdefault("operator_type", "dhconv")
    if embed is None:
        embed = 128 if dtype == "bfloat16" and op == "dhconv" else 32
    kw = dict(img_shape=(NLAT, NLON), in_chans=5, out_chans=4,
              embed_dim=embed, num_layers=2, **extra)
    net_j = JaxSFNO(dtype=jnp.dtype(dtype), **kw)
    net = SphericalFourierNeuralOperatorNet(
        dtype=getattr(torch, dtype), device="cpu", **kw)
    return net_j, net, dtype


@pytest.mark.parametrize("name", sorted(NET_CASES))
def test_sfno_matches_ace_tpu(name, monkeypatch):
    """The network's forward over each option, both packages on the same
    weights (the port's, ``_port_params``): f32 within ``F32_TOL``, bf16
    within ``BF16_TOL`` of the largest output."""
    net_j, net, dtype = _nets(NET_CASES[name])
    if dtype == "bfloat16":
        monkeypatch.setenv("ACE_TPU_PALLAS_FILTER", "interpret")
    x = _x(5)
    params = _port_params(net_j, net, x)
    # bf16 compiled once as a whole (faster here than op by op)
    jit = jax.jit if dtype == "bfloat16" else (lambda f: f)
    ref = jit(net_j.apply)(params, jnp.asarray(x))
    net.load_state_dict(flax_params_to_state_dict(params))
    with torch.inference_mode():
        out = net(torch.from_numpy(x))
    assert out.dtype == torch.float32
    _close(out, ref, F32_TOL if dtype == "float32" else BF16_TOL)


def _grads(net, x, w, **kw):
    net.zero_grad()
    out = net(x, **kw)
    (out * w).sum().backward()
    return {k: p.grad.detach().clone() for k, p in net.named_parameters()}


# the frequency embedding, a diagonal filter and layer norms, so that
# those leaves get gradients (and the converter's rules a test) too
GRAD_CASE = {"pos_embed": "frequency", "operator_type": "diagonal",
             "normalization_layer": "layer_norm"}


def test_sfno_gradients_match_jax_grad():
    """Every parameter's gradient of ``sum(out * w)`` against ``jax.grad``
    (float32, ``GRAD_CASE``), within 1e-4 relative L2 in flax's layout,
    plus 1e-6 of the largest gradient's norm: the first block's output
    bias (``block_0/mlp/fc2/bias``) adds a per-channel constant that the
    next block's instance norm removes, so its true gradient is zero and
    both sides hold rounding (2.4e-7 of norm 2.4e-7 measured)."""
    net_j, net, _ = _nets(GRAD_CASE)
    x = _x(5)
    w = np.random.RandomState(3).randn(2, NLAT, NLON, 4).astype(np.float32)
    params = _port_params(net_j, net, x)
    ref = jax.jit(jax.grad(
        lambda p: jnp.sum(net_j.apply(p, jnp.asarray(x)) * w)))(
        params)["params"]
    net.load_state_dict(flax_params_to_state_dict(params))
    grads = state_dict_to_flax_params(
        _grads(net, torch.from_numpy(x), torch.from_numpy(w)))
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    flat = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    assert set(flat) == set(flat_ref)
    largest = max(np.linalg.norm(np.asarray(r, np.float64))
                  for r in flat_ref.values())
    for k, r in flat_ref.items():
        r = np.asarray(r, np.float64)
        err = np.linalg.norm(np.asarray(flat[k], np.float64) - r)
        assert err <= 1e-4 * np.linalg.norm(r) + 1e-6 * largest, (k, err)


def test_checkpointing_gives_the_same_gradients_with_dropout():
    """``checkpointing 1`` (per-block recompute) gives the gradients of
    ``checkpointing 0`` (within 1e-6 relative L2: the same arithmetic)
    with dropout and drop-path on, both drawing from a generator seeded
    alike: the recompute replays the generator's draws. Without the
    replay the recomputed masks would differ (checked: they do)."""
    kw = dict(img_shape=(NLAT, NLON), in_chans=5, out_chans=4, embed_dim=16,
              num_layers=3, operator_type="dhconv", drop_rate=0.2,
              drop_path_rate=0.5, device="cpu")
    x, w = torch.from_numpy(_x(5)), torch.randn(2, NLAT, NLON, 4)
    out = {}
    for level in (0, 1):
        net = SphericalFourierNeuralOperatorNet(checkpointing=level, **kw)
        layers.init_weights(net, torch.Generator().manual_seed(0))
        out[level] = _grads(net, x, w, deterministic=False,
                            generator=torch.Generator().manual_seed(7))
    for k, g in out[0].items():
        assert float((out[1][k] - g).norm()) <= 1e-6 * float(g.norm()), k
    gen = torch.Generator().manual_seed(7)
    a = layers.dropout(x, 0.5, False, gen)
    assert not torch.equal(layers.dropout(x, 0.5, False, gen), a)


# --- builders -----------------------------------------------------------

BUILDERS = ["SphericalFourierNeuralOperatorNet", "SFNO-v0.1.0", "MLP",
            "Linear", "prebuilt"]


def _fields(cls):
    return {f.name: (f.default if f.default is not dataclasses.MISSING
                     else f.default_factory())
            for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", BUILDERS)
def test_builder_fields_and_defaults_equal_ace_tpu(name):
    """Each builder has ``ace_tpu``'s fields with equal defaults, field
    by field."""
    jax_cls = jax_registry.ModuleSelector.get_registry()._types[name]
    cls = registry.ModuleSelector.get_registry()._types[name]
    assert _fields(cls) == _fields(jax_cls)


def _info():
    return DatasetInfo(horizontal_coordinates=LatLonCoordinates(
        lat=np.linspace(-80, 80, NLAT),
        lon=np.linspace(0, 360, NLON, endpoint=False)))


@pytest.mark.parametrize("name, config", [
    ("SphericalFourierNeuralOperatorNet",
     {"embed_dim": 32, "num_layers": 2, "operator_type": "dhconv",
      "data_grid": "equiangular"}),
    ("SFNO-v0.1.0", {"embed_dim": 32, "num_layers": 1, "scale_factor": 2,
                     "repeat_layers": 2, "factorization": "cp",
                     "rank": 0.5}),
    ("MLP", {"hidden_channels": 8, "num_hidden_layers": 2}),
    ("Linear", {}),
])
def test_builders_build_what_ace_tpu_builds(name, config):
    """From one ``{type, config}`` dict each package builds its module;
    on ``ace_tpu``'s weights the port's computes the same outputs
    (``F32_TOL``). ``filter_type`` other than linear raises in both."""
    from ace_tpu.core.dataset_info import DatasetInfo as JaxDatasetInfo
    from ace_tpu.core.coordinates import LatLonCoordinates as JaxLatLon

    lat = np.linspace(-80, 80, NLAT)
    lon = np.linspace(0, 360, NLON, endpoint=False)
    info_j = JaxDatasetInfo(horizontal_coordinates=JaxLatLon(lat=lat,
                                                             lon=lon))
    info = DatasetInfo(horizontal_coordinates=LatLonCoordinates(lat=lat,
                                                                lon=lon))
    selector = {"type": name, "config": config}
    net_j = jax_registry.ModuleSelector(**selector).build(5, 4, info_j)
    net = registry.ModuleSelector(**selector).build(5, 4, info,
                                                    device="cpu")
    x = _x(5)
    params = _port_params(net_j, net, x)
    net.load_state_dict(flax_params_to_state_dict(params))
    with torch.inference_mode():
        _close(net(torch.from_numpy(x)), net_j.apply(params, jnp.asarray(x)),
               F32_TOL)
    if "SFNO" in name or "Spherical" in name:
        bad = {"type": name, "config": {**config, "filter_type": "local"}}
        if name == "SphericalFourierNeuralOperatorNet":
            with pytest.raises(NotImplementedError):
                jax_registry.ModuleSelector(**bad).build(5, 4, info_j)
            with pytest.raises(NotImplementedError):
                registry.ModuleSelector(**bad).build(5, 4, info)


def test_prebuilt_and_conditional_selection():
    """``prebuilt`` returns the registered module (moved to the device);
    ``conditional: true`` on a builder that takes no labels raises, as in
    ace_tpu."""
    module = registry.LinearModule(5, 4)
    registry.register_prebuilt_module("test_key", module)
    built = registry.ModuleSelector(
        type="prebuilt", config={"module_key": "test_key"}
    ).build(5, 4, _info(), device="cpu")
    assert built is module
    with pytest.raises(ValueError, match="conditional builder"):
        registry.ModuleSelector(type="SphericalFourierNeuralOperatorNet",
                                config={}, conditional=True)


def test_default_initialization_matches_flax_statistics():
    """The port's draws follow flax's initializers: the spectral weight
    normal at 1/(in*out), CP factors at (1/(in*out))^(1/n), norms at
    ones and zeros, Linear's default (lecun normal) at 1/sqrt(fan_in)."""
    net = SphericalFourierNeuralOperatorNet(
        (NLAT, NLON), 5, 4, embed_dim=32, num_layers=1,
        operator_type="diagonal", device="cpu")
    layers.init_weights(net, torch.Generator().manual_seed(0))
    w = net.block_0.filter.weight.detach()
    assert abs(float(w.std()) * 32 * 32 - 1) < 0.05
    assert torch.equal(net.block_0.norm0.scale, torch.ones(32))
    lin = registry.LinearModule(400, 300)
    lin.linear.reset_parameters(torch.Generator().manual_seed(0))
    assert abs(float(lin.linear.weight.detach().std()) * 20 - 1) < 0.05
    conv = SpectralConvS2(sht.RealSHT(NLAT, NLON), sht.InverseRealSHT(
        NLAT, NLON), 32, 32, factorization="cp", rank=0.5)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    std = (1 / (32 * 32)) ** (1 / 3)
    assert abs(float(conv.cp_factor_0.detach().std()) / std - 1) < 0.1


# --- the converter --------------------------------------------------------


def test_converter_maps_the_new_leaves_both_ways():
    """The diagonal weight (5-D, flax ``[in, out, l, m, 2]``) becomes the
    port's ``[2, l, m, in, out]`` and back; the frequency embedding (4-D,
    not a filter), CP factors (3-D) and LayerNorm2d's ``[H, W, 1]``
    leaves keep their layout; ``flax_name`` names every leaf as the flax
    tree does."""
    net_j, net, _ = _nets(GRAD_CASE)
    # drawn apart from either package's initialization, in ace_tpu's
    # leaf shapes: only the layout is under test
    rng = np.random.default_rng(4)
    params = _perturb(jax.tree_util.tree_map(
        lambda shape: rng.standard_normal(shape).astype(np.float32),
        _shapes(net_j, _x(5)), is_leaf=lambda v: isinstance(v, tuple)))
    state = flax_params_to_state_dict(params)
    w = np.asarray(params["params"]["block_0"]["filter"]["weight"])
    assert w.ndim == 5
    np.testing.assert_array_equal(state["block_0.filter.weight"].numpy(),
                                  w.transpose(4, 2, 3, 0, 1))
    np.testing.assert_array_equal(state["pos_embed_r"].numpy(),
                                  np.asarray(params["params"]["pos_embed_r"]))
    assert state["block_0.norm0.scale"].shape == (NLAT, NLON, 1)
    back = state_dict_to_flax_params(state)
    flat = dict(jax.tree_util.tree_flatten_with_path(params["params"])[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(flat) == set(flat_back)
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[k]), v)
    names = {flax_name(k, v) for k, v in state.items()}
    assert names == {"params/" + "/".join(p.key for p in k) for k in flat}
    net.load_state_dict(state)
    factors = {f"cp_factor_{i}": np.random.RandomState(i).randn(d, 3, 2)
               .astype(np.float32) for i, d in enumerate((8, 8, 16))}
    cp = flax_params_to_state_dict({"block_0": {"filter": factors}})
    for name, value in factors.items():
        np.testing.assert_array_equal(
            cp[f"block_0.filter.{name}"].numpy(), value)
    assert state_dict_to_flax_params(cp)["block_0"]["filter"].keys() == (
        factors.keys())
