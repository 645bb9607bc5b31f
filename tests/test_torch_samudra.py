"""The port's Samudra (``ace_tpu_torch/models/samudra.py``) against
``ace_tpu/models/samudra.py`` at small sizes, float32 on both sides:
padding, bilinear upsampling (both modes, odd shapes), the ConvNeXt
block, the network through both registries (outputs within 1e-5 of their
largest value), its longitude periodicity, the gradients against
``jax.grad`` (1e-4 of each gradient's norm) and the convolution kernels'
round trip through flax's ``[kh, kw, in, out]`` layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.core.config import from_dict as jax_from_dict
from ace_tpu.core.dataset_info import DatasetInfo as JaxDatasetInfo
from ace_tpu.core.coordinates import LatLonCoordinates as JaxLatLon
from ace_tpu.models import samudra as jax_samudra
from ace_tpu.models.registry import ModuleSelector as JaxModuleSelector
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.coordinates import LatLonCoordinates
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.models import samudra
from ace_tpu_torch.models.registry import ModuleSelector
from ace_tpu_torch.utils.convert import (
    flax_name,
    flax_params_to_state_dict,
    flax_view,
    state_dict_to_flax_params,
)

torch.set_num_threads(2)

# widths 16-32 over 3 levels (a 2x4 bottleneck at 16x32). With 4 levels
# the bottleneck of 16x32 is 1x2, where an instance norm over 2 cells
# turns float32 rounding into 2e-5 of the outputs on either side: the
# 4-level case runs at 32x64
BUILDER = {"ch_width": [16, 24, 32], "dilation": [1, 2, 2],
           "n_layers": [1, 1, 1], "norm": "instance"}
FOUR_LEVELS = {"ch_width": [16, 20, 24, 32], "dilation": [1, 2, 4, 4],
               "n_layers": [1, 1, 1, 1]}
OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def _draw(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("pad", [0, 1, 3])
def test_padding_matches_ace_tpu(pad):
    """Circular along longitude, zeros along latitude."""
    x = _draw((2, 5, 7, 3))
    ref = np.asarray(jax_samudra.pad_lon_circular_lat_zero(jnp.asarray(x),
                                                           pad))
    got = _nhwc(samudra.pad_lon_circular_lat_zero(_nchw(x), pad))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [(11, 22), (5, 9), (1, 2)])
@pytest.mark.parametrize("zonally_periodic", [False, True])
def test_bilinear_upsample_matches_jax_image_resize(shape, zonally_periodic):
    """``F.interpolate(align_corners=False)`` against ``jax.image.resize``
    at a factor of 2, edges included (clamping equals renormalizing
    there), with and without the periodic seam: within 1e-6."""
    x = _draw((2, *shape, 3))
    ref = np.asarray(jax_samudra.bilinear_upsample(
        jnp.asarray(x), zonally_periodic=zonally_periodic))
    got = _nhwc(samudra.bilinear_upsample(_nchw(x),
                                          zonally_periodic=zonally_periodic))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_capped_gelu_matches_ace_tpu():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(
        samudra.capped_gelu(torch.from_numpy(x)).numpy(),
        np.asarray(jax_samudra.capped_gelu(jnp.asarray(x))), atol=1e-6)


def _flax_shapes(jmodule, x):
    """The leaves' shapes of ``jmodule.init``'s tree, traced only."""
    return jax.tree_util.tree_map(
        lambda v: tuple(v.shape),
        dict(jax.eval_shape(jmodule.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))))


def _flax_params(jmodule, module, x):
    """``module``'s initial weights (the port draws them as flax does) as
    ``ace_tpu``'s tree, which must have ``jmodule.init``'s leaves (names
    and shapes). Drawing them in flax compiles its initializers once per
    shape: 50 of this file's 100 s on XLA:CPU."""
    params = {"params": state_dict_to_flax_params(module.state_dict())}
    assert jax.tree_util.tree_map(lambda v: tuple(v.shape), params) == (
        _flax_shapes(jmodule, x))
    return params


def _apply(module, params, x):
    return np.asarray(jax.jit(module.apply)(params, jnp.asarray(x)))


@pytest.mark.parametrize("norm", ["instance", "layer", None])
@pytest.mark.parametrize("c_in, c_out, dilation", [(6, 6, 1), (6, 10, 2)])
def test_convnext_block_matches_ace_tpu(norm, c_in, c_out, dilation):
    """A block with and without its skip convolution, each norm."""
    x = _draw((2, 9, 13, c_in))
    jblock = jax_samudra.ConvNeXtBlock(out_channels=c_out, dilation=dilation,
                                       norm=norm)
    block = samudra.ConvNeXtBlock(c_in, c_out, dilation=dilation, norm=norm)
    ref = _apply(jblock, _flax_params(jblock, block, x), x)
    got = _nhwc(block(_nchw(x)))
    assert np.abs(got - ref).max() <= OUT_TOL * np.abs(ref).max()


def _modules(nlat=16, nlon=32, n_in=7, n_out=5, **builder):
    """Both packages' Samudra of ``BUILDER`` updated by ``builder``,
    ``ace_tpu``'s tree of the port's initial weights, and an input; made
    once per configuration (the JAX side's compiles dominate the file)."""
    key = (nlat, nlon, n_in, n_out, repr(sorted(builder.items())))
    if key not in _MODULES:
        _MODULES[key] = _build_modules(nlat, nlon, n_in, n_out, builder)
    return _MODULES[key]


_MODULES: dict = {}


def _build_modules(nlat, nlon, n_in, n_out, builder):
    config = {"type": "Samudra", "config": {**BUILDER, **builder}}
    jinfo = JaxDatasetInfo(horizontal_coordinates=JaxLatLon(
        lat=np.linspace(-80, 80, nlat), lon=np.linspace(0, 360, nlon)))
    info = DatasetInfo(horizontal_coordinates=LatLonCoordinates(
        lat=np.linspace(-80, 80, nlat), lon=np.linspace(0, 360, nlon)))
    jmodule = jax_from_dict(JaxModuleSelector, config).build(n_in, n_out,
                                                             jinfo)
    module = from_dict(ModuleSelector, config).build(n_in, n_out, info,
                                                     device="cpu")
    x = _draw((2, nlat, nlon, n_in), seed=1)
    return jmodule, module, _flax_params(jmodule, module, x), x


@pytest.mark.parametrize("builder, shape", [
    ({}, (16, 32)),
    ({"zonally_periodic_upsample": True}, (16, 32)),
    (FOUR_LEVELS, (32, 64)),
    ({"ch_width": [8, 12], "dilation": [1, 2]}, (22, 45)),
], ids=["16x32", "16x32-periodic", "32x64-4-levels", "22x45"])
def test_samudra_through_the_registry_matches_ace_tpu(builder, shape):
    """``{"type": "Samudra"}`` builds in both registries with the same
    fields; the outputs agree within 1e-5 of their largest value, at
    16x32 and at an odd 22x45 (each decoder level padded to its skip's
    shape, the last block at the reference's left-over dilation)."""
    jmodule, module, params, x = _modules(*shape, **builder)
    ref = _apply(jmodule, params, x)
    got = module(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= OUT_TOL * np.abs(ref).max()


def test_samudra_is_periodic_in_longitude():
    """Rolling the input along longitude by a multiple of the coarsest
    level's cell rolls the output: the circular pads leave no seam."""
    _, module, _, x = _modules(zonally_periodic_upsample=True)
    shift = 8  # 2**3 grid cells: a whole cell of the coarsest level
    out = module(torch.from_numpy(x)).detach()
    rolled = module(torch.from_numpy(np.roll(x, shift, axis=2))).detach()
    torch.testing.assert_close(rolled, torch.roll(out, shift, dims=2),
                               rtol=0, atol=1e-5 * float(out.abs().max()))


def test_samudra_gradients_match_jax_grad():
    """The gradient of a mean-square error of the outputs with respect
    to every weight against ``jax.grad``, in flax's layout: within 1e-4
    of each gradient's norm, but the wide convolutions' biases, whose
    true gradient is zero (the instance norm after each removes it):
    those within 1e-4 of the largest gradient's norm on both sides."""
    jmodule, module, params, x = _modules()
    target = _draw((2, 16, 32, 5), seed=2)

    def loss(p):
        return jnp.mean((jmodule.apply(p, jnp.asarray(x)) - target) ** 2)

    jgrads = flax_params_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss))(params)))
    module.zero_grad()
    out = module(torch.from_numpy(x))
    ((out - torch.from_numpy(target)) ** 2).mean().backward()
    largest = max(np.linalg.norm(g) for g in jgrads.values())
    for name, p in module.named_parameters():
        ref = jgrads[name].double().numpy()
        got = p.grad.double().numpy()
        if name.endswith((".conv1.bias", ".conv2.bias")):
            assert max(np.linalg.norm(ref), np.linalg.norm(got)) <= (
                GRAD_TOL * largest), name
        else:
            assert np.linalg.norm(got - ref) <= GRAD_TOL * np.linalg.norm(
                ref), name


def test_convolution_weights_round_trip_through_flax_layout():
    """A flax ``Conv`` kernel ``[kh, kw, in, out]`` becomes the port's
    ``kernel`` in ``F.conv2d``'s ``[out, in, kh, kw]`` and back, bit for
    bit; ``flax_name`` and ``flax_view`` give the leaf's flax name and
    layout (what fine-tuning's rules and the optimizer's moments read).
    The flax tree is drawn apart from the port, in ``ace_tpu``'s leaf
    shapes."""
    jmodule, module, _, x = _build_modules(16, 32, 7, 5, {})
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda shape: rng.standard_normal(shape).astype(np.float32),
        _flax_shapes(jmodule, x), is_leaf=lambda v: isinstance(v, tuple))
    module.load_state_dict(flax_params_to_state_dict(params))
    back = state_dict_to_flax_params(module.state_dict())
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)
    kernel = module.down_0.conv1.kernel
    assert kernel.shape == (28, 7, 3, 3)  # 4 x 7 hidden channels
    assert flax_name("down_0.conv1.kernel", kernel) == (
        "params/down_0/conv1/kernel")
    np.testing.assert_array_equal(
        flax_view("down_0.conv1.kernel", kernel).detach().numpy(),
        params["params"]["down_0"]["conv1"]["kernel"])
