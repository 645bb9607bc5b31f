"""The port's HEALPix network (``ace_tpu_torch/models/healpix.py``) against
``ace_tpu/models/healpix.py`` at small sizes (nside 4-8, widths up to
32), float32 on both sides: the neighbour pad bit for bit at p = 1-3,
the capped GELU, each block type on the same weights (outputs within
1e-5 of their largest value), the configs' ``block_type``
parsing, ``HEALPixUNet`` through both registries at the defaults'
structure and with every block type, its gradients against ``jax.grad``
(1e-4 of each gradient's norm) and the builder's refusal of labels."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.core.config import from_dict as jax_from_dict
from ace_tpu.core.coordinates import HEALPixCoordinates as JaxHEALPix
from ace_tpu.core.dataset_info import DatasetInfo as JaxDatasetInfo
from ace_tpu.models import healpix as jax_healpix
from ace_tpu.models.registry import ModuleSelector as JaxModuleSelector
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.coordinates import HEALPixCoordinates
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.models import healpix
from ace_tpu_torch.models.registry import ModuleSelector
from ace_tpu_torch.utils.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)

torch.set_num_threads(2)

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
CAPPED = {"cap_value": 10}


def _draw(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(autouse=True, scope="module")
def _compiled_jax_pad():
    """``ace_tpu``'s networks run eagerly here, with its pad compiled once
    per shape: XLA:CPU takes 10-25 s to compile a UNet with its pads
    unrolled in it, and the pad's hundreds of small ops are slow one by
    one. The pad only moves values and averages pairs, so compiled or
    not it gives the same bits."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_healpix, "healpix_pad",
                   jax.jit(jax_healpix.healpix_pad, static_argnums=1))
        yield


def _flax_params(jmodule, module, x):
    """``module``'s initial weights as ``ace_tpu``'s tree, which must have
    the leaves (names and shapes) of ``jmodule.init``'s. The port draws
    them as flax does; drawing them in flax compiles its initializers once
    per shape, 10 s a block on XLA:CPU."""
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    state = module.state_dict()
    tree = {"params": state_dict_to_flax_params(state)} if state else {}
    assert (jax.tree_util.tree_map(lambda v: tuple(v.shape), tree)
            == jax.tree_util.tree_map(lambda v: tuple(v.shape),
                                      dict(shapes)))
    return tree


def _apply(module, params, x):
    return np.asarray(module.apply(params, jnp.asarray(x)))


def _close(got, ref):
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= OUT_TOL * np.abs(ref).max()


@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("nside", [4, 8])
def test_healpix_pad_equals_ace_tpu_bit_for_bit(p, nside):
    """Every padded face of every batch element equals ``ace_tpu``'s:
    the copies and the corner wedges' averages."""
    x = _draw((2, 12, nside, nside, 3))
    ref = np.asarray(jax_healpix.healpix_pad(jnp.asarray(x), p))
    got = healpix.healpix_pad(torch.from_numpy(x), p).numpy()
    np.testing.assert_array_equal(got, ref)


def test_healpix_pad_of_a_gradient_is_its_transpose():
    """The gather's backward adds each padded cell's gradient into its
    sources, as ``jax.vjp`` of the pad does."""
    x = _draw((1, 12, 4, 4, 2))
    cot = _draw((1, 12, 8, 8, 2), seed=1)
    _, vjp = jax.vjp(lambda v: jax_healpix.healpix_pad(v, 2), jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(cot))
    t = torch.from_numpy(x).requires_grad_()
    healpix.healpix_pad(t, 2).backward(torch.from_numpy(cot))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_capped_gelu_matches_ace_tpu():
    x = np.linspace(-6, 14, 201, dtype=np.float32)
    for cap in (1.0, 10.0):
        np.testing.assert_allclose(
            healpix.capped_gelu(torch.from_numpy(x), cap).numpy(),
            np.asarray(jax_healpix.capped_gelu(jnp.asarray(x), cap)),
            atol=1e-6)


# each block: (the JAX module, the port's module given its input width,
# the input width); nside 8
BLOCKS = {
    "basic": (lambda: jax_healpix.BasicConvBlock(
        out_channels=6, n_layers=2, cap_value=10.0),
        lambda c: healpix.BasicConvBlock(c, 6, n_layers=2, cap_value=10.0),
        5),
    "basic-dilated-1x1": (lambda: jax_healpix.BasicConvBlock(
        out_channels=4, kernel_size=1, dilation=2),
        lambda c: healpix.BasicConvBlock(c, 4, kernel_size=1, dilation=2),
        5),
    "convnext-skip": (lambda: jax_healpix.ConvNeXtBlock(
        out_channels=8, latent_channels=4, cap_value=10.0),
        lambda c: healpix.ConvNeXtBlock(c, 8, latent_channels=4,
                                        cap_value=10.0), 5),
    "convnext-identity-dilated": (lambda: jax_healpix.ConvNeXtBlock(
        out_channels=5, latent_channels=3, dilation=2),
        lambda c: healpix.ConvNeXtBlock(c, 5, latent_channels=3,
                                        dilation=2), 5),
    "symmetric-skip": (lambda: jax_healpix.SymmetricConvNeXtBlock(
        out_channels=6, latent_channels=4, cap_value=10.0),
        lambda c: healpix.SymmetricConvNeXtBlock(c, 6, latent_channels=4,
                                                 cap_value=10.0), 5),
    "symmetric-identity": (lambda: jax_healpix.SymmetricConvNeXtBlock(
        out_channels=5, latent_channels=5),
        lambda c: healpix.SymmetricConvNeXtBlock(c, 5, latent_channels=5),
        5),
    "multi-symmetric": (lambda: jax_healpix.MultiSymmetricConvNeXtBlock(
        out_channels=4, latent_channels=4, n_layers=2, cap_value=10.0),
        lambda c: healpix.MultiSymmetricConvNeXtBlock(
            c, 4, latent_channels=4, n_layers=2, cap_value=10.0), 5),
    "maxpool": (lambda: jax_healpix.MaxPool(),
                lambda c: healpix.MaxPool(), 3),
    "avgpool": (lambda: jax_healpix.AvgPool(),
                lambda c: healpix.AvgPool(), 3),
    "dealiased-4": (lambda: jax_healpix.DealiasedDownsample(stride=4),
                    lambda c: healpix.DealiasedDownsample(c, stride=4), 3),
    "transposed": (lambda: jax_healpix.TransposedConvUpsample(
        out_channels=4, cap_value=10.0),
        lambda c: healpix.TransposedConvUpsample(c, 4, cap_value=10.0), 5),
    "smoothed-nearest": (lambda: jax_healpix.SmoothedInterpolateConv(
        out_channels=4, cap_value=10.0),
        lambda c: healpix.SmoothedInterpolateConv(c, 4, cap_value=10.0), 5),
    "smoothed-bilinear": (lambda: jax_healpix.SmoothedInterpolateConv(
        out_channels=4, mode="bilinear"),
        lambda c: healpix.SmoothedInterpolateConv(c, 4, mode="bilinear"), 5),
    "interpolate-nearest": (lambda: jax_healpix.InterpolateUpsample(),
                            lambda c: healpix.InterpolateUpsample(), 3),
    "interpolate-bilinear": (lambda: jax_healpix.InterpolateUpsample(
        mode="bilinear"),
        lambda c: healpix.InterpolateUpsample(mode="bilinear"), 3),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_each_block_matches_ace_tpu(name):
    """Each block on ``[2, 12, 8, 8, C]`` with the port's initial weights
    in ``ace_tpu``'s tree (``state_dict_to_flax_params``)."""
    make_jax, make, c = BLOCKS[name]
    x = _draw((2, 12, 8, 8, c), seed=1)
    jblock, block = make_jax(), make(c)
    ref = _apply(jblock, _flax_params(jblock, block, x), x)
    _close(block(torch.from_numpy(x)).detach().numpy(), ref)


BLOCK_CONFIGS = [
    ("MaxPool", {"pooling": 2}),
    ("AvgPool", {}),
    ("DealiasedDownsample", {"pooling": 4, "resample_filter": [1, 3, 3, 1]}),
    ("TransposedConvUpsample", {"stride": 2, "activation": CAPPED}),
    ("SmoothedInterpolateConv", {"upsample_mode": "bilinear",
                                 "kernel_size": 1}),
    ("Interpolate", {"upsample_mode": "bilinear"}),
    ("BasicConvBlock", {"kernel_size": 1, "n_layers": 2}),
    ("ConvNeXtBlock", {"upscale_factor": 2, "activation": CAPPED}),
    ("SymmetricConvNeXtBlock", {"kernel_size": 5}),
    ("Multi_SymmetricConvNeXtBlock", {"n_layers": 3}),
]
_FIELDS = {"MaxPool": "down_sampling_block", "AvgPool": "down_sampling_block",
           "DealiasedDownsample": "down_sampling_block"}


@pytest.mark.parametrize("block_type, fields", BLOCK_CONFIGS,
                         ids=[b for b, _ in BLOCK_CONFIGS])
def test_block_type_selects_the_same_config(block_type, fields):
    """``{"block_type": ...}`` picks the same config class, with the same
    fields, in both packages' encoder or decoder config."""
    downsampling = _FIELDS.get(block_type) == "down_sampling_block"
    upsampling = block_type in ("TransposedConvUpsample",
                                "SmoothedInterpolateConv", "Interpolate")
    block = {"block_type": block_type, **fields}
    conv = {"block_type": "BasicConvBlock"}
    if downsampling:
        cls, jcls, d = (healpix.UNetEncoderConfig,
                        jax_healpix.UNetEncoderConfig,
                        {"conv_block": conv, "down_sampling_block": block})
        key = "down_sampling_block"
    elif upsampling:
        cls, jcls, d = (healpix.UNetDecoderConfig,
                        jax_healpix.UNetDecoderConfig,
                        {"conv_block": conv, "up_sampling_block": block,
                         "output_layer": conv})
        key = "up_sampling_block"
    else:
        cls, jcls, d = (healpix.UNetDecoderConfig,
                        jax_healpix.UNetDecoderConfig,
                        {"conv_block": block,
                         "up_sampling_block": {"block_type": "Interpolate"},
                         "output_layer": block})
        key = "conv_block"
    got = getattr(from_dict(cls, d), key)
    ref = getattr(jax_from_dict(jcls, d), key)
    assert type(got).__name__ == type(ref).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def _unet_config(**levels):
    """The builder's config of the defaults' structure (ConvNeXt blocks
    with capped GELU, average pooling, transposed-conv upsampling, a 1x1
    output) at ``levels``' widths."""
    enc = {"conv_block": {"block_type": "ConvNeXtBlock",
                          "activation": CAPPED},
           "down_sampling_block": {"block_type": "AvgPool"},
           "n_channels": levels.get("enc", [16, 8, 4]),
           "n_layers": [2, 2, 1]}
    dec = {"conv_block": {"block_type": "ConvNeXtBlock",
                          "activation": CAPPED},
           "up_sampling_block": {"block_type": "TransposedConvUpsample",
                                 "activation": CAPPED},
           "output_layer": {"block_type": "BasicConvBlock",
                            "kernel_size": 1, "n_layers": 1},
           "n_channels": levels.get("dec", [4, 8, 16]),
           "n_layers": [1, 2, 2]}
    return {"encoder": enc, "decoder": dec}


# every block type once, at the encoder's and decoder's levels
EVERY_BLOCK = {
    "encoder": {"conv_block": {"block_type": "SymmetricConvNeXtBlock",
                               "activation": CAPPED},
                "down_sampling_block": {"block_type": "DealiasedDownsample"},
                "n_channels": [8, 12], "n_layers": [1, 1],
                "dilations": [1, 2]},
    "decoder": {"conv_block": {"block_type": "Multi_SymmetricConvNeXtBlock",
                               "n_layers": 2},
                "up_sampling_block": {"block_type": "SmoothedInterpolateConv",
                                      "activation": CAPPED},
                "output_layer": {"block_type": "ConvNeXtBlock"},
                "n_channels": [12, 12], "n_layers": [1, 1]},
}
MAXPOOL_INTERPOLATE = {
    "encoder": {"conv_block": {"block_type": "BasicConvBlock",
                               "n_layers": 2, "activation": CAPPED},
                "down_sampling_block": {"block_type": "MaxPool"},
                "n_channels": [6, 10], "n_layers": [2, 1]},
    "decoder": {"conv_block": {"block_type": "ConvNeXtBlock"},
                "up_sampling_block": {"block_type": "Interpolate",
                                      "upsample_mode": "bilinear"},
                "output_layer": {"block_type": "BasicConvBlock",
                                 "kernel_size": 3},
                "n_channels": [10, 6], "n_layers": [1, 1]},
}
_NETS: dict = {}


def _nets(name, config, nside=8, n_in=5, n_out=3):
    """Both packages' HEALPixUNet through their registries from
    ``config``, ``ace_tpu``'s with the port's initial weights, an input, a
    target, and ``ace_tpu``'s outputs and (for ``GRAD_CASES``) gradients
    in flax's layout of the mean-square error against the target, from one
    compile; made once per configuration."""
    if name not in _NETS:
        selector = {"type": "HEALPixUNet", "config": config}
        jinfo = JaxDatasetInfo(
            horizontal_coordinates=JaxHEALPix.from_nside(nside))
        info = DatasetInfo(
            horizontal_coordinates=HEALPixCoordinates.from_nside(nside))
        jnet = jax_from_dict(JaxModuleSelector, selector).build(
            n_in, n_out, jinfo)
        net = from_dict(ModuleSelector, selector).build(n_in, n_out, info,
                                                        device="cpu")
        x = _draw((2, 12, nside, nside, n_in), seed=3)
        target = _draw((2, 12, nside, nside, n_out), seed=4)

        def loss(p):
            out = jnet.apply(p, jnp.asarray(x))
            return jnp.mean((out - target) ** 2), out

        params = _flax_params(jnet, net, x)
        grads = None
        if name in GRAD_CASES:
            (_, out), grads = jax.jit(jax.value_and_grad(
                loss, has_aux=True))(params)
            grads = flax_params_to_state_dict(jax.tree_util.tree_map(
                np.asarray, grads))
        else:
            out = jax.jit(jnet.apply)(params, jnp.asarray(x))
        _NETS[name] = net, x, target, np.asarray(out), grads
    return _NETS[name]


CASES = {"defaults-structure": _unet_config(),
         "every-block": EVERY_BLOCK,
         "maxpool-interpolate": MAXPOOL_INTERPOLATE}


@pytest.mark.parametrize("name", list(CASES))
def test_healpix_unet_through_the_registry_matches_ace_tpu(name):
    """``{"type": "HEALPixUNet"}`` builds in both registries with the same
    fields; the outputs agree within 1e-5 of their largest value."""
    net, x, _, ref, _ = _nets(name, CASES[name])
    _close(net(torch.from_numpy(x)).detach().numpy(), ref)


def test_healpix_unet_defaults_have_ace_tpus_parameters():
    """The builder's defaults (fme's widths, 11 inputs and 8 outputs as
    DLWP-HPX's) give ``ace_tpu``'s tree: every leaf's name and shape."""
    info = DatasetInfo(horizontal_coordinates=HEALPixCoordinates.from_nside(
        4))
    net = from_dict(ModuleSelector, {"type": "HEALPixUNet", "config": {}}
                    ).build(11, 8, info, device="cpu")
    jnet = jax_from_dict(JaxModuleSelector, {"type": "HEALPixUNet",
                                             "config": {}}).build(
        11, 8, JaxDatasetInfo(horizontal_coordinates=JaxHEALPix.from_nside(
            4)))
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 12, 4, 4, 11)))
    ref = {k: tuple(v.shape) for k, v in flax_params_to_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                               shapes)).items()}
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert got == ref
    assert sum(p.numel() for p in net.parameters()) == sum(
        int(np.prod(s)) for s in ref.values())


GRAD_CASES = ("defaults-structure", "every-block")


@pytest.mark.parametrize("name", GRAD_CASES)
def test_healpix_unet_gradients_match_jax_grad(name):
    """The gradient of a mean-square error of the outputs with respect
    to every weight against ``jax.grad``, in flax's layout: within 1e-4
    of each gradient's norm."""
    net, x, target, _, jgrads = _nets(name, CASES[name])
    net.zero_grad()
    out = net(torch.from_numpy(x))
    ((out - torch.from_numpy(target)) ** 2).mean().backward()
    for key, p in net.named_parameters():
        ref = jgrads[key].double().numpy()
        got = p.grad.double().numpy()
        assert np.linalg.norm(got - ref) <= GRAD_TOL * np.linalg.norm(
            ref), key


def test_builder_refuses_labels():
    info = DatasetInfo(
        horizontal_coordinates=HEALPixCoordinates.from_nside(4),
        all_labels=("a", "b"))
    builder = from_dict(ModuleSelector, {"type": "HEALPixUNet",
                                         "config": {}}).instance
    with pytest.raises(ValueError, match="labels"):
        builder.build(3, 2, info, device="cpu")
