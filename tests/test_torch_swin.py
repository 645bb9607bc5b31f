"""The port's Swin U-Net (``ace_tpu_torch/models/swin.py``) against
``ace_tpu/models/swin.py`` at small sizes (8x16 to 16x32, widths up to 16,
windows 2x4), float32 on both sides: the window helpers, both pads, the
shifted-window mask and the windows' mean latitudes exactly; the window
attention (with and without the cos-lat bias and a mask), each block
variant (CLN, AdaLN, plain), the patch merging and expanding, and both
nets through the registries (every padding and conditioning option)
within 1e-5 of the reference's largest value, the attention's and the
blocks' gradients within 1e-3 of each gradient's norm; the port's noise and drop path by their
statistics. ``ace_tpu``'s modules run eagerly (an XLA:CPU compile of a
Swin net takes a minute), on weights made from the port's, with the
zero-initialized ones redrawn so that they count."""

import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.core.config import from_dict as jax_from_dict
from ace_tpu.core.coordinates import LatLonCoordinates as JaxLatLon
from ace_tpu.core.dataset_info import DatasetInfo as JaxDatasetInfo
from ace_tpu.models import swin as jax_swin
from ace_tpu.models.registry import ModuleSelector as JaxModuleSelector
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.coordinates import LatLonCoordinates
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.models import swin
from ace_tpu_torch.models.layers import init_weights
from ace_tpu_torch.models.registry import ModuleSelector
from ace_tpu_torch.utils.convert import state_dict_to_flax_params

torch.set_num_threads(2)

OUT_TOL = 1e-5
# reference phase W's gradient limit: a deep stage's bias MLP sums many
# cancelling terms (its gradient 1e-4 of the largest, 1.7e-4 off)
GRAD_TOL = 1e-3
LAT = tuple(np.linspace(-84.0, 84.0, 8).tolist())


def _draw(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _weights(module, seed=0):
    """The port's initial weights, with the parameters that start at zero
    or one (the bias MLP's output layer, the AdaLN and label projections,
    the norms' noise terms, the temperatures) redrawn."""
    gen = torch.Generator().manual_seed(seed)
    init_weights(module, gen)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if any(k in name for k in ("cpb_fc2", "adaln", "w_scale",
                                       "w_bias", "tau", "norm")):
                p.copy_(p + 0.2 * torch.randn(p.shape, generator=gen))
    return {"params": state_dict_to_flax_params(module.state_dict())}


def _assert_tree_shapes(params, jmodule, *args, **kwargs):
    """``params`` has the leaves of ``jmodule.init``'s tree (the keyword
    arguments stay concrete: the cos-lat means are host constants)."""
    shapes = jax.eval_shape(
        lambda key, *a: jmodule.init(key, *a, **kwargs),
        jax.random.PRNGKey(0), *args)
    assert (jax.tree_util.tree_map(lambda v: tuple(v.shape), params)
            == jax.tree_util.tree_map(lambda v: tuple(v.shape),
                                      dict(shapes)))


def _close(got, ref, tol=OUT_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


# ---- exact: layouts, pads, masks, latitudes ----


@pytest.mark.parametrize("window", [(2, 4), (4, 8)])
def test_window_partition_and_reverse_equal_ace_tpu(window):
    x = _draw((2, 8, 16, 3))
    ref = np.asarray(jax_swin.window_partition(jnp.asarray(x), *window))
    got = swin.window_partition(torch.from_numpy(x), *window)
    np.testing.assert_array_equal(got.numpy(), ref)
    back = swin.window_reverse(got, *window, 8, 16)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jax_swin.window_reverse(jnp.asarray(ref), *window, 8, 16)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("pads", [((2, 2), (3, 3)), ((3, 1), (0, 2)),
                                  ((0, 0), (4, 4)), ((1, 0), (0, 0))])
@pytest.mark.parametrize("mode", ["earth", "mirror"])
def test_pads_and_unpad_equal_ace_tpu(mode, pads):
    x = _draw((2, 8, 16, 3))
    fn = {"earth": (jax_swin.earth_pad, swin.earth_pad),
          "mirror": (jax_swin.mirror_pad, swin.mirror_pad)}[mode]
    ref = np.asarray(fn[0](jnp.asarray(x), *pads))
    got = fn[1](torch.from_numpy(x), *pads)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        swin.boundary_unpad(got, *pads).numpy(),
        np.asarray(jax_swin.boundary_unpad(jnp.asarray(ref), *pads)))


def _jax_block(shift, lat=LAT, res=(8, 16), window=(2, 4)):
    return jax_swin.SwinTransformerBlock(
        dim=8, input_resolution=res, num_heads=2, window_size=window,
        shift_size=shift, lat_coords=lat)


@pytest.mark.parametrize("shift", [(0, 0), (1, 2), (2, 4)])
@pytest.mark.parametrize("window", [(2, 4), (4, 8)])
def test_shifted_window_mask_and_lat_mean_equal_ace_tpu(shift, window):
    res = (8, 16)
    block = _jax_block(shift, res=res, window=window)
    ref_mask = block._build_mask()
    got_mask = swin.shifted_window_mask(res, window, shift)
    if ref_mask is None:
        assert got_mask is None
    else:
        np.testing.assert_array_equal(got_mask, np.asarray(ref_mask))
    np.testing.assert_array_equal(
        swin.window_lat_mean(LAT, res, window, shift), block._lat_mean())
    assert swin.window_lat_mean(None, res, window, shift) is None


# ---- 1e-5: attention, blocks, patches ----


@pytest.mark.parametrize("lat_mean,masked", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_window_attention_matches_ace_tpu(lat_mean, masked):
    """The cosine attention with the learned bias, per window (cos-lat)
    or shared, with the shifted windows' mask or without."""
    res, window, shift = (8, 16), (2, 4), (1, 2)
    lat = swin.window_lat_mean(LAT, res, window, shift) if lat_mean else None
    mask = swin.shifted_window_mask(res, window, shift) if masked else None
    module = swin.WindowAttention2D(8, window, 2, cpb_hidden_dim=16,
                                    lat_mean=lat)
    jmodule = jax_swin.WindowAttention2D(dim=8, window_size=window,
                                         num_heads=2, cpb_hidden_dim=16)
    x = _draw((2 * 16, 8, 8))
    params = _weights(module)
    kw = dict(mask=None if mask is None else jnp.asarray(mask),
              lat_mean=lat)
    _assert_tree_shapes(params, jmodule, jnp.asarray(x), **kw)
    ref = jmodule.apply(params, jnp.asarray(x), **kw)
    got = module(torch.from_numpy(x), mask=None if mask is None
                 else torch.from_numpy(mask))
    _close(got, ref)


BLOCKS = {
    "cln": dict(conditioning="cln", noise_embed_dim=4, embed_dim_labels=3),
    "adaln": dict(conditioning="adaln"),
    "plain": dict(conditioning="adaln"),
    "swiglu": dict(conditioning="adaln", mlp_layer="swiglu"),
}


@pytest.mark.parametrize("shift", [(0, 0), (1, 2)])
@pytest.mark.parametrize("kind", list(BLOCKS))
def test_block_matches_ace_tpu(kind, shift):
    """A block of each conditioning (CLN with noise and labels, AdaLN with
    its six modulations, plain post-norm; the SwiGLU MLP), unshifted and
    shifted, cos-lat bias on: the output within 1e-5, and every
    parameter's and input's gradient of a squared sum within
    ``GRAD_TOL`` of ``jax.grad``'s norm (the whole nets' gradients are held
    through the training entries, ``tests/test_torch_swin_graphcast_path.py``:
    ``ace_tpu``'s eager gradient of a net takes a minute)."""
    kw = dict(BLOCKS[kind], lat_coords=LAT)
    module = swin.SwinTransformerBlock(8, (8, 16), 2, (2, 4), shift, **kw)
    jmodule = jax_swin.SwinTransformerBlock(
        dim=8, input_resolution=(8, 16), num_heads=2, window_size=(2, 4),
        shift_size=shift, **kw)
    params = _weights(module)
    x = _draw((2, 8, 16, 8))
    args = {}
    targs = {}
    if kind == "cln":
        noise, labels = _draw((2, 8, 16, 4), 1), _draw((2, 3), 2)
        args = dict(noise=jnp.asarray(noise), labels=jnp.asarray(labels))
        targs = dict(noise=torch.from_numpy(noise),
                     labels=torch.from_numpy(labels))
    elif kind == "adaln":
        cond = [_draw((2, 1, 1, 8), 3 + i) for i in range(6)]
        args = dict(cond_params=tuple(jnp.asarray(c) for c in cond))
        targs = dict(cond_params=tuple(torch.from_numpy(c) for c in cond))
    _assert_tree_shapes(params, jmodule, jnp.asarray(x), **args)

    def jax_loss(p, v):
        out = jmodule.apply(p, v, **args)
        return jnp.sum(out ** 2), out

    (_, ref), (ref_grads, ref_dx) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = module(xt, **targs)
    _close(out, ref)
    (out ** 2).sum().backward()
    _grads_close(module, ref_grads)
    assert np.linalg.norm(xt.grad.numpy() - np.asarray(ref_dx)) <= (
        GRAD_TOL * np.linalg.norm(np.asarray(ref_dx)))


@pytest.mark.parametrize("name", ["PatchMerging", "PatchExpanding"])
def test_patch_merging_and_expanding_match_ace_tpu(name):
    module = getattr(swin, name)(8)
    jmodule = getattr(jax_swin, name)(dim=8)
    params = _weights(module)
    x = _draw((2, 8, 16, 8 if name == "PatchExpanding" else 8))
    _assert_tree_shapes(params, jmodule, jnp.asarray(x))
    _close(module(torch.from_numpy(x)), jmodule.apply(params, jnp.asarray(x)))


def _grads_close(net, ref_grads):
    """Every parameter's gradient within ``GRAD_TOL`` of the norm of
    ``jax.grad``'s."""
    grads = state_dict_to_flax_params(
        {k: p.grad for k, p in net.named_parameters()})
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref_grads)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(
            {"params": grads})[0]:
        r = np.asarray(flat_ref[path])
        assert np.linalg.norm(g - r) <= GRAD_TOL * max(np.linalg.norm(r),
                                                       1e-12), path


def test_window_attention_gradients_and_a_zero_window():
    """The attention's gradients within ``GRAD_TOL`` of ``jax.grad``'s; with one
    window all zeros and no qkv bias (a window of the nets' zero padding
    at initialization), ``ace_tpu``'s are NaN (the norm's gradient at a
    zero vector) and the port's finite (torch takes it as 0)."""
    module = swin.WindowAttention2D(8, (2, 4), 2, cpb_hidden_dim=16)
    jmodule = jax_swin.WindowAttention2D(dim=8, window_size=(2, 4),
                                         num_heads=2, cpb_hidden_dim=16)
    for zero_window in (False, True):
        params = _weights(module)
        x = _draw((4, 8, 8))
        if zero_window:
            x[1] = 0.0
            params["params"]["qkv"]["bias"][:] = 0.0
            with torch.no_grad():
                module.qkv.bias.zero_()

        def jax_loss(p):
            return jnp.sum(jmodule.apply(p, jnp.asarray(x)) ** 2)

        ref_grads = jax.grad(jax_loss)(params)
        module.zero_grad()
        (module(torch.from_numpy(x)) ** 2).sum().backward()
        if not zero_window:
            _grads_close(module, ref_grads)
        else:
            assert np.isnan(np.asarray(
                ref_grads["params"]["qkv"]["kernel"])).any()
            assert all(torch.isfinite(p.grad).all()
                       for p in module.parameters())


# ---- the nets through the registries ----

NLAT, NLON, N_IN, N_OUT = 16, 32, 5, 3
SMALL = {"embed_dim": 8, "num_heads": [2, 2, 2, 2], "window_size": [2, 4],
         "cpb_hidden_dim": 16}
EARTH = {"activate": True, "mode": "earth", "pad_lat": [2, 2],
         "pad_lon": [4, 4]}
NETS = {
    # the path W-R recipe's options, at 20x40 after the earth pad
    "noise-cosl-earth": ("NoiseConditionedSwinTransformer", dict(
        SMALL, noise_embed_dim=4, padding_conf=EARTH), ()),
    "noise-labels-swiglu-noskip-mirror": (
        "NoiseConditionedSwinTransformer", dict(
            SMALL, noise_embed_dim=4, label_embed_dim=3, mlp_layer="swiglu",
            use_skip=False, use_cpb_scaling=False,
            padding_conf={"activate": True, "mode": "mirror",
                          "pad_lat": [3, 1], "pad_lon": [2, 2]}),
        ("era5", "shield")),
    # path W-A's options: AdaLN over two labels, earth padding whose
    # longitudes need zero padding to the windows' multiple
    "adaln-labels-earth-zero-pad": ("SwinTransformer", dict(
        SMALL, padding_conf=dict(EARTH, pad_lon=[3, 3])),
        ("era5", "shield")),
    "adaln-plain-depth2": ("SwinTransformer", dict(
        SMALL, depth_multiplier=2, use_cpb_scaling=False), ()),
}


def _nets(kind, config, labels):
    lat = np.linspace(-84.375, 84.375, NLAT)
    lon = np.linspace(0.0, 348.75, NLON)
    builder = {"type": kind, "config": config, "conditional": bool(labels)}
    net = from_dict(ModuleSelector, builder).build(
        N_IN, N_OUT, DatasetInfo(
            horizontal_coordinates=LatLonCoordinates(lat, lon),
            all_labels=labels), device="cpu")
    jnet = jax_from_dict(JaxModuleSelector, builder).build(
        N_IN, N_OUT, JaxDatasetInfo(
            horizontal_coordinates=JaxLatLon(lat, lon), all_labels=labels))
    return net, jnet


def _net_case(name):
    kind, config, labels = NETS[name]
    net, jnet = _nets(kind, config, labels)
    params = _weights(net)
    x = _draw((2, NLAT, NLON, N_IN))
    noise = _draw((2, NLAT, NLON, 4), 1)
    lab = np.eye(2, dtype=np.float32)[[1, 0]] if labels else None
    kw = {"labels": jnp.asarray(lab)} if labels else {}
    _assert_tree_shapes(params, jnet, jnp.asarray(x), **kw)
    patch = unittest.mock.patch.object(
        jax_swin.SwinTransformerNet, "_make_noise",
        lambda self, v: (jnp.asarray(noise)
                         if self.conditioning == "cln" else None))

    def port(**extra):
        tkw = {"labels": torch.from_numpy(lab)} if labels else {}
        return net(torch.from_numpy(x), noise=(
            torch.from_numpy(noise) if kind.startswith("Noise") else None),
            **tkw, **extra)

    return net, jnet, params, x, kw, patch, port


@pytest.mark.parametrize("name", list(NETS))
def test_nets_match_ace_tpu_through_the_registries(name):
    """Each net's output within 1e-5, the noise passed to both (patched
    into ``ace_tpu``'s ``_make_noise``)."""
    net, jnet, params, x, kw, patch, port = _net_case(name)
    with patch:
        ref = jnet.apply(params, jnp.asarray(x), **kw)
    _close(port(), ref)


def test_builder_with_a_scalar_embedding_raises_as_ace_tpu():
    """``embed_dim_scalar > 0`` raises at the first call in both packages:
    the net passes no scalar conditioning."""
    net, _ = _nets("SwinTransformer", dict(SMALL, embed_dim_scalar=4), ())
    with pytest.raises(ValueError, match="cond_scalar"):
        net(torch.zeros(1, NLAT, NLON, N_IN))


# ---- statistics of the port's own randomness ----


def test_noise_and_drop_path_statistics():
    """The noise field is standard normal at the input's shape, drawn
    from the generator (the same generator state, the same field; zeros
    without one); drop path keeps a sample with probability ``1 -
    rate``, scaled by ``1 / (1 - rate)``, drawn from the generator, and is
    the identity when deterministic."""
    kind, config, labels = NETS["noise-cosl-earth"]
    net, _ = _nets(kind, dict(config, noise_embed_dim=64), labels)
    x = torch.zeros(4, NLAT, NLON, N_IN)
    noise = net.make_noise(x, torch.Generator().manual_seed(5))
    assert noise.shape == (4, NLAT, NLON, 64)
    assert abs(float(noise.mean())) < 0.02
    assert float(noise.std()) == pytest.approx(1.0, abs=0.02)
    torch.testing.assert_close(
        net.make_noise(x, torch.Generator().manual_seed(5)), noise, rtol=0,
        atol=0)
    assert not net.make_noise(x, None).any()
    drop = net.layer2.blocks_5.drop_path
    assert drop.rate == pytest.approx(0.2)
    y = torch.ones(20000, 2)
    gen = torch.Generator().manual_seed(0)
    kept = drop(y, deterministic=False, generator=gen)
    share = float((kept[:, 0] > 0).float().mean())
    assert share == pytest.approx(0.8, abs=0.01)
    assert set(torch.unique(kept).tolist()) == {0.0, 1.0 / 0.8}
    torch.testing.assert_close(drop(y, deterministic=True), y)
    # the schedule: stages 2 and 3 share the deep rates
    rates = [getattr(net, f"layer{i}").__getattr__(f"blocks_{j}").drop_path
             .rate for i, n in ((1, 2), (2, 6), (3, 6), (4, 2))
             for j in range(n)]
    want = np.linspace(0.0, 0.2, 8).tolist()
    assert rates == pytest.approx(want[:2] + want[2:] + want[2:] + want[:2])
