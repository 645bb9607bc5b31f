"""The port's downscaling networks (``ace_tpu_torch/downscaling/
song_unet.py``, ``unet.py``, ``swinir.py``) against ``ace_tpu``'s at small
sizes (16x16 fine grids, widths 8-16, 2-3 levels), float32 on both sides:
SongUNetV2 in its three encoder/decoder types (standard; residual; skip
with the Fourier embedding), the compact DiffusionUNet and SwinIR, each
forward within 1e-5 of the reference's largest value and every
parameter's gradient within 1e-3 of its norm (plus 1e-6 of the largest
gradient's norm), from the same weights. The
weights are the port's (``init_weights``), converted with
``utils/convert.py`` and checked against ``jax.eval_shape`` of ``init``;
the parameters that start near zero are redrawn so that they count.
``ace_tpu``'s side runs one jitted ``value_and_grad`` per network. Also:
the converters both ways, the depthwise resampling's shapes, the
port's dropout keep rate, and SongUNetV2 and the DiffusionUNet in bf16
(``compute_dtype: bfloat16``) against ``ace_tpu``'s bf16 and the port's
float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.downscaling import song_unet as jax_song
from ace_tpu.downscaling import swinir as jax_swinir
from ace_tpu.downscaling import unet as jax_unet
from ace_tpu_torch.downscaling import song_unet, swinir, unet
from ace_tpu_torch.flagship import anomaly_error, gradient_error
from ace_tpu_torch.models.layers import init_weights
from ace_tpu_torch.utils.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)

torch.set_num_threads(2)

OUT_TOL = 1e-5
GRAD_TOL = 1e-3

SONG = dict(img_resolution=16, in_channels=5, out_channels=2,
            model_channels=8, channel_mult=(1, 2, 2), channel_mult_emb=4,
            num_blocks=1, attn_resolutions=(8,), dropout=0.0)
SONG_CASES = {
    "standard": dict(encoder_type="standard", decoder_type="standard",
                     embedding_type="positional"),
    "residual": dict(encoder_type="residual", decoder_type="standard",
                     embedding_type="positional"),
    "skip_fourier": dict(encoder_type="skip", decoder_type="skip",
                         embedding_type="fourier"),
}
UNET = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
            emb_dim=16, attn_levels=(1,), num_heads=2)
SWINIR = dict(upscale_factor=2, embed_dim=8, depths=(2,), num_heads=2,
              window_size=(2, 4))


def _draw(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _weights(module, seed=0):
    """The port's initial weights, every tensor then moved by a draw of
    its own scale (the zero and 1e-5 initializations redrawn)."""
    gen = torch.Generator().manual_seed(seed)
    init_weights(module, gen)
    with torch.no_grad():
        for p in module.parameters():
            fan = p[0].numel() if p.dim() > 1 else 1
            p.add_(0.3 * torch.randn(p.shape, generator=gen) / fan ** 0.5)
    return {"params": state_dict_to_flax_params(module.state_dict())}


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


def _check(module, jax_net, args, jax_args, init_args, seed=0):
    """Forward and every gradient of ``sum(out * w)``, port against
    ``ace_tpu``, from the port's weights."""
    params = _weights(module, seed)
    template = jax.eval_shape(jax_net.init, jax.random.PRNGKey(0),
                              *init_args)
    assert _shapes(template) == _shapes(params)
    out = module(*args)
    w = _draw(out.shape, seed + 7)
    (out * torch.as_tensor(w)).sum().backward()

    def loss(p):
        y = jax_net.apply(p, *jax_args)
        return jnp.sum(y * w), y

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=OUT_TOL * np.abs(ref).max())
    ours = state_dict_to_flax_params(
        {k: p.grad for k, p in module.named_parameters()})
    flat = jax.tree_util.tree_flatten_with_path(grads["params"])[0]
    largest = max(np.linalg.norm(np.asarray(g)) for _, g in flat)
    buffers = (set(module.state_dict())
               - {k for k, _ in module.named_parameters()})
    assert len(flat) == len(list(module.parameters())) + len(buffers)
    for path, g in flat:
        g = np.asarray(g)
        if ".".join(k.key for k in path) in buffers:
            # the Fourier frequencies: a buffer here, gradient-stopped there
            assert not g.any()
            continue
        node = ours
        for key in path:
            node = node[key.key]
        # plus 1e-6 of the largest gradient's norm (the reference gates'
        # allowance): a bias just before a group norm of one channel a
        # group has a gradient of rounding only
        np.testing.assert_allclose(
            node, g, rtol=0,
            atol=GRAD_TOL * np.linalg.norm(g) + 1e-6 * largest,
            err_msg=jax.tree_util.keystr(path))


def _song_inputs():
    x, cond = _draw((2, 16, 16, 2), 1), _draw((2, 16, 16, 3), 2)
    noise = _draw((2,), 3)
    return x, cond, noise


@pytest.mark.parametrize("case", sorted(SONG_CASES))
def test_song_unet_matches_ace_tpu(case):
    kw = {**SONG, **SONG_CASES[case]}
    module = song_unet.SongUNetV2(**kw)
    net = jax_song.SongUNetV2(**kw)
    x, cond, noise = _song_inputs()
    _check(module, net,
           (torch.as_tensor(x), torch.as_tensor(cond),
            torch.as_tensor(noise)),
           (x, cond, noise), (x, cond, noise))


def test_diffusion_unet_matches_ace_tpu():
    module = unet.DiffusionUNet(in_channels=5, out_channels=2, **UNET)
    net = jax_unet.DiffusionUNet(out_channels=2, **UNET)
    x, cond, noise = _song_inputs()
    _check(module, net,
           (torch.as_tensor(x), torch.as_tensor(cond),
            torch.as_tensor(noise)),
           (x, cond, noise), (x, cond, noise))


def test_swinir_matches_ace_tpu():
    """A 6x8 coarse input (reflect-padded to the 2x4 windows' multiple)
    upsampled twice: both the plain and the shifted block."""
    module = swinir.SwinIR(in_channels=3, out_channels=2, **SWINIR)
    net = jax_swinir.SwinIR(out_channels=2, **SWINIR)
    x = _draw((2, 7, 8, 3), 4)
    _check(module, net, (torch.as_tensor(x),), (x,), (x,))


def test_converters_round_trip_the_networks():
    """flax tree -> state_dict -> flax tree is the identity for each
    network's tree (drawn with numpy in ``init``'s shapes)."""
    x, cond, noise = _song_inputs()
    nets = [
        (jax_song.SongUNetV2(**{**SONG, **SONG_CASES["skip_fourier"]}),
         (x, cond, noise)),
        (jax_song.SongUNetV2(**{**SONG, **SONG_CASES["residual"]}),
         (x, cond, noise)),
        (jax_unet.DiffusionUNet(out_channels=2, **UNET), (x, cond, noise)),
        (jax_swinir.SwinIR(out_channels=2, **SWINIR),
         (_draw((1, 4, 8, 3), 5),)),
    ]
    rng = np.random.default_rng(0)
    for net, args in nets:
        template = jax.eval_shape(net.init, jax.random.PRNGKey(0), *args)
        tree = jax.tree_util.tree_map(
            lambda s: rng.standard_normal(s.shape).astype(np.float32),
            template)
        back = state_dict_to_flax_params(flax_params_to_state_dict(tree))
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               tree["params"], back)


@pytest.mark.parametrize("taps", [(1, 1), (1, 3, 3, 1)])
def test_depthwise_resampling_matches_ace_tpu(taps):
    """Down and up filters (the transposed one with ``ace_tpu``'s output
    size ``(H - 1) 2 - 2p + k``) equal to JAX's on the same input."""
    x = _draw((2, 8, 10, 3), 6)
    filt = song_unet.resample_filter_2d(taps)
    down = song_unet.depthwise_down(torch.as_tensor(x).permute(0, 3, 1, 2),
                                    filt).permute(0, 2, 3, 1)
    up = song_unet.depthwise_up(torch.as_tensor(x).permute(0, 3, 1, 2),
                                filt).permute(0, 2, 3, 1)
    ref_down = np.asarray(jax_song._depthwise_down(jnp.asarray(x), filt))
    ref_up = np.asarray(jax_song._depthwise_up(jnp.asarray(x), filt))
    assert up.shape == ref_up.shape
    np.testing.assert_allclose(down.numpy(), ref_down, rtol=0, atol=1e-6)
    np.testing.assert_allclose(up.numpy(), ref_up, rtol=0, atol=1e-6)


def test_song_unet_dropout_keeps_its_rate_and_replays_under_checkpointing():
    """With dropout 0.1 the port's draws keep 0.9 of a block's features
    (by their statistics) from the step's generator, and per-block
    recompute gives the gradients of the plain call."""
    kw = {**SONG, **SONG_CASES["standard"], "dropout": 0.1}
    x, cond, noise = (torch.as_tensor(a) for a in _song_inputs())
    plain = song_unet.SongUNetV2(**kw)
    init_weights(plain, torch.Generator().manual_seed(0))
    ones = torch.ones(4, 8, 64, 64)
    kept = song_unet.dropout(ones, 0.1, False,
                             torch.Generator().manual_seed(1))
    rate = float((kept != 0).float().mean())
    assert abs(rate - 0.9) < 4 * (0.9 * 0.1 / ones.numel()) ** 0.5
    assert torch.allclose(kept[kept != 0], torch.tensor(1 / 0.9))
    recompute = song_unet.SongUNetV2(**kw, checkpointing=1)
    recompute.load_state_dict(plain.state_dict())
    grads = []
    for module in (plain, recompute):
        out = module(x, cond, noise, deterministic=False,
                     generator=torch.Generator().manual_seed(5))
        out.square().sum().backward()
        grads.append([p.grad.clone() for p in module.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# the bf16 gates of the card-against-CPU references (PERF.md §2): each
# output channel within 3e-2 of its spatial anomaly, each gradient within
# 2e-2 of its norm (relative L2), here plus an allowance of the largest
# gradient's norm for the gradients of rounding size. Against the port's
# own float32 gradients 1e-3 of it (2.2e-4 needed); against ``ace_tpu``'s
# bf16 gradients 2e-2 of it (1.5e-2 needed): XLA:CPU sums bias gradients
# in bf16 (as ``XLA_BF16_SUMS`` of tests/test_torch_train.py), so that
# ``head.bias`` is 5.0e-2 of its norm off the float32 gradient in
# ``ace_tpu``, 3.4e-3 in the port
BF16_OUT_TOL = 3e-2
BF16_GRAD_TOL = 2e-2
BF16_F32_ALLOWANCE = 1e-3
BF16_NETS = {
    "SongUNetV2": {"type": "unet_diffusion_song_v2", "config": {
        "model_channels": 8, "channel_mult": [1, 2, 2], "num_blocks": 1,
        "attn_resolutions": [8], "dropout": 0.0}},
    "DiffusionUNet": {"type": "unet", "config": {
        "base_channels": 8, "channel_mults": [1, 2], "num_res_blocks": 1,
        "attn_levels": [1], "num_heads": 2}},
}


@pytest.mark.parametrize("name", sorted(BF16_NETS))
def test_bf16_networks_through_build_net_match_ace_tpu(name):
    """``compute_dtype: bfloat16`` through each package's network builder
    (the trainer's and the sampler's route) at 16x16, from the same
    weights: the port's bf16 forward against ``ace_tpu``'s bf16 forward
    and the port's float32 forward, and every parameter's gradient of
    ``sum(out * w)`` against both sides' (``ace_tpu``'s bf16, the port's
    float32), at the bf16 gates."""
    from ace_tpu.core.config import from_dict as jax_from_dict
    from ace_tpu.downscaling import models as jax_models
    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.downscaling import models

    def selector(package_from_dict, package, dtype):
        spec = BF16_NETS[name]
        return package_from_dict(package.DiffusionModuleSelector, {
            "type": spec["type"],
            "config": {**spec["config"], "compute_dtype": dtype}})

    module = models.build_net(selector(from_dict, models, "bfloat16"), 2, 3,
                              (16, 16), device="cpu")
    f32 = models.build_net(selector(from_dict, models, "float32"), 2, 3,
                           (16, 16), device="cpu")
    net = jax_models._build_net(selector(jax_from_dict, jax_models,
                                        "bfloat16"), 2, 3, (16, 16))
    x, cond, noise = _song_inputs()
    params = _weights(module)
    f32.load_state_dict(module.state_dict())
    template = jax.eval_shape(net.init, jax.random.PRNGKey(0), x, cond,
                              noise)
    assert _shapes(template) == _shapes(params)
    args = [torch.as_tensor(a) for a in (x, cond, noise)]
    out = module(*args)
    w = _draw(out.shape, 7)
    (out.float() * torch.as_tensor(w)).sum().backward()

    def loss(p):
        y = net.apply(p, x, cond, noise).astype(jnp.float32)
        return jnp.sum(y * w), y

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    ref = torch.from_numpy(np.array(ref))
    exact = f32(*args).detach()
    for label, a, b in (("ace_tpu", out.detach(), ref),
                        ("port vs float32", out.detach(), exact),
                        ("ace_tpu vs float32", ref, exact)):
        err = anomaly_error(a, b, (1, 2))
        assert err <= BF16_OUT_TOL, (label, err)
    (f32(*args) * torch.as_tensor(w)).sum().backward()
    exact = {k: p.grad for k, p in f32.named_parameters()}
    got = {k: p.grad for k, p in module.named_parameters()}
    want = flax_params_to_state_dict(jax.tree_util.tree_map(
        np.asarray, grads))
    largest = max(float(g.norm()) for g in exact.values())
    for label, ref, allowance in (("float32", exact, BF16_F32_ALLOWANCE),
                                  ("ace_tpu", want, BF16_GRAD_TOL)):
        errs = gradient_error(got, {k: ref[k] for k in got})
        excess = {k: errs[k] * float(ref[k].norm()) - (
            BF16_GRAD_TOL * float(ref[k].norm()) + allowance * largest)
            for k in errs}
        worst = max(excess, key=excess.get)
        assert excess[worst] <= 0, (label, worst, errs[worst])
