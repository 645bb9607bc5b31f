"""The spectral filter weight in the port's layout ``[2, L, I, O]``: the
converter maps it to and from ``ace_tpu``'s flax ``[I, O, L, 2]`` exactly,
and the port's gradient of ``SpectralConvS2.weight``, mapped back to flax,
agrees with ``jax.grad`` of ``ace_tpu``'s layer through its Pallas filter
(in the interpreter)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.models import conditional_sfno as jax_csfno
from ace_tpu.models.sfno import SpectralConvS2 as JaxSpectralConvS2
from ace_tpu.ops import pallas_filter as jax_pallas_filter
from ace_tpu.ops import sht as jax_sht
from ace_tpu_torch.models import conditional_sfno
from ace_tpu_torch.models.sfno import SpectralConvS2
from ace_tpu_torch.ops import sht
from ace_tpu_torch.utils.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)

torch.set_num_threads(2)

NLAT, NLON = 16, 32


def _model_params(embed=16, layers=2):
    kwargs = dict(img_shape=(NLAT, NLON), in_chans=5, out_chans=3,
                  embed_dim=embed, num_layers=layers, noise_embed_dim=8)
    model_j = jax_csfno.NoiseConditionedSFNO(**kwargs)
    params = model_j.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, NLAT, NLON, 5)))
    return kwargs, params


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_filter_weight_maps_to_kernel_layout_by_index():
    """Each block's flax filter weight ``[I, O, L, 2]`` lands in the
    port's ``[2, L, I, O]`` with every value at its (re/im, l, i, o)."""
    kwargs, params = _model_params(embed=12)
    state = flax_params_to_state_dict(params)
    for layer in range(kwargs["num_layers"]):
        w = np.asarray(params["params"][f"block_{layer}"]["filter"]["weight"])
        p = state[f"block_{layer}.filter.weight"].numpy()
        i_n, o_n, l_n, two = w.shape
        assert two == 2 and p.shape == (2, l_n, i_n, o_n)
        rng = np.random.RandomState(layer)
        for _ in range(50):
            i, o, l, c = (rng.randint(n) for n in (i_n, o_n, l_n, 2))
            assert p[c, l, i, o] == w[i, o, l, c]
        np.testing.assert_array_equal(p, np.transpose(w, (3, 2, 0, 1)))
    # the port's own module has the same parameter shapes
    model = conditional_sfno.NoiseConditionedSFNO(**kwargs, device="cpu")
    model.load_state_dict(state)
    assert model.block_0.filter.weight.shape == (2, NLAT, 12, 12)


def test_filter_weight_round_trips_exactly():
    """flax -> port -> flax gives every leaf back bit for bit, the filter
    weights in their flax layout; other 4-D leaves keep theirs."""
    _, params = _model_params()
    back = dict(_flat(state_dict_to_flax_params(
        flax_params_to_state_dict(params))))
    ref = dict(_flat(params["params"]))
    assert set(back) == set(ref)
    for name, value in ref.items():
        assert back[name].shape == value.shape, name
        np.testing.assert_array_equal(back[name], value, err_msg=name)
    # a 4-D leaf that is not a block's spectral filter keeps its layout
    conv = {"encoder": {"weight": np.arange(48.0).reshape(2, 3, 4, 2)}}
    state = flax_params_to_state_dict(conv)
    assert tuple(state["encoder.weight"].shape) == (2, 3, 4, 2)
    np.testing.assert_array_equal(
        state_dict_to_flax_params(state)["encoder"]["weight"],
        conv["encoder"]["weight"])


@pytest.mark.parametrize("embed", [32, 64])
def test_weight_gradient_maps_back_to_jax_grad(monkeypatch, embed):
    """The port's bf16 ``SpectralConvS2`` in grad mode (the weight through
    ``dhconv_filter_param``: its gradient from 1c's plain version) against
    ``jax.grad`` of ``ace_tpu``'s layer, whose bf16 filter runs its Pallas
    kernel in the interpreter and its custom VJP (the shape gate opened at
    these widths). The weight's and the bias's gradients, mapped back to
    flax, agree to 1e-2 of the largest: x and the cotangent are rounded to
    bf16 in both, after f32 transforms that sum in another order, so a few
    roundings land one bf16 step apart."""
    monkeypatch.setenv("ACE_TPU_PALLAS_FILTER", "interpret")
    monkeypatch.setattr(jax_pallas_filter, "shapes_supported",
                        lambda m, i, o: True)
    rng = np.random.RandomState(0)
    x = rng.randn(2, NLAT, NLON, embed).astype(np.float32)
    cot = rng.randn(2, NLAT, NLON, embed).astype(np.float32)
    layer_j = JaxSpectralConvS2(
        forward_transform=jax_sht.RealSHT(NLAT, NLON, channels_last=True),
        inverse_transform=jax_sht.InverseRealSHT(NLAT, NLON,
                                                 channels_last=True),
        in_channels=embed, out_channels=embed, operator_type="dhconv",
        use_bias=True,
    )
    xj = jnp.asarray(x, jnp.bfloat16)
    params = layer_j.init(jax.random.PRNGKey(0), xj)
    w = rng.randn(*params["params"]["weight"].shape) * embed ** -0.5
    params = {"params": {"weight": jnp.asarray(w, jnp.float32),
                         "bias": jnp.asarray(rng.randn(embed) * 0.1,
                                             jnp.float32)}}

    def loss(p):
        out, _ = layer_j.apply(p, xj)
        return jnp.sum(out.astype(jnp.float32) * cot)

    ref = jax.grad(loss)(params)["params"]

    layer = SpectralConvS2(
        sht.RealSHT(NLAT, NLON, device="cpu"),
        sht.InverseRealSHT(NLAT, NLON, device="cpu"),
        embed, embed, use_bias=True, device="cpu",
    )
    state = flax_params_to_state_dict({"filter": params["params"]})
    layer.load_state_dict({k.removeprefix("filter."): v
                           for k, v in state.items()})
    out, _ = layer(torch.from_numpy(x).to(torch.bfloat16))
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert layer.weight.grad.shape == (2, NLAT, embed, embed)
    grads = state_dict_to_flax_params(
        {f"filter.{n}": p.grad for n, p in layer.named_parameters()}
    )["filter"]
    for name in ("weight", "bias"):
        out_g, ref_g = grads[name], np.asarray(ref[name], np.float32)
        assert out_g.shape == ref_g.shape, name
        np.testing.assert_allclose(
            out_g, ref_g, rtol=0,
            atol=1e-2 * float(np.max(np.abs(ref_g))), err_msg=name)
