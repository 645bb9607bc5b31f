"""The port's SFNO layers against ace_tpu's on shared weights: the
instance and layer norms, the MLP with dropout, drop-path, the spectral
convolution (dhconv and diagonal, separable, CP, bias, re-gridded) and the
FFT pair. Inputs are drawn with numpy from seeds; where bfloat16 meets a
dhconv filter at width 128, the JAX side runs its Pallas filter in the
interpreter, as tests/test_torch_models.py does. The tolerances and
helpers are tests/test_torch_sfno.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.models import layers as jax_layers
from ace_tpu.models.sfno import SpectralConvS2 as JaxSpectralConvS2
from ace_tpu.ops import fft2 as jax_fft2
from ace_tpu.ops import sht as jax_sht
from ace_tpu_torch.models import layers
from ace_tpu_torch.models.sfno import SpectralConvS2
from ace_tpu_torch.ops import fft2, sht
from ace_tpu_torch.utils.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)
from tests.test_torch_sfno import (
    BF16_TOL,
    F32_TOL,
    NLAT,
    NLON,
    _close,
    _perturb,
    _x,
)

torch.set_num_threads(2)


# --- layers -----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_matches_ace_tpu(dtype):
    """f32: within 1e-6 of the largest output; bf16 (f32 statistics, the
    mean cast to bf16 before the subtraction, the bf16 difference's
    variance in f32, the rsqrt cast to bf16): bit for bit."""
    x = _x(8) * 3 + 1
    norm_j = jax_layers.InstanceNorm()
    xj = jnp.asarray(x, dtype)
    params = _perturb(norm_j.init(jax.random.PRNGKey(0), xj))
    ref = norm_j.apply(params, xj)
    norm = layers.InstanceNorm(8, device="cpu")
    norm.load_state_dict(flax_params_to_state_dict(params))
    out = norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(out, ref, 1e-6)
    else:
        np.testing.assert_array_equal(out.detach().float().numpy(),
                                      np.asarray(ref, np.float32))


def test_layer_norm_2d_matches_ace_tpu():
    """``[H, W, 1]`` parameters kept in flax's layout: within 1e-6."""
    x = _x(8) * 3 + 1
    norm_j = jax_layers.LayerNorm2d(spatial_shape=(NLAT, NLON))
    params = _perturb(norm_j.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    state = flax_params_to_state_dict(params)
    assert state["scale"].shape == (NLAT, NLON, 1)
    norm = layers.LayerNorm2d((NLAT, NLON), device="cpu")
    norm.load_state_dict(state)
    _close(norm(torch.from_numpy(x)), norm_j.apply(params, jnp.asarray(x)),
           1e-6)


def test_mlp_matches_ace_tpu_and_dropout_is_the_identity_when_deterministic():
    """The MLP (erf GELU in f32) within 1e-6 of ace_tpu's; with a dropout
    rate but ``deterministic`` it returns its input to dropout unchanged,
    bit for bit, whatever the generator."""
    x = _x(8)
    mlp_j = jax_layers.MLP(hidden_features=16, out_features=8,
                           drop_rate=0.5)
    params = mlp_j.init(jax.random.PRNGKey(0), jnp.asarray(x))
    mlp = layers.MLP(8, 16, 8, drop_rate=0.5, device="cpu")
    mlp.load_state_dict(flax_params_to_state_dict(params))
    xt = torch.from_numpy(x)
    out = mlp(xt, deterministic=True,
              generator=torch.Generator().manual_seed(0))
    _close(out, mlp_j.apply(params, jnp.asarray(x), deterministic=True),
           1e-6)
    for module in (layers.DropPath(0.5),):
        assert module(xt, deterministic=True) is xt
    assert layers.dropout(xt, 0.5, True, None) is xt
    assert layers.dropout(xt, 0.0, False, None) is xt


@pytest.mark.parametrize("kind", ["dropout", "drop_path"])
def test_random_layers_keep_their_fraction_and_scale(kind):
    """Dropout (per element) and drop-path (per sample) at rate 0.3, as
    flax's: each kept value is exactly ``x / 0.7``, the rest exactly 0;
    the kept fraction is 0.7 within 4 standard errors; a generator seeded
    alike draws the same mask, and none is an error."""
    rate, keep = 0.3, 0.7
    shape = (4096, 1, 1, 4) if kind == "drop_path" else (8, NLAT, NLON, 4)
    x = torch.from_numpy(np.random.RandomState(0).rand(*shape)
                         .astype(np.float32) + 1.0)

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        if kind == "dropout":
            return layers.dropout(x, rate, False, gen)
        return layers.DropPath(rate)(x, deterministic=False, generator=gen)

    out = draw(0)
    kept = out != 0
    torch.testing.assert_close(out[kept], (x / keep)[kept], rtol=0, atol=0)
    units = kept[:, 0, 0, 0] if kind == "drop_path" else kept
    if kind == "drop_path":  # whole samples
        assert torch.equal(kept, units[:, None, None, None].expand_as(kept))
    n = units.numel()
    frac = float(units.float().mean())
    assert abs(frac - keep) <= 4 * (keep * (1 - keep) / n) ** 0.5, frac
    assert torch.equal(draw(0), out) and not torch.equal(draw(1), out)
    with pytest.raises(ValueError, match="generator"):
        layers.dropout(x, rate, False, None)


# --- spectral convolution and transforms --------------------------------

CONV_CASES = {
    "dhconv": dict(operator_type="dhconv"),
    "diagonal": dict(operator_type="diagonal"),
    "separable_dhconv": dict(operator_type="dhconv", separable=True),
    "separable_diagonal": dict(operator_type="diagonal", separable=True),
    "cp_dhconv": dict(operator_type="dhconv", factorization="cp", rank=0.5),
    "cp_diagonal": dict(operator_type="diagonal", factorization="cp",
                        rank=0.3),
    "regrid": dict(operator_type="dhconv", regrid=True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_spectral_conv_matches_ace_tpu(name, dtype, monkeypatch):
    """Every operator and weight form with a bias, in f32 (four f32
    einsums, ``F32_TOL``) and bf16 (``BF16_TOL``): a non-separable dhconv
    at width 128 through both filters' stand-ins (JAX's Pallas filter in
    the interpreter, the port's plain version), the others contracting
    bf16 operands into f32 on both sides; ``regrid`` goes from 16x32 to
    8x16, so the residual is re-gridded too."""
    kw = dict(CONV_CASES[name])
    regrid = kw.pop("regrid", False)
    dhconv = kw["operator_type"] == "dhconv" and not kw.get("separable")
    c = 128 if dtype == "bfloat16" and dhconv else 32
    if dtype == "bfloat16":
        monkeypatch.setenv("ACE_TPU_PALLAS_FILTER", "interpret")
    out_grid = (NLAT // 2, NLON // 2) if regrid else (NLAT, NLON)
    lmax, mmax = out_grid[0], out_grid[1] // 2 + 1
    layer_j = JaxSpectralConvS2(
        forward_transform=jax_sht.RealSHT(NLAT, NLON, lmax=lmax, mmax=mmax,
                                          channels_last=True),
        inverse_transform=jax_sht.InverseRealSHT(*out_grid, lmax=lmax,
                                                 mmax=mmax,
                                                 channels_last=True),
        in_channels=c, out_channels=c, use_bias=True, **kw)
    x = _x(c)
    xj = jnp.asarray(x, dtype)
    layer = SpectralConvS2(
        sht.RealSHT(NLAT, NLON, lmax=lmax, mmax=mmax, device="cpu"),
        sht.InverseRealSHT(*out_grid, lmax=lmax, mmax=mmax, device="cpu"),
        c, c, use_bias=True, device="cpu", **kw)
    # the port's initial weights (drawn as flax draws them; flax's
    # initializers compile once per shape) in ace_tpu's tree, which must
    # have its leaves; the converter's filter rules key on a block's
    # ``filter``
    layers.init_weights(layer, torch.Generator().manual_seed(0))
    params = _perturb({"params": state_dict_to_flax_params(
        {f"filter.{k}": v for k, v in layer.state_dict().items()})["filter"]})
    assert jax.tree_util.tree_map(np.shape, params) == (
        jax.tree_util.tree_map(lambda v: v.shape, dict(jax.eval_shape(
            layer_j.init, jax.random.PRNGKey(0), xj))))
    # bf16 compiled once as a whole (faster here than op by op)
    jit = jax.jit if dtype == "bfloat16" else (lambda f: f)
    out_j, res_j = jit(layer_j.apply)(params, xj)
    state = flax_params_to_state_dict({"filter": params["params"]})
    layer.load_state_dict({k.removeprefix("filter."): v
                           for k, v in state.items()})
    with torch.inference_mode():
        out, res = layer(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(out, out_j, tol)
    _close(res, res_j, tol if regrid else 0.0)


@pytest.mark.parametrize("shape, lmax, mmax", [
    ((NLAT, NLON), None, None),
    ((NLAT, NLON), 10, 9),      # truncated
    ((12, 30), 14, 17),         # padded past the grid's modes
    ((NLAT, 31), 12, 16),       # odd longitude count: no Nyquist column
])
def test_fft_pair_matches_ace_tpu(shape, lmax, mmax):
    """``RealFFT2`` and ``InverseRealFFT2`` (ortho norm, truncation and
    padding to (lmax, mmax), the m = 0 and Nyquist columns made real)
    within 1e-6 of the largest output of ``ace_tpu/ops/fft2.py``'s."""
    x = _x(3, shape=(2, *shape))
    fwd = fft2.RealFFT2(*shape, lmax=lmax, mmax=mmax)
    inv = fft2.InverseRealFFT2(*shape, lmax=lmax, mmax=mmax)
    fwd_j = jax_fft2.RealFFT2(*shape, lmax=lmax, mmax=mmax)
    inv_j = jax_fft2.InverseRealFFT2(*shape, lmax=lmax, mmax=mmax)
    coeffs_j = np.asarray(fwd_j(jnp.asarray(x)))
    coeffs = fwd(torch.from_numpy(x)).numpy()
    assert coeffs.shape == coeffs_j.shape
    np.testing.assert_allclose(coeffs, coeffs_j, rtol=0,
                               atol=1e-6 * np.abs(coeffs_j).max())
    # a spectrum with nonzero imaginary m = 0 and Nyquist parts
    spec = (np.random.RandomState(1).randn(*coeffs_j.shape)
            + 1j * np.random.RandomState(2).randn(*coeffs_j.shape)
            ).astype(np.complex64)
    ref = np.asarray(inv_j(jnp.asarray(spec)))
    out = inv(torch.from_numpy(spec)).numpy()
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
