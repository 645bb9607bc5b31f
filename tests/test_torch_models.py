"""The port's SFNO modules against ace_tpu's on shared weights: the
spectral convolution, the conditional block and the whole
NoiseConditionedSFNO, in float32 and in bfloat16 (where the JAX side runs
its Pallas filter in the interpreter)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.models import conditional_sfno as jax_csfno
from ace_tpu.models.sfno import SpectralConvS2 as JaxSpectralConvS2
from ace_tpu.ops import sht as jax_sht
from ace_tpu_torch.models import conditional_sfno
from ace_tpu_torch.models.sfno import SpectralConvS2
from ace_tpu_torch.ops import sht
from ace_tpu_torch.utils.convert import flax_params_to_state_dict

torch.set_num_threads(2)

NLAT, NLON = 16, 32
# (dtype, embed): f32 holds the algorithm (1e-4 of the largest output:
# summation order only); bf16 at embed 128 routes the JAX side through
# its Pallas filter, and bf16 rounds at other points in the two
# frameworks (2e-2 of the largest output)
CASES = {
    "float32": (jnp.float32, torch.float32, 32, 1e-4),
    "bfloat16": (jnp.bfloat16, torch.bfloat16, 128, 2e-2),
}


@pytest.fixture(params=sorted(CASES))
def case(request, monkeypatch):
    if request.param == "bfloat16":
        monkeypatch.setenv("ACE_TPU_PALLAS_FILTER", "interpret")
    return CASES[request.param]


def _perturb_conditioning(params, seed=1):
    """Give the zero-initialized noise-conditioning kernels random values
    so the conditioning path is tested."""
    rng = np.random.RandomState(seed)

    def visit(path, leaf):
        name = "/".join(str(p.key) for p in path)
        if "w_scale_2d" in name or "w_bias_2d" in name:
            return jnp.asarray(rng.randn(*leaf.shape) * 0.1, leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(visit, params)


def _close(out, ref, tol):
    out = out.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=tol * float(np.max(np.abs(ref))))


def test_spectral_conv_matches_ace_tpu(case):
    jdt, tdt, c, tol = case
    x = np.random.RandomState(0).randn(2, NLAT, NLON, c).astype(np.float32)
    layer_j = JaxSpectralConvS2(
        forward_transform=jax_sht.RealSHT(NLAT, NLON, channels_last=True),
        inverse_transform=jax_sht.InverseRealSHT(NLAT, NLON,
                                                 channels_last=True),
        in_channels=c, out_channels=c, operator_type="dhconv", use_bias=True,
    )
    xj = jnp.asarray(x, jdt)
    params = layer_j.init(jax.random.PRNGKey(0), xj)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.01 if p.ndim == 1 else p, params
    )  # nonzero bias
    out_j, _ = layer_j.apply(params, xj)

    layer = SpectralConvS2(
        sht.RealSHT(NLAT, NLON, device="cpu"),
        sht.InverseRealSHT(NLAT, NLON, device="cpu"),
        c, c, use_bias=True, device="cpu",
    )
    # the converter maps the filter weight's layout under a block's
    # ``filter``: name the lone layer so
    state = flax_params_to_state_dict({"filter": params["params"]})
    layer.load_state_dict({k.removeprefix("filter."): v
                           for k, v in state.items()})
    with torch.inference_mode():
        out, residual = layer(torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt
    torch.testing.assert_close(residual, torch.from_numpy(x).to(tdt))
    _close(out, out_j, tol)


def test_conditional_block_matches_ace_tpu(case):
    jdt, tdt, c, tol = case
    rng = np.random.RandomState(0)
    x = rng.randn(2, NLAT, NLON, c).astype(np.float32)
    noise = rng.randn(2, NLAT, NLON, 8).astype(np.float32)
    block_j = jax_csfno.ConditionalFNOBlock(
        forward_transform=jax_sht.RealSHT(NLAT, NLON, channels_last=True),
        inverse_transform=jax_sht.InverseRealSHT(NLAT, NLON,
                                                 channels_last=True),
        embed_dim=c, embed_dim_noise=8, affine_norms=True, dtype=jdt,
    )
    xj, nj = jnp.asarray(x, jdt), jnp.asarray(noise)
    params = _perturb_conditioning(
        block_j.init(jax.random.PRNGKey(0), xj, nj)
    )
    out_j = block_j.apply(params, xj, nj)

    block = conditional_sfno.ConditionalFNOBlock(
        sht.RealSHT(NLAT, NLON, device="cpu"),
        sht.InverseRealSHT(NLAT, NLON, device="cpu"),
        c, 8, affine_norms=True, dtype=tdt, device="cpu",
    )
    block.load_state_dict(flax_params_to_state_dict(params))
    with torch.inference_mode():
        out = block(torch.from_numpy(x).to(tdt), torch.from_numpy(noise))
    assert out.dtype == tdt
    _close(out, out_j, tol)


def _model_kwargs(c, layers=2):
    return dict(
        img_shape=(NLAT, NLON), in_chans=5, out_chans=4, embed_dim=c,
        noise_embed_dim=8, noise_type="isotropic", num_layers=layers,
        affine_norms=True, normalize_big_skip=True,
    )


def test_noise_conditioned_sfno_matches_ace_tpu(case, monkeypatch):
    jdt, tdt, c, tol = case
    rng = np.random.RandomState(0)
    x = rng.randn(2, NLAT, NLON, 5).astype(np.float32)
    noise = rng.randn(2, NLAT, NLON, 8).astype(np.float32)
    # the same noise field for both: the two frameworks' generators differ
    monkeypatch.setattr(
        jax_csfno.NoiseConditionedSFNO, "_make_noise",
        lambda self, batch: jnp.asarray(noise),
    )
    model_j = jax_csfno.NoiseConditionedSFNO(**_model_kwargs(c), dtype=jdt)
    params = _perturb_conditioning(
        model_j.init(jax.random.PRNGKey(0), jnp.asarray(x))
    )
    out_j = model_j.apply(params, jnp.asarray(x))

    model = conditional_sfno.NoiseConditionedSFNO(
        **_model_kwargs(c), dtype=tdt, device="cpu"
    )
    model.load_state_dict(flax_params_to_state_dict(params))
    with torch.inference_mode():
        out = model(torch.from_numpy(x), noise=torch.from_numpy(noise))
    assert out.dtype == torch.float32
    _close(out, out_j, tol)


def test_isotropic_noise_statistics():
    """Zero mean and unit pointwise variance over many draws."""
    model = conditional_sfno.NoiseConditionedSFNO(
        img_shape=(24, 48), in_chans=1, out_chans=1, embed_dim=8,
        noise_embed_dim=64, noise_type="isotropic", num_layers=1,
        device="cpu",
    )
    gen = torch.Generator().manual_seed(0)
    noise = model.make_noise(64, gen)
    assert noise.shape == (64, 24, 48, 64)
    pointwise_var = noise.var(dim=(0, 3))  # per grid point, over draws
    assert abs(float(noise.mean())) < 0.02
    assert 0.9 < float(pointwise_var.mean()) < 1.1
    assert float(pointwise_var.min()) > 0.6
    assert float(pointwise_var.max()) < 1.5
    # zero noise without a generator, as the JAX model without an rng
    assert not model.make_noise(1, None).any()


def test_converter_covers_every_parameter():
    model_j = jax_csfno.NoiseConditionedSFNO(**_model_kwargs(16))
    params = model_j.init(jax.random.PRNGKey(0), jnp.zeros((1, NLAT, NLON, 5)))
    state = flax_params_to_state_dict(params)
    model = conditional_sfno.NoiseConditionedSFNO(
        **_model_kwargs(16), device="cpu"
    )
    assert set(state) == set(model.state_dict())
    # dense kernels [in, out] become nn.Linear weights [out, in]
    np.testing.assert_array_equal(
        state["encoder_out.weight"].numpy(),
        np.asarray(params["params"]["encoder_out"]["kernel"]).T,
    )
