"""The port's EDM core, patching, resizes and metrics
(``ace_tpu_torch/downscaling/diffusion.py``, ``models.py``,
``patching.py``, ``resize.py``, ``metrics.py`` and
``aggregator/one_step.py:EnsembleOneStepAggregator``) against
``ace_tpu``'s, float32 on both sides: the preconditioning and the sampler
(with and without churn, a toy denoiser) within 1e-5 of the largest
value; a small diffusion model (the compact UNet of one level on a 16x16
fine grid, residual prediction, fine topography; ``test_torch_song_unet``
holds the networks' levels) from the same weights: its EDM loss
within 1e-5, its gradients within 1e-3 of each gradient's norm (plus 1e-6
of the largest), one Adam update, and ``generate`` with ``ace_tpu``'s
draws (3 Heun steps, churn) within 1e-4 of the field's std; the
mixture-of-experts routing exactly; the noise distributions by their
statistics; patches and compositing exactly; both resizes at the edges
(factors 2, 4, 32) within 1e-6; the metrics and both aggregators within
1e-5. ``ace_tpu``'s random draws are reproduced with ``jax.random`` from
the same key and passed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.aggregator.one_step import (
    EnsembleOneStepAggregator as JaxEnsembleAggregator,
)
from ace_tpu.core.coordinates import LatLonCoordinates as JaxLatLon
from ace_tpu.core.dataset_info import DatasetInfo as JaxDatasetInfo
from ace_tpu.core.gridded_ops import LatLonOperations as JaxOps
from ace_tpu.core.metrics import spherical_area_weights
from ace_tpu.core.optimization import OptimizationConfig as JaxOptConfig
from ace_tpu.downscaling import diffusion as jax_diffusion
from ace_tpu.downscaling import metrics as jax_metrics
from ace_tpu.downscaling import patching as jax_patching
from ace_tpu.downscaling.models import (
    DiffusionModelConfig as JaxDiffusionModelConfig,
)
from ace_tpu.core.config import from_dict as jax_from_dict
from ace_tpu_torch.aggregator.one_step import EnsembleOneStepAggregator
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.coordinates import LatLonCoordinates
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.gridded_ops import LatLonOperations
from ace_tpu_torch.core.optimization import OptimizationConfig
from ace_tpu_torch.downscaling import diffusion, metrics, patching
from ace_tpu_torch.downscaling.models import DiffusionModelConfig
from ace_tpu_torch.downscaling.resize import resize
from ace_tpu_torch.models.layers import init_weights
from ace_tpu_torch.utils.convert import state_dict_to_flax_params

torch.set_num_threads(2)

OUT_TOL = 1e-5
GRAD_TOL = 1e-3
GENERATE_TOL = 1e-4
RESIZE_TOL = 1e-6
METRIC_TOL = 1e-5


def _draw(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(ours, ref, tol, scale=None):
    ref = np.asarray(ref)
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=0,
                               atol=tol * max(scale, 1e-30))


# --- preconditioning, noise, sampler -----------------------------------


def _toy_net(lib):
    """A raw network with every input in play."""
    def net(x, cond, c_noise):
        c = c_noise.reshape((-1, 1, 1, 1))
        return lib.tanh(x * (1 + c)) + 0.3 * cond[..., :1]
    return net


def test_precondition_matches_ace_tpu():
    x, cond = _draw((3, 4, 5, 1), 1), _draw((3, 4, 5, 2), 2)
    sigma = np.exp(_draw((3,), 3)).astype(np.float32)
    ours = diffusion.edm_precondition(_toy_net(torch), 0.5)(
        torch.as_tensor(x), torch.as_tensor(cond), torch.as_tensor(sigma))
    ref = jax_diffusion.edm_precondition(_toy_net(jnp), 0.5)(x, cond, sigma)
    _close(ours, ref, OUT_TOL)


@pytest.mark.parametrize("churn", [0.0, 2.0])
def test_sampler_matches_ace_tpu_with_its_draws(churn):
    """Heun steps on a toy denoiser, ``ace_tpu``'s latents and churn noise
    passed in; the churn window (S_min, S_max) leaves some steps out."""
    steps, shape = 5, (2, 4, 6, 1)
    cond = _draw((2, 4, 6, 2), 4)
    key = jax.random.PRNGKey(3)
    latents = np.asarray(jax.random.normal(jax.random.PRNGKey(9), shape))
    eps, k = [], key
    for _ in range(steps):
        k, k_eps = jax.random.split(k)
        eps.append(torch.as_tensor(np.asarray(
            jax.random.normal(k_eps, shape))))
    kw = dict(num_steps=steps, sigma_min=0.002, sigma_max=80.0,
              S_churn=churn, S_min=0.05, S_max=50.0)
    ref = jax_diffusion.stochastic_sampler(
        jax_diffusion.edm_precondition(_toy_net(jnp), 1.0), latents, cond,
        key, **kw)
    calls = []

    def counted(x, c, s):
        calls.append(s)
        return diffusion.edm_precondition(_toy_net(torch), 1.0)(x, c, s)

    ours = diffusion.stochastic_sampler(
        counted, torch.as_tensor(latents), torch.as_tensor(cond), eps=eps,
        **kw)
    _close(ours, ref, OUT_TOL)
    assert len(calls) == 2 * steps - 1
    assert all(isinstance(s, float) for s in calls)


def test_noise_distributions_by_their_statistics():
    n = 200_000
    gen = torch.Generator().manual_seed(0)
    log_n = torch.log(diffusion.LogNormalNoiseDistribution(-1.2, 1.8)
                      .sample(gen, (n,))).double()
    assert abs(float(log_n.mean()) + 1.2) < 5 * 1.8 / n ** 0.5
    assert abs(float(log_n.std()) - 1.8) < 5 * 1.8 / (2 * n) ** 0.5
    lo, hi = np.log(0.002), np.log(80.0)
    log_u = torch.log(diffusion.LogUniformNoiseDistribution(0.002, 80.0)
                      .sample(gen, (n,))).double()
    width = hi - lo
    assert float(log_u.min()) >= lo - 1e-5 and float(log_u.max()) <= hi
    assert abs(float(log_u.mean()) - (lo + hi) / 2) < 5 * width / (
        12 * n) ** 0.5
    assert abs(float(log_u.var()) - width ** 2 / 12) < 0.01 * width ** 2 / 12


def test_moe_routing_matches_ace_tpu():
    ranges = [(0.002, 1.0), (1.0, 10.0), (10.0, 80.0)]

    def expert(lib, value):
        return lambda x, c, s: lib.full_like(x, value)

    jax_moe = jax_diffusion.make_moe_denoiser(
        ranges, [expert(jnp, float(i)) for i in range(3)])
    moe = diffusion.make_moe_denoiser(
        ranges, [expert(torch, float(i)) for i in range(3)])
    x = np.zeros((1, 2, 2, 1), np.float32)
    for sigma in (1e-4, 0.002, 0.5, 1.0, 1.0000001, 5.0, 10.0, 50.0, 80.0,
                  100.0):
        want = float(jax_moe(x, x, jnp.full((1,), sigma))[0, 0, 0, 0])
        assert float(moe(torch.as_tensor(x), torch.as_tensor(x),
                         sigma)[0, 0, 0, 0]) == want, sigma
    with pytest.raises(TypeError, match="host float"):
        moe(torch.as_tensor(x), torch.as_tensor(x), torch.ones(1))
    with pytest.raises(ValueError, match="contiguous"):
        diffusion.make_moe_denoiser([(0.002, 1.0), (2.0, 10.0)],
                                    [None, None])


# --- a small diffusion model ------------------------------------------

NAMES_IN, NAMES_OUT = ["x", "a"], ["x"]
COARSE, FACTOR = (8, 8), 2


def _model_dict(churn=0.5):
    return {
        "in_names": NAMES_IN, "out_names": NAMES_OUT,
        "normalization": {
            "coarse": {"means": {"x": 1.0, "a": -2.0},
                       "stds": {"x": 2.0, "a": 0.5}},
            "fine": {"means": {"x": 0.5}, "stds": {"x": 3.0}},
        },
        "module": {"base_channels": 8, "channel_mults": [1],
                   "num_res_blocks": 1, "num_heads": 2},
        "downscale_factor": FACTOR, "num_diffusion_generation_steps": 3,
        "churn": churn, "predict_residual": True,
        "use_fine_topography": True, "p_mean": -1.0, "p_std": 1.5,
        "loss_weights": {"output_channels": {"x": 2.0},
                         "noise_weight_exponent": 0.8},
    }


def _lat_lon(n_lat, n_lon):
    return (np.linspace(-60.0, 60.0, n_lat),
            np.linspace(0.0, 360.0, n_lon, endpoint=False))


def _models():
    lat, lon = _lat_lon(*COARSE)
    static = _draw((COARSE[0] * FACTOR, COARSE[1] * FACTOR, 1), 11)
    model = from_dict(DiffusionModelConfig, _model_dict()).build(
        DatasetInfo(horizontal_coordinates=LatLonCoordinates(lat=lat,
                                                             lon=lon)),
        static_inputs=static, device="cpu")
    gen = torch.Generator().manual_seed(0)
    init_weights(model.net, gen)
    with torch.no_grad():  # the zero-initialized convolutions count too
        for p in model.net.parameters():
            fan = p[0].numel() if p.dim() > 1 else 1
            p.add_(0.3 * torch.randn(p.shape, generator=gen) / fan ** 0.5)
    jax_model = jax_from_dict(JaxDiffusionModelConfig, _model_dict()).build(
        JaxDatasetInfo(horizontal_coordinates=JaxLatLon(lat=lat, lon=lon)),
        static_inputs=static)
    jax_model.params = {"params": state_dict_to_flax_params(
        model.net.state_dict())}
    return model, jax_model


@pytest.fixture(scope="module")
def models():
    return _models()


def _fields(batch, seed):
    coarse = {n: _draw((batch, *COARSE), seed + i)
              for i, n in enumerate(NAMES_IN)}
    fine = {"x": _draw((batch, COARSE[0] * FACTOR, COARSE[1] * FACTOR),
                       seed + 5) * 3.0 + 0.5}
    return coarse, fine


def _torch(fields):
    return {k: torch.as_tensor(v) for k, v in fields.items()}


def test_loss_gradients_and_one_update_match_ace_tpu(models):
    """The EDM loss (residual target, static channel, channel weights,
    the weight's exponent, ``p_mean``/``p_std`` folded) from ``ace_tpu``'s
    sigma and noise; its gradients; one Adam step from them."""
    model, jax_model = models
    coarse, fine = _fields(3, 20)
    key = jax.random.PRNGKey(4)
    rng, _dropout = jax.random.split(key)
    k_sigma, k_noise = jax.random.split(rng)
    sigma = np.asarray(jax_model._noise_dist.sample(k_sigma, (3,)))
    noise = np.asarray(jax.random.normal(k_noise, (3, 16, 16, 1)))
    params = jax_model.params
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_model.loss_fn))(
        params, coarse, fine, key)
    loss = model.loss_fn(_torch(coarse), _torch(fine),
                         sigma=torch.as_tensor(sigma),
                         noise=torch.as_tensor(noise))
    _close(float(loss.detach()), float(ref_loss), OUT_TOL)
    names = [k for k, _ in model.net.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.net.parameters()))
    ours = state_dict_to_flax_params(dict(zip(names, grads)))
    flat = jax.tree_util.tree_flatten_with_path(ref_grads["params"])[0]
    largest = max(np.linalg.norm(np.asarray(g)) for _, g in flat)

    def leaf(tree, path):
        for k in path:
            tree = tree[k.key]
        return np.asarray(tree)

    for path, g in flat:
        g = np.asarray(g)
        np.testing.assert_allclose(
            leaf(ours, path), g, rtol=0,
            atol=GRAD_TOL * np.linalg.norm(g) + 1e-6 * largest,
            err_msg=jax.tree_util.keystr(path))

    # one Adam step: where a gradient is ten times the gradients' allowance
    # above 0, the update lr * g / (|g| + eps) agrees within 1e-6 of lr;
    # elsewhere its sign may be rounding's, and it is bounded by lr
    lr = 1e-3
    opt = jax_from_dict(JaxOptConfig, {"lr": lr}).build(max_epochs=1)
    updates, _ = opt.tx.update(ref_grads, opt.init(params), params)
    port_opt = from_dict(OptimizationConfig, {"lr": lr}).build(max_epochs=1)
    weights = [p.detach().clone() for p in model.net.parameters()]
    port_opt.init(weights)
    before = [w.clone() for w in weights]
    port_opt.step(weights, list(grads))
    moved = state_dict_to_flax_params(
        {n: w - b for n, w, b in zip(names, weights, before)})
    for (path, u), (_, g) in zip(
            jax.tree_util.tree_flatten_with_path(updates["params"])[0], flat):
        u, g, m = np.asarray(u), np.asarray(g), leaf(moved, path)
        # the change read back from the weights carries their rounding
        ulp = 2 * np.spacing(np.abs(leaf(params["params"], path)))
        clear = np.abs(g) >= 10 * (GRAD_TOL * np.linalg.norm(g)
                                   + 1e-6 * largest)
        assert (np.abs(m - u) <= 1e-6 * lr + ulp)[clear].all(), path
        assert (np.abs(m) <= lr * (1 + 1e-5) + ulp).all(), path


def test_generate_matches_ace_tpu_with_its_draws(models):
    """Two samples of 3 Heun steps with churn 0.5 from ``ace_tpu``'s
    latents and churn noise (the keys ``generate`` and the sampler split),
    denormalized, residual base added."""
    model, jax_model = models
    coarse, _ = _fields(2, 30)
    key = jax.random.PRNGKey(6)
    ref = np.asarray(jax_model.generate(coarse, key, n_samples=2)["x"])
    latents, eps, rng = [], [], key
    for _ in range(2):
        rng, k_lat, k_samp = jax.random.split(rng, 3)
        latents.append(torch.as_tensor(np.asarray(
            jax.random.normal(k_lat, (2, 16, 16, 1)))))
        steps, k = [], k_samp
        for _ in range(3):
            k, k_eps = jax.random.split(k)
            steps.append(torch.as_tensor(np.asarray(
                jax.random.normal(k_eps, (2, 16, 16, 1)))))
        eps.append(steps)
    ours = model.generate(_torch(coarse), n_samples=2, latents=latents,
                          eps=eps)["x"]
    assert ours.shape == ref.shape == (2, 2, 16, 16)
    _close(ours, ref, GENERATE_TOL, scale=float(ref.std()))


def test_the_models_own_draws_are_seeded(models):
    model, _ = models
    coarse, _ = _fields(1, 40)
    a, b = (model.generate(_torch(coarse), torch.Generator().manual_seed(s),
                           n_samples=2)["x"] for s in (1, 1))
    assert torch.equal(a, b) and not torch.equal(a[:, 0], a[:, 1])


# --- patching ------------------------------------------------------------


@pytest.mark.parametrize("extent,patch,overlap,drop", [
    ((10, 14), (6, 6), 2, False), ((31, 31), (16, 16), 1, False),
    ((32, 64), (16, 16), 1, True), ((9, 9), (4, 5), 0, False)])
def test_patches_and_compositing_match_ace_tpu(extent, patch, overlap, drop):
    ours = patching.get_patches(extent, patch, overlap, drop)
    ref = jax_patching.get_patches(extent, patch, overlap, drop)
    assert [(p.input_slice.y, p.input_slice.x, p.output_slice.y,
             p.output_slice.x) for p in ours] == [
        (p.input_slice.y, p.input_slice.x, p.output_slice.y,
         p.output_slice.x) for p in ref]
    scaled = [patching.scale_patch(p, 3) for p in ours]
    preds = [{"v": _draw((2, 1, patch[0] * 3, patch[1] * 3), i)}
             for i in range(len(ours))]
    got = patching.composite_patch_predictions(
        [_torch(p) for p in preds], scaled)["v"]
    want = jax_patching.composite_patch_predictions(
        preds, [jax_patching.scale_patch(p, 3) for p in ref])["v"]
    _close(got, want, 1e-7)


# --- resizes -------------------------------------------------------------


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("factor", [2, 4, 32])
def test_resizes_match_jax_image_resize_at_the_edges(method, factor):
    """Every output (the edge pixels included) of ``jax.image.resize``."""
    x = _draw((2, 3, 5), factor)
    out = (3 * factor, 5 * factor)
    ours = resize(torch.as_tensor(x), out, method)
    ref = jax.image.resize(x, (2, *out), method=method)
    _close(ours, ref, RESIZE_TOL, scale=1.0)
    edges = np.concatenate([np.asarray(ref)[:, [0, -1]].ravel(),
                            np.asarray(ref)[:, :, [0, -1]].ravel()])
    got = ours.numpy()
    np.testing.assert_allclose(
        np.concatenate([got[:, [0, -1]].ravel(), got[:, :, [0, -1]].ravel()]),
        edges, rtol=0, atol=RESIZE_TOL)
    if method == "bicubic":  # F.interpolate's cubic differs at the edges
        torch_cubic = torch.nn.functional.interpolate(
            torch.as_tensor(x)[:, None], size=out, mode="bicubic",
            align_corners=False)[:, 0]
        assert float((torch_cubic - torch.as_tensor(np.asarray(ref))
                      ).abs().max()) > 1e-3


# --- metrics and aggregators -----------------------------------------------


def test_metric_functions_match_ace_tpu():
    tgt, pred = _draw((2, 24, 32), 50), _draw((2, 3, 24, 32), 51)
    t, p = torch.as_tensor(tgt), torch.as_tensor(pred)
    for name in ("compute_crps", "compute_mae_error", "compute_rank"):
        _close(getattr(metrics, name)(t, p),
               getattr(jax_metrics, name)(tgt, pred), METRIC_TOL)
    folded, rep = pred.reshape(-1, 24, 32), np.repeat(tgt, 3, axis=0)
    # PSNR within 1e-5 of its value, SSIM of its range (1): the SSIM of
    # unrelated fields is near 0
    for name, scale in (("compute_psnr", None), ("compute_ssim", 1.0)):
        _close(getattr(metrics, name)(torch.as_tensor(folded),
                                      torch.as_tensor(rep), True),
               getattr(jax_metrics, name)(folded, rep, True), METRIC_TOL,
               scale=scale)
    _close(metrics.compute_zonal_power_spectrum(t),
           jax_metrics.compute_zonal_power_spectrum(tgt), METRIC_TOL)
    _close(metrics.interpolate_bicubic(t[:, :6, :8], 4),
           jax_metrics.interpolate_bicubic(tgt[:, :6, :8], 4), RESIZE_TOL,
           scale=1.0)
    one = metrics.get_sample_mae_estimate(p[:, :1])
    assert torch.isnan(one).all()


def test_aggregators_match_ace_tpu():
    """Two batches through ``GenerationMetricsAggregator`` (logs and
    diagnostics) and ``EnsembleOneStepAggregator``."""
    gen_agg = metrics.GenerationMetricsAggregator(4)
    jax_gen_agg = jax_metrics.GenerationMetricsAggregator(4)
    lat, _ = _lat_lon(12, 16)
    weights = spherical_area_weights(lat, 16)
    ens = EnsembleOneStepAggregator(LatLonOperations(weights))
    jax_ens = JaxEnsembleAggregator(JaxOps(weights))
    for seed in (60, 70):
        tgt = _draw((2, 12, 16), seed)
        pred = _draw((2, 3, 12, 16), seed + 1) * 0.8 + tgt[:, None]
        coarse = _draw((2, 3, 4), seed + 2)
        gen_agg.record_batch({"v": torch.as_tensor(tgt)},
                             {"v": torch.as_tensor(pred)},
                             {"v": torch.as_tensor(coarse)})
        jax_gen_agg.record_batch({"v": tgt}, {"v": pred}, {"v": coarse})
        ens.record_batch({"v": torch.as_tensor(pred)},
                         {"v": torch.as_tensor(tgt)})
        jax_ens.record_batch({"v": pred}, {"v": tgt})
    for ours, ref in ((gen_agg.get_logs("d"), jax_gen_agg.get_logs("d")),
                      (ens.get_logs("e"), jax_ens.get_logs("e"))):
        assert sorted(ours) == sorted(ref)
        for k in ref:
            _close(ours[k], ref[k], METRIC_TOL)
    ours, ref = gen_agg.get_diagnostics(), jax_gen_agg.get_diagnostics()
    assert sorted(ours) == sorted(ref)
    for k in ref:
        _close(ours[k], ref[k], METRIC_TOL)


def test_prescribed_cells_report_no_spread_skill_bias():
    """Where every member equals the target (a prescribed half of the
    field) the spread-skill map is exactly 0, and elsewhere it is
    ``ace_tpu``'s. (``ace_tpu``'s ``jnp.var`` of equal members is rounding,
    1e-14, so it scores those cells by their noise.)"""
    lat, _ = _lat_lon(12, 16)
    ens = EnsembleOneStepAggregator(LatLonOperations(
        spherical_area_weights(lat, 16)))
    jax_ens = JaxEnsembleAggregator(JaxOps(spherical_area_weights(lat, 16)))
    tgt = _draw((2, 12, 16), 80)
    pred = _draw((2, 3, 12, 16), 81) * 0.8 + tgt[:, None]
    pred[..., :6, :] = tgt[:, None, :6, :]
    ens.record_batch({"v": torch.as_tensor(pred)},
                     {"v": torch.as_tensor(tgt)})
    jax_ens.record_batch({"v": pred}, {"v": tgt})
    ens.get_logs(), jax_ens.get_logs()
    ours, ref = ens._ssr_bias_map("v"), jax_ens._ssr_bias_map("v")
    assert not ours[:6].any()
    _close(ours[6:], ref[6:], METRIC_TOL)
