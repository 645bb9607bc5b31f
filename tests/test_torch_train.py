"""The port's TrainStepper against ace_tpu's on a small flagship-like
configuration (NoiseConditionedSFNO with prescribed SST and the dry-air
corrector, 16x32 Gauss grid, residual loss normalization, the CRPS and
energy score ensemble loss): loss and gradients against ``jax.grad``, in
float32 and in bf16 through the kernels' stand-ins (JAX's Pallas kernels
in the interpreter, the port's plain versions), parameters after one train
step, per-block recompute, and the card check's power to see a wrong
filter gradient. The noise is patched in, as in test_torch_stepper.py."""

import functools
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.core import coordinates as jax_coords
from ace_tpu.core.config import from_dict as jax_from_dict
from ace_tpu.core.config import to_dict as jax_to_dict
from ace_tpu.core.dataset_info import DatasetInfo as JaxDatasetInfo
from ace_tpu.core.loss import StepLossConfig as JaxStepLossConfig
from ace_tpu.core.optimization import EMAConfig as JaxEMAConfig
from ace_tpu.core.optimization import OptimizationConfig as JaxOptConfig
from ace_tpu.core.schedule import TimeLengthProbabilities as JaxTLP
from ace_tpu.core.step import StepSelector as JaxStepSelector
from ace_tpu.core.step.single_module import (
    SingleModuleStepConfig as JaxSingleModuleStepConfig,
)
from ace_tpu.models.conditional_sfno import (
    NoiseConditionedSFNO as JaxNoiseConditionedSFNO,
)
from ace_tpu.stepper.stepper import StepperConfig as JaxStepperConfig
from ace_tpu.stepper.train import StepperTrainConfig as JaxTrainConfig
from ace_tpu.stepper.train import TrainStepper as JaxTrainStepper
from ace_tpu_torch import flagship
from ace_tpu_torch.core import coordinates
from ace_tpu_torch.core import schedule
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.loss import StepLossConfig
from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
from ace_tpu_torch.core.step import StepSelector
from ace_tpu_torch.models.conditional_sfno import NoiseConditionedSFNO
from ace_tpu_torch.ops import dhconv_filter as filter_ops
from ace_tpu_torch.stepper.stepper import StepperConfig
from ace_tpu_torch.stepper.train import StepperTrainConfig, TrainStepper
from ace_tpu_torch.utils.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)

torch.set_num_threads(2)

NLAT, NLON, NZ, B, E, NOISE = 16, 32, 2, 2, 2, 8
PROGNOSTIC = (
    [f"air_temperature_{k}" for k in range(NZ)]
    + [f"specific_total_water_{k}" for k in range(NZ)]
    + ["PRESsfc", "surface_temperature"]
)
DIAGNOSTIC = ["PRATEsfc", "LHTFLsfc"]
FORCING = ["DSWRFtoa", "ocean_fraction"]
NAMES = sorted(set(PROGNOSTIC + DIAGNOSTIC + FORCING))
MEANS = {"PRESsfc": 1.0e5, "surface_temperature": 280.0}
STDS = {"PRESsfc": 1000.0, "surface_temperature": 10.0}
AK = np.asarray([100.0, 5000.0, 0.0])
BK = np.asarray([0.0, 0.4, 1.0])
LOSS = {"type": "EnsembleLoss",
        "kwargs": {"crps_weight": 0.9, "energy_score_weight": 0.1}}
OPT = dict(lr=1e-4, optimizer_type="AdamW", max_grad_norm=1.0,
           first_moment_dtype="bfloat16")


def _step_dict(embed, dtype):
    builder = {
        "embed_dim": embed, "noise_embed_dim": NOISE,
        "noise_type": "isotropic", "num_layers": 2, "affine_norms": True,
        "normalize_big_skip": True, "compute_dtype": dtype,
    }
    return dict(
        builder={"type": "NoiseConditionedSFNO", "config": builder},
        in_names=PROGNOSTIC + FORCING,
        out_names=PROGNOSTIC + DIAGNOSTIC,
        normalization={
            "network": {"means": {n: MEANS.get(n, 0.0) for n in NAMES},
                        "stds": {n: STDS.get(n, 1.0) for n in NAMES}},
            # residual stats for the prognostic variables of the loss
            "residual": {"means": {n: 0.1 for n in NAMES},
                         "stds": {n: 2.0 * STDS.get(n, 1.0) for n in NAMES}},
        },
        ocean={"surface_temperature_name": "surface_temperature",
               "ocean_fraction_name": "ocean_fraction"},
        corrector={"conserve_dry_air": True,
                   "force_positive_names": ["specific_total_water_0"]},
    )


def _grid():
    return (jax_coords.gaussian_latitudes(NLAT),
            np.linspace(0, 360, NLON, endpoint=False))


@functools.lru_cache(maxsize=None)
def _jax_stepper(embed, dtype):
    """ace_tpu's stepper and its parameters (built once per width and
    dtype: its initialization compiles)."""
    lat, lon = _grid()
    info = JaxDatasetInfo(
        horizontal_coordinates=jax_coords.LatLonCoordinates(lat=lat, lon=lon),
        vertical_coordinate=jax_coords.HybridSigmaPressureCoordinate(
            ak=AK, bk=BK),
        timestep=timedelta(hours=6),
    )
    step_cfg = jax_from_dict(JaxSingleModuleStepConfig,
                             _step_dict(embed, dtype))
    stepper = JaxStepperConfig(step=JaxStepSelector(
        type="single_module", config=jax_to_dict(step_cfg))).get_stepper(info)
    params = stepper.init_params(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)

    def perturb(path, leaf):
        # noise conditioning and filters large enough to matter
        name = "/".join(str(p.key) for p in path)
        if "w_scale_2d" in name or "w_bias_2d" in name:
            return jnp.asarray(rng.randn(*leaf.shape) * 0.1, leaf.dtype)
        if name.endswith("filter/weight"):
            return jnp.asarray(rng.randn(*leaf.shape) * leaf.shape[0] ** -0.5,
                               leaf.dtype)
        return leaf

    return stepper, jax.tree_util.tree_map_with_path(perturb, params)


def _jax_train_stepper(embed, dtype, n_forward, **opt):
    stepper, params = _jax_stepper(embed, dtype)
    ts = JaxTrainStepper(
        stepper,
        JaxTrainConfig(loss=jax_from_dict(JaxStepLossConfig, LOSS),
                       n_forward_steps=n_forward, n_ensemble=E),
        JaxOptConfig(**dict(OPT, **opt)), JaxEMAConfig(),
    )
    return ts, params


def _torch_train_stepper(embed, dtype, n_forward, params=None, fused=False,
                         **train_kw):
    lat, lon = _grid()
    info = DatasetInfo(
        horizontal_coordinates=coordinates.LatLonCoordinates(lat=lat, lon=lon),
        vertical_coordinate=coordinates.HybridSigmaPressureCoordinate(
            ak=AK, bk=BK),
        timestep=timedelta(hours=6),
    )
    config = StepperConfig(step=StepSelector(
        type="single_module", config=_step_dict(embed, dtype)))
    stepper = config.get_stepper(info, device="cpu")
    stepper.module.use_fused_block_tail(fused)
    if params is not None:
        stepper.load_state_dict(flax_params_to_state_dict(params))
    opt = dict(OPT)
    opt.update(train_kw.pop("opt", {}))
    ts = TrainStepper(
        stepper,
        StepperTrainConfig(loss=from_dict(StepLossConfig, LOSS),
                           n_forward_steps=n_forward, n_ensemble=E,
                           **train_kw),
        from_dict(OptimizationConfig, opt), EMAConfig(),
    )
    if params is None:
        ts.init(torch.Generator().manual_seed(0))
    return ts


def _data(n_forward, seed=0):
    rng = np.random.RandomState(seed)
    batch = {k: rng.randn(B, n_forward + 1, NLAT, NLON).astype(np.float32)
             for k in NAMES}
    batch["PRESsfc"] = batch["PRESsfc"] * 1000 + 1.0e5
    batch["surface_temperature"] = batch["surface_temperature"] * 10 + 280
    for k in range(NZ):
        name = f"specific_total_water_{k}"
        batch[name] = np.abs(batch[name]) * 1e-3
    batch["ocean_fraction"] = np.clip(np.abs(batch["ocean_fraction"]), 0, 1)
    noise = rng.randn(B * E, NLAT, NLON, NOISE).astype(np.float32)
    return batch, noise


def _patch_noise(mp, noise):
    """Both models condition on the same noise field."""
    mp.setattr(JaxNoiseConditionedSFNO, "_make_noise",
               lambda self, batch: jnp.asarray(noise))
    mp.setattr(NoiseConditionedSFNO, "make_noise",
               lambda self, batch, generator: torch.from_numpy(noise))


def _jax_loss_and_grads(embed, dtype, n_forward, env=None):
    batch, noise = _data(n_forward)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in (env or {}).items():
            mp.setenv(k, v)
        _patch_noise(mp, noise)
        ts, params = _jax_train_stepper(embed, dtype, n_forward)
        (loss, metrics), grads = jax.jit(
            jax.value_and_grad(ts.loss_fn, has_aux=True), static_argnums=3,
        )(params, {k: jnp.asarray(v) for k, v in batch.items()},
          jax.random.PRNGKey(1), n_forward)
    return params, float(loss), metrics, grads


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float64)


def _grad_errors(torch_grads, jax_grads):
    """Relative L2 error of each gradient, in the flax layout."""
    out = dict(_flat(state_dict_to_flax_params(torch_grads)))
    ref = dict(_flat(jax_grads["params"] if "params" in jax_grads
                     else jax_grads))
    assert set(out) == set(ref)
    return {k: float(np.linalg.norm(out[k] - r) / max(np.linalg.norm(r),
                                                      1e-30))
            for k, r in ref.items()}


@pytest.fixture(scope="module")
def f32_reference():
    """ace_tpu's loss and gradients of a 1-step float32 rollout, embed 32."""
    return _jax_loss_and_grads(32, "float32", 1)


def test_loss_and_gradients_match_jax_f32(f32_reference, monkeypatch):
    """Float32 on both sides, sums in another order: within 1e-4 (4e-5
    measured). One step: over two, the gradients of this random model
    move by 4e-4 in ace_tpu itself when its inputs move by 1e-7 (the
    abs kinks of the CRPS), so no f32 comparison could hold 1e-4 there."""
    params, ref_loss, _, ref_grads = f32_reference
    batch, noise = _data(1)
    _patch_noise(monkeypatch, noise)
    ts = _torch_train_stepper(32, "float32", 1, params)
    loss, grads = flagship.train_gradients(
        ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-4)
    errs = _grad_errors(grads, ref_grads)
    assert max(errs.values()) <= 1e-4, errs


def test_rollout_losses_match_jax_f32(f32_reference, monkeypatch):
    """A 2-step rollout loss, step by step, within 1e-4 (float32)."""
    params = f32_reference[0]
    batch, noise = _data(2)
    with pytest.MonkeyPatch.context() as mp:
        _patch_noise(mp, noise)
        jts, _ = _jax_train_stepper(32, "float32", 2)
        _, ref = jax.jit(jts.loss_fn, static_argnums=3)(
            params, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(1), 2)
    _patch_noise(monkeypatch, noise)
    ts = _torch_train_stepper(32, "float32", 2, params)
    metrics = ts.valid_step({k: torch.from_numpy(v) for k, v in batch.items()},
                            None)
    assert set(metrics) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(metrics[k]), float(ref[k]),
                                   rtol=1e-4, err_msg=k)


# The biases whose gradient ace_tpu's bf16 model gets from XLA:CPU's bf16
# reduce over the 2048 rows (4 samples x 16 x 32), which rounds every
# partial sum to bf16: 2.8-7.7% off ace_tpu's own float32 gradients at
# embed 128, where the port's bf16 gradients of them are 0.4-0.6% off
# (test_torch_block_tail.py::test_tail_gradients_match_ace_tpu_vjp shows
# the reduce bit for bit on the tail's fc2 bias).
XLA_BF16_SUMS = frozenset(
    ["encoder_0/bias", "decoder_0/bias"]
    + [f"block_{i}/{leaf}" for i in range(2)
       for leaf in ("inner_skip/bias", "mlp/fc1/bias", "mlp/fc2/bias",
                    "norm0/norm/bias")]
)


def test_loss_and_gradients_match_jax_bf16_kernels(monkeypatch):
    """bf16 at embed 128, through the dhconv filter and the fused tail:
    JAX's Pallas kernels in the interpreter (their custom VJPs), the
    port's autograd Functions on their plain versions. bf16 rounds at
    other points on the two sides: the loss within 2e-2 of ace_tpu's bf16
    loss; every gradient within 5e-2 relative L2 of ace_tpu's float32
    gradient of the same model (2.9e-2 measured), and every gradient
    outside ``XLA_BF16_SUMS`` within 5e-2 of ace_tpu's bf16 one (4.2e-2
    measured). For those in ``XLA_BF16_SUMS`` ace_tpu's bf16 gradient is
    more than twice as far from its float32 one as the port's is."""
    env = {"ACE_TPU_PALLAS_FILTER": "interpret",
           "ACE_TPU_PALLAS_BLOCK": "interpret"}
    params, ref_loss, _, ref_grads = _jax_loss_and_grads(128, "bfloat16", 1,
                                                         env)
    f32_params, _, _, f32_grads = _jax_loss_and_grads(128, "float32", 1)
    for a, b in zip(*map(jax.tree_util.tree_leaves, (params, f32_params))):
        np.testing.assert_array_equal(a, b)
    batch, noise = _data(1)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _patch_noise(monkeypatch, noise)
    ts = _torch_train_stepper(128, "bfloat16", 1, params, fused=True)
    loss, grads = flagship.train_gradients(ts, batch)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=2e-2)
    f32_errs = _grad_errors(grads, f32_grads)
    assert max(f32_errs.values()) <= 5e-2, f32_errs
    errs = _grad_errors(grads, ref_grads)
    assert XLA_BF16_SUMS < set(errs)
    held = {k: e for k, e in errs.items() if k not in XLA_BF16_SUMS}
    assert max(held.values()) <= 5e-2, held
    jax_bf16 = dict(_flat(ref_grads["params"]))
    jax_gap = {k: float(np.linalg.norm(jax_bf16[k] - r) / np.linalg.norm(r))
               for k, r in _flat(f32_grads["params"])}
    for k in sorted(XLA_BF16_SUMS):
        print(f"{k}: off ace_tpu's float32 gradient by {jax_gap[k]:.4f} "
              f"(ace_tpu's bf16), {f32_errs[k]:.4f} (the port's bf16)")
        assert jax_gap[k] > 2 * f32_errs[k], (k, jax_gap[k], f32_errs[k])


def test_first_update_matches_jax_at_the_flagship_recipe(monkeypatch):
    """The flagship recipe (``flagship.build_train_stepper``: bf16, per-block
    recompute, 2 members, AdamW at lr 1e-4 with a bf16 first moment and
    clipping at 1.0) at the flagship's width (embed 512) on a 16x32 grid
    with 1 layer, from ace_tpu's own initialization (the filters at std
    1/(in*out)), against ace_tpu's ``build_train_step`` of bench.py's
    recipe (its einsum filter path on the CPU): the first two train steps'
    losses and gradient norms within 1e-2 (bf16 rounding points; 1.4e-3
    measured). The first update raises the loss sixfold on both sides
    (43.6 to 282): Adam moves every filter element by about the learning
    rate, far past its initial size."""
    import bench

    monkeypatch.setattr(bench, "NLAT", NLAT)
    monkeypatch.setattr(bench, "NLON", NLON)
    builder = {"type": "NoiseConditionedSFNO", "config": {
        "embed_dim": 512, "noise_embed_dim": 32, "noise_type": "isotropic",
        "filter_type": "linear", "use_mlp": True, "num_layers": 1,
        "operator_type": "dhconv", "separable": False, "spectral_layers": 3,
        "spectral_transform": "sht", "affine_norms": True,
        "normalize_big_skip": True, "compute_dtype": "bfloat16",
        "checkpointing": 1,
    }}
    jts = JaxTrainStepper(
        bench._stepper(builder),
        JaxTrainConfig(loss=jax_from_dict(JaxStepLossConfig, LOSS),
                       n_forward_steps=1, n_ensemble=E, remat=False),
        JaxOptConfig(**OPT), JaxEMAConfig(),
    )
    params, opt_state = jts.init(jax.random.PRNGKey(0))
    ts = flagship.build_train_stepper(NLAT, NLON, embed=512, layers=1,
                                      device="cpu")
    assert jts.stepper.step.config.get_state() == (
        ts.stepper.step.config.get_state())
    ts.stepper.load_state_dict(flax_params_to_state_dict(params))
    batch = flagship.synthetic_batch(ts.stepper, B,
                                     generator=torch.Generator().manual_seed(1))
    noise = np.random.RandomState(0).randn(B * E, NLAT, NLON, 32).astype(
        np.float32)
    _patch_noise(monkeypatch, noise)
    step = jts.build_train_step(donate=False)
    jax_batch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    ref, out = [], []
    for _ in range(2):
        params, opt_state, m = step(params, opt_state, jax_batch,
                                    jax.random.PRNGKey(1))
        ref.append(m)
        out.append(ts.train_step(batch, None))
    for k in ("loss", "grad_norm"):
        print(f"{k}: ace_tpu {[float(m[k]) for m in ref]}, the port "
              f"{[float(m[k]) for m in out]}")
        np.testing.assert_allclose([float(m[k]) for m in out],
                                   [float(m[k]) for m in ref], rtol=1e-2,
                                   err_msg=k)
    for metrics in (ref, out):
        assert float(metrics[1]["loss"]) > 4 * float(metrics[0]["loss"])


def test_parameters_after_one_train_step_match_jax(f32_reference,
                                                   monkeypatch):
    """One AdamW step from the same parameters, clipped (at 0.01: the
    gradient norm is 0.03): the loss and the gradient norm within 1e-4,
    each parameter's update within 1e-2 relative L2. (Adam's first update
    is g / (|g| + eps) times the learning rate: where |g| is near eps, a
    gradient off by 1e-4 of its norm moves single elements by a few
    percent of the learning rate.)"""
    params, _, _, _ = f32_reference
    batch, noise = _data(1)
    with pytest.MonkeyPatch.context() as mp:
        _patch_noise(mp, noise)
        jts, _ = _jax_train_stepper(32, "float32", 1, max_grad_norm=0.01)
        opt_state = jts.optimization.init(params)
        new_params, _, ref_metrics = jts.build_train_step(donate=False)(
            params, opt_state, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(1),
        )
    _patch_noise(monkeypatch, noise)
    ts = _torch_train_stepper(32, "float32", 1, params,
                              opt={"max_grad_norm": 0.01})
    metrics = ts.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                            None)
    assert float(ref_metrics["grad_norm"]) > 0.01
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]),
                                   rtol=1e-4)
    before = dict(_flat(params["params"]))
    ref = dict(_flat(new_params["params"]))
    out = dict(_flat(state_dict_to_flax_params(ts.module.state_dict())))
    for k, r in ref.items():
        step, ref_step = out[k] - before[k], r - before[k]
        assert (np.linalg.norm(step - ref_step)
                <= 1e-2 * np.linalg.norm(ref_step)), k


def _grads_with(monkeypatch, noise, **train_kw):
    ts = _torch_train_stepper(32, "float32", 2, **train_kw)
    batch, _ = _data(2)
    return flagship.train_gradients(
        ts, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(5))


def test_block_recompute_equals_no_recompute(monkeypatch):
    """checkpointing=1 (the flagship's per-block recompute) gives the same
    loss and gradients as checkpointing=0 on the CPU, bf16 through the
    autograd Functions, the noise drawn from a generator."""
    out = {}
    for level in (0, 1):
        ts = flagship.build_train_stepper(NLAT, NLON, nz=2, embed=64,
                                          layers=2, device="cpu")
        assert ts.module.checkpointing == 1
        ts.module.checkpointing = level
        ts.init(torch.Generator().manual_seed(0))
        batch = flagship.synthetic_batch(
            ts.stepper, generator=torch.Generator().manual_seed(1))
        out[level] = flagship.train_gradients(
            ts, batch, torch.Generator().manual_seed(2))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    errs = flagship.gradient_error(out[1][1], out[0][1])
    assert max(errs.values()) == 0.0, errs


def test_whole_step_recompute_replays_the_noise(monkeypatch):
    """after_n_forward_steps=0 recomputes each rollout step in the
    backward pass; the recompute draws the same noise from the generator
    as the forward did, so the gradients equal those without it."""
    ref = _grads_with(monkeypatch, None)
    out = _grads_with(monkeypatch, None,
                      opt={"checkpoint": {"after_n_forward_steps": 0}})
    torch.testing.assert_close(out[0], ref[0], rtol=0, atol=0)
    errs = flagship.gradient_error(out[1], ref[1])
    assert max(errs.values()) <= 1e-6, errs


def test_optimize_last_step_only_and_valid_step(monkeypatch):
    _, noise = _data(2)
    _patch_noise(monkeypatch, noise)
    batch = {k: torch.from_numpy(v) for k, v in _data(2)[0].items()}
    ts = _torch_train_stepper(32, "float32", 2, optimize_last_step_only=True)
    loss, metrics = ts.loss_fn(batch, None)
    assert float(loss.detach()) == float(metrics["loss_step_1"].detach())
    valid = ts.valid_step(batch, None)
    assert float(valid["loss"]) == float(loss.detach())
    assert not valid["loss"].requires_grad


def _filter_dw_variant(variant):
    plain = filter_ops.dhconv_filter_dw

    def dhconv_filter_dw(xr, xi, gr, gi):
        dw = plain(xr, xi, gr, gi)
        if variant == "zeros":
            return torch.zeros_like(dw)
        return dw.flip(0)  # re and im swapped

    return dhconv_filter_dw


@pytest.mark.parametrize("variant", ["zeros", "swapped"])
def test_train_check_detects_a_wrong_filter_gradient(monkeypatch, variant):
    """The gate of chip_smoke.py's reference phase T (each gradient, under
    the smooth loss, within ``TRAIN_GRAD_TOL`` of the CPU's) fails for a
    dW that writes zeros or swaps re and im, with the weights of
    ``draw_check_weights``."""
    def gradients():
        ts = flagship.build_train_stepper(NLAT, NLON, nz=2, embed=128,
                                          layers=2, device="cpu")
        flagship.draw_check_weights(ts.stepper,
                                    torch.Generator().manual_seed(3))
        batch = flagship.synthetic_batch(
            ts.stepper, generator=torch.Generator().manual_seed(4))
        return flagship.train_gradients(ts, batch,
                                        torch.Generator().manual_seed(5),
                                        smooth=True)

    loss, ref = gradients()
    monkeypatch.setattr(filter_ops, "dhconv_filter_dw",
                        _filter_dw_variant(variant))
    bad_loss, bad = gradients()
    assert float(bad_loss) == float(loss)  # the forward is untouched
    errs = flagship.gradient_error(bad, ref)
    assert max(errs.values()) > flagship.TRAIN_GRAD_TOL, errs


def test_schedule_is_a_copy_of_ace_tpu():
    import inspect

    from ace_tpu.core import schedule as jax_schedule

    def body(module):
        src = inspect.getsource(module)
        return src[src.index("import dataclasses"):]

    assert body(schedule) == body(jax_schedule)
    probs = schedule.TimeLengthProbabilities.from_constant(3)
    assert probs.is_constant and probs.max_n_forward_steps == 3
    outcomes = [schedule.TimeLengthProbability(1, 0.5),
                schedule.TimeLengthProbability(4, 0.5)]
    draws = [schedule.TimeLengthProbabilities(outcomes).sample()
             for _ in range(1)]
    jax_draws = [JaxTLP([jax_schedule.TimeLengthProbability(1, 0.5),
                         jax_schedule.TimeLengthProbability(4, 0.5)]).sample()]
    assert draws == jax_draws


def test_unported_training_options_raise():
    with pytest.raises(ValueError, match="n_ensemble"):
        StepperTrainConfig(loss=from_dict(StepLossConfig, LOSS), n_ensemble=1)
