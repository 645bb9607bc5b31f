"""The port's optimizer, schedules and EMA against ace_tpu's (optax) on
the same parameters and gradients, made with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ace_tpu.core import optimization as jo
from ace_tpu_torch.core import optimization as to

SCHEDULERS = [
    {},
    {"type": "CosineAnnealingLR", "kwargs": {"T_max": 7, "eta_min": 1e-5}},
    {"type": "CosineAnnealingLR"},
    {"type": "CosineAnnealingWarmRestarts", "kwargs": {"T_0": 4}},
    {"type": "StepLR", "kwargs": {"step_size": 3, "gamma": 0.5}},
    {"type": "ExponentialLR", "kwargs": {"gamma": 0.9}},
    {"type": "LinearLR", "kwargs": {"start_factor": 0.1, "total_iters": 6}},
    {"type": "ConstantLR", "kwargs": {"factor": 0.2, "total_iters": 4}},
    {"type": "OneCycleLR", "kwargs": {"max_lr": 3e-3, "total_steps": 20}},
]


@pytest.mark.parametrize("each_iteration", [False, True])
@pytest.mark.parametrize("config", SCHEDULERS,
                         ids=[c.get("type", "none") for c in SCHEDULERS])
def test_schedulers_match_ace_tpu(config, each_iteration):
    """The learning rate of every update count 0..39, with 3 updates an
    epoch (float32 in optax, float64 here)."""
    kw = dict(config, step_each_iteration=each_iteration)
    ref = jo.SchedulerConfig(**kw).build(1e-3, max_epochs=10,
                                         steps_per_epoch=3)
    out = to.SchedulerConfig(**kw).build(1e-3, max_epochs=10,
                                         steps_per_epoch=3)
    for count in range(40):
        np.testing.assert_allclose(out(count), float(ref(count)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(count))


def test_sequential_scheduler_matches_ace_tpu():
    kw = dict(
        schedulers=[
            {"type": "LinearLR", "kwargs": {"start_factor": 0.1,
                                            "total_iters": 3}},
            {"type": "CosineAnnealingLR", "kwargs": {"T_max": 5}},
            {"type": "StepLR", "kwargs": {"step_size": 2}},
        ],
        milestones=[3, 8],
    )
    ref = jo.SequentialSchedulerConfig(
        schedulers=[jo.SchedulerConfig(**s) for s in kw["schedulers"]],
        milestones=kw["milestones"],
    ).build(1e-3, max_epochs=12, steps_per_epoch=2)
    out = to.SequentialSchedulerConfig(
        schedulers=[to.SchedulerConfig(**s) for s in kw["schedulers"]],
        milestones=kw["milestones"],
    ).build(1e-3, max_epochs=12, steps_per_epoch=2)
    for count in range(30):
        np.testing.assert_allclose(out(count), float(ref(count)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(count))


SHAPES = {"a": (4, 3), "b": (7,), "c": (2, 3, 5, 2)}


def _params_and_grads(seed, scale):
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * scale).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("optimizer", ["Adam", "AdamW"])
@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("grad_scale, max_norm", [(1.0, None), (1.0, 1.0),
                                                  (0.01, 1.0)])
def test_updates_match_optax(optimizer, mu_dtype, grad_scale, max_norm):
    """Three updates from the same parameters and gradients, with the
    first moment in float32 or bf16 and clipping off, on (norms ~7 > 1)
    and on but not triggered (norms ~0.07 < 1); Adam with weight decay."""
    kwargs = {"weight_decay": 0.05} if optimizer == "Adam" else {}
    cfg = dict(optimizer_type=optimizer, lr=1e-2, kwargs=kwargs,
               max_grad_norm=max_norm, first_moment_dtype=mu_dtype,
               scheduler={"type": "StepLR",
                          "kwargs": {"step_size": 1, "gamma": 0.5},
                          "step_each_iteration": True})
    jcfg = dict(cfg, scheduler=jo.SchedulerConfig(**cfg["scheduler"]))
    tcfg = dict(cfg, scheduler=to.SchedulerConfig(**cfg["scheduler"]))
    params, grads = _params_and_grads(0, grad_scale)

    ref_opt = jo.OptimizationConfig(**jcfg).build(max_epochs=1)
    ref_params = {k: jnp.asarray(v) for k, v in params.items()}
    state = ref_opt.init(ref_params)
    for g in grads:
        ref_params, state = ref_opt.step(
            ref_params, {k: jnp.asarray(v) for k, v in g.items()}, state
        )

    opt = to.OptimizationConfig(**tcfg).build(max_epochs=1)
    tparams = [torch.from_numpy(params[k].copy()) for k in SHAPES]
    opt.init(tparams)
    for g in grads:
        norm = opt.step(tparams, [torch.from_numpy(g[k]) for k in SHAPES])
        np.testing.assert_allclose(
            float(norm), float(optax.global_norm(g)), rtol=1e-6)
    for k, p in zip(SHAPES, tparams):
        np.testing.assert_allclose(p.numpy(), np.asarray(ref_params[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    adam = next(s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))
    for k, mu, nu in zip(SHAPES, opt.mu, opt.nu):
        assert str(mu.dtype).endswith(mu_dtype or "float32")
        np.testing.assert_allclose(mu.float().numpy(),
                                   np.asarray(adam.mu[k], np.float32),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(nu.numpy(), np.asarray(adam.nu[k]),
                                   rtol=1e-6, atol=1e-12, err_msg=k)


def test_ema_matches_ace_tpu():
    params, grads = _params_and_grads(1, 1.0)
    ref = jo.EMAConfig(decay=0.99).build()
    ref.init({k: jnp.asarray(v) for k, v in params.items()})
    ema = to.EMAConfig(decay=0.99).build()
    ema.init([torch.from_numpy(params[k]) for k in SHAPES])
    for g in grads:  # three different "parameters" in turn
        ref({k: jnp.asarray(v) for k, v in g.items()})
        ema([torch.from_numpy(g[k]) for k in SHAPES])
    for k, e in zip(SHAPES, ema.ema_params):
        np.testing.assert_allclose(e.numpy(), np.asarray(ref.ema_params[k]),
                                   rtol=1e-6, atol=1e-7)
    assert ema.num_updates == ref.num_updates == 3


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        to.OptimizationConfig(optimizer_type="SGD")
    with pytest.raises(NotImplementedError):
        to.SchedulerConfig(type="Cyclic").build(1e-3, 1)
