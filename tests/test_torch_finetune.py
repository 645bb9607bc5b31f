"""Fine-tuning in the port against ``ace_tpu``: weight transfer from a base
checkpoint (an exclude rule, and a narrower base whose tensors land as
their leading slices), frozen parameters, the L2-SP term, copying weights
back after each update, gradient accumulation and Adam's state taken from
another run, each over several train steps of both packages' train
steppers from the same weights, batches and noise (a small
NoiseConditionedSFNO, 8x16, MSE loss). Also: wildcard rules select the
same tensors in both, each package reads the other's fine-tuning
checkpoint, and ``optimize_last_step_only`` keeps no graph of its earlier
steps.

Tolerances are those of ``tests/test_torch_train.py``: float32 on both
sides in another summation order, so losses within 1e-4 and each
tensor's change from its start within 1e-2 relative L2 (Adam moves a
weight by about the rate whatever its gradient's size); the moments
within 1e-3 relative L2; the start weights, frozen and copied tensors and
all counts exactly.
"""

import types
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ace_tpu.core import coordinates as jax_coords
from ace_tpu.core import wildcard as jax_wildcard
from ace_tpu.core.config import from_dict as jax_from_dict
from ace_tpu.core.config import to_dict as jax_to_dict
from ace_tpu.core.dataset_info import DatasetInfo as JaxDatasetInfo
from ace_tpu.core.loss import StepLossConfig as JaxStepLossConfig
from ace_tpu.core.optimization import EMAConfig as JaxEMAConfig
from ace_tpu.core.optimization import OptimizationConfig as JaxOptConfig
from ace_tpu.core.step import StepSelector as JaxStepSelector
from ace_tpu.core.step.single_module import (
    SingleModuleStepConfig as JaxSingleModuleStepConfig,
)
from ace_tpu.models.conditional_sfno import (
    NoiseConditionedSFNO as JaxNoiseConditionedSFNO,
)
from ace_tpu.stepper import checkpoint as jax_checkpoint
from ace_tpu.stepper import parameter_init as jax_pinit
from ace_tpu.stepper.stepper import StepperConfig as JaxStepperConfig
from ace_tpu.stepper.train import StepperTrainConfig as JaxTrainConfig
from ace_tpu.stepper.train import TrainStepper as JaxTrainStepper
from ace_tpu.train.trainer import Trainer as JaxTrainer
from ace_tpu_torch.core import coordinates, wildcard
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.loss import StepLossConfig
from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
from ace_tpu_torch.core.step import StepSelector
from ace_tpu_torch.models.conditional_sfno import NoiseConditionedSFNO
from ace_tpu_torch.stepper import checkpoint
from ace_tpu_torch.stepper import parameter_init
from ace_tpu_torch.stepper.stepper import Stepper, StepperConfig
from ace_tpu_torch.stepper.train import StepperTrainConfig, TrainStepper
from ace_tpu_torch.train.trainer import Trainer
from ace_tpu_torch.utils.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)

torch.set_num_threads(2)

NLAT, NLON, NOISE, B = 8, 16, 8, 2
PROGNOSTIC = ["air_temperature_0", "specific_total_water_0", "PRESsfc",
              "surface_temperature"]
FORCING = ["DSWRFtoa", "ocean_fraction"]
NAMES = sorted(PROGNOSTIC + FORCING + ["PRATEsfc"])
LOSS = {"type": "MSE"}


def _step_dict(embed):
    return dict(
        builder={"type": "NoiseConditionedSFNO", "config": {
            "embed_dim": embed, "noise_embed_dim": NOISE,
            "noise_type": "isotropic", "num_layers": 1, "affine_norms": True,
            "data_grid": "equiangular"}},
        in_names=PROGNOSTIC + FORCING, out_names=PROGNOSTIC + ["PRATEsfc"],
        normalization={"network": {
            "means": {n: 1.0e5 if n == "PRESsfc" else 0.0 for n in NAMES},
            "stds": {n: 1000.0 if n == "PRESsfc" else 1.0 for n in NAMES}}},
        ocean={"surface_temperature_name": "surface_temperature",
               "ocean_fraction_name": "ocean_fraction"},
    )


def _grid(module):
    return module.LatLonCoordinates(
        lat=np.linspace(-78.75, 78.75, NLAT),
        lon=np.linspace(0, 360, NLON, endpoint=False))


def _jax_stepper(embed):
    """ace_tpu's stepper; its ``init_params`` gives one draw per width and
    seed, made once (each stepper would compile its own)."""
    info = JaxDatasetInfo(horizontal_coordinates=_grid(jax_coords),
                          timestep=timedelta(hours=6))
    step = jax_from_dict(JaxSingleModuleStepConfig, _step_dict(embed))
    config = JaxStepperConfig(step=JaxStepSelector(
        type="single_module", config=jax_to_dict(step)))
    stepper = config.get_stepper(info)

    def init_params(rng):
        key = (embed, tuple(np.asarray(jax.random.key_data(rng)).ravel())
               if jnp.issubdtype(rng.dtype, jax.dtypes.prng_key)
               else tuple(np.asarray(rng).ravel()))
        if key not in _DRAWS:
            _DRAWS[key] = jax.jit(stepper.step.init_params)(rng)
        stepper.params = _DRAWS[key]
        return stepper.params

    stepper.init_params = init_params
    return stepper, config


_DRAWS: dict = {}


def _port_stepper(embed):
    info = DatasetInfo(horizontal_coordinates=_grid(coordinates),
                       timestep=timedelta(hours=6))
    config = StepperConfig(step=StepSelector(type="single_module",
                                             config=_step_dict(embed)))
    return config.get_stepper(info, device="cpu"), config


def _noise(batch):
    return np.random.RandomState(batch).randn(
        batch, NLAT, NLON, NOISE).astype(np.float32)


@pytest.fixture(autouse=True)
def fixed_noise(monkeypatch):
    monkeypatch.setattr(JaxNoiseConditionedSFNO, "_make_noise",
                        lambda self, batch: jnp.asarray(_noise(batch)))
    monkeypatch.setattr(
        NoiseConditionedSFNO, "make_noise",
        lambda self, batch, generator: torch.from_numpy(_noise(batch)))


def _batch(seed, n_forward=1):
    rng = np.random.RandomState(seed)
    out = {k: rng.randn(B, n_forward + 1, NLAT, NLON).astype(np.float32)
           for k in NAMES}
    out["PRESsfc"] = out["PRESsfc"] * 1000 + 1.0e5
    out["ocean_fraction"] = np.clip(np.abs(out["ocean_fraction"]), 0, 1)
    return out


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    """Base checkpoints written by ace_tpu: one of the fine-tuned model's
    width (embed 16), one narrower (embed 12)."""
    tmp = tmp_path_factory.mktemp("finetune")
    out = {}
    for label, embed, seed in (("same", 16, 7), ("narrow", 12, 8)):
        stepper, config = _jax_stepper(embed)
        stepper.params = stepper.init_params(jax.random.PRNGKey(seed))
        out[label] = str(tmp / f"base_{label}.msgpack")
        jax_checkpoint.save_stepper(out[label], stepper, config)
    return tmp, out


def _as_state(params) -> dict[str, torch.Tensor]:
    return flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                            params))


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _run_both(base, pinit=None, opt=None, copy=None, n_updates=3):
    """``n_updates`` train steps of both packages' train steppers with the
    same fine-tuning options, the port started from ace_tpu's draw of the
    weights it does not transfer. Returns both sides' start weights, end
    weights, EMA, optax state tree (ace_tpu) and the port's train
    stepper."""
    pinit = {"weights_path": base, **(pinit or {})}
    opt = {"lr": 1e-3, "optimizer_type": "AdamW", "max_grad_norm": 0.5,
           **(opt or {})}
    stepper, _ = _jax_stepper(16)
    jts = JaxTrainStepper(
        stepper,
        JaxTrainConfig(loss=jax_from_dict(JaxStepLossConfig, LOSS),
                       parameter_init=jax_from_dict(
                           jax_pinit.ParameterInitializationConfig, pinit)),
        jax_from_dict(JaxOptConfig, opt), JaxEMAConfig(decay=0.9))
    drawn = _as_state(stepper.init_params(jax.random.PRNGKey(0)))
    params, opt_state = jts.init(jax.random.PRNGKey(0))
    jax_start = _as_state(params)
    jax_copy = (jax_pinit.CopyWeightsConfig(**copy).build(params)
                if copy else None)
    step = jts.build_train_step(donate=False)
    jax_metrics = []
    for i in range(n_updates):
        params, opt_state, metrics = step(
            params, opt_state, {k: jnp.asarray(v)
                                for k, v in _batch(i).items()},
            jax.random.PRNGKey(i), 1)
        jts.optimization._count += 1
        if jax_copy is not None:
            params = jax_copy.apply(params)
        jts.ema(params)
        jax_metrics.append({k: float(v) for k, v in metrics.items()})

    port_stepper, _ = _port_stepper(16)
    ts = TrainStepper(
        port_stepper,
        StepperTrainConfig(loss=from_dict(StepLossConfig, LOSS),
                           parameter_init=from_dict(
                               parameter_init.ParameterInitializationConfig,
                               pinit)),
        from_dict(OptimizationConfig, opt), EMAConfig(decay=0.9))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Stepper, "init_params",
                   lambda self, generator=None: self.load_state_dict(drawn))
        ts.init(None)
    port_start = {k: v.clone() for k, v in ts.module.state_dict().items()}
    if copy:
        ts.copy_weights = parameter_init.CopyWeightsConfig(**copy).build(
            ts.module.state_dict())
    port_metrics = []
    for i in range(n_updates):
        metrics = ts.train_step({k: torch.from_numpy(v)
                                 for k, v in _batch(i).items()}, None, 1)
        port_metrics.append({k: float(v) for k, v in metrics.items()})
    return types.SimpleNamespace(
        jts=jts, ts=ts, drawn=drawn, jax_start=jax_start,
        port_start=port_start, jax_end=_as_state(params),
        jax_ema=_as_state(jts.ema.ema_params), opt_state=opt_state,
        jax_metrics=jax_metrics, port_metrics=port_metrics)


def _assert_runs_agree(run, fixed=()):
    """Start weights equal; losses, each tensor's change, the EMA's change
    and the moments within the module's tolerances; the counts equal; the
    tensors in ``fixed`` bit-equal to their start on both sides."""
    for k, v in run.jax_start.items():
        assert torch.equal(run.port_start[k], v), k
    for got, ref in zip(run.port_metrics, run.jax_metrics):
        for k in ("loss", "grad_norm"):
            assert got[k] == pytest.approx(ref[k], rel=1e-4), k
    ts = run.ts
    names = ts.parameter_names()
    end = ts.module.state_dict()
    ema = dict(zip(names, ts.ema.ema_params))
    for k, start in run.jax_start.items():
        if k in fixed:
            assert torch.equal(end[k], start), k
            assert torch.equal(run.jax_end[k], start), k
            continue
        ref = run.jax_end[k] - start
        assert ref.norm() > 0, k
        assert _rel(end[k] - start, ref) <= 1e-2, k
        assert _rel(ema[k] - start, run.jax_ema[k] - start) <= 1e-2, k
    adam = checkpoint._adam_state(jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(run.opt_state)))
    opt = ts.optimization
    assert opt.adam_count == adam["count"]
    assert opt.schedule_count == adam["schedule_count"]
    assert opt._count == run.jts.optimization._count
    assert opt.learning_rate == run.jts.optimization.learning_rate
    for key, moments in (("mu", opt.mu), ("nu", opt.nu)):
        for n, m in zip(names, moments):
            assert _rel(m, adam[key][n]) <= 1e-3, (key, n)
    return adam


@pytest.mark.parametrize("base, exclude", [
    ("same", ["*encoder*"]), ("narrow", None), ("narrow", ["*decoder*"])])
def test_weight_transfer_matches_ace_tpu(bases, base, exclude):
    """The base's weights, but for the excluded ones (ace_tpu's own draw)
    and, from the narrower base, each tensor's leading slice in flax's
    layout: the spectral filters' ``[in, out, l, 2]`` and the Linear
    kernels' ``[in, out]``; then three steps agree."""
    _, paths = bases
    pinit = {"exclude_parameters": exclude} if exclude else {}
    run = _run_both(paths[base], pinit)
    _assert_runs_agree(run)
    base_state = _as_state(jax_checkpoint.load_stepper(paths[base]).params)
    names = dict(zip(run.port_start, wildcard.param_names(run.port_start)))
    excluded = {k for k, n in names.items() if exclude and any(
        wildcard.wildcard_match(p, n) for p in exclude)}
    assert excluded or not exclude
    sliced = []
    for k, v in run.port_start.items():
        if k in excluded:
            assert torch.equal(v, run.drawn[k]), k
            continue
        b = base_state[k]
        if b.shape != v.shape:
            sliced.append(k)
            # the slice in flax's layout, written back through the view
            view, bview = (parameter_init.flax_view(k, t) for t in (v, b))
            sl = tuple(slice(0, min(x, y))
                       for x, y in zip(view.shape, bview.shape))
            assert torch.equal(view[sl], bview[sl]), k
        else:
            assert torch.equal(v, b), k
    if base == "narrow":
        assert any(k.endswith("filter.weight") for k in sliced)
        assert any(run.port_start[k].dim() == 2 for k in sliced)


def test_frozen_parameters_match_ace_tpu(bases):
    """Frozen filters keep their weights on both sides; their gradients
    still count in the clipping norm and their moments still move."""
    _, paths = bases
    rule = {"include": ["*filter*"]}
    run = _run_both(paths["same"], {"frozen_parameters": rule})
    fixed = {k for k, m in parameter_init.FrozenParameterConfig(
        **rule).frozen_mask(run.port_start).items() if m}
    assert fixed and all("filter" in k for k in fixed)
    _assert_runs_agree(run, fixed)
    opt = run.ts.optimization
    names = run.ts.parameter_names()
    assert all(float(m.float().norm()) > 0 for n, m in zip(names, opt.mu)
               if n in fixed)


def test_l2sp_matches_ace_tpu(bases):
    """alpha toward the base's tensors of the same shape, beta toward zero
    for the rest (the narrower base's), over three steps."""
    _, paths = bases
    run = _run_both(paths["narrow"], {"alpha": 0.5, "beta": 0.2})
    _assert_runs_agree(run)
    # the term is in the loss: the same batch without it
    ts = run.ts
    batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
    with_term = float(ts.valid_step(batch, None)["loss"])
    ts.train_config.parameter_init.alpha = 0.0
    ts.train_config.parameter_init.beta = 0.0
    assert float(ts.valid_step(batch, None)["loss"]) < with_term


def test_copy_weights_matches_ace_tpu(bases):
    """``copy_weights_after_batch``: the decoder is reset after each
    update, before the EMA, on both sides."""
    _, paths = bases
    copy = {"include": ["*decoder*"]}
    run = _run_both(paths["same"], copy=copy)
    fixed = {k for k in run.port_start if "decoder" in k}
    assert fixed
    _assert_runs_agree(run, fixed)
    ema = dict(zip(run.ts.parameter_names(), run.ts.ema.ema_params))
    for k in fixed:
        assert torch.equal(ema[k], run.port_start[k]), k


def test_gradient_accumulation_matches_ace_tpu(bases, tmp_path):
    """``gradient_accumulation_steps: 2`` over five batches (two updates
    and one batch accumulated), with frozen filters: the counts (batches,
    Adam's, the schedule's and MultiSteps'), the running mean and the
    moments. Then each package reads the other's checkpoint of that
    state: optax's tree with MultiSteps and the masked link."""
    _, paths = bases
    rule = {"include": ["*filter*"]}
    run = _run_both(paths["same"], {"frozen_parameters": rule},
                    {"gradient_accumulation_steps": 2,
                     "scheduler": {"type": "StepLR", "step_each_iteration":
                                   True, "kwargs": {"step_size": 1,
                                                    "gamma": 0.5}}},
                    n_updates=5)
    fixed = {k for k, m in parameter_init.FrozenParameterConfig(
        **rule).frozen_mask(run.port_start).items() if m}
    adam = _assert_runs_agree(run, fixed)
    opt = run.ts.optimization
    names = run.ts.parameter_names()
    assert (opt._count, opt.adam_count, opt.schedule_count,
            opt.mini_step) == (5, 2, 2, 1)
    assert adam["mini_step"] == 1
    for n, a in zip(names, opt.acc):
        assert _rel(a, adam["acc"][n]) <= 1e-4, n

    # ace_tpu's file read by the port
    jax_stepper = run.jts.stepper
    jax_stepper.params = jax.tree_util.tree_map(
        jnp.asarray, {"params": state_dict_to_flax_params(run.jax_end)})
    jax_path = str(tmp_path / "ace_tpu.msgpack")
    jax_checkpoint.save_train_checkpoint(
        jax_path, jax_stepper, _jax_stepper(16)[1], opt_state=run.opt_state,
        extra={"optimization": run.jts.optimization.get_state()})
    back = checkpoint.read_train_checkpoint(jax_path)["optimizer"]
    fresh = from_dict(OptimizationConfig, {
        "gradient_accumulation_steps": 2}).build(1)
    fresh.init(run.ts.parameters())
    fresh.load_moments(back["count"], [back["mu"][n] for n in names],
                       [back["nu"][n] for n in names],
                       schedule_count=back["schedule_count"])
    fresh.load_accumulation(back["mini_step"], [back["acc"][n]
                                                for n in names])
    assert (fresh.adam_count, fresh.schedule_count, fresh.mini_step) == (
        2, 2, 1)
    for group, key in ((fresh.mu, "mu"), (fresh.nu, "nu"),
                       (fresh.acc, "acc")):
        for n, t in zip(names, group):
            assert torch.equal(t, adam[key][n]), (key, n)

    # the port's file read by ace_tpu: optax's own template accepts it
    port_path = str(tmp_path / "port.msgpack")
    _, config = _port_stepper(16)
    checkpoint.save_train_checkpoint(
        port_path, run.ts.stepper, config, optimization=opt,
        parameter_names=names, ema_state=dict(zip(names, run.ts.ema.ema_params)))
    out = jax_checkpoint.load_train_checkpoint(port_path)
    template = run.jts.optimization.tx.init(out["stepper"].params)
    restored = serialization.from_state_dict(template,
                                             out["optimizer_state_dict"])
    got = checkpoint._adam_state(jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(restored)))
    assert (got["count"], got["schedule_count"], got["mini_step"]) == (
        2, 2, 1)
    for group, key in ((opt.mu, "mu"), (opt.nu, "nu"), (opt.acc, "acc")):
        for n, t in zip(names, group):
            assert torch.equal(got[key][n].to(t.dtype), t), (key, n)


def test_resume_optimizer_state_matches_ace_tpu(bases, tmp_path):
    """``resume_optimizer_ckpt_path``: Adam's moments and count come from
    another run's checkpoint (here one with gradient accumulation, read
    into a run without), the learning-rate schedule and the batch count
    start afresh; then three steps agree. Both trainers' own methods do
    the transfer."""
    _, paths = bases
    source = _run_both(paths["same"], opt={"gradient_accumulation_steps": 2},
                       n_updates=4)
    jax_stepper = source.jts.stepper
    jax_stepper.params = jax.tree_util.tree_map(
        jnp.asarray, {"params": state_dict_to_flax_params(source.jax_end)})
    path = str(tmp_path / "source.msgpack")
    jax_checkpoint.save_train_checkpoint(
        path, jax_stepper, _jax_stepper(16)[1], opt_state=source.opt_state)

    run = _run_both(paths["same"], n_updates=0)
    jax_trainer = types.SimpleNamespace(opt_state=run.opt_state,
                                        train_stepper=run.jts)
    JaxTrainer._load_optimizer_running_state(jax_trainer, path)
    port_trainer = types.SimpleNamespace(train_stepper=run.ts)
    Trainer._load_optimizer_running_state(port_trainer, path)
    opt = run.ts.optimization
    assert (opt.adam_count, opt.schedule_count, opt._count) == (2, 0, 0)
    adam = checkpoint._adam_state(jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(jax_trainer.opt_state)))
    assert (adam["count"], adam["schedule_count"]) == (2, 0)
    for key, moments in (("mu", opt.mu), ("nu", opt.nu)):
        for n, m in zip(run.ts.parameter_names(), moments):
            assert torch.equal(m, adam[key][n]), (key, n)

    # three steps from the transferred state
    step = run.jts.build_train_step(donate=False)
    params = jax.tree_util.tree_map(
        jnp.asarray, {"params": state_dict_to_flax_params(run.jax_start)})
    opt_state = jax_trainer.opt_state
    for i in range(3):
        params, opt_state, _ = step(
            params, opt_state, {k: jnp.asarray(v)
                                for k, v in _batch(i).items()},
            jax.random.PRNGKey(i), 1)
        run.ts.train_step({k: torch.from_numpy(v)
                           for k, v in _batch(i).items()}, None, 1)
    end = run.ts.module.state_dict()
    for k, v in _as_state(params).items():
        start = run.jax_start[k]
        assert _rel(end[k] - start, v - start) <= 1e-2, k


@pytest.mark.parametrize("rules", [
    {"include": ["*filter*"]}, {"exclude": ["*encoder*", "*decoder*"]},
    {"include": ["params/block_0/*"]}, {"include": ["*kernel"]}])
def test_wildcard_rules_select_the_same_tensors(rules):
    """A rule selects the same tensors by flax name in both packages (a
    Linear weight is flax's ``kernel``)."""
    stepper, _ = _jax_stepper(16)
    params = stepper.init_params(jax.random.PRNGKey(0))
    ref = {"/".join(str(p.key) for p in path): m for path, m in
           jax.tree_util.tree_flatten_with_path(
               jax_wildcard.build_mask(params, **rules))[0]}
    port_stepper, _ = _port_stepper(16)
    state = port_stepper.module.state_dict()
    mask = wildcard.build_mask(state, **rules)
    got = dict(zip(wildcard.param_names(state), mask.values()))
    assert got == ref
    assert any(got.values()) and not all(got.values())


def test_unused_rule_raises_in_both():
    stepper, _ = _jax_stepper(16)
    params = stepper.init_params(jax.random.PRNGKey(0))
    port_stepper, _ = _port_stepper(16)
    for fn, tree in ((jax_wildcard.build_mask, params),
                     (wildcard.build_mask, port_stepper.module.state_dict())):
        with pytest.raises(ValueError, match="match no parameters"):
            fn(tree, include=["*no_such_layer*"])


def test_last_step_only_keeps_no_graph_of_earlier_steps():
    """A 3-step ``optimize_last_step_only`` loss: the loss of the last step
    and the gradients of ace_tpu's ``jax.grad`` (where the earlier steps
    stop the gradient), and autograd saves the tensors of one step, as
    many as a 1-step loss saves."""
    stepper, _ = _jax_stepper(16)
    params = stepper.init_params(jax.random.PRNGKey(0))
    jts = JaxTrainStepper(
        stepper, JaxTrainConfig(loss=jax_from_dict(JaxStepLossConfig, LOSS),
                                n_forward_steps=3,
                                optimize_last_step_only=True),
        JaxOptConfig())
    batch = _batch(0, 3)
    (ref_loss, ref_metrics), ref_grads = jax.value_and_grad(
        jts.loss_fn, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0), 3)
    port_stepper, _ = _port_stepper(16)
    port_stepper.load_state_dict(_as_state(params))
    ts = TrainStepper(
        port_stepper,
        StepperTrainConfig(loss=from_dict(StepLossConfig, LOSS),
                           n_forward_steps=3, optimize_last_step_only=True),
        OptimizationConfig())

    def saved(n):
        count = [0]

        def pack(t):
            count[0] += 1
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            total, metrics = ts.loss_fn(
                {k: torch.from_numpy(v) for k, v in _batch(0, n).items()},
                None, n)
        return total, metrics, count[0]

    _, _, one_step = saved(1)
    total, metrics, three_steps = saved(3)
    assert three_steps == one_step
    assert not metrics["loss_step_0"].requires_grad
    assert not metrics["loss_step_1"].requires_grad
    assert float(total.detach()) == float(metrics["loss_step_2"].detach())
    assert float(total.detach()) == pytest.approx(float(ref_loss), rel=1e-4)
    for i in range(3):
        assert float(metrics[f"loss_step_{i}"].detach()) == pytest.approx(
            float(ref_metrics[f"loss_step_{i}"]), rel=1e-4)
    total.backward()
    grads = {n: p.grad for n, p in zip(ts.parameter_names(),
                                       ts.parameters())}
    ref = _as_state(ref_grads)
    for k, g in grads.items():
        assert _rel(g, ref[k]) <= 1e-4, k
