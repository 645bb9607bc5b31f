"""The conditional SFNO's options in the port against ace_tpu's at 16x32,
ace_tpu's weights carried across by ``utils/convert.py``: the global
``ConditionalLayerNorm`` (float32 and bf16, with its float32 promotion),
``SpectralConvS2`` with ``spectral_ratio`` 0.5 and with LoRA rank 2
(float32, and bf16 through JAX's Pallas filter in the interpreter at
spectral width 128, the dtype of the filter's sum held to ace_tpu's),
``NoiseConditionedSFNO`` with local blocks, labels (``label_embed_dim`` 0
and 2) and every option together: forward and one ``TrainStepper`` loss
and gradients (float32: loss 1e-4, gradients 1e-3 relative L2; bf16: the
rules of tests/test_torch_train.py, loss 2e-2 of ace_tpu's bf16 loss and
gradients 5e-2 of its float32 ones); the fused-tail gate (``_fuses``) and
the converter on each new leaf, both ways. The noise is passed in."""

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
from ace_tpu.core.step import StepSelector as JaxStepSelector
from ace_tpu.core.step.single_module import (
    SingleModuleStepConfig as JaxSingleModuleStepConfig,
)
from ace_tpu.models import conditional_sfno as jax_csfno
from ace_tpu.models import localnet as jax_localnet
from ace_tpu.models import sfno as jax_sfno
from ace_tpu.ops import sht as jax_sht
from ace_tpu.stepper.stepper import StepperConfig as JaxStepperConfig
from ace_tpu.stepper.train import StepperTrainConfig as JaxTrainConfig
from ace_tpu.stepper.train import TrainStepper as JaxTrainStepper
from ace_tpu_torch import flagship
from ace_tpu_torch.core import coordinates
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.loss import StepLossConfig
from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
from ace_tpu_torch.core.step import StepSelector
from ace_tpu_torch.models import conditional_sfno, localnet, sfno
from ace_tpu_torch.models.layers import init_weights
from ace_tpu_torch.ops import sht
from ace_tpu_torch.stepper.stepper import StepperConfig
from ace_tpu_torch.stepper.train import StepperTrainConfig, TrainStepper
from ace_tpu_torch.utils.convert import (
    flax_name,
    flax_params_to_state_dict,
    flax_view,
    state_dict_to_flax_params,
    state_dict_to_flax_variables,
)

torch.set_num_threads(2)

NLAT, NLON, B, E, NOISE = 16, 32, 2, 2, 4
LABELS = ("era5", "shield")
IN_NAMES, OUT_NAMES = ["a", "b", "f"], ["a", "b", "d"]
NAMES = sorted(set(IN_NAMES) | set(OUT_NAMES))
LOSS = {"type": "EnsembleLoss",
        "kwargs": {"crps_weight": 0.9, "energy_score_weight": 0.1}}
OPT = dict(lr=1e-4, optimizer_type="AdamW")
# every option of the conditional SFNO at once
ALL_OPTIONS = dict(local_blocks=[1], lora_rank=2, spectral_ratio=0.5,
                   global_layer_norm=True, affine_norms=True,
                   normalize_big_skip=True, label_embed_dim=2)


def _draw(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _anomaly_ratio(got, ref, tol):
    """The largest error over ``tol`` of each channel's spatial anomaly
    plus 1e-5 of its largest value, ``[..., H, W, C]``."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    spatial = (-3, -2)
    anomaly = np.abs(ref - ref.mean(spatial, keepdims=True)).max(
        spatial, keepdims=True)
    allowed = tol * anomaly + 1e-5 * np.abs(ref).max(spatial, keepdims=True)
    return float((np.abs(got - ref) / allowed).max())


def _perturb(params, seed=1):
    """The leaves that start at or near zero or one (the noise
    conditioning, ``lora_b``, the norms' affine weights) and the filters
    (std 1/(in*out)) drawn so that they show in the outputs."""
    rng = np.random.RandomState(seed)

    def visit(path, leaf):
        name = "/".join(str(p.key) for p in path)
        shape = np.shape(leaf)
        if ("w_scale_2d" in name or "w_bias_2d" in name or "lora_b" in name
                or "norm" in name):
            return np.asarray(rng.randn(*shape) * 0.1
                              + (name.endswith("norm0/weight")
                                 or name.endswith("norm1/weight")), np.float32)
        if name.endswith("filter/weight") and len(shape) == 4:
            return np.asarray(rng.randn(*shape) * shape[0] ** -0.5,
                              np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(visit, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [False, True])
def test_global_layer_norm_matches_ace_tpu(dtype, affine):
    """Normalized over (lat, lon, channel) in float32 and cast back; the
    float32 affine weights come after the cast, so a bf16 input leaves an
    affine norm as float32, on both sides."""
    x = _draw((B, NLAT, NLON, 8)).astype(jnp.dtype(dtype))
    noise = _draw((B, NLAT, NLON, 3), 1)
    jm = jax_csfno.ConditionalLayerNorm(
        n_channels=8, embed_dim_noise=3, global_layer_norm=True,
        elementwise_affine=affine)
    params = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                       jnp.asarray(x), jnp.asarray(noise)))
    ref = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(noise))
    module = conditional_sfno.ConditionalLayerNorm(
        8, 3, elementwise_affine=affine, global_layer_norm=True)
    module.load_state_dict(flax_params_to_state_dict(params))
    got = module(torch.from_numpy(np.asarray(x, np.float32)).to(
        getattr(torch, dtype)), torch.from_numpy(noise))
    want = "float32" if affine else dtype
    assert str(ref.dtype) == want and got.dtype == getattr(torch, want)
    tol = 1e-4 if dtype == "float32" else flagship.CHECK_TOL
    assert _anomaly_ratio(got.float().detach().numpy(),
                          np.asarray(ref, np.float32), tol) <= 1


def _transforms(jax_side):
    kw = dict(lmax=NLAT, mmax=NLON // 2 + 1)
    if jax_side:
        return (jax_sht.build_sht(NLAT, NLON, channels_last=True, **kw),
                jax_sht.build_isht(NLAT, NLON, channels_last=True, **kw))
    return sht.build_sht(NLAT, NLON, **kw), sht.build_isht(NLAT, NLON, **kw)


@pytest.mark.parametrize("dtype,width,options", [
    ("float32", 16, dict(spectral_ratio=0.5)),
    ("float32", 16, dict(lora_rank=2)),
    ("bfloat16", 256, dict(spectral_ratio=0.5)),
    ("bfloat16", 256, dict(spectral_ratio=0.5, lora_rank=2)),
], ids=["f32-ratio", "f32-lora", "bf16-ratio", "bf16-ratio-lora"])
def test_spectral_conv_options_match_ace_tpu(monkeypatch, dtype, width,
                                             options):
    """``pre_proj``/``post_proj`` around a narrowed filter (the residual at
    full width) and the LoRA adapters; in bf16 K1's stand-in computes the
    main product (bf16 out), the LoRA terms are float32, and the sum the
    inverse transform receives has ace_tpu's dtype: bf16 without LoRA,
    float32 with it."""
    monkeypatch.setenv("ACE_TPU_PALLAS_FILTER", "interpret")
    seen = {}

    def recording(cls, key):
        original = cls.inverse_pair

        def inverse_pair(self, cr, ci):
            seen.setdefault(key, str(cr.dtype).replace("torch.", ""))
            return original(self, cr, ci)

        monkeypatch.setattr(cls, "inverse_pair", inverse_pair)

    recording(jax_sht.InverseRealSHT, "jax")
    recording(sht.InverseRealSHT, "port")
    x = _draw((B, NLAT, NLON, width)).astype(jnp.dtype(dtype))
    ft, it = _transforms(True)
    jm = jax_sfno.SpectralConvS2(
        forward_transform=ft, inverse_transform=it, in_channels=width,
        out_channels=width, operator_type="dhconv", use_bias=True, **options)
    params = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                       jnp.asarray(x)))
    seen.clear()
    ref, ref_res = jax.jit(jm.apply)(params, jnp.asarray(x))
    module = sfno.SpectralConvS2(*_transforms(False), width, width,
                                 use_bias=True, **options)
    # the converter knows a spectral weight by its module's name
    state = flax_params_to_state_dict({"filter": params["params"]})
    module.load_state_dict({k.removeprefix("filter."): v
                            for k, v in state.items()})
    with torch.no_grad():
        got, res = module(torch.from_numpy(np.asarray(x, np.float32)).to(
            getattr(torch, dtype)))
    assert seen["port"] == seen["jax"] == (
        "float32" if dtype == "float32" or options.get("lora_rank")
        else "bfloat16"), seen
    assert str(ref.dtype) == dtype and got.dtype == getattr(torch, dtype)
    assert torch.equal(res, torch.from_numpy(
        np.array(ref_res, np.float32)).to(res.dtype))
    tol = 1e-4 if dtype == "float32" else flagship.CHECK_TOL
    assert _anomaly_ratio(got.float().numpy(), np.asarray(ref, np.float32),
                          tol) <= 1
    if options.get("spectral_ratio"):
        assert params["params"]["weight"].shape[:2] == (width // 2,
                                                         width // 2)


def _grid():
    return (jax_coords.gaussian_latitudes(NLAT),
            np.linspace(0, 360, NLON, endpoint=False))


def _step_dict(builder, dtype, conditional=True):
    config = {"embed_dim": 32, "noise_embed_dim": NOISE,
              "noise_type": "isotropic", "num_layers": 2,
              "compute_dtype": dtype, **builder}
    return dict(
        builder={"type": "NoiseConditionedSFNO", "config": config,
                 "conditional": conditional},
        in_names=IN_NAMES, out_names=OUT_NAMES,
        normalization={"network": {"means": {n: 0.0 for n in NAMES},
                                   "stds": {n: 1.0 for n in NAMES}}},
    )


def _shapes(init, *args):
    """The leaves' shapes of the tree ``init(*args)`` would make, traced
    only."""
    return jax.tree_util.tree_map(lambda v: v.shape,
                                  dict(jax.eval_shape(init, *args)))


@functools.lru_cache(maxsize=None)
def _steppers(case, dtype):
    """ace_tpu's and the port's train steppers on the step config of
    ``CASES[case]`` (labels ``LABELS`` in the dataset info), both on the
    port's initial weights (drawn as flax draws them), perturbed, in
    ``ace_tpu``'s tree, which must have ``init_params``' leaves (drawing
    them in flax compiles its initializers once per shape); built once per
    case and dtype."""
    builder = CASES[case]
    lat, lon = _grid()
    jinfo = JaxDatasetInfo(
        horizontal_coordinates=jax_coords.LatLonCoordinates(lat=lat, lon=lon),
        timestep=timedelta(hours=6), all_labels=LABELS)
    info = DatasetInfo(
        horizontal_coordinates=coordinates.LatLonCoordinates(lat=lat, lon=lon),
        timestep=timedelta(hours=6), all_labels=LABELS)
    step = _step_dict(builder, dtype)
    jcfg = jax_from_dict(JaxSingleModuleStepConfig, step)
    jstepper = JaxStepperConfig(step=JaxStepSelector(
        type="single_module", config=jax_to_dict(jcfg))).get_stepper(jinfo)
    stepper = StepperConfig(step=StepSelector(
        type="single_module", config=step)).get_stepper(info, device="cpu")
    stepper.init_params(torch.Generator().manual_seed(0))
    params = _perturb(state_dict_to_flax_variables(
        stepper.module.state_dict()))
    assert jax.tree_util.tree_map(np.shape, params) == _shapes(
        jstepper.init_params, jax.random.PRNGKey(0))
    jts = JaxTrainStepper(
        jstepper, JaxTrainConfig(loss=jax_from_dict(JaxStepLossConfig, LOSS),
                                 n_forward_steps=1, n_ensemble=E),
        JaxOptConfig(**OPT), JaxEMAConfig())
    stepper.load_state_dict(flax_params_to_state_dict(params))
    ts = TrainStepper(
        stepper, StepperTrainConfig(loss=from_dict(StepLossConfig, LOSS),
                                    n_forward_steps=1, n_ensemble=E),
        from_dict(OptimizationConfig, OPT), EMAConfig())
    return jts, params, ts


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(B, 2, NLAT, NLON).astype(np.float32) for k in NAMES}


def _patch_noise(monkeypatch, noise):
    """Both models condition on the first ``batch`` rows of ``noise``."""
    monkeypatch.setattr(jax_csfno.NoiseConditionedSFNO, "_make_noise",
                        lambda self, batch: jnp.asarray(noise[:batch]))
    monkeypatch.setattr(conditional_sfno.NoiseConditionedSFNO, "make_noise",
                        lambda self, batch, generator: torch.from_numpy(
                            noise[:batch]))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float64)


def _grad_errors(grads, jax_grads):
    """Relative L2 error of each gradient, in the flax layout."""
    out = dict(_flat(state_dict_to_flax_params(grads)))
    ref = dict(_flat(jax_grads["params"]))
    assert set(out) == set(ref)
    return {k: float(np.linalg.norm(out[k] - r)
                     / max(np.linalg.norm(r), 1e-30))
            for k, r in ref.items()}


def _jax_loss_and_grads(jts, params, batch, labels):
    (loss, _), grads = jax.jit(
        jax.value_and_grad(jts.loss_fn, has_aux=True), static_argnums=3)(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(1), 1, jnp.asarray(labels))
    return float(loss), grads


def _jax_forward(jts, params, x):
    return jax.jit(lambda p, x, labels: jts.stepper.step.module.apply(
        p, x, labels=labels))(params, jnp.asarray(x), jnp.asarray(LABEL_ROWS))


LABEL_ROWS = np.asarray([[1.0, 0.0], [0.0, 1.0]], np.float32)
NOISE_FIELD = _draw((B * E, NLAT, NLON, NOISE), 3)
X = _draw((B, NLAT, NLON, len(IN_NAMES)))


@functools.lru_cache(maxsize=None)
def _jax_results(case, dtype):
    """ace_tpu's forward of ``X`` with ``LABEL_ROWS``, and its loss and
    gradients of ``_batch()`` with them, under ``NOISE_FIELD``: computed
    once per case and dtype."""
    jts, params, _ = _steppers(case, dtype)
    with pytest.MonkeyPatch.context() as mp:
        _patch_noise(mp, NOISE_FIELD)
        ref = np.asarray(_jax_forward(jts, params, X), np.float32)
        loss, grads = _jax_loss_and_grads(jts, params, _batch(), LABEL_ROWS)
    return ref, loss, grads

# the labels straight (``label_embed_dim`` 0) and through the embedding
# (2, in every option at once)
CASES = {
    "local-blocks-labels": dict(local_blocks=[1]),
    "all-options": ALL_OPTIONS,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_noise_conditioned_sfno_options_match_ace_tpu_f32(monkeypatch, case):
    """The network's forward with labels (each row its own), then one
    ensemble loss and its gradients through ``TrainStepper.loss_fn`` with
    the labels repeated over the 2 members."""
    _patch_noise(monkeypatch, NOISE_FIELD)
    _, _, ts = _steppers(case, "float32")
    ref, ref_loss, ref_grads = _jax_results(case, "float32")
    network = ts.stepper.step.network
    assert network.n_labels == len(LABELS)
    with torch.no_grad():
        got = network(torch.from_numpy(X),
                      labels=torch.from_numpy(LABEL_ROWS))
    assert _anomaly_ratio(got.numpy(), ref, 1e-4) <= 1
    loss, grads = flagship.train_gradients(
        ts, {k: torch.from_numpy(v) for k, v in _batch().items()},
        labels=torch.from_numpy(LABEL_ROWS))
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-4)
    errs = _grad_errors(grads, ref_grads)
    assert max(errs.values()) <= 1e-3, errs


def test_noise_conditioned_sfno_all_options_match_ace_tpu_bf16(monkeypatch):
    """bf16 with every option (K1's stand-in at spectral width 16 on the
    port, ace_tpu's einsum filter at that width): the forward within the
    flagship's bf16 limit of each channel's anomaly, the loss within 2e-2
    of ace_tpu's bf16 loss, every gradient within 5e-2 relative L2 of
    ace_tpu's float32 gradient of the same model."""
    _patch_noise(monkeypatch, NOISE_FIELD)
    _, _, ts = _steppers("all-options", "bfloat16")
    ref, ref_loss, _ = _jax_results("all-options", "bfloat16")
    _, _, f32_grads = _jax_results("all-options", "float32")
    with torch.no_grad():
        got = ts.stepper.step.network(torch.from_numpy(X),
                                      labels=torch.from_numpy(LABEL_ROWS))
    assert _anomaly_ratio(got.numpy(), ref, flagship.CHECK_TOL) <= 1
    loss, grads = flagship.train_gradients(
        ts, {k: torch.from_numpy(v) for k, v in _batch().items()},
        labels=torch.from_numpy(LABEL_ROWS))
    np.testing.assert_allclose(float(loss), ref_loss, rtol=2e-2)
    errs = _grad_errors(grads, f32_grads)
    assert max(errs.values()) <= 5e-2, errs


def _block(**kw):
    _, it = _transforms(False)
    ft, _ = _transforms(False)
    block = conditional_sfno.ConditionalFNOBlock(ft, it, 64, 3, **kw)
    block.fused_tail = True
    return block


@pytest.mark.parametrize("kw,fuses", [
    ({}, True),
    ({"filter_type": "local"}, True),
    ({"global_layer_norm": True}, False),
    ({"affine_norms": True}, True),
    ({"filter_type": "local", "global_layer_norm": True}, False),
    ({"use_mlp": False}, False),
    ({"activation": "relu"}, False),
], ids=["default", "local", "global-norm", "affine", "local-global-norm",
        "no-mlp", "relu"])
def test_fused_tail_gate(kw, fuses):
    """``_fuses``: ace_tpu's gate (conditional_sfno.py:301-312), bf16
    activations with noise given; never float32 or without noise."""
    block = _block(**kw)
    bf = torch.zeros(1, dtype=torch.bfloat16)
    noise = torch.zeros(1)
    assert block._fuses(bf, noise) is fuses
    assert not block._fuses(bf.float(), noise)
    assert not block._fuses(bf, None)
    block.fused_tail = False
    assert not block._fuses(bf, noise)


def test_fused_tail_refuses_a_global_norm_model():
    """A bf16 model with the global layer norm computes the same with the
    fused tail asked for (the gate sends every tail to the modules; the
    fused plain version would take the channel norm)."""
    model = conditional_sfno.NoiseConditionedSFNO(
        (NLAT, NLON), 3, 2, embed_dim=64, noise_embed_dim=NOISE,
        num_layers=2, global_layer_norm=True, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    init_weights(model, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "w_scale_2d" in name or "w_bias_2d" in name:
                p.normal_(std=0.1, generator=gen)
    x = torch.from_numpy(_draw((B, NLAT, NLON, 3)))
    noise = torch.from_numpy(_draw((B, NLAT, NLON, NOISE), 1))
    with torch.no_grad():
        unfused = model(x, noise=noise)
        fused = model.use_fused_block_tail(True)(x, noise=noise)
    assert torch.equal(fused, unfused)


@pytest.fixture(scope="module")
def converter_trees():
    """ace_tpu parameter trees holding each new leaf: a local block's
    ``filter/weight`` ``[K, C, C]``, a spectral filter's ``lora_a``,
    ``lora_b`` and ``pre_proj``/``post_proj`` and ``label_embed`` (the
    all-options network), ``LoRADense``'s kernels (LocalNet),
    AnkurLocalNet's ``disco_encoder/weight`` ``[K, G, cin, cout]``."""
    x = jnp.asarray(_draw((1, NLAT, NLON, 4)))
    local = jax_localnet.LocalNet(img_shape=(NLAT, NLON), in_chans=4,
                                  out_chans=4, embed_dim=8, noise_embed_dim=2,
                                  block_types=("disco", "conv1x1"),
                                  lora_rank=2)
    ankur = jax_localnet.AnkurLocalNet(img_shape=(NLAT, NLON), in_chans=4,
                                       out_chans=4, embed_dim=6)
    rng = np.random.default_rng(4)

    def drawn(shapes):
        # drawn apart from either package's initialization: only the
        # layout is under test
        return jax.tree_util.tree_map(
            lambda shape: rng.standard_normal(shape).astype(np.float32),
            shapes, is_leaf=lambda v: isinstance(v, tuple))["params"]

    key = jax.random.PRNGKey(0)
    trees = {name: drawn(_shapes(m.init, key, x))
             for name, m in (("localnet", local), ("ankur", ankur))}
    jts = _steppers("all-options", "float32")[0]
    trees["sfno"] = drawn(_shapes(jts.stepper.init_params, key))
    return trees


@pytest.mark.parametrize("tree,path,port_key,transposed", [
    ("sfno", "block_1/filter/weight", "block_1.filter.weight", False),
    ("sfno", "block_0/filter/lora_a", "block_0.filter.lora_a", False),
    ("sfno", "block_0/filter/lora_b", "block_0.filter.lora_b", False),
    ("sfno", "block_0/filter/pre_proj/kernel",
     "block_0.filter.pre_proj.weight", True),
    ("sfno", "label_embed/kernel", "label_embed.weight", True),
    ("localnet", "block_1/filter/base/kernel", "block_1.filter.base.weight",
     True),
    ("localnet", "block_1/filter/lora_a/kernel",
     "block_1.filter.lora_a.weight", True),
    ("localnet", "encoder_0/lora_b/kernel", "encoder_0.lora_b.weight", True),
    ("ankur", "disco_encoder/weight", "disco_encoder.weight", False),
])
def test_converter_carries_the_new_leaves_both_ways(converter_trees, tree,
                                                    path, port_key,
                                                    transposed):
    """Each leaf keeps flax's layout (a 2-D Dense kernel transposed to
    ``nn.Linear``'s), and comes back to it bit for bit; ``flax_name`` and
    ``flax_view`` name and view it as ace_tpu does. A change to
    ``_is_spectral_filter`` that permuted one would fail here."""
    params = converter_trees[tree]
    leaf = params
    for part in path.split("/"):
        leaf = leaf[part]
    leaf = np.asarray(leaf)
    state = flax_params_to_state_dict(params)
    value = state[port_key]
    np.testing.assert_array_equal(value.numpy(),
                                  leaf.T if transposed else leaf)
    assert flax_name(port_key, value) == "params/" + path
    np.testing.assert_array_equal(flax_view(port_key, value).numpy(), leaf)
    back = state_dict_to_flax_params(state)
    for part in path.split("/"):
        back = back[part]
    np.testing.assert_array_equal(back, leaf)


def test_converted_trees_load_into_the_port(converter_trees):
    """Every leaf of each tree finds its port parameter, shapes equal."""
    models = {
        "sfno": _steppers("all-options", "float32")[2].stepper.step.network,
        "localnet": localnet.LocalNet(
            (NLAT, NLON), 4, 4, embed_dim=8, noise_embed_dim=2,
            block_types=("disco", "conv1x1"), lora_rank=2),
        "ankur": localnet.AnkurLocalNet((NLAT, NLON), 4, 4, embed_dim=6),
    }
    for name, model in models.items():
        model.load_state_dict(flax_params_to_state_dict(
            converter_trees[name]), strict=True)
