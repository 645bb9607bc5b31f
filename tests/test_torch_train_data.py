"""The modules under the port's trainer against ace_tpu: the copied
modules, the training data loader (batches, times and order over epochs),
the total-energy budget correction, the one-step validation aggregator,
training checkpoints written by either package and read by the other, and
the trainer's refusals."""

import importlib
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from ace_tpu.aggregator.one_step import OneStepAggregator as JaxOneStep
from ace_tpu.core import coordinates as jax_coords
from ace_tpu.core.config import from_dict as jax_from_dict
from ace_tpu.core.config import to_dict as jax_to_dict
from ace_tpu.core.corrector.atmosphere import (
    AtmosphereCorrectorConfig as JaxCorrectorConfig,
)
from ace_tpu.core.dataset_info import DatasetInfo as JaxInfo
from ace_tpu.core.optimization import (
    OptimizationConfig as JaxOptimizationConfig,
)
from ace_tpu.core.step import StepSelector as JaxStepSelector
from ace_tpu.core.step.single_module import (
    SingleModuleStepConfig as JaxSingleModuleStepConfig,
)
from ace_tpu.data.loading import DataLoaderConfig as JaxDataLoaderConfig
from ace_tpu.data.requirements import DataRequirements as JaxRequirements
from ace_tpu.stepper import checkpoint as jax_checkpoint
from ace_tpu.stepper.stepper import StepperConfig as JaxStepperConfig
from ace_tpu.testing import SyntheticData
from ace_tpu_torch.aggregator.one_step import OneStepAggregator
from ace_tpu_torch.core import coordinates
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.corrector.atmosphere import AtmosphereCorrectorConfig
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
from ace_tpu_torch.data.loading import DataLoaderConfig
from ace_tpu_torch.data.requirements import DataRequirements
from ace_tpu_torch.stepper import checkpoint
from ace_tpu_torch.stepper.stepper import StepperConfig
from ace_tpu_torch.stepper.train import StepperTrainConfig, TrainStepper
from ace_tpu_torch.train.train import main
from ace_tpu_torch.utils.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)

torch.set_num_threads(2)

NLAT, NLON = 16, 32
NAMES = ["air_temperature_0", "air_temperature_1", "specific_total_water_0",
         "specific_total_water_1", "PRESsfc", "surface_temperature",
         "DSWRFtoa", "ocean_fraction"]


@pytest.mark.parametrize("copy, original", [
    ("ace_tpu_torch.core.training_history",
     "ace_tpu.core.training_history"),
    ("ace_tpu_torch.data.augmentation", "ace_tpu.data.augmentation"),
])
def test_copied_modules_keep_the_originals_code(copy, original):
    """These copies differ from their originals in the module docstring
    and in the package their imports name."""
    def body(name):
        source = pathlib.Path(importlib.import_module(name).__file__)
        text = source.read_text()
        return text[text.index('"""', 3) + 3:]

    assert body(copy) == body(original).replace("from ace_tpu.",
                                                "from ace_tpu_torch.")


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    return SyntheticData(tmp_path_factory.mktemp("loader") / "data", NAMES,
                         n_time=13, nlat=NLAT, nlon=NLON)


@pytest.mark.parametrize("options", [
    {},
    {"time_buffer": 2, "time_buffer_pool_size": 2},
    {"sample_with_replacement": 7},
    {"augmentation": {"rotate_probability": 0.5}},
], ids=["plain", "time_buffer", "with_replacement", "rotate"])
def test_loader_matches_ace_tpu(synthetic, options):
    """Both packages' ``DataLoaderConfig`` give the same batches (exactly:
    the same numpy reads), times and order over two epochs, training
    (shuffled) and validation."""
    config = {"dataset": {"data_path": str(synthetic.data_dir)},
              "batch_size": 2, "num_data_workers": 2, **options}
    names = sorted(NAMES)
    ref_data = {
        train: jax_from_dict(JaxDataLoaderConfig, config).build(
            JaxRequirements(names=names, n_timesteps=3), train=train,
            seed=5)
        for train in (True, False)
    }
    data = {
        train: from_dict(DataLoaderConfig, config).build(
            DataRequirements(names=names, n_timesteps=3), train=train,
            seed=5, device="cpu")
        for train in (True, False)
    }
    for train in (True, False):
        assert data[train].n_batches == ref_data[train].n_batches
        assert data[train].n_samples == ref_data[train].n_samples
        for epoch in (0, 1):
            data[train].set_epoch(epoch)
            ref_data[train].set_epoch(epoch)
            batches = list(data[train])
            refs = list(ref_data[train])
            assert len(batches) == len(refs) == data[train].n_batches
            for batch, ref in zip(batches, refs):
                np.testing.assert_array_equal(batch.time.values,
                                              ref.time.values)
                assert set(batch.data) == set(ref.data)
                for k, v in ref.data.items():
                    assert isinstance(batch.data[k], torch.Tensor)
                    np.testing.assert_array_equal(batch.data[k].numpy(),
                                                  np.asarray(v), err_msg=k)


def test_loader_refuses_a_mesh(synthetic):
    """A data axis that does not divide the global batch is refused when
    the loader is built, with ``ace_tpu``'s error."""
    from ace_tpu_torch.parallel.distributed import BatchPlacement
    from ace_tpu_torch.parallel.mesh import MeshConfig

    config = from_dict(DataLoaderConfig, {
        "dataset": {"data_path": str(synthetic.data_dir)}, "batch_size": 3})
    placement = BatchPlacement(MeshConfig().build(2, 0), "cpu")
    with pytest.raises(ValueError, match="not divisible by the data mesh"):
        config.build(DataRequirements(names=NAMES, n_timesteps=2),
                     sharding=placement)


def _atmosphere(nz, rng, batch=2):
    """Inputs, outputs and forcing at atmospheric scales."""
    def field(mean, std, positive=False):
        v = rng.randn(batch, NLAT, NLON)
        return ((np.abs(v) if positive else v) * std + mean).astype(
            np.float32)

    def state():
        data = {f"air_temperature_{k}": field(220 + 10 * k, 5)
                for k in range(nz)}
        data.update({f"specific_total_water_{k}": field(0, 1e-3 * (k + 1),
                                                        True)
                     for k in range(nz)})
        data["PRESsfc"] = field(1e5, 100)
        return data

    gen = state()
    gen.update(PRATEsfc=field(0, 3e-5, True), LHTFLsfc=field(80, 20),
               SHTFLsfc=field(20, 10), DLWRFsfc=field(340, 10),
               ULWRFsfc=field(390, 10), DSWRFsfc=field(180, 30),
               USWRFsfc=field(20, 5), USWRFtoa=field(100, 10),
               ULWRFtoa=field(240, 10),
               tendency_of_total_water_path_due_to_advection=field(0, 1e-4))
    forcing = {"DSWRFtoa": field(340, 50), "HGTsfc": field(0, 500, True)}
    # the step's input holds the forcing of its time
    inp = {**state(), "DSWRFtoa": field(340, 50),
           "HGTsfc": forcing["HGTsfc"]}
    return inp, gen, forcing


@pytest.mark.parametrize("dry_air", [False, True])
def test_total_energy_correction_matches_ace_tpu(dry_air):
    """The total-energy budget correction (alone, and after the dry-air
    correction that moves the surface pressure) against ace_tpu's on one
    step, without and with unaccounted heating. The temperature
    correction is the difference of two float32 global means of ~2.5e9
    J/m^2 energy paths (~5e6 J/m^2 apart), which summation order moves by
    ~1e3 J/m^2: it must agree within 5e-3 of its size (measured: 6e-4
    alone, 1.9e-3 after the dry-air correction). The heating of 2.5
    W/m^2 moves it by 1.2%, more than that tolerance. The surface
    pressure that the dry-air correction sets: within 1e-5."""
    from datetime import timedelta

    nz = 4
    inp, gen, forcing = _atmosphere(nz, np.random.RandomState(0))
    vc_args = dict(ak=np.concatenate([np.linspace(100.0, 5000.0, nz // 2),
                                      np.linspace(5000.0, 0.0, nz // 2 + 1)]),
                   bk=np.linspace(0.0, 1.0, nz + 1))
    lat = coordinates.gaussian_latitudes(NLAT)
    lon = np.linspace(0, 360, NLON, endpoint=False)
    ref_ops = JaxInfo(horizontal_coordinates=jax_coords.LatLonCoordinates(
        lat=lat, lon=lon)).gridded_operations
    ops = DatasetInfo(horizontal_coordinates=coordinates.LatLonCoordinates(
        lat=lat, lon=lon)).gridded_operations
    temperatures = [f"air_temperature_{k}" for k in range(nz)]
    deltas = {}
    for heating in (0.0, 2.5):
        config = {"conserve_dry_air": dry_air,
                  "total_energy_budget_correction": {
                      "method": "constant_temperature",
                      "constant_unaccounted_heating": heating}}
        ref = jax_from_dict(JaxCorrectorConfig, config).build(
            ref_ops, jax_coords.HybridSigmaPressureCoordinate(**vc_args),
            timedelta(hours=6))(
            *({k: jnp.asarray(v) for k, v in d.items()}
              for d in (inp, gen, forcing)), None)
        out = from_dict(AtmosphereCorrectorConfig, config).build(
            ops, coordinates.HybridSigmaPressureCoordinate(**vc_args),
            timedelta(hours=6))(
            *({k: torch.from_numpy(v) for k, v in d.items()}
              for d in (inp, gen, forcing)), None)
        assert set(out.corrected) == set(ref.corrected)
        assert set(out.delta) == set(ref.delta)
        assert set(temperatures) <= set(out.delta)
        for k in temperatures:
            r = np.asarray(ref.delta[k])
            np.testing.assert_allclose(out.delta[k].numpy(), r, rtol=0,
                                       atol=5e-3 * np.abs(r).max(),
                                       err_msg=k)
        if dry_air:
            # ace_tpu's float32 dry-air target is 0.23 Pa off float64
            # (ROADMAP Queue 3): tests/test_torch_stepper.py's 1e-5
            np.testing.assert_allclose(out.corrected["PRESsfc"].numpy(),
                                       np.asarray(ref.corrected["PRESsfc"]),
                                       rtol=1e-5)
        for k, v in gen.items():
            if k not in ref.delta:
                assert torch.equal(out.corrected[k], torch.from_numpy(v)), k
        deltas[heating] = out.delta["air_temperature_0"]
    shift = (deltas[2.5] - deltas[0.0]).abs().max()
    assert shift > 5e-3 * deltas[0.0].abs().max()


def test_shipped_training_config_parses_with_the_energy_correction():
    """``configs/ace2-era5-train.yaml`` as shipped reads into the port's
    ``TrainConfig`` (which refused it before the correction was ported);
    ``chip_smoke.py``'s path R trains with it
    (``tests/test_torch_trainer_resume.py`` runs that on the CPU)."""
    from ace_tpu_torch.core.corrector.atmosphere import EnergyBudgetConfig
    from ace_tpu_torch.train.trainer import TrainConfig

    root = pathlib.Path(__file__).resolve().parent.parent
    with open(root / "configs" / "ace2-era5-train.yaml") as f:
        config = from_dict(TrainConfig, yaml.safe_load(f))
    corrector = config.stepper.step.instance.corrector
    assert corrector.total_energy_budget_correction == EnergyBudgetConfig(
        method="constant_temperature")
    assert not corrector.is_noop


def test_one_step_aggregator_matches_ace_tpu(tmp_path):
    """``OneStepAggregator``'s logs over three batches against ace_tpu's:
    float32 reductions in another order, summed in float32 on the device
    (ace_tpu sums each batch's value in float64 on the host): within 1e-5
    relative. The diagnostics files hold the same groups."""
    lat = coordinates.gaussian_latitudes(NLAT)
    lon = np.linspace(0, 360, NLON, endpoint=False)
    ops = DatasetInfo(horizontal_coordinates=coordinates.LatLonCoordinates(
        lat=lat, lon=lon)).gridded_operations
    ref_ops = JaxInfo(horizontal_coordinates=jax_coords.LatLonCoordinates(
        lat=lat, lon=lon)).gridded_operations
    agg = OneStepAggregator(ops, record_snapshots=True,
                            record_mean_maps=True)
    ref_agg = JaxOneStep(ref_ops, record_snapshots=True,
                         record_mean_maps=True)
    rng = np.random.RandomState(2)
    for _ in range(3):
        gen = {k: rng.randn(2, 1, NLAT, NLON).astype(np.float32)
               for k in ("a", "b")}
        target = {k: v + rng.randn(*v.shape).astype(np.float32)
                  for k, v in gen.items()}
        target["extra"] = gen["a"]
        agg.record_batch({k: torch.from_numpy(v) for k, v in gen.items()},
                         {k: torch.from_numpy(v) for k, v in target.items()})
        ref_agg.record_batch({k: jnp.asarray(v) for k, v in gen.items()},
                             {k: jnp.asarray(v) for k, v in target.items()})
    logs, ref = agg.get_logs(), ref_agg.get_logs()
    assert set(logs) == set(ref) and len(ref) == 6
    for k, r in ref.items():
        assert logs[k] == pytest.approx(r, rel=1e-5), k
    snaps, ref_snaps = agg.get_snapshots(), ref_agg.get_snapshots()
    assert set(snaps) == set(ref_snaps)
    for k, r in ref_snaps.items():
        np.testing.assert_allclose(snaps[k], np.asarray(r), rtol=1e-6,
                                   atol=1e-6)
    agg.flush_diagnostics(str(tmp_path / "port"))
    ref_agg.flush_diagnostics(str(tmp_path / "ref"))
    assert (sorted(p.name for p in (tmp_path / "port").iterdir())
            == sorted(p.name for p in (tmp_path / "ref").iterdir()))


def _step_dict():
    return dict(
        builder={"type": "NoiseConditionedSFNO", "config": {
            "embed_dim": 16, "noise_embed_dim": 4, "num_layers": 2,
            "affine_norms": True, "compute_dtype": "bfloat16",
        }},
        in_names=NAMES,
        out_names=[n for n in NAMES if n not in ("DSWRFtoa",
                                                 "ocean_fraction")],
        normalization={"network": {"means": {n: 0.0 for n in NAMES},
                                   "stds": {n: 1.0 for n in NAMES}}},
    )


_OPTIMIZATION = {"optimizer_type": "AdamW", "lr": 1e-4, "max_grad_norm": 1.0,
                 "first_moment_dtype": "bfloat16"}
_EXTRA = {"epoch": 3, "num_batches_seen": 12, "epoch_batches_seen": 0,
          "best_validation_loss": 0.5, "best_inference_error": float("inf"),
          "ema": {"num_updates": 12, "decay": 0.999},
          "optimization": {"count": 12, "lr_scale": 0.5}}


@pytest.fixture(scope="module")
def train_steppers():
    """Both packages' steppers of one bf16 config (the flagship recipe's
    optimizer: AdamW, clipping, a bf16 first moment)."""
    lat = coordinates.gaussian_latitudes(NLAT)
    lon = np.linspace(0, 360, NLON, endpoint=False)
    from datetime import timedelta

    info = DatasetInfo(horizontal_coordinates=coordinates.LatLonCoordinates(
        lat=lat, lon=lon), timestep=timedelta(hours=6))
    ref_info = JaxInfo(horizontal_coordinates=jax_coords.LatLonCoordinates(
        lat=lat, lon=lon), timestep=timedelta(hours=6))
    step = jax_from_dict(JaxSingleModuleStepConfig, _step_dict())
    ref_config = JaxStepperConfig(step=JaxStepSelector(
        type="single_module", config=jax_to_dict(step)))
    ref_stepper = ref_config.get_stepper(ref_info)
    config = StepperConfig.from_state(ref_config.get_state())
    ts = TrainStepper(
        config.get_stepper(info, device="cpu"), StepperTrainConfig(),
        from_dict(OptimizationConfig, _OPTIMIZATION), EMAConfig())
    return ref_config, ref_stepper, config, ts


def _state_dict(tree) -> dict[str, torch.Tensor]:
    """A JAX parameter tree as the port's ``state_dict`` (bfloat16 leaves,
    which numpy holds as ml_dtypes, through float32: exact)."""
    def host(x):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        return x

    return flax_params_to_state_dict(jax.tree_util.tree_map(host, tree))


def _random_like(tree, rng, scale=1.0):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.randn(*x.shape) * scale, x.dtype), tree)


def test_train_stepper_schedule_and_scaling_match_ace_tpu(train_steppers):
    """What the trainer asks of ``TrainStepper`` beside the step: the
    rollout lengths drawn per batch from a stochastic, epoch-scheduled
    ``n_forward_steps`` (the same numpy draws, so equal), the corrector's
    disabled epochs, and the loss scaling of each output (float32 stds
    over weights: equal)."""
    from ace_tpu.stepper.train import StepperTrainConfig as JaxTrainConfig
    from ace_tpu.stepper.train import TrainStepper as JaxTrainStepper

    _, ref_stepper, _, ts = train_steppers
    config = {
        "loss": {"type": "MSE", "weights": {"PRESsfc": 5.0}},
        "n_forward_steps": {"start_value": {"outcomes": [
            {"steps": 1, "probability": 0.25},
            {"steps": 3, "probability": 0.75}]},
            "milestones": [{"epoch": 1, "value": 2}]},
    }
    ref = JaxTrainStepper(ref_stepper, jax_from_dict(JaxTrainConfig, config),
                          jax_from_dict(JaxOptimizationConfig, _OPTIMIZATION))
    port = TrainStepper(ts.stepper, from_dict(StepperTrainConfig, config),
                        from_dict(OptimizationConfig, _OPTIMIZATION))
    for epoch in (0, 0, 1, 0):
        draws = [port.sample_n_forward_steps(epoch) for _ in range(12)]
        assert draws == [ref.sample_n_forward_steps(epoch)
                         for _ in range(12)]
    assert set(draws) == {1, 3}
    assert port.corrector_disabled_epochs == ref.corrector_disabled_epochs
    ref_scaling = ref.effective_loss_scaling
    assert port.effective_loss_scaling == {
        k: pytest.approx(float(v), rel=1e-7) for k, v in ref_scaling.items()}
    assert port.effective_loss_scaling["PRESsfc"] == pytest.approx(0.2)


def test_port_reads_the_train_checkpoint_of_ace_tpu(train_steppers,
                                                    tmp_path):
    """ace_tpu's ``save_train_checkpoint`` (weights, optax state with a
    bf16 first moment, EMA, extra) read by the port: every tensor equal
    after conversion, bit for bit."""
    ref_config, ref_stepper, _, ts = train_steppers
    rng = np.random.RandomState(0)
    params = ref_stepper.init_params(jax.random.PRNGKey(0))
    ref_stepper.params = params
    optimization = jax_from_dict(JaxOptimizationConfig, _OPTIMIZATION).build(
        max_epochs=1)
    opt_state = optimization.init(params)
    # moments and counts that are not zero
    opt_state = (opt_state[0], (
        opt_state[1][0]._replace(
            count=jnp.asarray(12, jnp.int32),
            mu=_random_like(opt_state[1][0].mu, rng),
            nu=_random_like(opt_state[1][0].nu, rng, 0.01)),
        opt_state[1][1],
        opt_state[1][2]._replace(count=jnp.asarray(12, jnp.int32)),
    ))
    ema = _random_like(params, rng)
    path = str(tmp_path / "ace_tpu.msgpack")
    jax_checkpoint.save_train_checkpoint(path, ref_stepper, ref_config,
                                         opt_state=opt_state,
                                         ema_params=ema, extra=_EXTRA)
    out = checkpoint.load_train_checkpoint(path, device="cpu")
    assert out["extra"] == json.loads(json.dumps(_EXTRA))
    names = ts.parameter_names()
    want = _state_dict(params)
    got = out["stepper"].module.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    adam_out = out["optimizer"]
    assert set(adam_out["mu"]) == set(adam_out["nu"]) == set(names)
    ts.optimization.init(ts.parameters())
    ts.optimization.load_moments(
        adam_out["count"], [adam_out["mu"][n] for n in names],
        [adam_out["nu"][n] for n in names])
    assert ts.optimization.count == 12
    adam = opt_state[1][0]
    for key, moments in (("mu", ts.optimization.mu),
                         ("nu", ts.optimization.nu)):
        ref = _state_dict(getattr(adam, key))
        for n, m in zip(names, moments):
            assert m.dtype == ref[n].dtype and torch.equal(m, ref[n]), (
                key, n)
    assert ts.optimization.mu[0].dtype == torch.bfloat16
    ref_ema = _state_dict(ema)
    for k, v in ref_ema.items():
        assert torch.equal(out["ema_state"][k], v), k


def test_ace_tpu_reads_the_train_checkpoint_of_the_port(train_steppers,
                                                        tmp_path):
    """The port's ``save_train_checkpoint`` read by ace_tpu: the optimizer
    tree restores into optax's own state (``serialization.from_state_dict``
    accepts its structure), and weights, moments, counts, EMA and extra
    come out equal after conversion, bit for bit."""
    ref_config, ref_stepper, config, ts = train_steppers
    ts.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    opt = ts.optimization
    with torch.no_grad():
        for group, scale in ((opt.mu, 1.0), (opt.nu, 0.01),
                             (ts.ema.ema_params, 1.0)):
            for t in group:
                t.copy_(torch.randn(t.shape, generator=gen) * scale)
    opt._count = opt.adam_count = opt.schedule_count = 7
    names = ts.parameter_names()
    path = str(tmp_path / "port.msgpack")
    checkpoint.save_train_checkpoint(
        path, ts.stepper, config,
        optimization=opt, parameter_names=names,
        ema_state=dict(zip(names, ts.ema.ema_params)), extra=_EXTRA)
    out = jax_checkpoint.load_train_checkpoint(path)
    assert out["extra"] == json.loads(json.dumps(_EXTRA))
    template = jax_from_dict(JaxOptimizationConfig, _OPTIMIZATION).build(
        max_epochs=1).init(out["stepper"].params)
    restored = serialization.from_state_dict(template,
                                             out["optimizer_state_dict"])
    adam = restored[1][0]
    assert adam.count.shape == () and restored[1][2].count.shape == ()
    assert int(adam.count) == 7 and int(restored[1][2].count) == 7
    assert {x.dtype for x in jax.tree_util.tree_leaves(adam.mu)} == {
        jnp.dtype(jnp.bfloat16)}

    def port_tree(tensors):
        return state_dict_to_flax_params(dict(zip(names, tensors)))

    for ref, tensors in ((adam.mu, opt.mu), (adam.nu, opt.nu),
                         (out["ema_params"], ts.ema.ema_params),
                         (out["stepper"].params, ts.parameters())):
        flat = dict(jax.tree_util.tree_flatten_with_path(
            ref["params"])[0])
        want = dict(jax.tree_util.tree_flatten_with_path(
            port_tree(tensors))[0])
        assert set(flat) == set(want)
        for k, v in flat.items():
            w = want[k]
            w = w.float().numpy() if isinstance(w, torch.Tensor) else w
            np.testing.assert_array_equal(np.asarray(v, np.float32),
                                          np.asarray(w, np.float32))
    # and back into the port
    back = checkpoint.read_train_checkpoint(path)
    opt2 = from_dict(OptimizationConfig, _OPTIMIZATION).build(max_epochs=1)
    opt2.init(ts.parameters())
    opt2.load_moments(back["optimizer"]["count"],
                      [back["optimizer"]["mu"][n] for n in names],
                      [back["optimizer"]["nu"][n] for n in names])
    assert opt2.count == 7
    for a, b in zip(opt.mu + opt.nu, opt2.mu + opt2.nu):
        assert torch.equal(a, b)


def test_checkpoint_writer_gives_the_bytes_of_packb(tmp_path):
    """``save_msgpack`` streams the tree leaf by leaf and writes arrays of
    1 MiB or more from their own buffers: its file holds exactly the bytes
    of ``msgpack.packb`` of the whole tree, which flax reads."""
    import msgpack

    rng = np.random.RandomState(0)
    tree = {"params": {
        "w": rng.randn(700, 600).astype(np.float32),
        "small": rng.randn(3).astype(np.float32),
        "mu": torch.randn(1024, 1024).to(torch.bfloat16),
        "count": np.asarray(7, np.int32),
        "f64": torch.randn(512, 1024, dtype=torch.float64),
    }, "extra": json.dumps({"epoch": 1})}
    path = tmp_path / "tree.msgpack"
    checkpoint.save_msgpack(str(path), tree)
    assert path.read_bytes() == msgpack.packb(
        tree, default=checkpoint._ext_pack, strict_types=True)
    back = serialization.msgpack_restore(path.read_bytes())
    np.testing.assert_array_equal(np.asarray(back["params"]["w"]),
                                  tree["params"]["w"])
    assert back["params"]["mu"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back["params"]["mu"], np.float32),
        tree["params"]["mu"].float().numpy())


@pytest.mark.parametrize("extra, error, match", [
    ({"mesh": {"h": 2, "w": 1}}, NotImplementedError, "item 5b"),
    ({"logging": {"log_to_wandb": True}}, NotImplementedError,
     "Weights & Biases"),
])
def test_trainer_refuses_what_is_not_ported(synthetic, tmp_path, extra,
                                            error, match):
    loader = {"dataset": {"data_path": str(synthetic.data_dir)},
              "batch_size": 2}
    config = {
        "experiment_dir": str(tmp_path / "out"), "max_epochs": 1,
        "train_loader": loader, "validation_loader": loader,
        "optimization": {"lr": 1e-3},
        "stepper": {"step": {"type": "single_module",
                             "config": _step_dict()}},
        "logging": {"log_to_screen": False, "log_to_file": False},
    }
    for k, v in extra.items():
        config[k] = {**config.get(k, {}), **v} if k in config else v
    path = tmp_path / "c.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    with pytest.raises(error, match=match):
        main([str(path)], device="cpu")
