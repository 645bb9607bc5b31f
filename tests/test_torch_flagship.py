"""The port's flagship configuration (ace_tpu_torch/flagship.py, what
chip_smoke.py runs) against the JAX package's headline benchmark config
(bench.py), and one bf16 step of it against ace_tpu at a small size."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from ace_tpu.core.step import StepArgs as JaxStepArgs
from ace_tpu.models.conditional_sfno import (
    NoiseConditionedSFNO as JaxNoiseConditionedSFNO,
)
from ace_tpu_torch import flagship
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.step import StepArgs
from ace_tpu_torch.models import sfno
from ace_tpu_torch.models.conditional_sfno import NoiseConditionedSFNO
from ace_tpu_torch.ops.dhconv_filter import dhconv_filter_plain
from ace_tpu_torch.profile_flagship import busy_us, family, print_tables
from ace_tpu_torch.utils.convert import flax_params_to_state_dict

torch.set_num_threads(2)

NLAT, NLON, EMBED, LAYERS = 16, 32, 128, 1


def _bench_builder(embed, layers):
    return {"type": "NoiseConditionedSFNO", "config": {
        "embed_dim": embed, "noise_embed_dim": 32,
        "noise_type": "isotropic", "filter_type": "linear",
        "use_mlp": True, "num_layers": layers, "operator_type": "dhconv",
        "separable": False, "spectral_layers": 3,
        "spectral_transform": "sht", "affine_norms": True,
        "normalize_big_skip": True, "compute_dtype": "bfloat16",
    }}


@pytest.fixture
def bench_grid(monkeypatch):
    monkeypatch.setattr(bench, "NLAT", NLAT)
    monkeypatch.setattr(bench, "NLON", NLON)


def _state(obj):
    return json.loads(json.dumps(obj))


def test_flagship_config_equals_bench(bench_grid):
    """Same step config and dataset info as bench.py, field for field
    (checked at a small grid; the builder fields are the flagship's)."""
    jax_stepper = bench._stepper(_bench_builder(512, 8))
    stepper = flagship.build_stepper(NLAT, NLON, device="cpu")
    assert _state(stepper.step.config.get_state()) == _state(
        jax_stepper.step.config.get_state()
    )
    jax_info = _state(jax_stepper.dataset_info.get_state())
    assert _state(stepper.dataset_info.get_state()) == jax_info
    assert _state(DatasetInfo.from_state(jax_info).get_state()) == jax_info
    assert len(stepper.step.config.in_names) == 38
    assert len(stepper.out_names) == 44


def test_flagship_step_bf16_matches_ace_tpu(bench_grid, monkeypatch):
    """One bf16 step, the JAX side through its Pallas filter in the
    interpreter: within 2e-2 of the largest normalized output (bf16
    rounds at other points in the two frameworks)."""
    monkeypatch.setenv("ACE_TPU_PALLAS_FILTER", "interpret")
    rng = np.random.RandomState(0)
    noise = rng.randn(1, NLAT, NLON, 32).astype(np.float32)
    monkeypatch.setattr(JaxNoiseConditionedSFNO, "_make_noise",
                        lambda self, batch: jnp.asarray(noise))
    monkeypatch.setattr(NoiseConditionedSFNO, "make_noise",
                        lambda self, batch, generator: torch.from_numpy(noise))

    jax_stepper = bench._stepper(_bench_builder(EMBED, LAYERS))
    params = jax_stepper.init_params(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (
            jnp.asarray(rng.randn(*leaf.shape) * 0.1, leaf.dtype)
            if any(getattr(p, "key", "") in ("w_scale_2d", "w_bias_2d")
                   for p in path) else leaf
        ),
        params,
    )
    stepper = flagship.build_stepper(NLAT, NLON, embed=EMBED, layers=LAYERS,
                                     device="cpu")
    stepper.load_state_dict(flax_params_to_state_dict(params))

    ic, forcing = flagship.synthetic_inputs(
        stepper, 1, generator=torch.Generator().manual_seed(0)
    )
    step_in = {k: v[:, 0] for k, v in ic.data.items()}
    step_in.update({k: forcing[k][:, 0] for k in ("DSWRFtoa", "HGTsfc",
                                                  "ocean_fraction")})
    next_in = {k: forcing[k][:, 1] for k in stepper.step.next_step_input_names}
    with torch.inference_mode():
        out = stepper.step.step(StepArgs(
            input=step_in, next_step_input_data=next_in,
            stepper_state=stepper.step.init_stepper_state(step_in),
        ))

    jstep = jax_stepper.step
    jin = {k: jnp.asarray(v.numpy()) for k, v in step_in.items()}
    ref = jstep.step(params, JaxStepArgs(
        input=jin,
        next_step_input_data={k: jnp.asarray(v.numpy())
                              for k, v in next_in.items()},
        stepper_state=jstep.init_stepper_state(jin),
        rng=jax.random.PRNGKey(1),
    ))
    # the flagship normalizes with mean 0 / std 1, so each output is held
    # to its own largest value (PRESsfc is ~1e5 Pa, where one bf16 ulp is
    # 512 Pa)
    for name, r in ref.output.items():
        r = np.asarray(r)
        np.testing.assert_allclose(
            out.output[name].numpy(), r, rtol=0,
            atol=2e-2 * float(np.max(np.abs(r))), err_msg=name,
        )


def _filter_variant(variant):
    plain = dhconv_filter_plain

    def dhconv_filter(xr, xi, wr, wi):
        if variant == "input_rounding":  # x unrounded: another bf16 rounding
            return tuple(o.to(torch.bfloat16) for o in plain(
                xr.double(), xi.double(), wr.double(), wi.double(),
                torch.float64,
            ))
        if variant == "zeros":
            outr, _ = plain(xr, xi, wr, wi)
            return torch.zeros_like(outr), torch.zeros_like(outr)
        return plain(xr, xi, wr, torch.zeros_like(wi))  # real weight only

    return dhconv_filter


@pytest.mark.parametrize("variant, detected", [
    ("input_rounding", False), ("zeros", True), ("real_weight_only", True),
])
def test_card_check_detects_a_wrong_filter(monkeypatch, variant, detected):
    """The comparison that holds the small model on the card against the
    CPU (chip_smoke.py, tests/test_torch_cuda.py) can fail: with the
    weights of ``draw_check_weights``, a filter that writes zeros or drops
    the imaginary weight exceeds ``CHECK_TOL``, one that rounds its input
    differently stays under it."""
    stepper = flagship.build_stepper(NLAT, NLON, nz=2, embed=EMBED, layers=2,
                                     device="cpu")
    flagship.draw_check_weights(stepper, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, NLAT, NLON, stepper.module.in_chans, generator=gen)
    noise = stepper.module.make_noise(2, gen)
    with torch.inference_mode():
        ref = stepper.module(x, noise=noise)
        monkeypatch.setattr(sfno, "dhconv_filter", _filter_variant(variant))
        out = stepper.module(x, noise=noise)
    err = flagship.anomaly_error(out, ref, (1, 2))
    assert (err > flagship.CHECK_TOL) == detected, err


def test_busy_time_is_the_union_of_device_intervals():
    """Overlapping device events count once; gaps count not at all."""
    events = [{"ts": 0.0, "dur": 10.0}, {"ts": 5.0, "dur": 10.0},
              {"ts": 6.0, "dur": 2.0}, {"ts": 20.0, "dur": 5.0}]
    assert busy_us(events) == 20.0
    assert busy_us([]) == 0.0


def test_profile_families_and_tables(capsys):
    """Each kernel name falls in one family, the first whose pattern it
    holds; the tables of a trace print per-step device time by family."""
    assert family("void dhconv_dw_kernel(CUtensorMap)") == "1c dhconv_dw"
    assert family("void dhconv_filter_kernel(CUtensorMap)") == \
        "K1 dhconv_filter"
    assert family("void at::native::elementwise_kernel<128, 4, "
                  "direct_copy_kernel_cuda>") == \
        "strided copies (copies, casts, DtoD)"
    assert family("Memcpy DtoD (Device -> Device)") == \
        "strided copies (copies, casts, DtoD)"
    assert family("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n") == "f32 SGEMM"
    assert family("nvjet_tst_192x192_64x4") == "bf16 GEMMs"
    assert family("void at::native::vectorized_elementwise_kernel<4, "
                  "AUnaryFunctor>") == "elementwise"
    assert family("something else") == "rest"
    events = [{"name": "void dhconv_dw_kernel()", "ts": 0.0, "dur": 3000.0},
              {"name": "nvjet_tst", "ts": 3000.0, "dur": 1000.0}]
    print_tables(events, 2)
    out = capsys.readouterr().out
    assert "1.500  75.0%  1c dhconv_dw" in out
    assert "2.000         busy" in out
