"""The ACE2-ERA5 flagship configuration on random inputs.

The same dicts as the JAX package's headline benchmark (bench.py:30-91,
:544-551): NoiseConditionedSFNO with a dhconv filter, 32 isotropic noise
channels, affine norms, a normalized big skip and bf16 compute, inside the
single-module step with normalization, prescribed SST and the dry-air
corrector; 38 inputs and 44 outputs at ``nz=8``. The grid, depth and
width are arguments so that a smaller copy can be built for checks. The
weights are drawn from a seed: no trained checkpoint ships with the repo.

``build_train_stepper`` adds the flagship pretraining recipe of
bench.py:187-251 and :596-608 (per-block recompute, a CRPS and energy
score ensemble loss over 2 members, AdamW with a bf16 first moment and
gradient clipping, an EMA), and ``synthetic_batch`` its random batch.
"""

from datetime import timedelta

import numpy as np
import torch

from ace_tpu_torch.core.coordinates import (
    HybridSigmaPressureCoordinate,
    LatLonCoordinates,
    gaussian_latitudes,
)
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.loss import StepLossConfig
from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
from ace_tpu_torch.core.step import StepSelector
from ace_tpu_torch.stepper.stepper import PrognosticState, Stepper, StepperConfig
from ace_tpu_torch.stepper.train import StepperTrainConfig, TrainStepper

NLAT, NLON, NZ, EMBED, LAYERS = 180, 360, 8, 512, 8
# limit of ``anomaly_error`` between the card and the CPU under
# ``draw_check_weights``: bf16 rounds at other points on the two (~1%); a
# filter that writes zeros is off by ~7%
CHECK_TOL = 3e-2
# limits between the card and the CPU for one train step of a bf16 model
# under ``draw_check_weights``: its loss (relative) and each parameter's
# gradient under ``train_gradients(..., smooth=True)`` (``gradient_error``,
# relative L2). Under the ensemble loss itself each bf16 gradient moves by
# 4-10% between two roundings of the same model (its abs kinks flip where
# two values nearly agree; bf16 against f32 on the CPU), which would test
# rounding, not the kernels; under the smooth loss bf16 and f32 differ by
# at most 1%, and the card and the CPU by 0.55% (H100). The gradient norm
# under the ensemble loss moves by about 1% (0.84% measured on an H100).
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_TOL = 2e-2
TRAIN_NORM_TOL = 5e-2


def names(nz: int = NZ) -> tuple[list[str], list[str], list[str]]:
    """(prognostic, diagnostic, forcing) variable names."""
    prognostic = (
        [f"air_temperature_{k}" for k in range(nz)]
        + [f"specific_total_water_{k}" for k in range(nz)]
        + [f"eastward_wind_{k}" for k in range(nz)]
        + [f"northward_wind_{k}" for k in range(nz)]
        + ["PRESsfc", "surface_temperature", "h500"]
    )
    diagnostics = ["LHTFLsfc", "SHTFLsfc", "PRATEsfc", "ULWRFsfc",
                   "ULWRFtoa", "DLWRFsfc", "DSWRFsfc", "USWRFsfc",
                   "USWRFtoa"]
    forcings = ["DSWRFtoa", "HGTsfc", "ocean_fraction"]
    return prognostic, diagnostics, forcings


def build_stepper(nlat=NLAT, nlon=NLON, nz=NZ, embed=EMBED, layers=LAYERS,
                  device=None, fused_block_tail=False,
                  checkpointing=0) -> Stepper:
    """The flagship stepper (weights not drawn yet) on ``device``.
    ``fused_block_tail`` sends every block's tail through the fused kernel
    (``NoiseConditionedSFNO.use_fused_block_tail``); it is not part of the
    model's config, as JAX checkpoints do not carry it. ``checkpointing``
    is the model config's per-block recompute level (1 for training)."""
    prognostic, diagnostics, forcings = names(nz)
    in_names = prognostic + forcings
    out_names = prognostic + diagnostics
    all_names = sorted(set(in_names) | set(out_names))
    builder = {"type": "NoiseConditionedSFNO", "config": {
        "embed_dim": embed, "noise_embed_dim": 32,
        "noise_type": "isotropic", "filter_type": "linear",
        "use_mlp": True, "num_layers": layers, "operator_type": "dhconv",
        "separable": False, "spectral_layers": 3,
        "spectral_transform": "sht", "affine_norms": True,
        "normalize_big_skip": True, "compute_dtype": "bfloat16",
        "checkpointing": checkpointing,
    }}
    step = dict(
        builder=builder, in_names=in_names, out_names=out_names,
        normalization={"network": {
            "means": {n: 0.0 for n in all_names},
            "stds": {n: 1.0 for n in all_names},
        }},
        ocean={"surface_temperature_name": "surface_temperature",
               "ocean_fraction_name": "ocean_fraction"},
        corrector={"conserve_dry_air": True},
    )
    info = DatasetInfo(
        horizontal_coordinates=LatLonCoordinates(
            lat=gaussian_latitudes(nlat),
            lon=np.linspace(0, 360, nlon, endpoint=False),
        ),
        vertical_coordinate=HybridSigmaPressureCoordinate(
            ak=np.concatenate([np.linspace(100.0, 5000.0, nz // 2),
                               np.linspace(5000.0, 0.0, nz // 2 + 1)]),
            bk=np.linspace(0.0, 1.0, nz + 1),
        ),
        timestep=timedelta(hours=6),
    )
    config = StepperConfig(step=StepSelector(type="single_module", config=step))
    stepper = config.get_stepper(info, device=device)
    stepper.module.use_fused_block_tail(fused_block_tail)
    return stepper


def build_train_stepper(nlat=NLAT, nlon=NLON, nz=NZ, embed=EMBED,
                        layers=LAYERS, fused_block_tail=False,
                        device=None) -> TrainStepper:
    """The flagship pretraining recipe (bench.py:_bench_train_step): the
    flagship stepper with per-block recompute (``checkpointing=1``), one
    forward step, 2 ensemble members, ``EnsembleLoss`` (CRPS 0.9, energy
    score 0.1), AdamW at lr 1e-4 with a bf16 first moment and gradient
    clipping at 1.0, and the default EMA. Weights not drawn yet: call
    ``init`` (or ``stepper.init_params``)."""
    stepper = build_stepper(nlat, nlon, nz, embed, layers, device=device,
                            fused_block_tail=fused_block_tail,
                            checkpointing=1)
    return TrainStepper(
        stepper,
        StepperTrainConfig(
            n_forward_steps=1,
            n_ensemble=2,
            remat=False,
            loss=from_dict(StepLossConfig, {
                "type": "EnsembleLoss",
                "kwargs": {"crps_weight": 0.9, "energy_score_weight": 0.1},
            }),
        ),
        OptimizationConfig(lr=1e-4, optimizer_type="AdamW",
                           max_grad_norm=1.0,
                           first_moment_dtype="bfloat16"),
        EMAConfig(),
    )


def synthetic_batch(stepper: Stepper, batch: int = 2,
                    n_forward_steps: int = 1,
                    generator: torch.Generator | None = None,
                    ) -> dict[str, torch.Tensor]:
    """A random training batch ``[batch, n_forward_steps + 1, nlat, nlon]``
    for every variable, on the stepper's device, shaped and scaled as
    bench.py:230-243 draws it."""
    nlat, nlon = stepper.dataset_info.img_shape
    step = stepper.step
    data = {}
    for k in sorted(set(step.input_names) | set(step.output_names)):
        v = torch.randn(batch, n_forward_steps + 1, nlat, nlon,
                        generator=generator, device=stepper.device)
        if k == "PRESsfc":
            v = v * 100 + 1.0e5
        if k.startswith("specific_total_water"):
            v = v.abs() * 1e-3
        if k == "ocean_fraction":
            v = v.abs().clamp(0, 1)
        data[k] = v
    return data


def draw_check_weights(stepper: Stepper, generator: torch.Generator):
    """Draw the weights for a comparison of two runs of one model (card
    against CPU): the default draw, then the parts that start at or near
    zero made large enough that a wrong filter or conditioning shows in
    the outputs. The noise conditioning (zero-initialized) gets std 0.1;
    the spectral filters (std 1/(in*out)) get std 1/sqrt(in)."""
    stepper.init_params(generator)
    with torch.no_grad():
        for name, p in stepper.module.named_parameters():
            if "w_scale_2d" in name or "w_bias_2d" in name:
                p.normal_(std=0.1, generator=generator)
            elif name.endswith("filter.weight"):
                # [2, L, I, O]: the fan-in is I
                p.normal_(std=p.shape[2] ** -0.5, generator=generator)


def fixed_noise(stepper: Stepper, noise: torch.Tensor):
    """Make the stepper's model condition on ``noise`` (moved to its
    device) whatever generator it is given: two runs on two devices then
    see the same noise."""
    noise = noise.to(stepper.device)
    stepper.module.make_noise = lambda batch, generator: noise


def train_gradients(train_stepper: TrainStepper, batch, generator=None,
                    smooth=False
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The loss of ``batch`` and the gradient of every parameter (by
    ``named_parameters`` name), without an update. ``smooth`` takes them
    under an MSE of the same outputs, targets and normalizer in place of
    the train stepper's loss (see ``TRAIN_GRAD_TOL``)."""
    params = dict(train_stepper.module.named_parameters())
    for p in params.values():
        p.grad = None
    step_loss = train_stepper.step_loss
    if smooth:
        train_stepper.step_loss = StepLossConfig(type="MSE").build(
            train_stepper.stepper.dataset_info.gridded_operations,
            out_names=train_stepper.stepper.step.output_names,
            normalizer=step_loss.loss.normalizer,
        )
    try:
        loss, _ = train_stepper.loss_fn(batch, generator)
    finally:
        train_stepper.step_loss = step_loss
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in params.items()
             if p.grad is not None}
    for p in params.values():
        p.grad = None
    return loss.detach(), grads


def gradient_error(grads: dict, ref: dict) -> dict[str, float]:
    """Relative L2 error of each gradient against ``ref`` (both on any
    device), by name."""
    if set(grads) != set(ref):
        raise ValueError(f"gradients of other parameters: "
                         f"{sorted(set(grads) ^ set(ref))}")
    errs = {}
    for k, r in ref.items():
        r = r.double().cpu()
        errs[k] = float((grads[k].double().cpu() - r).norm()
                        / r.norm().clamp_min(1e-30))
    return errs


def anomaly_error(out: torch.Tensor, ref: torch.Tensor, dim) -> float:
    """Largest error of ``out`` against ``ref`` over the scale of ``ref``'s
    spatial anomaly (its largest distance from its mean over the
    horizontal ``dim``), taken per variable or channel: dimensions outside
    ``dim`` that hold one field each are compared on their own scales."""
    ref = ref.float()
    scale = (ref - ref.mean(dim=dim, keepdim=True)).abs().amax(dim=dim)
    err = (out.float() - ref).abs().amax(dim=dim)
    return float((err / scale).max())


def synthetic_inputs(stepper: Stepper, n_steps: int, batch: int = 1,
                     generator: torch.Generator | None = None,
                     ) -> tuple[PrognosticState, dict[str, torch.Tensor]]:
    """A random initial condition and ``n_steps + 1`` forcing times on
    the stepper's device, shaped like the benchmark's synthetic data."""
    nlat, nlon = stepper.dataset_info.img_shape
    kw = dict(generator=generator, device=stepper.device)
    ic = {
        k: torch.randn(batch, 1, nlat, nlon, **kw)
        for k in stepper.prognostic_names
    }
    ic["PRESsfc"] = ic["PRESsfc"] * 100 + 1.0e5
    for k in ic:
        if k.startswith("specific_total_water"):
            ic[k] = ic[k].abs() * 1e-3
    forcing = {
        k: torch.randn(batch, n_steps + 1, nlat, nlon, **kw)
        for k in stepper.forcing_window_names
    }
    forcing["ocean_fraction"] = forcing["ocean_fraction"].abs().clamp(0, 1)
    return PrognosticState(data=ic), forcing
