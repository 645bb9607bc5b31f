"""Smoke run of the PyTorch/CUDA port (ace_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Checks that CUDA is present, prints the card's name and power limit,
   and turns TF32 off for matmuls and convolutions.
2. Builds the port's CUDA kernels from ``ace_tpu_torch/csrc/`` with nvcc
   (one process per source, all at once) and prints the build times and
   the compiler's resource reports (registers, shared memory, spills).
3. Kernel phases: holds each kernel (K1 dhconv_filter, K2
   fused_block_tail, K3 fused_sht, and K1's backward: 1b dhconv_filter_dx
   and 1c dhconv_filter_dw) against its plain PyTorch version on the card,
   at the main paths' shapes (K1 and K2 also as paths T and T-A call them:
   4 samples, float32 weights that require grad, through their autograd
   Functions; K1, 1b and 1c also at width 384, path S-bf16's) and at a
   ragged shape, and times the kernel,
   the plain version and what the port runs in its place (one PyTorch
   library call for K1, 1b and 1c, the unfused tail for K2,
   ``RealSHT.forward_pair`` and one three-operand einsum for K3), beside
   the least time the card could take (``bound_share`` = bound / kernel
   time). K3 and ``forward_pair`` are also held against a float64
   evaluation of the same transform.
4. Reference phases: runs a small bf16 model on the card (kernels) and on
   the CPU (plain versions) with the same weights and noise, unfused
   (K1) and with the fused tail (K1 and K2), and compares its outputs;
   then (phase T) the same for one train step of it: loss, every
   parameter's gradient (K1, 1b, 1c; K2 and its recomputed backward) and
   the step's metrics; then (phase R) one epoch of a small bf16 copy of
   the shipped training config through the training entry's ``main``,
   whose train and validation losses must agree.
5. Paths, each driven with the launch counts set to 0 just before it and
   read just after, on the ACE2-ERA5 flagship stepper (NoiseConditionedSFNO,
   embed 512, 8 layers, 180x360 Gauss grid, bf16, 32 isotropic noise
   channels, prescribed SST, dry-air corrector; 38 inputs, 44 outputs)
   built through the port's config and registry with weights drawn from a
   seed on the card:
   - path 0, the unfused rollout: ``Stepper.predict`` for 20 steps at
     batch 1 (K1 only);
   - path A, the same stepper with the fused block tail: its first step
     against path 0's, then 20 steps (K1 and K2);
   - path B, ``RealSHT.forward_fused`` (K3) on the flagship's transform,
     applied to the input a block's forward SHT sees, against
     ``forward_pair``.
   - path T, the flagship pretraining step (``flagship.build_train_stepper``:
     per-block recompute, 2 ensemble members, CRPS and energy score, AdamW
     with a bf16 first moment, clipping, EMA) on a batch of 2: one
     warm-up step, then 5 steps on the same batch and noise (K1, 1b, 1c);
   - path T-A, one step of the same recipe with the fused tail (K2 too)
     from the same weights, batch and noise, against path T's first;
   - path I, the inference entry (``ace_tpu_torch.inference``): flagship
     weights written with ``save_stepper`` and loaded back, 22 times of
     the flagship's 47 variables, 20 steps from start indices [0, 1] in
     windows of 5, through ``main`` on YAML configs over a netCDF file,
     once without a writer and once with one. It prints the versions of
     h5py, msgpack and PyYAML first; where h5py is missing it prints so and
     holds the entry's files in host memory (``h5py_in_memory``, a
     stand-in for ``h5py.File``); msgpack and PyYAML it needs. It checks
     that restart.nc and the diagnostics files are finite, 160 K1
     launches and no other kernel's, no synchronizing call in
     ``run_inference`` without a writer before the one that stops its
     clock, the written predictions within 1e-5 of each channel's spatial
     std of one 20-step ``Stepper.predict`` from the same seed, and the
     dry-air mass within 1 Pa; it prints steps/s, the ``GlobalTimer`` phases and the
     peak memory.
   - path R, the training entry (``ace_tpu_torch.train``):
     ``configs/ace2-era5-train.yaml`` as shipped (the ACE2-ERA5 recipe at
     full width, with the total-energy correction) but for the cuts of
     ``_train_config`` (synthetic files of its 48 variables at 180x360, 9
     training and 5 validation times; batch 2; the builder's per-block
     recompute; one epoch; one inline-inference entry of 4 steps from 2
     initial conditions), through ``main``, then ``main`` again with
     ``--override max_epochs=2``, which must resume at epoch 1 from
     ``ckpt.msgpack``. It checks finite metrics, one metrics.jsonl line
     per epoch, the four checkpoint files, the resumed state bit for bit
     (per-tensor checksums on the device), the launches of each phase (per
     train step as on path T, 16 K1 per validation batch, 8 K1 per
     inference step, no K2 or K3) and no synchronizing call inside the
     batch loop; it prints the rate over epoch 2 beside path T's, the
     ``GlobalTimer`` phases, each checkpoint's bytes and seconds to write,
     the seconds to read ``ckpt.msgpack`` (at the resume) and
     ``best_ckpt.msgpack``, the free disk and host memory before the first
     write
     (and fails if they cannot hold the checkpoints) and the peak memory.
   - path S, the ACE2-SHiELD AMIP recipe
     (``configs/baselines/amip-c96-shield/train-ace2.yaml``:
     SphericalFourierNeuralOperatorNet, embed 384, 8 layers, float32, 56
     variables at 180x360), after reference phase S (a small SFNO of its
     shape, card against CPU: float32 with the dhconv and diagonal
     operators and the FFT transform, and bfloat16 through K1, 1b and
     1c): S-R, the training entry over synthetic files with the cuts of
     ``_shield_config`` (batch 2, 4 training batches, 1 validation
     batch, one epoch, an inline entry of 4 steps from 2 initial
     conditions with the YAML's histograms and synthetic time-mean and
     monthly references): finite metrics, the checkpoint files, no kernel
     launch (float32 filters are einsums, as in JAX) and no sync in the
     batch loop; S-I, the inference entry over S-R's best checkpoint (20
     steps at batch 1 in windows of 5: no launch, no sync in
     ``run_inference``, within 1e-5 of ``Stepper.predict``, dry air
     within 1 Pa); S-bf16, S-R's config with ``compute_dtype: bfloat16``
     (3 train steps at batch 1 after a warm-up: 16 K1, 16 1b, 16 1c each,
     the loss falling; a 20-step rollout: 8 K1 a step).
   - path M, the ACE2-SOM slab-ocean recipe
     (``configs/baselines/shield-som/``: the same network at embed 384,
     the multi-call step around the slab-ocean step, the energy-budget
     corrector with 1.14 W/m2 of unaccounted heating), after reference
     phase M (small steps of every type and option of the slice, card
     against CPU in float32 and bfloat16: ``multi_call`` over the slab
     step, global-mean removal in both modes, channel-mask inputs, input
     dropout with its presence passed in, the secondary decoder,
     ``separate_radiation`` with and without ``detach_radiation``,
     ``secondary_module`` with a decoder; exact K1, 1b and 1c counts in
     bfloat16): M-R, the training entry over synthetic files with the
     cuts of ``_som_config`` (no launch, no sync in the batch loop); M-I,
     the abrupt-4xCO2 inference YAML over M-R's best checkpoint (4 of its
     initial conditions, 20 steps in its windows of 1: no launch, no sync
     in ``run_inference``, the forcing's CO2 the YAML's constant, the slab
     SST within 1e-6 of its float64 formula, within 1e-5 of
     ``Stepper.predict``); M-bf16, M-R's config in bfloat16 with CO2
     quadrupled in a second call of each step and its six fluxes in the
     loss (3 train steps at batch 1 after a warm-up: 32 K1, 32 1b, 32 1c
     each; a 20-step rollout with the multi-call set through
     ``stepper_override``: 16 K1 a step, its suffixed outputs equal to a
     call of the wrapped step with CO2 x 4).
   - path O, the uncoupled-ocean CM4 recipe
     (``configs/baselines/cm4-piControl/uncoupled-ocean/``: Samudra at its
     widths 200-400, float32, 180x360 at five days a step, 90 inputs and
     80 outputs over 19 depth levels, the ocean corrector, input masking
     and NaN-filled outputs over a land mask of 30% of the grid), after
     reference phase O (a small Samudra of its shape, card against CPU over
     3 steps in float32: the outputs with NaN on the same cells, the loss
     and every gradient): O-R, the training entry over three synthetic
     stores read through the YAML's ``merge`` lists with the cuts of
     ``_ocean_config`` (batch 4, 2 batches, 1 validation batch, 4 inline
     steps from 8 initial conditions, one epoch, then a resume that must
     be bit-equal): finite losses, no launch, no sync in the batch loop,
     the masked outputs NaN exactly on the dry cells and finite elsewhere,
     the inputs finite after the input masking, the corrector's
     ``force_positive_names`` >= 0 and the sea-ice fraction in [0, 1]; O-E,
     the evaluator YAML over O-R's best checkpoint for 20 steps with every
     aggregator flag (no launch, no sync in ``run_inference``, the
     predictions within 1e-5 of ``Stepper.predict``, the derived ocean heat
     content within 1e-6 of a float64 depth integral of the step's own
     temperatures, the time-mean maps NaN on the dry cells, the global
     means over the wet cells).
   - path C, the SamudrACE CM4 coupled recipes
     (``configs/baselines/cm4-piControl/{train,finetune,evaluator}-config.yaml``:
     the CM4 atmosphere, the SFNO at embed 384 with 8 layers at 6 hours,
     coupled to path O's Samudra at 5 days, 20 atmosphere steps an ocean
     step, float32), after reference phase C (a small coupled system of
     its shape, card against CPU over 2 ocean steps of 4 atmosphere steps:
     both components' outputs, the coupled loss and every ocean gradient):
     C-R, ``python -m ace_tpu_torch.coupled``'s ``main`` on the training
     YAML over two merged atmosphere stores (``coupled_files``: 58
     variables at 180x360, every atmosphere time 20 i at ocean time i) and
     path O's ocean stores, from seeded component checkpoints
     (``coupled_checkpoints``: the uncoupled-atmosphere YAML's stepper and
     the ocean's), with the cuts of ``_coupled_config`` (batch 1, 2
     batches and 1 validation pair, one epoch; 4 coupled steps, the ocean
     fraction predicted, the atmosphere frozen): finite losses with an
     atmosphere loss of 0, the atmosphere bit-equal to its checkpoint, the
     ocean changed, no launch, no sync in the batch loop, the atmosphere's
     state and inputs finite after every exchange, the predicted ocean
     fraction within 1e-6 of float64, the fluxes the ocean receives within
     1e-6 of the float64 mean of the atmosphere's outputs, a restart
     loading weights bit-equal to the files; C-F, the finetune YAML from
     C-R's checkpoints (2 coupled steps, both components trained: the
     learning rate of each update ``CosineAnnealingLR``'s); C-E, the
     evaluator YAML over them (4 coupled steps in windows of 2: no launch,
     no sync in the window loop, the predictions within 1e-5 of one
     ``CoupledStepper.predict``); C-bf16, C-R's config with the
     atmosphere in bfloat16 (2 coupled steps: exactly 480 K1, 160 1b and no
     1c a train step, 160 K1 a rollout of one outer step).
   - path N, FourCastNet3's recipe (``configs/fcn3-train.yaml``: DISCO
     encoders and decoders at 180x360 on the Legendre-Gauss grid, a
     processor of 8 blocks at 45x90 over 1184 channels, global dhconv
     and local DISCO blocks in turn, float32, 37 variables over 8 levels),
     after reference phase N (``DiscoConvS2`` at ragged shapes, then a
     small FCN3 of its shape, 32x64, 2 levels with a diagnostic in each,
     4 layers, card against CPU: one forward step and one MSE train step):
     N-R, the training entry over synthetic files with the cuts of
     ``_fcn3_config`` (batch 4, 2 batches, 1 validation batch, one epoch,
     then a resume that must be bit-equal), TF32 turned on before each
     run: both TF32 flags off after it, finite metrics, one
     ``metrics.jsonl`` line per epoch, the checkpoint files, no launch, no
     sync in the batch loop; N-I, the inference entry over N-R's best
     checkpoint (20 steps from 2 initial conditions in windows of 5: TF32
     off after it, no launch, no sync in ``run_inference``, within 1e-5
     of ``Stepper.predict``).
   - path L, LocalNet and the conditional SFNO's options
     (``local_paths``): K2 at 34 conditioning channels (a ragged shape
     and L-A's) and K1, 1b, 1c at ``[1, 180, 181, 256]`` against their
     plain versions, with their times and bounds; reference phase L
     (small models card against CPU: the bf16 conditional SFNO with local
     blocks, LoRA, ``spectral_ratio`` 0.5 and labels, f32 with the global
     layer norm, LocalNet with both block types and isotropic noise,
     AnkurLocalNet); L-R, the training entry on
     ``configs/ace2-era5-train.yaml`` at full width with path R's cuts,
     local blocks at 1, 3, 5 and 7, ``conditional`` over two concatenated
     sources labelled ``era5`` and ``shield``, ``allow_missing_variables``
     with ``L_MISSING`` absent from both (one epoch, then a bit-equal
     resume: finite metrics but the missing variable's one-step ones, the
     missing variable's loss term masked, exact launches, 2 K1, 1b and 1c
     per spectral block a train step, no sync in the batch loop); L-I, the
     inference entry over L-R's best checkpoint (20 steps at batch 1 in
     windows of 5: 4 K1 a step, no sync, within 1e-5 of
     ``Stepper.predict``); L-A, the same model with the fused tail (its
     first step against the unfused one from check weights, then 20 steps:
     8 K2 and 4 K1 a step); L-N, ``LocalNet`` at its builder's defaults in
     the network's place (one epoch, then 20 inference steps: no launch, no
     sync, within 1e-5 of ``Stepper.predict``).
   - path H, DLWP-HPX's recipe on the HEALPix grid
     (``configs/dlwp-hpx64-train.yaml``: HEALPixUNet at its builder's
     defaults, 9.54 M parameters, on HPX64, 12 x 64 x 64 pixels, 8
     prognostic fields and 3 forcings, float32, MSE), after reference
     phase H (the neighbour pad at p = 1-3 equal to the CPU, the nside-64
     SHT pair against float64, a band-limited round trip, the winds'
     vorticity and divergence at 180x360 and back against float64, three
     small HEALPixUNets over every block type and an ensemble-loss train
     step on the HEALPix SHT, card against CPU): H-R, the training entry
     over synthetic files on (face, height, width) dims with the cuts of
     ``_healpix_config`` (batch 4, 4 batches, 1 validation batch, 4 inline
     steps, one epoch, then a resume that must be bit-equal; TF32 turned
     on before each run and off after it; no launch, no sync in the batch
     loop); H-I, the inference entry over H-R's best checkpoint (20 steps
     at batch 1 in windows of 5 from an initial condition given as a
     ``file://`` URL, the spectrum aggregator on the HEALPix SHT: no
     launch, no sync in ``run_inference``, within 1e-5 of
     ``Stepper.predict``).
   - path W, the Swin U-Nets through the flagship recipe, after reference
     phase W (``W_REFERENCE``: small Swin nets over every option, card
     against CPU, later rollout steps stepwise): W-R, the training entry
     on ``configs/ace2-era5-train.yaml`` with path R's cuts and the
     NoiseConditionedSwinTransformer at its builder's defaults (10.2 M
     parameters, f32; one epoch, then a bit-equal resume; TF32 on before
     each run and off after it; no launch, no sync in the batch loop);
     W-I, the inference entry over W-R's best checkpoint (20 steps at
     batch 1 in windows of 5: no launch, no sync, within 1e-5 of
     ``Stepper.predict``); W-A, the AdaLN ``SwinTransformer`` with fme's
     earth pad (40, 40), conditional over path L's two sources (2
     batches).
   - path G, FloeNet through the sea-ice recipe of
     ``tests/test_ice_train.py`` on the 1° grid with path O's land mask,
     after reference phase G (the fast ``radius_query`` and
     ``containing_triangle`` equal to their brute-force copies at meshes 6
     on 8,192 seeded points, the brute force on the card in float64;
     small GraphCasts with and without a mask, card against CPU and two
     runs bit-equal; a FloeNet step): G-R, the training entry (FloeNet at
     its defaults, batch 2, one epoch then a bit-equal resume; prints
     ``build_graphs``' seconds); G-E, the evaluator over G-R's best
     checkpoint (20 steps, ``fill_nans: 0.0``: finite metrics, NaN
     exactly on land, no launch, no sync); G-L, ``LandNet`` with its
     positional embedding (2 batches).
   - path D, the HiRO-ACE global downscaling recipe
     (``configs/baselines/downscaling-hiro-global/train.yaml``: SongUNet
     at model_channels 128 over 7 levels, 54.6 M parameters, f32, residual
     prediction with the fine topography, x32 on 16x16 coarse patches,
     18 Heun steps) over synthetic files (``D_SIZES``: 32x64 coarse cells
     inside the recipe's lat_extent), after reference phase D (small
     SongUNets of each encoder and decoder type, the compact UNet and
     SwinIR, card against CPU: outputs, EDM loss, gradients, one sampler
     call; the dropout's keep rate): D-R, the downscaling training entry
     (batch 6, 4 batches an epoch, validation each epoch; one epoch, then
     a bit-equal resume; TF32 on before each run and off after it; no
     launch, no sync in the batch loop); D-G, the downscaler entry over
     D-R's checkpoint (one event of 2x2 patches, 2 samples: 35 network
     calls a patch-sample, no sync in the sampler, the first patch's
     cells equal to ``PatchPredictor.generate`` on the same draws); D-E,
     the evaluator entry (one patch-sized region, one time and one
     event: every metric finite).
   The rollouts check finite outputs, the dry-air mass, the prescribed SST
   and the launch counts, and print steps/s and peak device memory; the
   train steps check finite losses and gradient norms, a loss after the
   6 updates below the warm-up step's (taken before any update), the
   launch counts and that no step waits for the device, and print steps/s,
   samples/s and peak device memory.

Prints the seconds each section took, a ``{"kernels": [...]}`` JSON line,
then as its last line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero without that line. Needs no network and imports nothing of JAX.
"""

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

N_STEPS = 20
TRAIN_STEPS = 5
TRAIN_BATCH = 2
# published H100 SXM peaks (dense bf16 and TF32 tensor cores, f32 outside
# the tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# the width of path S's network (configs/baselines/amip-c96-shield/
# train-ace2.yaml: embed_dim 384)
SFNO_EMBED = 384
BF16_TOL = 8e-3  # of the largest output: the final bf16 rounding
# K2: four bf16 rounding points between the products, the JAX package's
# fused-versus-module limit (tests/test_pallas_block.py)
TAIL_TOL = 2e-2
# K3: split-TF32 products (about 22 mantissa bits) summed over 360 and 180
# terms in another order
SHT_TOL = 1e-4
# 1b and 1c: bf16 products are exact in f32, so only the order of the f32
# sums differs (over 512 and 1448 terms at the flagship)
BWD_TOL = 1e-4
# path T-A's first step against path T's: the fused tail rounds to bf16 at
# other points than the unfused modules
TRAIN_PATH_TOL = 2e-2


def bound(n_bytes, flops, peak_flops):
    """(bound_ms, bound_by): the larger of the memory and compute times."""
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / peak_flops * 1e3
    by = "bytes" if bytes_ms >= flops_ms else "operations"
    return max(bytes_ms, flops_ms), by, bytes_ms, flops_ms


def max_err(out, ref):
    """Largest absolute difference over a tuple of outputs, and the
    largest absolute reference value."""
    import torch

    torch.cuda.synchronize()
    err = max(float((a.float() - r.float()).abs().max())
              for a, r in zip(out, ref))
    scale = max(float(r.float().abs().max()) for r in ref)
    return err, scale


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` launches, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dhconv_phase(gen):
    """Kernel K1 against its plain version, with its times and bound."""
    import torch

    from ace_tpu_torch.ops.dhconv_filter import (
        dhconv_filter,
        dhconv_filter_plain,
    )

    def inputs(b, l, m, i, o):
        kw = dict(generator=gen, device="cuda")
        xr = torch.randn(b, l, m, i, **kw)
        xi = torch.randn(b, l, m, i, **kw)
        wr = (torch.randn(l, i, o, **kw) / (i * o)).to(torch.bfloat16)
        wi = (torch.randn(l, i, o, **kw) / (i * o)).to(torch.bfloat16)
        return xr, xi, wr, wi

    def check(args):
        return max_err(dhconv_filter(*args), dhconv_filter_plain(*args))

    # ragged M and O edges (M=181 over 64-row tiles, O=200 over 64 columns)
    err, scale = check(inputs(2, 3, 181, 96, 200))
    print(f"dhconv_filter ragged [2,3,181,96]x[3,96,200]: max_abs_err "
          f"{err:.3e} (tol {BF16_TOL * scale:.3e})")
    if not err <= BF16_TOL * scale:
        raise AssertionError("dhconv_filter disagrees with its plain version "
                             "at the ragged shape")

    # the flagship shape: B=1, L=180, M=181, I=O=512
    from ace_tpu_torch import flagship

    b, l, m = 1, flagship.NLAT, flagship.NLON // 2 + 1
    train_err, train_tol = dhconv_train_check(gen)
    rows = {}
    for label, width in (("flagship", flagship.EMBED),
                         ("sfno", SFNO_EMBED)):
        args = inputs(b, l, m, width, width)
        err, scale = check(args)
        tol = BF16_TOL * scale
        print(f"dhconv_filter {label} [1,180,181,{width}]x[180,{width},"
              f"{width}]: max_abs_err {err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError("dhconv_filter disagrees with its plain "
                                 f"version at the {label} shape")
        rows[label] = {"max_abs_err": err, "tol": tol,
                       **_dhconv_times(label, args)}
    train_err_s, train_tol_s = dhconv_train_check(gen, SFNO_EMBED, 1)
    rows["sfno"].update(train_max_abs_err=train_err_s,
                        train_tol=train_tol_s)
    return {
        "name": "dhconv_filter", "route": "cuda",
        "source": "ace_tpu_torch/csrc/dhconv_filter.cu",
        "replaces": "ace_tpu/ops/pallas_filter.py:69",
        "launches": None, **rows["flagship"],
        "train_max_abs_err": train_err, "train_tol": train_tol,
        "at_width_384": rows["sfno"],
    }


def _dhconv_times(label, args):
    """K1's time at ``args``' shape beside its plain version, one bf16
    library matmul of the same function and its bound."""
    import torch

    from ace_tpu_torch.ops.dhconv_filter import (
        dhconv_filter,
        dhconv_filter_plain,
    )

    xr, xi, wr, wi = args
    b, l, m, i = xr.shape
    o = wr.shape[-1]
    # the same function as one bf16 library matmul on the stacked real
    # form [x_r | x_i] @ [[w_r, w_i], [-w_i, w_r]] (timed only, never used)
    a = torch.cat([xr, xi], dim=-1).to(torch.bfloat16)
    w = torch.cat([torch.cat([wr, wi], dim=-1),
                   torch.cat([-wi, wr], dim=-1)], dim=1)
    ms = cuda_ms(lambda: dhconv_filter(*args), 50)
    plain_ms = cuda_ms(lambda: dhconv_filter_plain(*args), 10)
    library_ms = cuda_ms(lambda: torch.matmul(a, w), 50)
    n_bytes = 2 * xr.numel() * 4 + 2 * wr.numel() * 2 + 2 * b * l * m * o * 2
    flops = 8 * b * l * m * i * o
    bound_ms, bound_by, bytes_ms, flops_ms = bound(n_bytes, flops,
                                                   PEAK_BF16_FLOPS)
    print(f"dhconv_filter {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, library (bf16 matmul) {library_ms:.4f} ms; bound: "
          f"{n_bytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms, {flops / 1e9:.1f} "
          f"GFLOP -> {flops_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def dhconv_train_check(gen, width=None, batch=2 * TRAIN_BATCH):
    """K1 as path T (or, at ``width`` 384 and ``batch`` 1, path S-bf16)
    calls it: ``batch`` samples through
    ``dhconv_filter_param``, whose autograd Function rounds the float32
    ``[2, L, I, O]`` weight (which requires grad) to bf16, one contiguous
    cast whose halves are K1's ``[L, I, O]`` weights; against the plain
    version on the same float32 weights."""
    import torch

    from ace_tpu_torch import flagship
    from ace_tpu_torch.ops.dhconv_filter import (
        dhconv_filter_param,
        dhconv_filter_plain,
    )

    b, l, m = batch, flagship.NLAT, flagship.NLON // 2 + 1
    i = o = width or flagship.EMBED
    kw = dict(generator=gen, device="cuda")
    xr, xi = (torch.randn(b, l, m, i, **kw) for _ in range(2))
    weight = (torch.randn(2, l, i, o, **kw) * i ** -0.5).requires_grad_()
    with torch.enable_grad():
        out = dhconv_filter_param(xr, xi, weight)
    if out[0].grad_fn is None:
        raise AssertionError("dhconv_filter_param did not go through its "
                             "autograd Function")
    ref = dhconv_filter_plain(xr, xi, *weight.detach())
    err, scale = max_err(tuple(t.detach() for t in out), ref)
    tol = BF16_TOL * scale
    print(f"dhconv_filter train [{b},{l},{m},{i}] through "
          f"dhconv_filter_param (f32 [2, L, I, O] weight): max_abs_err "
          f"{err:.3e} (tol {tol:.3e})")
    if not err <= tol:
        raise AssertionError("dhconv_filter disagrees with its plain version "
                             f"at the training shape [{b},{l},{m},{i}]")
    return err, tol


def dhconv_bwd_phase(gen):
    """Kernels 1b (dx) and 1c (dW) against their plain versions at a
    ragged shape, the flagship training shape (B = 4: 2 samples x 2
    members) and path S-bf16's (B = 1, width 384), with their times at
    the last two beside their bounds, their plain versions and one bf16
    library matmul each."""
    import torch

    from ace_tpu_torch import flagship
    from ace_tpu_torch.ops.dhconv_filter import (
        dhconv_filter_dw,
        dhconv_filter_dw_plain,
        dhconv_filter_dx,
        dhconv_filter_dx_plain,
    )

    def inputs(b, l, m, i, o):
        kw = dict(generator=gen, device="cuda")
        xr, xi = (torch.randn(b, l, m, i, **kw) for _ in range(2))
        gr, gi = (torch.randn(b, l, m, o, **kw).to(torch.bfloat16)
                  for _ in range(2))
        wr, wi = ((torch.randn(l, i, o, **kw) / (i * o)).to(torch.bfloat16)
                  for _ in range(2))
        return xr, xi, gr, gi, wr, wi

    def check(label, shape, name, out, ref):
        err, scale = max_err(out, ref)
        tol = BWD_TOL * scale
        print(f"{name} {label} {list(shape)}: max_abs_err {err:.3e} (tol "
              f"{tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at the {label} shape")
        return err, tol

    m = flagship.NLON // 2 + 1
    rows = {}
    for label, shape in (("ragged", (2, 3, 181, 96, 200)),
                         ("flagship-train", (2 * TRAIN_BATCH, flagship.NLAT,
                                             m, flagship.EMBED,
                                             flagship.EMBED)),
                         ("sfno-train", (1, flagship.NLAT, m, SFNO_EMBED,
                                         SFNO_EMBED))):
        args = inputs(*shape)
        xr, xi, gr, gi, wr, wi = args
        dx = check(label, shape, "dhconv_filter_dx",
                   dhconv_filter_dx(gr, gi, wr, wi),
                   dhconv_filter_dx_plain(gr, gi, wr, wi))
        dw_ref = dhconv_filter_dw_plain(xr, xi, gr, gi)
        dw = check(label, shape, "dhconv_filter_dw",
                   (dhconv_filter_dw(xr, xi, gr, gi),),
                   (torch.stack(dw_ref),))
        del dw_ref
        if label == "ragged":
            continue
        for name, row in _dhconv_bwd_times(label, args, dx, dw).items():
            if label == "flagship-train":
                rows[name] = row
            else:
                rows[name]["at_width_384"] = {
                    k: row[k] for k in ("max_abs_err", "tol", "ms",
                                        "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")}
    return rows


def _dhconv_bwd_times(label, args, dx, dw):
    """1b's and 1c's times at ``args``' shape beside their plain versions,
    one bf16 library matmul each and their bounds."""
    import torch

    from ace_tpu_torch.ops.dhconv_filter import (
        dhconv_filter_dw,
        dhconv_filter_dw_plain,
        dhconv_filter_dx,
        dhconv_filter_dx_plain,
    )

    xr, xi, gr, gi, wr, wi = args
    b, l, m, i = xr.shape
    o = wr.shape[-1]
    bf = torch.bfloat16
    # the same functions as one bf16 library matmul each, on the stacked
    # real forms (timed only, never used):
    # dx = [g_r | g_i] @ [[w_r^T, -w_i^T], [w_i^T, w_r^T]] per l, the
    # operands laid out for it beforehand
    g_cat = torch.cat([gr, gi], dim=-1).transpose(0, 1).reshape(
        l, b * m, 2 * o).contiguous()
    w_t = torch.cat([torch.cat([wr, -wi], dim=1),
                     torch.cat([wi, wr], dim=1)], dim=2).transpose(1, 2)
    w_t = w_t.contiguous()
    # dW = [x_r; x_i]^T @ [[g_r, g_i], [g_i, -g_r]] per l, over b and m
    x_st = torch.cat([xr, xi], dim=2).to(bf).permute(1, 3, 0, 2).reshape(
        l, i, 2 * b * m).contiguous()
    g_st = torch.cat([torch.cat([gr, gi], dim=-1),
                      torch.cat([gi, -gr], dim=-1)], dim=2).permute(
        1, 0, 2, 3).reshape(l, 2 * b * m, 2 * o).contiguous()
    times = {
        "dx": cuda_ms(lambda: dhconv_filter_dx(gr, gi, wr, wi), 20),
        "dx_plain": cuda_ms(lambda: dhconv_filter_dx_plain(gr, gi, wr, wi),
                            3),
        "dx_library": cuda_ms(lambda: torch.matmul(g_cat, w_t), 20),
        "dw": cuda_ms(lambda: dhconv_filter_dw(xr, xi, gr, gi), 20),
        "dw_plain": cuda_ms(lambda: dhconv_filter_dw_plain(xr, xi, gr, gi),
                            3),
        "dw_library": cuda_ms(lambda: torch.matmul(x_st, g_st), 20),
    }
    flops = 8 * b * l * m * i * o
    dx_bytes = 2 * b * l * m * o * 2 + 2 * l * i * o * 2 + 2 * b * l * m * i * 4
    dw_bytes = 2 * b * l * m * i * 4 + 2 * b * l * m * o * 2 + 2 * l * i * o * 4
    rows = {}
    for name, n_bytes, key, source, replaces in (
            ("dhconv_filter_dx", dx_bytes, "dx", "dhconv_filter_bwd.cu", 129),
            ("dhconv_filter_dw", dw_bytes, "dw", "dhconv_filter_dw.cu", 137)):
        bound_ms, bound_by, bytes_ms, flops_ms = bound(n_bytes, flops,
                                                       PEAK_BF16_FLOPS)
        err, tol = dx if key == "dx" else dw
        print(f"{name} {label}: kernel {times[key]:.4f} ms, plain "
              f"{times[key + '_plain']:.4f} ms, library (bf16 matmul, "
              f"stacked real form) {times[key + '_library']:.4f} ms; bound: "
              f"{n_bytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms, "
              f"{flops / 1e9:.1f} GFLOP -> {flops_ms:.4f} ms")
        rows[name] = {
            "name": name, "route": "cuda",
            "source": f"ace_tpu_torch/csrc/{source}",
            "replaces": f"ace_tpu/ops/pallas_filter.py:{replaces}",
            "launches": None, "max_abs_err": err, "tol": tol,
            "ms": times[key], "plain_ms": times[key + "_plain"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": times[key + "_library"],
        }
    return rows


def tail_inputs(n, c, hidden, nc, gen, params=False):
    """Rows and weights for K2, the weights drawn at std 1/sqrt(fan-in)
    so that every product shows in the output: bf16 and contiguous, as
    the rollout's cache holds them, or with ``params`` as path T-A hands
    them to the autograd Function (``ConditionalFNOBlock.tail_params``):
    float32 tensors that require grad, the dense kernels as transposed
    views of ``[out, in]`` weights."""
    import torch

    def r(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    def dense(n_in, n_out, std):
        if params:
            return r(n_out, n_in, std=std).requires_grad_().t()
        return r(n_in, n_out, std=std)

    bf = torch.bfloat16
    xf, resid = r(n, c).to(bf), r(n, c).to(bf)
    noise = r(n, nc)
    weights = (
        dense(c, c, c ** -0.5), r(c, std=0.1), 1.0 + r(c, std=0.1),
        r(c, std=0.1), dense(nc, c, 0.1), dense(nc, c, 0.1),
        dense(c, hidden, c ** -0.5), r(hidden, std=0.1),
        dense(hidden, c, hidden ** -0.5), r(c, std=0.1),
    )
    if params:
        return xf, resid, noise, tuple(
            w if w.requires_grad else w.requires_grad_() for w in weights)
    return xf, resid, noise, tuple(w.to(bf).contiguous() for w in weights)


def block_tail_phase(gen, block):
    """Kernel K2 against its plain version at a ragged and the flagship
    shape, and as path T-A calls it (the rows of 2 * TRAIN_BATCH samples,
    float32 parameter views that require grad, through the autograd
    Function); times beside the unfused tail of ``block`` (a flagship
    block, as path 0 runs it) on the same rows."""
    import torch

    from ace_tpu_torch.ops.fused_block_tail import (
        fused_block_tail,
        fused_block_tail_plain,
    )

    def check(args, label):
        err, scale = max_err((fused_block_tail(*args),),
                             (fused_block_tail_plain(*args),))
        tol = TAIL_TOL * scale
        print(f"fused_block_tail {label}: max_abs_err {err:.3e} "
              f"(tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"fused_block_tail disagrees with its plain "
                                 f"version at the {label} shape")
        return err, tol

    check(tail_inputs(1000, 128, 256, 4, gen), "ragged N=1000 C=128 H=256 nc=4")
    from ace_tpu_torch import flagship

    n = flagship.NLAT * flagship.NLON
    c, hidden, nc = flagship.EMBED, block.hidden, block.embed_dim_noise
    n_train = 2 * TRAIN_BATCH * n
    xf, resid, noise, params = tail_inputs(n_train, c, hidden, nc, gen,
                                           params=True)
    with torch.enable_grad():
        out = fused_block_tail(xf, resid, noise, params)
    if out.grad_fn is None:
        raise AssertionError("fused_block_tail did not go through its "
                             "autograd Function")
    with torch.no_grad():
        ref = fused_block_tail_plain(xf, resid, noise, params)
    train_err, scale = max_err((out.detach(),), (ref,))
    train_tol = TAIL_TOL * scale
    print(f"fused_block_tail flagship-train N={n_train} (f32 parameter "
          f"views through the autograd Function): max_abs_err "
          f"{train_err:.3e} (tol {train_tol:.3e})")
    if not train_err <= train_tol:
        raise AssertionError("fused_block_tail disagrees with its plain "
                             "version at the flagship training shape")
    del xf, resid, noise, params, out, ref
    args = tail_inputs(n, c, hidden, nc, gen)
    err, tol = check(args, f"flagship N={n} C={c} H={hidden} nc={nc}")
    xf, resid, noise, weights = args
    xf4, r4, n4 = (t.view(1, flagship.NLAT, flagship.NLON, -1)
                   for t in (xf, resid, noise))

    def unfused():
        # the tail as path 0 runs it (ConditionalFNOBlock.forward)
        with torch.inference_mode():
            y = block.norm1(block.act(xf4 + block.inner_skip(r4)), n4)
            return block.mlp(y) + r4

    ms = cuda_ms(lambda: fused_block_tail(*args), 20)
    plain_ms = cuda_ms(lambda: fused_block_tail_plain(*args), 5)
    unfused_ms = cuda_ms(unfused, 20)
    n_bytes = (3 * n * c * 2 + n * nc * 4
               + sum(w.numel() for w in weights) * 2)
    flops = 2 * n * (c * c + 2 * nc * c + 2 * c * hidden)
    bound_ms, bound_by, bytes_ms, flops_ms = bound(n_bytes, flops,
                                                   PEAK_BF16_FLOPS)
    print(f"fused_block_tail flagship: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, unfused tail as path 0 runs it (not one "
          f"library call) {unfused_ms:.4f} ms; bound: {n_bytes / 1e6:.1f} "
          f"MB -> {bytes_ms:.4f} ms, {flops / 1e9:.1f} GFLOP -> "
          f"{flops_ms:.4f} ms")
    return {
        "name": "fused_block_tail", "route": "cuda",
        "source": "ace_tpu_torch/csrc/fused_block_tail.cu",
        "replaces": "ace_tpu/ops/pallas_block.py:85",
        "launches": None, "max_abs_err": err, "tol": tol,
        "train_max_abs_err": train_err, "train_tol": train_tol,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "unfused_tail_ms": unfused_ms,
    }


def sht_phase(gen, sht):
    """Kernel K3 (``RealSHT.forward_fused``) against ``forward_pair`` at a
    ragged transform and on the flagship's own transform ``sht``; both
    against a float64 evaluation; times of the kernel, its plain version,
    ``forward_pair`` and one three-operand einsum."""
    import torch

    from ace_tpu_torch.ops.fused_sht import fused_sht_plain
    from ace_tpu_torch.ops.sht import RealSHT

    def check(transform, x, label):
        err, scale = max_err(transform.forward_fused(x),
                             transform.forward_pair(x))
        tol = SHT_TOL * scale
        print(f"fused_sht {label}: max_abs_err {err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"fused_sht disagrees with forward_pair at "
                                 f"the {label} shape")
        return err, tol

    ragged = RealSHT(37, 72, device="cuda")
    check(ragged, torch.randn(2, 37, 72, 96, generator=gen, device="cuda"),
          "ragged [2,37,72,96]")
    from ace_tpu_torch import flagship

    shape = (1, sht.nlat, sht.nlon, flagship.EMBED)
    x = torch.randn(*shape, generator=gen, device="cuda")
    err, tol = check(sht, x, "flagship [1,180,360,512]")

    # accuracy against a float64 evaluation from the float64 tables
    fc, fs, w = (torch.as_tensor(t, device="cuda")
                 for t in sht.tables_float64())
    x64 = x.double()
    exact = [torch.einsum("bkmc,mlk->blmc",
                          torch.einsum("bkjc,jm->bkmc", x64, d), w)
             for d in (fc, fs)]
    err64 = {}
    for name, fn in (("kernel", sht.forward_fused),
                     ("forward_pair", sht.forward_pair)):
        e, scale64 = max_err(fn(x), exact)
        err64[name] = e / scale64
    del exact, x64
    print(f"fused_sht flagship vs float64: kernel {err64['kernel']:.3e}, "
          f"forward_pair {err64['forward_pair']:.3e} of the largest output "
          f"(the gate against forward_pair: {SHT_TOL:.0e})")

    table = sht.fused_table()
    dft = torch.stack((sht.fc, sht.fs), dim=1)  # [J, 2, M]
    ms = cuda_ms(lambda: sht.forward_fused(x), 20)
    plain_ms = cuda_ms(lambda: fused_sht_plain(x, sht.fc, sht.fs, table), 10)
    pair_ms = cuda_ms(lambda: sht.forward_pair(x), 10)
    # the same function as one library call (timed only, never used)
    library_ms = cuda_ms(
        lambda: torch.einsum("bkjc,jnm,klm->bnlmc", x, dft, table), 10)
    b, k, j, c = shape
    l, m = sht.lmax, sht.mmax
    n_bytes = (x.numel() + 2 * b * l * m * c
               + sht.fc.numel() + sht.fs.numel() + table.numel()) * 4
    # the work the function needs: a multiply-add for each nonzero column
    # of the DFT matrices (the sin column vanishes at m = 0 and at the
    # Nyquist mode), and for each (l, m) pair of the Legendre table that is
    # nonzero (l >= m: about half of the dense table)
    dft_cols = int((sht.fc != 0).any(0).sum() + (sht.fs != 0).any(0).sum())
    leg_pairs = int((table != 0).any(0).sum())
    flops = 2 * b * k * j * dft_cols * c + 4 * b * k * leg_pairs * c
    dense_flops = 4 * b * k * j * m * c + 4 * b * l * k * m * c
    # an f32-accurate result either in f32 outside the tensor cores or as
    # three TF32 products per product: the faster of the two bounds it
    f32_ms = flops / PEAK_F32_FLOPS * 1e3
    tf32_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3
    peak = PEAK_F32_FLOPS if f32_ms <= tf32_ms else PEAK_TF32_FLOPS / 3
    bound_ms, bound_by, bytes_ms, _ = bound(n_bytes, flops, peak)
    print(f"fused_sht flagship: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"forward_pair (the einsum path the rollout runs) {pair_ms:.4f} "
          f"ms, library (one three-operand f32 einsum) {library_ms:.4f} ms; "
          f"bound: {n_bytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms, "
          f"{flops / 1e9:.2f} GFLOP ({leg_pairs} nonzero (l, m) pairs, "
          f"{dft_cols} DFT columns; the dense count is "
          f"{dense_flops / 1e9:.2f} GFLOP) -> {f32_ms:.4f} ms in f32 at "
          f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s, {tf32_ms:.4f} ms as three "
          f"TF32 products at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s; "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    return {
        "name": "fused_sht", "route": "cuda",
        "source": "ace_tpu_torch/csrc/fused_sht.cu",
        "replaces": "ace_tpu/ops/pallas_sht.py:90",
        "launches": None, "max_abs_err": err, "tol": tol,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "forward_pair_ms": pair_ms,
        "f32_compute_ms": f32_ms, "split_tf32_compute_ms": tf32_ms,
        "rel_err_vs_float64": err64["kernel"],
        "forward_pair_rel_err_vs_float64": err64["forward_pair"],
    }


def reference_phase(fused):
    """A small bf16 flagship-shaped model on the card (through the
    kernels) against the same model on the CPU (plain versions), on the
    same weights and noise; ``fused`` sends the block tails through K2."""
    import torch

    from ace_tpu_torch.flagship import (
        CHECK_TOL,
        anomaly_error,
        build_stepper,
        draw_check_weights,
    )
    from ace_tpu_torch.ops.fused_block_tail import fused_block_tail

    kw = dict(nz=2, embed=128, layers=2, fused_block_tail=fused)
    cpu = build_stepper(16, 32, device="cpu", **kw)
    gpu = build_stepper(16, 32, device="cuda", **kw)
    gen = torch.Generator().manual_seed(3)
    # filters and conditioning drawn large enough to show in the outputs
    draw_check_weights(cpu, gen)
    gpu.load_state_dict(cpu.module.state_dict())
    n_in = cpu.module.in_chans
    x = torch.randn(2, 16, 32, n_in, generator=gen)
    noise = cpu.module.make_noise(2, gen)
    with torch.inference_mode():
        ref = cpu.module(x, noise=noise)
        before = fused_block_tail.launches
        out = gpu.module(x.cuda(), noise=noise.cuda()).cpu()
        tails = fused_block_tail.launches - before
    # per output channel, over the scale of its spatial anomaly
    err = anomaly_error(out, ref, (1, 2))
    label = "fused tail (K1, K2)" if fused else "unfused (K1)"
    print(f"reference {label}: bf16 model on the card vs the CPU, largest "
          f"error over the anomaly {err:.4g} (tol {CHECK_TOL}); K2 launches "
          f"{tails}")
    if not (torch.isfinite(out).all() and err <= CHECK_TOL):
        raise AssertionError("the model on the card disagrees with the CPU")
    if tails != (2 if fused else 0):
        raise AssertionError(f"the reference model launched K2 {tails} times")


def reference_train_phase(fused, counters):
    """One train step of a small bf16 flagship-shaped model on the card
    (K1, 1b, 1c; with ``fused`` K2 and its recomputed backward) against
    the same step on the CPU (plain versions), from the same weights,
    batch and noise: every parameter's gradient (under the smooth loss of
    ``flagship.train_gradients``, see ``flagship.TRAIN_GRAD_TOL``), then
    the loss and gradient norm of ``train_step`` itself."""
    import torch

    from ace_tpu_torch import flagship

    kw = dict(nz=2, embed=128, layers=2, fused_block_tail=fused)
    cpu = flagship.build_train_stepper(16, 32, device="cpu", **kw)
    gpu = flagship.build_train_stepper(16, 32, device="cuda", **kw)
    gen = torch.Generator().manual_seed(3)
    flagship.draw_check_weights(cpu.stepper, gen)
    gpu.stepper.load_state_dict(cpu.module.state_dict())
    batch = flagship.synthetic_batch(cpu.stepper, TRAIN_BATCH, generator=gen)
    noise = cpu.module.make_noise(2 * TRAIN_BATCH, gen)
    for ts in (cpu, gpu):
        flagship.fixed_noise(ts.stepper, noise)
    gpu_batch = {k: v.cuda() for k, v in batch.items()}
    ref_loss, ref_grads = flagship.train_gradients(cpu, batch, smooth=True)
    (loss, grads), launches = counted(
        counters, lambda: flagship.train_gradients(gpu, gpu_batch,
                                                   smooth=True))
    loss_err = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    errs = flagship.gradient_error(grads, ref_grads)
    worst = max(errs, key=errs.get)
    label = "fused tail" if fused else "unfused"
    print(f"reference T ({label}): smooth loss {float(loss):.6g} on the "
          f"card, {float(ref_loss):.6g} on the CPU (relative error "
          f"{loss_err:.3g}, tol {flagship.TRAIN_LOSS_TOL}); largest gradient error "
          f"{errs[worst]:.4g} relative L2 ({worst}; tol "
          f"{flagship.TRAIN_GRAD_TOL}) over {len(errs)} parameters; "
          f"launches {launches}")
    if not (loss_err <= flagship.TRAIN_LOSS_TOL
            and errs[worst] <= flagship.TRAIN_GRAD_TOL):
        raise AssertionError("the train step on the card disagrees with the "
                             "CPU")
    want = {"dhconv_filter": 4, "dhconv_filter_dx": 2, "dhconv_filter_dw": 2,
            "fused_block_tail": 4 if fused else 0, "fused_sht": 0}
    if launches != want:
        raise AssertionError(f"reference T: launches {launches}, want {want}")
    steps = [ts.train_step(b, None) for ts, b in ((cpu, batch),
                                                  (gpu, gpu_batch))]
    step_errs = {k: abs(float(steps[1][k]) - float(steps[0][k]))
                 / abs(float(steps[0][k])) for k in ("loss", "grad_norm")}
    print(f"reference T ({label}): train_step loss "
          f"{float(steps[1]['loss']):.6g} / {float(steps[0]['loss']):.6g}, "
          f"grad_norm {float(steps[1]['grad_norm']):.6g} / "
          f"{float(steps[0]['grad_norm']):.6g} (card / CPU); relative "
          f"errors {step_errs} (tol {flagship.TRAIN_LOSS_TOL} and "
          f"{flagship.TRAIN_NORM_TOL})")
    if not (step_errs["loss"] <= flagship.TRAIN_LOSS_TOL
            and step_errs["grad_norm"] <= flagship.TRAIN_NORM_TOL):
        raise AssertionError("reference T: train_step on the card disagrees "
                             "with the CPU")
    return errs[worst]


def build_flagship(fused):
    """The flagship stepper on the card, weights from seed 0."""
    import torch

    from ace_tpu_torch import flagship

    t0 = time.perf_counter()
    stepper = flagship.build_stepper(device="cuda", fused_block_tail=fused)
    stepper.init_params(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in stepper.module.parameters())
    print(f"flagship stepper (fused tail {fused}) built and initialized in "
          f"{time.perf_counter() - t0:.2f} s: {n_params} parameters, "
          f"{len(stepper.step.config.in_names)} inputs, "
          f"{len(stepper.out_names)} outputs")
    return stepper


def counted(counters, fn):
    """Run ``fn`` with every launch count set to 0 just before it; return
    its result and the counts read just after."""
    for c in counters:
        c.launches = 0
    result = fn()
    return result, {c.__name__: c.launches for c in counters}


def rollout(label, stepper, ic, forcing, counters, expected):
    """A timed ``N_STEPS`` rollout with its checks; returns steps/s and
    the launches counted in it."""
    import torch

    # first call (one step) timed apart: it prepares the kernel-layout
    # weights and warms the library handles
    t0 = time.perf_counter()
    stepper.predict(ic, {k: v[:, :2] for k, v in forcing.items()})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()

    def run():
        t0 = time.perf_counter()
        # the rollout must never wait for the device: any synchronizing
        # operation inside it raises
        torch.cuda.set_sync_debug_mode("error")
        try:
            outputs, _ = stepper.predict(ic, forcing)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return outputs, time.perf_counter() - t0

    (outputs, rollout_s), launches = counted(counters, run)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps_per_s = N_STEPS / rollout_s
    print(f"path {label}: first call (1 step) {first_s:.3f} s; {N_STEPS}-step "
          f"rollout {rollout_s:.3f} s = {steps_per_s:.3f} steps/s at batch 1; "
          f"peak device memory {peak_gb:.2f} GB; launches {launches}")

    for name in stepper.out_names:
        v = outputs[name]
        if (v.shape != (1, N_STEPS, *stepper.dataset_info.img_shape)
                or not torch.isfinite(v).all()):
            raise AssertionError(f"path {label} output {name}: shape "
                                 f"{tuple(v.shape)} or non-finite values")
    # the prescribed SST holds where the next step's ocean fraction is 1
    ocean = torch.round(forcing["ocean_fraction"][:, 1:]) == 1
    sst = outputs["surface_temperature"]
    if not torch.equal(sst[ocean], forcing["surface_temperature"][:, 1:][ocean]):
        raise AssertionError(f"path {label}: the prescribed SST does not hold")
    # the corrector pins the global dry-air mass to the initial condition's
    corrector = stepper.step.corrector
    target = corrector.init_state({k: v[:, 0] for k, v in ic.data.items()})
    drift = max(
        float((corrector.init_state({k: v[:, t] for k, v in outputs.items()})
               ["global_dry_air_mass"] - target["global_dry_air_mass"])
              .abs().max())
        for t in range(N_STEPS)
    )
    print(f"path {label}: dry-air mass drift over the rollout {drift:.4f} Pa")
    if not drift < 1.0:
        raise AssertionError(f"path {label}: the dry-air mass is not conserved")
    if launches != expected:
        raise AssertionError(f"path {label}: kernel launches {launches}, "
                             f"want {expected}")
    return steps_per_s, launches


def build_train_flagship(fused):
    """The flagship train stepper on the card, weights from seed 0."""
    import torch

    from ace_tpu_torch import flagship

    t0 = time.perf_counter()
    ts = flagship.build_train_stepper(device="cuda", fused_block_tail=fused)
    ts.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in ts.parameters())
    print(f"flagship train stepper (fused tail {fused}) built and "
          f"initialized in {time.perf_counter() - t0:.2f} s: {n_params} "
          f"parameters, checkpointing {ts.module.checkpointing}")
    return ts


def noise_generator():
    """The generator each train step draws its noise from, seeded the same
    for every step."""
    import torch

    return torch.Generator("cuda").manual_seed(2)


def train_path(ts, batch, counters, expected):
    """Path T: a warm-up train step, then ``TRAIN_STEPS`` timed steps on
    the same batch and noise, with no synchronizing operation inside them;
    returns the warm-up step's metrics, the rate and the launches."""
    import torch

    t0 = time.perf_counter()
    first = ts.train_step(batch, noise_generator())
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    def run():
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            metrics = [ts.train_step(batch, noise_generator())
                       for _ in range(TRAIN_STEPS)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return metrics, time.perf_counter() - t0

    (metrics, train_s), launches = counted(counters, run)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    after = ts.valid_step(batch, noise_generator())["loss"]
    losses = [float(m["loss"]) for m in metrics] + [float(after)]
    norms = [float(m["grad_norm"]) for m in metrics]
    rate = TRAIN_STEPS / train_s
    print(f"path T: first step {first_s:.3f} s (loss "
          f"{float(first['loss']):.6g}, grad_norm "
          f"{float(first['grad_norm']):.6g}); {TRAIN_STEPS} steps "
          f"{train_s:.3f} s = {rate:.4f} steps/s = "
          f"{rate * TRAIN_BATCH:.4f} samples/s at batch {TRAIN_BATCH} (x2 "
          f"ensemble members); peak device memory {peak_gb:.2f} GB; "
          f"launches {launches}")
    print(f"path T: losses {[round(v, 6) for v in losses]} (the last after "
          f"the {TRAIN_STEPS} updates), grad_norms "
          f"{[round(v, 6) for v in norms]}")
    if not all(map(math.isfinite, losses + norms)):
        raise AssertionError("path T: a loss or gradient norm is not finite")
    # against the warm-up step's loss, taken before any update (the first
    # update raises it: tests/test_torch_train.py shows ace_tpu's does too)
    if not losses[-1] < float(first["loss"]):
        raise AssertionError(f"path T: the loss after {TRAIN_STEPS + 1} "
                             f"updates on a fixed batch is not below the "
                             f"loss before them")
    want = {k: v * TRAIN_STEPS for k, v in expected.items()}
    if launches != want:
        raise AssertionError(f"path T: launches {launches}, want {want}")
    return first, rate, launches


def first_steps_agree(path0, path_a, ic, forcing):
    """Path A's first step against path 0's, from the same weights, state
    and noise (both draw it from the default seed). The weights of both
    are drawn with ``flagship.draw_check_weights``: at the default draw the
    outputs' spatial anomalies are about one bf16 ulp of their values, so
    no comparison could tell a right tail from a wrong one there."""
    import torch

    from ace_tpu_torch.flagship import (
        CHECK_TOL,
        anomaly_error,
        draw_check_weights,
    )

    draw_check_weights(path0, torch.Generator("cuda").manual_seed(5))
    path_a.load_state_dict(path0.module.state_dict())
    window = {k: v[:, :2] for k, v in forcing.items()}
    ref, _ = path0.predict(ic, window)
    out, _ = path_a.predict(ic, window)
    errs = {k: anomaly_error(out[k], ref[k], (-2, -1)) for k in ref}
    worst = max(errs, key=errs.get)
    print(f"path A first step vs path 0: largest error over the anomaly "
          f"{errs[worst]:.4g} ({worst}; tol {CHECK_TOL})")
    if not errs[worst] <= CHECK_TOL:
        raise AssertionError("path A's first step disagrees with path 0's")


class _H5Dim:
    """A dimension of an in-memory dataset: its label and its scales."""

    def __init__(self):
        self.label, self._scales = "", []

    def attach_scale(self, scale):
        self._scales.append(scale)

    def __len__(self):
        return len(self._scales)

    def __getitem__(self, i):
        return self._scales[i]


class _H5Dataset:
    """An array with the part of ``h5py.Dataset`` that the port uses."""

    def __init__(self, name, data=None, shape=None, dtype=None, **_):
        import numpy as np

        self.name = "/" + name
        self.array = (np.array(data) if data is not None
                      else np.zeros(shape, dtype))
        self.attrs = {}
        self.dims = [_H5Dim() for _ in self.array.shape]

    @property
    def shape(self):
        return self.array.shape

    @property
    def dtype(self):
        return self.array.dtype

    def make_scale(self, name=""):
        pass

    def resize(self, size, axis):
        import numpy as np

        shape = list(self.array.shape)
        n = min(size, shape[axis])
        shape[axis] = size
        grown = np.zeros(shape, self.array.dtype)
        keep = (slice(None),) * axis + (slice(0, n),)
        grown[keep] = self.array[keep]
        self.array = grown

    def __getitem__(self, key):
        import numpy as np

        return np.array(self.array[key])

    def __setitem__(self, key, value):
        self.array[key] = value


class _H5File:
    """``h5py.File`` kept in host memory: a file opened to write is an empty
    file on the disk (so that directories list it) and its datasets and
    attributes in ``files``, from which it is opened to read."""

    files: dict = {}

    def __init__(self, path, mode="r"):
        import os

        path = os.path.abspath(path)
        if mode == "w":
            open(path, "w").close()
            self.files[path] = ({}, {})
        elif path not in self.files:
            raise FileNotFoundError(path)
        self._datasets, self.attrs = self.files[path]

    def create_dataset(self, name, **kwargs):
        self._datasets[name] = _H5Dataset(name, **kwargs)
        return self._datasets[name]

    def __getitem__(self, name):
        return self._datasets[name]

    def items(self):
        return self._datasets.items()

    def keys(self):
        return self._datasets.keys()

    def flush(self):
        pass

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def h5py_in_memory():
    """A context in which ``import h5py`` gives ``_H5File`` in place of the
    package (path I where h5py is missing): the entry runs whole, and its
    netCDF files are held in host memory instead of written."""
    import contextlib
    import types

    @contextlib.contextmanager
    def context():
        module = types.ModuleType("h5py")
        module.File = _H5File
        saved = sys.modules.get("h5py")
        sys.modules["h5py"] = module
        try:
            yield
        finally:
            _H5File.files.clear()
            if saved is None:
                del sys.modules["h5py"]
            else:
                sys.modules["h5py"] = saved

    return context()


def inference_packages():
    """The versions of the packages that the inference entry's files
    (h5py) and config (PyYAML) and the checkpoint (msgpack) need, and the
    names of those missing."""
    import importlib.metadata
    import importlib.util

    present, missing = {}, []
    for module, dist in (("h5py", "h5py"), ("msgpack", "msgpack"),
                         ("yaml", "PyYAML")):
        if importlib.util.find_spec(module) is None:
            missing.append(dist)
        else:
            present[dist] = importlib.metadata.version(dist)
    return present, missing


def no_sync_in_run_inference(module=None, event_waits=None):
    """A context in which the entry's call of ``run_inference`` (the
    inference entry's, or ``module``'s) raises at any synchronizing call,
    from its start to the one ``torch.cuda.synchronize`` that stops its
    clock (the only exemption). With a list ``event_waits``, each wait on
    a CUDA event (the histograms' wait on the pinned copies of the window
    before) is allowed too, and recorded in the list."""
    import contextlib

    import torch

    if module is None:
        from ace_tpu_torch.inference import inference as module

    run_inference, synchronize = module.run_inference, torch.cuda.synchronize
    event_sync = torch.cuda.Event.synchronize

    def exempt(device=None):
        torch.cuda.set_sync_debug_mode("default")
        synchronize(device)

    def event_wait(self):
        torch.cuda.set_sync_debug_mode("default")
        try:
            event_sync(self)
        finally:
            torch.cuda.set_sync_debug_mode("error")
        event_waits.append(time.perf_counter())

    def checked(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        torch.cuda.synchronize = exempt
        if event_waits is not None:
            torch.cuda.Event.synchronize = event_wait
        try:
            return run_inference(*args, **kwargs)
        finally:
            torch.cuda.synchronize = synchronize
            torch.cuda.Event.synchronize = event_sync
            torch.cuda.set_sync_debug_mode("default")

    @contextlib.contextmanager
    def context():
        module.run_inference = checked
        try:
            yield
        finally:
            module.run_inference = run_inference

    return context()


def _timed_run(counters, fn, check_sync):
    """``fn()`` with the launch counts set to 0 just before it, the
    timers and the peak memory reset, and (``check_sync``) no
    synchronizing call allowed in ``run_inference``; returns its result,
    the counts, the timer phases and the peak memory in GB."""
    import contextlib

    import torch

    from ace_tpu_torch.core.timing import GlobalTimer

    GlobalTimer.reset()
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    guard = (no_sync_in_run_inference() if check_sync
             else contextlib.nullcontext())
    with guard:
        result, launches = counted(counters, fn)
    phases = GlobalTimer.get_instance().get_durations()
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    return result, launches, phases, peak


def _write_files(tmp, series, time, info):
    """The series as one netCDF file with the grid and the vertical
    coordinate, as the data layer reads them."""
    import os

    import numpy as np

    from ace_tpu_torch.data.store import write_h5

    data_dir = os.path.join(tmp, "data")
    os.makedirs(data_dir)
    data = dict(series)
    dims = {k: ("time", "lat", "lon") for k in series}
    vc = info.vertical_coordinate
    for i, (a, b) in enumerate(zip(vc.ak, vc.bk)):
        data[f"ak_{i}"], data[f"bk_{i}"] = np.float32(a), np.float32(b)
        dims[f"ak_{i}"] = dims[f"bk_{i}"] = ()
    grid = info.horizontal_coordinates
    write_h5(os.path.join(data_dir, "data.nc"), data, dims,
             coords={"lat": grid.lat, "lon": grid.lon}, time=time)
    return data_dir


def _entry_from_files(tmp, ckpt, series, time, info, counters, device,
                      n_steps, in_memory, check_sync, data_dir=None,
                      starts=(0, 1), label="path I", initial_condition=None):
    """Path I through ``main`` on a YAML: netCDF forcing in (``series``
    written to a file, or the files under ``data_dir``), predictions from
    ``starts`` (or from the ``initial_condition`` section, a file's
    path and its ``start_indices``), restart.nc and diagnostics out.
    Returns the writer-off run's summary, launches, phases and peak, and
    the written predictions."""
    import os

    import numpy as np
    import yaml

    from ace_tpu_torch.data.store import open_file_dataset
    from ace_tpu_torch.inference.inference import main as inference_main

    if data_dir is None:
        data_dir = _write_files(tmp, series, time, info)
    runs = {}
    for save in (False, True):
        out_dir = os.path.join(tmp, f"inference_{save}")
        config = {
            "experiment_dir": out_dir, "checkpoint_path": ckpt,
            "n_forward_steps": n_steps, "forward_steps_in_memory": in_memory,
            "logging": {"log_to_screen": False, "log_to_file": True},
            "forcing_loader": {"dataset": {"data_path": data_dir},
                               "start_indices": {"list": list(starts)}},
            "data_writer": {"save_prediction_files": save},
        }
        if initial_condition is not None:
            config["initial_condition"] = initial_condition
        path = os.path.join(tmp, f"inference_{save}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(config, f)
        runs[save] = _timed_run(
            counters, lambda: inference_main([path], device=device),
            check_sync and not save)
        names = ["restart.nc"] + [os.path.join("diagnostics", n) for n in
                                  os.listdir(os.path.join(out_dir,
                                                          "diagnostics"))]
        for name in names:
            ds = open_file_dataset(os.path.join(out_dir, name))
            for k in ds.keys():
                if not np.isfinite(ds[k].read(())).all():
                    raise AssertionError(f"{label}: {name} {k} not finite")
        print(f"{label} (writer {save}): {len(names)} files finite: "
              f"{sorted(names)}")
    ds = open_file_dataset(os.path.join(
        tmp, "inference_True", "autoregressive_predictions.nc"))
    written = {k: ds[k].read(()) for k in ds.keys()}
    return runs, written


def _check_written(label, stepper, series, written, starts, n_steps):
    """The written predictions against one ``Stepper.predict`` of the same
    initial conditions (``series`` at ``starts``), forcing and seed: each
    variable's largest error over its spatial std, and the dry-air mass's
    largest drift from the initial condition's in Pa (None for a step
    without a corrector)."""
    import numpy as np
    import torch

    from ace_tpu_torch.stepper.stepper import PrognosticState

    ic = {k: torch.as_tensor(np.stack([series[k][s:s + 1] for s in starts]))
          .to(stepper.device) for k in stepper.prognostic_names}
    forcing = {k: torch.as_tensor(np.stack(
        [series[k][s:s + n_steps + 1] for s in starts])).to(stepper.device)
        for k in stepper.forcing_window_names}
    ref, _ = stepper.predict(PrognosticState(data=ic), forcing,
                             generator=torch.Generator(
                                 stepper.device).manual_seed(0))
    errs = {}
    for k in stepper.out_names:
        r = ref[k].float()
        out = torch.as_tensor(written[k]).to(r.device)
        if out.shape != r.shape:
            raise AssertionError(f"{label}: {k} written as "
                                 f"{tuple(out.shape)}")
        err = float((out - r).abs().max())
        errs[k] = err / float(r.std(dim=(-2, -1)).mean()) if err else 0.0
    worst = max(errs, key=errs.get)
    corrector = stepper.step.corrector
    if corrector is None:  # no dry-air target (FCN3's recipe)
        return errs, worst, None
    target = corrector.init_state({k: v[:, 0] for k, v in ic.items()})
    drift = max(
        float((corrector.init_state({
            k: torch.as_tensor(written[k][:, t]).to(stepper.device)
            for k in stepper.out_names})["global_dry_air_mass"]
            - target["global_dry_air_mass"]).abs().max())
        for t in range(n_steps))
    return errs, worst, drift


def inference_path(counters, device="cuda", sizes=None, n_steps=N_STEPS,
                   in_memory=5, n_times=22, keep_checkpoint=None):
    """Path I: the inference entry on the flagship stepper (weights drawn
    from seed 0 by ``flagship.draw_check_weights``, written with
    ``save_stepper`` and loaded back), over
    ``n_times`` times of the flagship's 47 variables, ``n_steps`` steps
    from start indices [0, 1] in windows of ``in_memory``. Runs ``main``
    on YAML configs and netCDF files; where h5py is missing, the files are
    held in host memory (``h5py_in_memory``). Checks that restart.nc and
    the diagnostics files are finite, the writer-off run's launches and
    (on the card) that its ``run_inference`` never waits for the device
    before its clock stops, the written predictions against one
    ``Stepper.predict`` of the same initial condition, forcing and seed,
    and the dry-air mass. ``keep_checkpoint`` (a path) keeps a copy of the
    checkpoint for path E. Returns the writer-off run's launches, rate,
    phases and peak."""
    import contextlib
    import os
    import tempfile

    import numpy as np
    import torch

    from ace_tpu_torch import flagship
    from ace_tpu_torch.data.time import TimeCoord
    from ace_tpu_torch.stepper import checkpoint

    present, missing = inference_packages()
    print(f"path I: packages {present}")
    for dist in missing:
        print(f"path I: missing package {dist}")
    if "msgpack" in missing or "PyYAML" in missing:
        raise AssertionError("path I: the entry reads its checkpoint with "
                             "msgpack and its config with PyYAML")
    check_sync = torch.device(device).type == "cuda"
    config, info = flagship.stepper_config(**(sizes or {}))
    built = config.get_stepper(info, device=device)
    # drawn so that the outputs have spatial structure to compare
    flagship.draw_check_weights(built, torch.Generator(device).manual_seed(0))
    series = flagship.synthetic_series(
        built, n_times, generator=torch.Generator(device).manual_seed(3))
    time = TimeCoord.from_range("2000-01-01T00:00", n_times, 21600)
    files = contextlib.nullcontext()
    if "h5py" in missing:
        print("path I: the entry's netCDF files are held in host memory "
              "(h5py_in_memory), not written to the disk")
        files = h5py_in_memory()
    with tempfile.TemporaryDirectory() as tmp, files:
        ckpt = os.path.join(tmp, "flagship.msgpack")
        checkpoint.save_stepper(ckpt, built, config)
        if keep_checkpoint is not None:
            checkpoint.save_stepper(keep_checkpoint, built, config)
        del built  # the entry's peak memory holds its own stepper alone
        runs, written = _entry_from_files(
            tmp, ckpt, series, time, info, counters, device, n_steps,
            in_memory, check_sync)
        stepper = checkpoint.load_stepper(ckpt, device=device)

    errs, worst, drift = _check_written("path I", stepper, series, written,
                                        [0, 1], n_steps)
    (summary, launches, phases, peak) = runs[False]
    rate_on = runs[True][0]["total_steps_per_second"]
    print(f"path I: written predictions vs one {n_steps}-step predict: "
          f"largest error {errs[worst]:.3g} of the channel's spatial std "
          f"({worst}; tol 1e-5); dry-air mass drift {drift:.4f} Pa")
    print(f"path I (writer off): {summary['total_steps']} steps at "
          f"{summary['total_steps_per_second']:.4f} steps/s (batch 2, "
          f"windows of {in_memory}); phases "
          f"{ {k: round(v, 4) for k, v in sorted(phases.items())} }; peak "
          f"device memory {peak:.2f} GB; launches {launches}")
    print(f"path I (writer on): {rate_on:.4f} steps/s; phases "
          f"{ {k: round(v, 4) for k, v in sorted(runs[True][2].items())} }")
    if not errs[worst] <= 1e-5:
        raise AssertionError("path I: the written predictions disagree "
                             "with Stepper.predict")
    if not drift < 1.0:
        raise AssertionError("path I: the dry-air mass is not conserved")
    return launches, summary["total_steps_per_second"], phases, peak


# path R: the training entry on the repo's ACE2-ERA5 training config
TRAIN_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "configs", "ace2-era5-train.yaml")
# the synthetic data of path R: 9 training times (8 windows of 2, so 4
# batches of 2) and 5 validation times (2 batches)
R_TRAIN_TIMES, R_VALID_TIMES, R_BATCH = 9, 5, 2
R_INFERENCE_STEPS = 4
# reference R: the largest relative L2 error, card against CPU, of a
# tensor's change from the initial weights over the epoch. Read on an
# H100 (tests/test_torch_cuda.py, reference R with planted faults):
# 0.028 sound; 0.73 with 1c's upper modes zeroed, 1.0 without the EMA
# update, 2.2 with half of each batch
R_CHANGE_TOL = 0.1


def _field_scale(name):
    """(mean, std, positive) of the synthetic draw of a variable: values
    near the atmosphere's, so that the corrector's energy and moisture
    terms stay finite."""
    prefix, _, suffix = name.rpartition("_")
    level = int(suffix) if prefix and suffix.isdigit() else 0
    table = {
        "air_temperature": (210.0 + 10.0 * level, 5.0, False),
        "specific_total_water": (0.0, 1e-3 * (level + 1), True),
        "eastward_wind": (0.0, 10.0, False),
        "northward_wind": (0.0, 10.0, False),
        "PRESsfc": (1.0e5, 100.0, False),
        "surface_temperature": (285.0, 10.0, False),
        "h500": (5500.0, 50.0, False),
        "DSWRFtoa": (340.0, 50.0, False),
        "HGTsfc": (0.0, 500.0, True),
        "LHTFLsfc": (80.0, 20.0, False),
        "SHTFLsfc": (20.0, 10.0, False),
        "PRATEsfc": (0.0, 3e-5, True),
        "ULWRFsfc": (390.0, 10.0, False),
        "ULWRFtoa": (240.0, 10.0, False),
        "DLWRFsfc": (340.0, 10.0, False),
        "DSWRFsfc": (180.0, 30.0, False),
        "USWRFsfc": (20.0, 5.0, False),
        "USWRFtoa": (100.0, 10.0, False),
        "total_frozen_precipitation_rate": (0.0, 1e-6, True),
        "TMP2m": (285.0, 10.0, False),
        "TMP850": (270.0, 10.0, False),
        "Q2m": (0.0, 5e-3, True),
        "UGRD10m": (0.0, 5.0, False),
        "VGRD10m": (0.0, 5.0, False),
        "eastward_surface_wind_stress": (0.0, 0.1, False),
        "northward_surface_wind_stress": (0.0, 0.1, False),
    }
    for prefix, value in table.items():
        if name == prefix or name.startswith(prefix + "_"):
            return value
    return 0.0, 1e-4, False


# the slab ocean's forcing, drawn uniform in these ranges: positive
# mixed-layer depths of a realistic size (a depth near zero makes the slab
# tendency blow up) and q-fluxes of order 100 W/m2
SLAB_DRAWS = {"prescribed_mixed_layer_depth": (10.0, 200.0),
              "prescribed_qflux": (-100.0, 100.0)}


def _draw(name, shape, generator, device):
    """A synthetic field of variable ``name``: ``_field_scale``'s normal
    draw, a fraction in [0, 1] for the ocean fraction, or uniform in
    ``SLAB_DRAWS``' range."""
    import torch

    if name in SLAB_DRAWS:
        low, high = SLAB_DRAWS[name]
        return low + (high - low) * torch.rand(shape, generator=generator,
                                               device=device)
    mean, std, positive = _field_scale(name)
    v = torch.randn(shape, generator=generator, device=device)
    if name == "ocean_fraction":
        return v.abs().clamp(0, 1)
    return (v.abs() if positive else v) * std + mean


R_SPLITS = (("train", R_TRAIN_TIMES, "2000-01-01T00:00"),
            ("valid", R_VALID_TIMES, "2001-01-01T00:00"))


def _training_files(tmp, names, nlat, nlon, generator, device,
                    splits=R_SPLITS, absent=()):
    """The netCDF files of ``names`` (with the vertical coordinate), one
    directory per split of ``splits`` (name, number of 6-hourly times,
    first time), and the three stats files the shipped config reads
    (from the first split), drawn from ``generator`` on ``device``;
    the variables of ``absent`` are drawn for the stats but left out of
    the data files. Returns their paths."""
    import numpy as np

    from ace_tpu_torch.core.coordinates import gaussian_latitudes
    from ace_tpu_torch.data.store import write_h5
    from ace_tpu_torch.data.time import TimeCoord

    nz = 8
    ak = np.concatenate([np.linspace(100.0, 5000.0, nz // 2),
                         np.linspace(5000.0, 0.0, nz // 2 + 1)])
    bk = np.linspace(0.0, 1.0, nz + 1)
    coords = {"lat": gaussian_latitudes(nlat),
              "lon": np.linspace(0, 360, nlon, endpoint=False)}
    paths, series = {}, {}
    for split, n, start in splits:
        data = {}
        for name in names:
            data[name] = _draw(name, (n, nlat, nlon), generator,
                               device).cpu().numpy()
        series[split] = dict(data)
        for name in absent:
            del data[name]
        dims = {k: ("time", "lat", "lon") for k in data}
        for i, (a, b) in enumerate(zip(ak, bk)):
            data[f"ak_{i}"], data[f"bk_{i}"] = np.float32(a), np.float32(b)
            dims[f"ak_{i}"] = dims[f"bk_{i}"] = ()
        paths[split] = os.path.join(tmp, split)
        os.makedirs(paths[split])
        write_h5(os.path.join(paths[split], "data.nc"), data, dims,
                 coords=coords,
                 time=TimeCoord.from_range(start, n, 21600))
    train = series[splits[0][0]]
    stats = {
        "centering": {k: np.float32(v.mean()) for k, v in train.items()},
        "scaling-full-field": {k: np.float32(v.std())
                               for k, v in train.items()},
        "scaling-residual": {k: np.float32(np.diff(v, axis=0).std())
                             for k, v in train.items()},
    }
    for label, values in stats.items():
        paths[label] = os.path.join(tmp, f"{label}.nc")
        write_h5(paths[label], {k: np.asarray(v) for k, v in values.items()},
                 {k: () for k in values})
    return paths


def _train_config(paths, experiment_dir, embed=None, layers=None,
                  inference=True, loss=None):
    """The shipped training config with path R's cuts: the synthetic
    files, batch 2, the builder's per-block recompute, one epoch, a
    temporary experiment directory and one inline-inference entry;
    ``embed``, ``layers`` and ``loss`` make the small copies the CPU runs."""
    import yaml

    with open(TRAIN_CONFIG) as f:
        config = yaml.safe_load(f)
    config["experiment_dir"] = experiment_dir
    config["max_epochs"] = 1
    config["logging"]["log_to_screen"] = False
    for loader, split in (("train_loader", "train"),
                          ("validation_loader", "valid")):
        config[loader]["dataset"]["data_path"] = paths[split]
        config[loader]["batch_size"] = R_BATCH
    step = config["stepper"]["step"]["config"]
    builder = step["builder"]["config"]
    builder["checkpointing"] = 1
    if embed is not None:
        builder["embed_dim"], builder["num_layers"] = embed, layers
    norm = step["normalization"]
    norm["network"] = {"global_means_path": paths["centering"],
                       "global_stds_path": paths["scaling-full-field"]}
    norm["residual"] = {"global_means_path": paths["centering"],
                        "global_stds_path": paths["scaling-residual"]}
    if loss is not None:
        config["stepper_training"]["loss"] = loss
    if inference:
        config["inference"] = {
            "loader": {"dataset": {"data_path": paths["train"]},
                       "start_indices": {"list": [0, 1]}},
            "n_forward_steps": R_INFERENCE_STEPS,
        }
    return config, builder["num_layers"]


def _write_yaml(path, config):
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def _state_checksums(trainer):
    """``_tensor_checksums`` of the trainer's weights, Adam moments and
    EMA, with the update count and the batches seen."""
    ts = trainer.train_stepper
    opt = ts.optimization
    tensors = {}
    for label, group in (("param", ts.parameters()), ("mu", opt.mu),
                         ("nu", opt.nu), ("ema", ts.ema.ema_params)):
        for name, t in zip(ts.parameter_names(), group):
            tensors[f"{label}/{name}"] = t
    out = _tensor_checksums(tensors)
    out["count"] = opt.count
    out["num_batches_seen"] = trainer.num_batches_seen
    return out


def _record_checkpoints(records, before_first_write):
    """A context in which the trainer's checkpoint writes and reads are
    timed into ``records`` (kind, file, seconds, bytes);
    ``before_first_write(stepper, kwargs)`` runs before the first write
    with the writer's keyword arguments."""
    import contextlib

    from ace_tpu_torch.train import trainer as trainer_module

    save, read = (trainer_module.save_train_checkpoint,
                  trainer_module.read_train_checkpoint)

    def timed_save(path, stepper, *args, **kwargs):
        if not records:
            before_first_write(stepper, kwargs)
        t0 = time.perf_counter()
        save(path, stepper, *args, **kwargs)
        records.append(("write", os.path.basename(path),
                        time.perf_counter() - t0, os.path.getsize(path)))

    def timed_read(path):
        t0 = time.perf_counter()
        out = read(path)
        records.append(("read", os.path.basename(path),
                        time.perf_counter() - t0, os.path.getsize(path)))
        return out

    @contextlib.contextmanager
    def context():
        trainer_module.save_train_checkpoint = timed_save
        trainer_module.read_train_checkpoint = timed_read
        try:
            yield
        finally:
            trainer_module.save_train_checkpoint = save
            trainer_module.read_train_checkpoint = read

    return context()


def _phase_probes(counters, launches, rates, check_sync, restored,
                  trainer_cls=None,
                  phases=("_train_batches", "validate", "inference_one_epoch")):
    """A context that wraps a trainer's phases (``trainer_cls``, the
    training entry's ``Trainer`` by default): the launches of each call of
    each of ``phases`` into ``launches`` (by phase), the batch loop's
    (``_train_batches``, which returns its batch count second) steps/s
    (host clock, ending in a synchronize) into ``rates``, no synchronizing
    call allowed inside the batch loop (``check_sync``), and (unless
    ``restored`` is None) the state checksums just after ``restore`` into
    ``restored``."""
    import contextlib

    import torch

    if trainer_cls is None:
        from ace_tpu_torch.train.trainer import Trainer as trainer_cls

    hooked = phases if restored is None else (*phases, "restore")
    originals = {name: getattr(trainer_cls, name) for name in hooked}

    def counted_phase(name):
        def wrapped(self, *args, **kwargs):
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            if name == "_train_batches" and check_sync:
                torch.cuda.set_sync_debug_mode("error")
            try:
                result = originals[name](self, *args, **kwargs)
            finally:
                if check_sync:
                    torch.cuda.set_sync_debug_mode("default")
            if name == "_train_batches":
                if check_sync:
                    torch.cuda.synchronize()
                rates.append(result[1] / (time.perf_counter() - t0))
            launches.setdefault(name, []).append(
                {c.__name__: c.launches for c in counters})
            return result
        return wrapped

    def restore(self, path):
        originals["restore"](self, path)
        restored.update(_state_checksums(self))

    @contextlib.contextmanager
    def context():
        for name in phases:
            setattr(trainer_cls, name, counted_phase(name))
        if restored is not None:
            trainer_cls.restore = restore
        try:
            yield
        finally:
            for name, fn in originals.items():
                setattr(trainer_cls, name, fn)

    return context()


def _tensor_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _check_room(tmp, ckpt_bytes, weight_bytes, cuda):
    """Fail loudly unless the disk under ``tmp`` and the host memory can
    hold path R's checkpoints: ``ckpt.msgpack`` (``ckpt_bytes``: the
    weights, both Adam moments and the EMA, each in its own dtype) twice
    while it is replaced, and the best, EMA and best-inference files
    (``weight_bytes`` each); msgpack holds one leaf at a time, the reader
    a whole file and its arrays. Returns the free disk space in bytes."""
    import shutil

    free = shutil.disk_usage(tmp).free
    need_disk = 2 * ckpt_bytes + 3 * weight_bytes
    with open("/proc/meminfo") as f:
        meminfo = dict(line.split(":", 1) for line in f)
    available = int(meminfo["MemAvailable"].split()[0]) * 1024
    need_host = 3 * ckpt_bytes
    print(f"path R: free disk {free / 1e9:.2f} GB under the experiment "
          f"directory (needs {need_disk / 1e9:.2f}), available host memory "
          f"{available / 1e9:.2f} GB (needs {need_host / 1e9:.2f}) before "
          f"the first write")
    if free < need_disk or (cuda and available < need_host):
        raise AssertionError("path R: the disk or the host memory cannot "
                             "hold the training checkpoints")
    return free


def _bare_step_rate(trainer, n_steps=4):
    """``train_step`` alone on one batch of the trainer's loader, after a
    warm-up step: path R's config without the loader and the loop (host
    clock, ending in a synchronize). It trains the trainer on, so it
    comes after every gate of the run."""
    import torch

    batch = next(iter(trainer.train_data)).data
    ts = trainer.train_stepper
    ts.train_step(batch, trainer.generator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        ts.train_step(batch, trainer.generator)
    torch.cuda.synchronize()
    return n_steps / (time.perf_counter() - t0)


def _finite_metrics(path, n_epochs, label="path R",
                    required=("train/loss", "val/loss",
                              "inference/inference_error")):
    """``metrics.jsonl``'s lines: one per epoch, every value finite, the
    ``required`` metrics present."""
    import json

    with open(path) as f:
        lines = [json.loads(line) for line in f]
    if len(lines) != n_epochs:
        raise AssertionError(f"{label}: metrics.jsonl has {len(lines)} "
                             f"lines after {n_epochs} epochs")
    bad = [k for line in lines for k, v in line.items()
           if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{label}: metrics not finite: {bad[:10]}")
    keys = set(lines[-1])
    for prefix in required:
        if prefix not in keys:
            raise AssertionError(f"{label}: no {prefix} in metrics.jsonl")
    return lines


def train_entry_path(counters, device="cuda", sizes=None, path_t_rate=None,
                     then=None):
    """Path R: ``python -m ace_tpu_torch.train``'s ``main`` on the shipped
    ``configs/ace2-era5-train.yaml`` with the cuts of ``_train_config``
    (at its full width unless ``sizes`` gives ``nlat``, ``nlon``,
    ``embed`` and ``layers``) over synthetic files: one epoch, then
    ``--override max_epochs=2``, which must resume at epoch 1 from
    ``ckpt.msgpack`` with its state bit for bit. Checks finite metrics,
    one metrics.jsonl line per epoch, the four checkpoint files, the
    launches of each phase, and (on the card) that the batch loop never
    waits for the device; prints the rates, phases, checkpoint bytes and
    seconds and the peak memory. ``then(paths, best_checkpoint)`` runs
    after the gates, inside the context that holds the run's files (its
    stats files are named in the checkpoint's config), with every
    checkpoint file but ``best_ckpt.msgpack`` deleted. Returns the
    launches of both runs."""
    import contextlib
    import tempfile

    import torch
    import yaml

    from ace_tpu_torch.core.timing import GlobalTimer
    from ace_tpu_torch.stepper.checkpoint import load_msgpack
    from ace_tpu_torch.train.train import main as train_main

    sizes = sizes or {}
    nlat, nlon = sizes.get("nlat", 180), sizes.get("nlon", 360)
    cuda = torch.device(device).type == "cuda"
    _, missing = inference_packages()
    files = contextlib.nullcontext()
    if "h5py" in missing:
        print("path R: the training files are held in host memory "
              "(h5py_in_memory); the checkpoints go to the disk")
        files = h5py_in_memory()
    with tempfile.TemporaryDirectory() as tmp, files:
        with open(TRAIN_CONFIG) as f:
            step = yaml.safe_load(f)["stepper"]["step"]["config"]
        names = sorted(set(step["in_names"]) | set(step["out_names"]))
        paths = _training_files(tmp, names, nlat, nlon,
                                torch.Generator(device).manual_seed(7),
                                device)
        out_dir = os.path.join(tmp, "experiment")
        config, layers = _train_config(paths, out_dir, sizes.get("embed"),
                                       sizes.get("layers"))
        path = _write_yaml(os.path.join(tmp, "train.yaml"), config)
        builder = config["stepper"]["step"]["config"]["builder"]["config"]
        print(f"path R: {len(names)} variables at {nlat}x{nlon}, "
              f"{R_TRAIN_TIMES} training and {R_VALID_TIMES} validation "
              f"times; {TRAIN_CONFIG} with the cuts of _train_config "
              f"(embed {builder['embed_dim']}, {layers} layers)")
        launches, rates, restored, records, runs = {}, [], {}, [], []
        room = {}

        def before_first_write(stepper, kwargs):
            # the first write is ckpt.msgpack, with the optimizer and EMA
            opt, ema = kwargs["optimization"], kwargs["ema_state"]
            weight_bytes = _tensor_bytes(stepper.module.parameters())
            ckpt_bytes = (weight_bytes + _tensor_bytes(opt.mu + opt.nu)
                          + _tensor_bytes(ema.values()))
            room["free"] = _check_room(tmp, ckpt_bytes, weight_bytes, cuda)

        for argv in ([path], [path, "--override", "max_epochs=2"]):
            GlobalTimer.reset()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            with (_phase_probes(counters, launches, rates, cuda, restored),
                  _record_checkpoints(records, before_first_write)):
                trainer = train_main(argv, device=device)
            if cuda:
                torch.cuda.synchronize()
            runs.append({
                "start_epoch": trainer.start_epoch,
                "num_batches_seen": trainer.num_batches_seen,
                "phases": GlobalTimer.get_instance().get_durations(),
                "peak": (torch.cuda.max_memory_allocated() / 1e9 if cuda
                         else 0.0),
                "state": _state_checksums(trainer),
            })
            if cuda and len(runs) == 2:
                runs[-1]["bare_rate"] = _bare_step_rate(trainer)
            del trainer
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        ckpt_dir = os.path.join(out_dir, "training_checkpoints")
        files_found = sorted(os.listdir(ckpt_dir))
        read_back = {}
        # the restore timed ckpt.msgpack's read; of the others, path F's
        for name in [n for n in files_found if n == "best_ckpt.msgpack"]:
            t0 = time.perf_counter()
            load_msgpack(os.path.join(ckpt_dir, name))
            read_back[name] = time.perf_counter() - t0
        lines = _finite_metrics(os.path.join(out_dir, "metrics.jsonl"), 2)
        _check_train_entry(runs, restored, records, read_back, files_found,
                           lines, rates, launches, counters, layers, cuda,
                           path_t_rate)
        if then is not None:
            for name in files_found:
                if name != "best_ckpt.msgpack":
                    os.remove(os.path.join(ckpt_dir, name))
            then(paths, os.path.join(ckpt_dir, "best_ckpt.msgpack"))
    total = {c.__name__: sum(n[c.__name__] for calls in launches.values()
                             for n in calls) for c in counters}
    return total, rates, runs[0]["peak"], room["free"]


def _check_train_entry(runs, restored, records, read_back, files_found,
                       lines, rates, launches, counters, layers, cuda,
                       path_t_rate):
    """Path R's prints and gates."""
    first, second = runs
    for label, run in (("epoch 1", first), ("resume", second)):
        print(f"path R ({label}): phases "
              f"{ {k: round(v, 4) for k, v in sorted(run['phases'].items())} }; "
              f"peak device memory {run['peak']:.2f} GB")
    for kind, name, seconds, size in records:
        print(f"path R: {kind} {name}: {size} bytes in {seconds:.3f} s")
    for name, seconds in read_back.items():
        print(f"path R: read back {name} (load_msgpack): {seconds:.3f} s")
    print(f"path R: train steps/s over the batch loop, epoch 1 (warm-up) "
          f"{rates[0]:.4f}, epoch 2 {rates[1]:.4f} at batch {R_BATCH} (x2 "
          f"ensemble members)" + (f"; path T in the same call: "
                                  f"{path_t_rate:.4f}" if path_t_rate else ""))
    if "bare_rate" in second:
        print(f"path R: train_step alone on one batch of this config (no "
              f"loader, no loop): {second['bare_rate']:.4f} steps/s")
    print(f"path R: losses by epoch: train "
          f"{[line['train/loss'] for line in lines]}, validation "
          f"{[line['val/loss'] for line in lines]}, inline inference error "
          f"{[line['inference/inference_error'] for line in lines]}")
    want_files = {"ckpt.msgpack", "best_ckpt.msgpack", "ema_ckpt.msgpack",
                  "best_inference_ckpt.msgpack"}
    if not want_files <= set(files_found):
        raise AssertionError(f"path R: checkpoint files {files_found}")
    if second["start_epoch"] != 1:
        raise AssertionError(f"path R: the second run started at epoch "
                             f"{second['start_epoch']}, not 1")
    per_epoch = (R_TRAIN_TIMES - 1) // R_BATCH  # windows of 2 times
    if second["num_batches_seen"] != first["num_batches_seen"] + per_epoch:
        raise AssertionError("path R: the resumed run did not add one "
                             "epoch's batches")
    differ = [k for k, v in first["state"].items() if restored.get(k) != v]
    print(f"path R: resumed state against the first run's end: "
          f"{len(first['state']) - len(differ)} of {len(first['state'])} "
          f"checksums equal (count {restored.get('count')}, batches seen "
          f"{restored.get('num_batches_seen')})")
    if differ:
        raise AssertionError(f"path R: the resumed state differs: "
                             f"{differ[:5]}")

    none = {c.__name__: 0 for c in counters}
    n_valid = (R_VALID_TIMES - 1) // R_BATCH  # windows of 2 times
    if cuda:
        want = {
            "_train_batches": {**none, "dhconv_filter": 2 * layers * per_epoch,
                               "dhconv_filter_dx": layers * per_epoch,
                               "dhconv_filter_dw": layers * per_epoch},
            "validate": {**none, "dhconv_filter": 2 * layers * n_valid},
            "inference_one_epoch": {
                **none, "dhconv_filter": layers * R_INFERENCE_STEPS},
        }
    else:  # the plain versions
        want = dict.fromkeys(launches, none)
    for phase, counts in launches.items():
        print(f"path R: launches per {phase} call {counts} (want "
              f"{want[phase]} each: per train step 2 x {layers} K1, "
              f"{layers} 1b, {layers} 1c; per validation batch 2 x {layers} "
              f"K1; per inference step {layers} K1)")
        if any(c != want[phase] for c in counts):
            raise AssertionError(f"path R: launches in {phase}")


def reference_train_entry_phase(device="cuda", sizes=None):
    """Reference phase R: one epoch (4 AdamW updates) of a small bf16 copy
    of the shipped training config (embed 128, 2 layers, 16x32, MSE loss
    in place of the ensemble loss, as reference T takes its gradients; the
    shipped learning rate, clipping and EMA) through the entry's ``main``
    on ``device`` and on the CPU, from the same weights
    (``flagship.draw_check_weights``) and noise, over the same files. The
    epoch's train and validation losses must agree within
    ``flagship.TRAIN_LOSS_TOL``, as reference T's loss of a step, and each
    weight's and each EMA weight's change from the initial weights within
    ``R_CHANGE_TOL`` relative L2 per tensor (the updates themselves: the
    1b and 1c gradients, clipping, AdamW, the EMA). Adam moves every
    weight by about the rate whatever its gradient's size, so a gradient
    component near zero whose sign the card and the CPU round apart moves
    its weight the other way: the tolerance is set from readings on the
    card, of sound runs and of planted faults
    (``tests/test_torch_cuda.py``). Returns the relative errors
    (``train_loss``, ``val_loss``, ``change``), the tensor of the largest
    change error (``worst``), and the number of tensors compared
    (``tensors``) and of those that the CPU's epoch moved (``moved``)."""
    import contextlib
    import json
    import tempfile

    import numpy as np
    import torch
    import yaml

    from ace_tpu_torch import flagship
    from ace_tpu_torch.models.conditional_sfno import NoiseConditionedSFNO
    from ace_tpu_torch.stepper.train import TrainStepper
    from ace_tpu_torch.train.train import main as train_main

    sizes = sizes or dict(nlat=16, nlon=32, embed=128, layers=2)
    _, missing = inference_packages()
    files = (h5py_in_memory() if "h5py" in missing
             else contextlib.nullcontext())
    weights = {}
    init, make_noise = TrainStepper.init, NoiseConditionedSFNO.make_noise

    def fixed_init(self, generator=None):
        # the CPU run draws the weights, the card's loads the same
        if not weights:
            flagship.draw_check_weights(self.stepper,
                                        torch.Generator().manual_seed(3))
            weights.update({k: v.detach().clone() for k, v in
                            self.module.state_dict().items()})
        self.stepper.load_state_dict(
            {k: v.to(self.stepper.device) for k, v in weights.items()})
        params = self.parameters()
        self.optimization.init(params)
        self.ema.init(params)

    def fixed_noise(self, batch, generator):
        noise = np.random.RandomState(batch).randn(
            batch, *self.img_shape, self.noise_embed_dim)
        return torch.as_tensor(noise, dtype=torch.float32).to(
            next(self.parameters()).device)

    losses, changes = {}, {}
    with tempfile.TemporaryDirectory() as tmp, files:
        with open(TRAIN_CONFIG) as f:
            step = yaml.safe_load(f)["stepper"]["step"]["config"]
        names = sorted(set(step["in_names"]) | set(step["out_names"]))
        paths = _training_files(tmp, names, sizes["nlat"], sizes["nlon"],
                                torch.Generator().manual_seed(8), "cpu")
        TrainStepper.init = fixed_init
        NoiseConditionedSFNO.make_noise = fixed_noise
        try:
            for dev in ("cpu", device):
                out_dir = os.path.join(tmp, f"experiment_{dev}")
                config, _ = _train_config(
                    paths, out_dir, sizes["embed"], sizes["layers"],
                    inference=False, loss={"type": "MSE"})
                path = _write_yaml(os.path.join(tmp, f"{dev}.yaml"), config)
                trainer = train_main([path], device=dev)
                with open(os.path.join(out_dir, "metrics.jsonl")) as f:
                    line = json.loads(f.readline())
                losses[dev] = (line["train/loss"], line["val/loss"])
                ts = trainer.train_stepper
                changes[dev] = {
                    f"{label}/{name}": (
                        t.detach().cpu().double() - weights[name].double())
                    for label, group in (("param", ts.parameters()),
                                         ("ema", ts.ema.ema_params))
                    for name, t in zip(ts.parameter_names(), group)
                }
                del trainer, ts
        finally:
            TrainStepper.init, NoiseConditionedSFNO.make_noise = (
                init, make_noise)
    errs = {key: abs(a - b) / abs(b) for key, a, b in
            zip(("train_loss", "val_loss"), losses[device], losses["cpu"])}
    change_errs = {
        k: float((changes[device][k] - ref).norm()
                 / ref.norm().clamp_min(1e-30))
        for k, ref in changes["cpu"].items()
    }
    worst = max(change_errs, key=change_errs.get)
    errs["change"] = change_errs[worst]
    errs["tensors"] = len(change_errs)
    errs["moved"] = sum(bool(ref.norm() > 0)
                        for ref in changes["cpu"].values())
    if not errs["moved"]:
        raise AssertionError("reference R: the epoch moved no weight")
    print(f"reference R: one epoch through main, {device} / CPU: train loss "
          f"{losses[device][0]:.6g} / {losses['cpu'][0]:.6g}, validation "
          f"loss {losses[device][1]:.6g} / {losses['cpu'][1]:.6g}; relative "
          f"errors {errs['train_loss']:.3g}, {errs['val_loss']:.3g} (tol "
          f"{flagship.TRAIN_LOSS_TOL}); each tensor's change from the "
          f"initial weights, relative L2: largest {errs['change']:.3g} "
          f"({worst}), median "
          f"{float(np.median(list(change_errs.values()))):.3g}, over "
          f"{len(change_errs)} tensors, {errs['moved']} of them moved on "
          f"the CPU (tol {R_CHANGE_TOL})")
    if not (max(errs["train_loss"], errs["val_loss"])
            <= flagship.TRAIN_LOSS_TOL and errs["change"] <= R_CHANGE_TOL):
        raise AssertionError(
            f"reference R: the epoch on the card disagrees with the CPU "
            f"(losses {errs['train_loss']:.3g}, {errs['val_loss']:.3g}; "
            f"change {errs['change']:.3g} in {worst})")
    return {**errs, "worst": worst}


# path E: the evaluator entry on the repo's ERA5 evaluator baseline
EVAL_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "baselines", "era5",
                           "ace-evaluator-config.yaml")
# its first initial condition, which the synthetic file must hold
E_START = "1940-01-01T12:00"
# its depth: two windows of 25 steps (the YAML's windows are 50 steps;
# two keep the histograms' wait on the window before in the loop)
E_STEPS = 50
E_IN_MEMORY = 25
# phase E-agg: windows of this many steps (the videos keep float64 host
# arrays of every step, variable and grid point, on each side); 10 before
# paths W and G came, cut to keep the whole run near 1000 s
E_AGG_WINDOW = 5
# phase E-agg: card against CPU, the same port code; float32 sums in
# another order round at the size of the values summed (a variable's
# values; their squares for a variance; for a trend, the values over the
# spread of the times in years, since the slope divides by it), so each
# output is held within 1e-5 of the larger of its own largest value and
# that size: an output that is a difference of such sums (a variance, a
# trend, an anomaly, a bias) keeps their rounding whatever its own size
E_AGG_TOL = 1e-5


def _yaml(path):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def _finite_files(directory, label):
    """Every array of every netCDF file under ``directory`` is finite;
    returns the file names."""
    import numpy as np

    from ace_tpu_torch.data.store import open_file_dataset

    names = sorted(os.listdir(directory))
    for name in names:
        ds = open_file_dataset(os.path.join(directory, name))
        for k in ds.keys():
            values = np.asarray(ds[k].read(()))
            if values.dtype.kind == "f" and not np.isfinite(values).all():
                raise AssertionError(f"{label}: {name} {k} not finite")
    return names


def evaluator_path(counters, ckpt, device="cuda", n_steps=E_STEPS,
                   in_memory=E_IN_MEMORY):
    """Path E: ``python -m ace_tpu_torch.evaluator``'s ``main`` on
    ``configs/baselines/era5/ace-evaluator-config.yaml`` over the flagship
    checkpoint ``ckpt`` (path I's), with path I's kind of cuts: the data
    a synthetic netCDF file from the YAML's first initial condition on
    (``engine: netcdf4``, held in host memory where h5py is missing),
    ``n_steps`` steps in windows of ``in_memory`` (None: the YAML's), no
    Weights & Biases; the aggregator flags are the YAML's. Checks the launches,
    no synchronizing call in ``run_inference`` but the histograms' wait on
    the window before, finite logs and diagnostics files. Returns the
    launches, the summary, the timer phases and the peak memory."""
    import contextlib
    import tempfile

    import numpy as np
    import torch

    from ace_tpu_torch import flagship
    from ace_tpu_torch.core.timing import GlobalTimer
    from ace_tpu_torch.data.time import TimeCoord
    from ace_tpu_torch.inference import evaluator
    from ace_tpu_torch.stepper.checkpoint import load_stepper

    cuda = torch.device(device).type == "cuda"
    config = _yaml(EVAL_CONFIG)
    in_memory = in_memory or config["forward_steps_in_memory"]
    stepper = load_stepper(ckpt, device=device)
    info = stepper.dataset_info
    series = flagship.synthetic_series(
        stepper, n_steps + 1, generator=torch.Generator(device).manual_seed(4))
    del stepper
    time_coord = TimeCoord.from_range(E_START, n_steps + 1, 21600)
    _, missing = inference_packages()
    files = (h5py_in_memory() if "h5py" in missing
             else contextlib.nullcontext())
    waits = []
    with tempfile.TemporaryDirectory() as tmp, files:
        data_dir = _write_files(tmp, series, time_coord, info)
        out_dir = os.path.join(tmp, "evaluator")
        config.update({
            "experiment_dir": out_dir, "checkpoint_path": ckpt,
            "n_forward_steps": n_steps, "forward_steps_in_memory": in_memory,
        })
        config["logging"].update(log_to_wandb=False, log_to_screen=False)
        config["loader"]["dataset"] = {"data_path": data_dir,
                                       "file_pattern": "*.nc",
                                       "engine": "netcdf4"}
        path = _write_yaml(os.path.join(tmp, "evaluator.yaml"), config)
        GlobalTimer.reset()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        guard = (no_sync_in_run_inference(evaluator, event_waits=waits)
                 if cuda else contextlib.nullcontext())
        with guard:
            summary, launches = counted(
                counters, lambda: evaluator.main([path], device=device))
        phases = GlobalTimer.get_instance().get_durations()
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
        diagnostics = _finite_files(os.path.join(out_dir, "diagnostics"),
                                    "path E")
    logs = summary["logs"]
    bad = [k for k, v in logs.items() if not np.isfinite(v)]
    n_windows = -(-n_steps // in_memory)
    print(f"path E: {EVAL_CONFIG} at {info.img_shape}, {n_steps} steps in "
          f"windows of {in_memory} from {E_START}; aggregator "
          f"{config['aggregator']}; {len(logs)} logs, diagnostics "
          f"{diagnostics}")
    print(f"path E: {summary['total_steps']} steps at "
          f"{summary['total_steps_per_second']:.4f} steps/s (batch 1); "
          f"histograms filled in {summary['histogram_host_seconds']:.3f} s "
          f"of host time; phases "
          f"{ {k: round(v, 4) for k, v in sorted(phases.items())} }; peak "
          f"device memory {peak:.2f} GB; waits on the window before "
          f"{len(waits)}; launches {launches}")
    if bad:
        raise AssertionError(f"path E: logs not finite: {bad[:10]}")
    for name in ("histogram", "zonal_mean", "time_mean", "annual"):
        if f"{name}_diagnostics.nc" not in diagnostics:
            raise AssertionError(f"path E: no {name} diagnostics")
    if cuda and len(waits) != n_windows - 1:
        raise AssertionError(f"path E: {len(waits)} waits on a CUDA event "
                             f"in the window loop, want {n_windows - 1}")
    return launches, summary, phases, peak


def _tensor_scale(values):
    import numpy as np

    return float(np.max(np.abs(values))) if np.size(values) else 0.0


def _summed_scale(key, scales, sst_name, sigma_t):
    """The size of the values summed into the output ``key`` (``label
    name``): its variable's largest value (named last in the key), squared
    for a variance, over ``sigma_t`` (the times' spread in years) for a
    trend; the SST's for the ENSO index; 0 for normalized series."""
    if key.startswith("mean_norm "):
        return 0.0
    if "index" in key:
        return scales.get(sst_name, 0.0)
    name = max((n for n in scales if key.endswith(n)), key=len,
               default=None)
    if name is None:
        return 0.0
    if "gen_var" in key:
        return scales[name] ** 2
    return scales[name] / sigma_t if "trend" in key else scales[name]


def aggregator_phase(ckpt, device="cuda", window=E_AGG_WINDOW):
    """Phase E-agg: every aggregator of ``InferenceAggregatorConfig`` on
    (histograms, ENSO, seasonal, near-zero, video and extended video,
    trends, annual and step means) on the card and on the CPU, fed the
    same two windows of ``window`` steps of path E's stepper's outputs
    (from ``ckpt``, at its full grid) and targets. Histogram counts and
    edges must be equal; every other log and diagnostic within
    ``E_AGG_TOL`` of the size of the values summed into it. Returns the
    largest error so measured, its key and the seconds each side took."""
    import numpy as np
    import torch

    from ace_tpu_torch import flagship
    from ace_tpu_torch.aggregator.inference import InferenceAggregatorConfig
    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.data.time import TimeCoord
    from ace_tpu_torch.stepper.checkpoint import load_stepper
    from ace_tpu_torch.stepper.stepper import PrognosticState

    stepper = load_stepper(ckpt, device=device)
    n = 2 * window
    series = flagship.synthetic_series(
        stepper, n + 1, generator=torch.Generator(device).manual_seed(5))
    times = TimeCoord.from_range(E_START, n + 1, 21600).values
    flags = {"log_histograms": True, "log_enso_index": True,
             "log_seasonal_means": True, "log_near_zero_fraction": True,
             "log_video": True, "log_extended_video": True,
             "log_trends": True, "log_annual_means": True,
             "log_step_means": [{"step": window}]}
    config = from_dict(InferenceAggregatorConfig, flags)
    years = times[1:] / 1e6 / (365.25 * 86400)
    sigma_t = float(np.std(years - years.mean()))
    sides = {side: config.build(stepper.dataset_info, n_timesteps=n,
                                normalizer=stepper.step.normalizer)
             for side in ("card", "cpu")}
    seconds = {"card": 0.0, "cpu": 0.0}
    state = stepper.get_initial_state(PrognosticState(data={
        k: torch.as_tensor(series[k][None, :1]).to(stepper.device)
        for k in stepper.prognostic_names}))
    generator = torch.Generator(stepper.device).manual_seed(0)
    scales: dict[str, float] = {}
    for w in range(2):
        sl = slice(w * window, (w + 1) * window + 1)
        forcing = {k: torch.as_tensor(series[k][None, sl]).to(stepper.device)
                   for k in stepper.forcing_window_names}
        with torch.inference_mode():
            outputs, state = stepper.predict(state, forcing,
                                             generator=generator,
                                             n_forward=window)
        target = {k: torch.as_tensor(series[k][None, sl][:, 1:]).to(
            stepper.device) for k in outputs}
        window_time = TimeCoord(times[None, sl][:, 1:])
        host = {k: v.cpu() for k, v in outputs.items()}
        host_target = {k: v.cpu() for k, v in target.items()}
        for k in outputs:
            scales[k] = max(scales.get(k, 0.0),
                            _tensor_scale(host[k].numpy()),
                            _tensor_scale(host_target[k].numpy()))
        for side, (gen, tgt) in (("card", (outputs, target)),
                                 ("cpu", (host, host_target))):
            t0 = time.perf_counter()
            sides[side].record_batch(gen, tgt, time=window_time)
            if gen is outputs and stepper.device.type == "cuda":
                torch.cuda.synchronize()
            seconds[side] += time.perf_counter() - t0
    results = {}
    for side, agg in sides.items():
        t0 = time.perf_counter()
        results[side] = (agg.get_logs(), agg.get_diagnostics())
        seconds[side] += time.perf_counter() - t0
    (logs, diags), (ref_logs, ref_diags) = results["card"], results["cpu"]
    sst = config.enso_sst_name
    if set(logs) != set(ref_logs) or set(diags) != set(ref_diags):
        raise AssertionError("phase E-agg: the card's and the CPU's "
                             "aggregators give other keys")
    errs, n_hist = {}, 0
    arrays = {f"log {k}": (logs[k], v) for k, v in ref_logs.items()}
    for label, ref in ref_diags.items():
        if set(diags[label]) != set(ref):
            raise AssertionError(f"phase E-agg: {label} keys differ")
        for k, v in ref.items():
            if label == "histogram":
                n_hist += 1
                if not np.array_equal(diags[label][k], v):
                    raise AssertionError(f"phase E-agg: histogram {k} "
                                         "differs from the CPU's")
            else:
                arrays[f"{label} {k}"] = (diags[label][k], v)
    for key, (out, ref) in arrays.items():
        out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
        if out.shape != ref.shape:
            raise AssertionError(f"phase E-agg: {key} shape {out.shape}")
        if not np.array_equal(np.isnan(out), np.isnan(ref)):
            raise AssertionError(f"phase E-agg: {key} NaN where the CPU's "
                                 "is not")
        finite = ~np.isnan(ref)
        size = max(_tensor_scale(ref[finite]),
                   _summed_scale(key, scales, sst, sigma_t))
        diff = _tensor_scale(out[finite] - ref[finite])
        errs[key] = diff / size if size else diff
    worst = max(errs, key=errs.get)
    largest = sorted(errs, key=errs.get)[-5:]
    print("phase E-agg: the five largest errors "
          f"{ {k: float(f'{errs[k]:.3g}') for k in largest} }")
    card = sides["card"]._aggregators
    print(f"phase E-agg: every aggregator, card and CPU, on two windows of "
          f"{window} steps of path E's stepper at "
          f"{stepper.dataset_info.img_shape} ({len(scales)} variables): "
          f"{n_hist} histogram arrays equal; {len(errs)} other logs and "
          f"diagnostics, largest error {errs[worst]:.3g} of the values "
          f"summed ({worst}; tol {E_AGG_TOL}); seconds card "
          f"{seconds['card']:.3f}, CPU {seconds['cpu']:.3f}; on the card "
          f"the histograms' host fill {card['histogram'].host_seconds:.3f} "
          f"s, the video's drains {card['video'].drain_seconds:.3f} s "
          f"({card['video'].forced_drains} forced by "
          f"{card['video'].DRAIN_BYTES} bytes)")
    if n_hist == 0 or errs[worst] > E_AGG_TOL:
        raise AssertionError("phase E-agg: the card's aggregators disagree "
                             "with the CPU's")
    return errs[worst], worst, seconds


# path F: the fine-tuning entry on the repo's ERA5 multi-step baseline
FINETUNE_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "configs", "baselines", "era5",
                               "ace-train-config-multi-step-finetuning.yaml")
# 22 six-hourly times a file: two windows of the longest sampled rollout
# (20 steps), so each of the concat's three subsets gives 2 samples
F_TIMES = 22
F_SPLITS = (("subset_0", F_TIMES, "1995-12-20T00:00"),
            ("subset_1", F_TIMES, "2015-06-01T00:00"),
            ("subset_2", F_TIMES, "2021-03-01T00:00"),
            ("valid", F_TIMES, "1996-06-01T00:00"))
F_INFERENCE_STEPS = 4


def _time_mean_reference(tmp, paths, names, split="valid"):
    """A synthetic time-mean reference: each variable's map at its
    centering value."""
    import numpy as np

    from ace_tpu_torch.core.normalizer import load_scalar_dict_from_file
    from ace_tpu_torch.data.store import write_h5

    means = load_scalar_dict_from_file(paths["centering"])
    grid = _data_grid(paths, split)
    data = {k: np.full(grid, means[k], np.float32) for k in names}
    path = os.path.join(tmp, "time-mean.nc")
    write_h5(path, data, {k: ("lat", "lon") for k in data})
    return path


def _data_grid(paths, split="valid"):
    from ace_tpu_torch.data.store import open_file_dataset

    ds = open_file_dataset(os.path.join(paths[split], "data.nc"))
    return (len(ds["lat"].read(())), len(ds["lon"].read(())))


def _finetune_config(paths, base, experiment_dir, tmp, names):
    """The shipped fine-tuning config with path F's cuts: each subset of
    the training ``concat`` reads its own synthetic file (times inside
    the subset), batch 2 for both loaders, one epoch, one inline
    inference entry of ``F_INFERENCE_STEPS`` steps with the YAML's
    aggregator flags and a synthetic time-mean reference, the base
    weights and the stepper from ``base``, no Weights & Biases."""
    config = _yaml(FINETUNE_CONFIG)
    config["experiment_dir"] = experiment_dir
    config["max_epochs"] = 1
    config["logging"].update(log_to_wandb=False, log_to_screen=False)
    for i, entry in enumerate(config["train_loader"]["dataset"]["concat"]):
        entry.update(data_path=paths[f"subset_{i}"], file_pattern="*.nc",
                     engine="netcdf4")
    config["validation_loader"]["dataset"].update(
        data_path=paths["valid"], file_pattern="*.nc", engine="netcdf4")
    for loader in ("train_loader", "validation_loader"):
        config[loader]["batch_size"] = R_BATCH
    (entry,) = config["inference"]
    entry.update(n_forward_steps=F_INFERENCE_STEPS,
                 forward_steps_in_memory=F_INFERENCE_STEPS)
    entry["loader"]["dataset"] = {"data_path": paths["valid"],
                                  "file_pattern": "*.nc",
                                  "engine": "netcdf4"}
    entry["loader"]["start_indices"] = {"list": [0, 1]}
    entry["aggregator"]["time_mean_reference_data"] = _time_mean_reference(
        tmp, paths, names)
    config["stepper_training"]["parameter_init"]["weights_path"] = base
    config["stepper"]["checkpoint_path"] = base
    return config


def _module_checksums(state):
    """Per-tensor checksums of a ``state_dict``, on its device."""
    import torch

    out = {}
    for name, t in state.items():
        bits = t.detach().contiguous().view(
            torch.int16 if t.element_size() == 2 else torch.int32
        ).reshape(-1).to(torch.int64)
        weight = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out[name] = torch.stack([bits.sum(), (bits * weight).sum()])
    values = torch.stack(list(out.values())).cpu().tolist()
    return dict(zip(out, map(tuple, values)))


def _train_step_probe(counters, steps):
    """A context that records, for each ``TrainStepper.train_step`` call,
    its rollout length and the launches it made (the counts' growth over
    the call: the phase probes count on)."""
    import contextlib

    from ace_tpu_torch.stepper.train import TrainStepper

    train_step = TrainStepper.train_step

    def probed(self, batch, generator, n_steps=None, **kwargs):
        before = {c.__name__: c.launches for c in counters}
        out = train_step(self, batch, generator, n_steps, **kwargs)
        steps.append((n_steps, {c.__name__: c.launches - before[c.__name__]
                                for c in counters}))
        return out

    @contextlib.contextmanager
    def context():
        TrainStepper.train_step = probed
        try:
            yield
        finally:
            TrainStepper.train_step = train_step

    return context()


def finetune_entry_path(counters, paths, base, device="cuda", sizes=None):
    """Path F: ``python -m ace_tpu_torch.train``'s ``main`` on
    ``configs/baselines/era5/ace-train-config-multi-step-finetuning.yaml``
    with the cuts of ``_finetune_config``, from path R's
    ``best_ckpt.msgpack`` (``base``; ``paths`` are path R's files, whose
    stats files its config names). Checks that the start weights equal
    the base's (checksums), finite metrics, the four checkpoint files, no
    synchronizing call in the batch loop, and the launches of each train
    step of n sampled steps (8n + 8 K1: a step's forward, and the last
    step's per-block recompute; 8 of 1b and 8 of 1c); then times one
    ``train_step`` at 20 steps against one at 1 step and checks their
    peaks. Returns the launches, the peaks and the 20-step seconds."""
    import tempfile

    import torch

    from ace_tpu_torch.core.timing import GlobalTimer
    from ace_tpu_torch.stepper.parameter_init import read_base_weights
    from ace_tpu_torch.stepper.train import TrainStepper
    from ace_tpu_torch.train.train import main as train_main

    sizes = sizes or {}
    nlat, nlon = sizes.get("nlat", 180), sizes.get("nlon", 360)
    cuda = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        names = sorted(set(_yaml(TRAIN_CONFIG)["stepper"]["step"]["config"]
                           ["in_names"])
                       | set(_yaml(TRAIN_CONFIG)["stepper"]["step"]["config"]
                             ["out_names"]))
        files = _training_files(tmp, names, nlat, nlon,
                                torch.Generator(device).manual_seed(9),
                                device, splits=F_SPLITS)
        files.update({k: paths[k] for k in ("centering", "scaling-full-field",
                                             "scaling-residual")})
        out_dir = os.path.join(tmp, "experiment")
        config = _finetune_config(files, base, out_dir, tmp, names)
        path = _write_yaml(os.path.join(tmp, "finetune.yaml"), config)
        start = {}
        init = TrainStepper.init

        def checked_init(self, generator=None):
            init(self, generator)
            start.update(_module_checksums(self.module.state_dict()))

        base_state, _ = read_base_weights(base)
        want_start = _module_checksums(base_state)
        del base_state
        steps, launches, rates, restored = [], {}, [], {}
        TrainStepper.init = checked_init
        try:
            GlobalTimer.reset()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            with (_train_step_probe(counters, steps),
                  _phase_probes(counters, launches, rates, cuda, restored)):
                trainer = train_main([path], device=device)
        finally:
            TrainStepper.init = init
        peak_run = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
        phases = GlobalTimer.get_instance().get_durations()
        files_found = sorted(os.listdir(os.path.join(
            out_dir, "training_checkpoints")))
        lines = _finite_metrics(os.path.join(out_dir, "metrics.jsonl"), 1)
        # the worst case: one train step of the longest sampled rollout
        ts = trainer.train_stepper
        batch = next(iter(trainer.train_data)).data
        peaks, seconds = {}, {}
        for n in (1, ts.train_config.max_n_forward_steps):
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ts.train_step(batch, trainer.generator, n)
            if cuda:
                torch.cuda.synchronize()
            seconds[n] = time.perf_counter() - t0
            peaks[n] = (torch.cuda.max_memory_allocated() / 1e9 if cuda
                        else 0.0)
        del trainer, ts, batch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    layers = _yaml(TRAIN_CONFIG)["stepper"]["step"]["config"]["builder"][
        "config"]["num_layers"] if not sizes else sizes["layers"]
    differ = [k for k, v in want_start.items() if start.get(k) != v]
    longest = max(seconds)
    print(f"path F: {FINETUNE_CONFIG} from path R's best_ckpt.msgpack at "
          f"{nlat}x{nlon}: start weights against the base's "
          f"{len(want_start) - len(differ)} of {len(want_start)} checksums "
          f"equal; sampled rollout lengths {[n for n, _ in steps]}; "
          f"files {files_found}; peak device memory {peak_run:.2f} GB")
    print(f"path F: metrics train/loss {lines[0]['train/loss']:.6g}, "
          f"val/loss {lines[0]['val/loss']:.6g}, inference error "
          f"{lines[0]['inference/inference_error']:.6g}; batch loop "
          f"{rates[0]:.4f} train steps/s; phases "
          f"{ {k: round(v, 4) for k, v in sorted(phases.items())} }")
    print(f"path F: one train_step of {longest} steps (batch {R_BATCH} x 2 "
          f"members) {seconds[longest]:.3f} s, peak {peaks[longest]:.3f} "
          f"GB; of 1 step {seconds[1]:.3f} s, peak {peaks[1]:.3f} GB; the "
          f"longest's peak {1e3 * (peaks[longest] - peaks[1]):.1f} MB above "
          f"(gate 3 GB)")
    if differ or not start:
        raise AssertionError(f"path F: the start weights differ from the "
                             f"base's: {differ[:5]}")
    want_files = {"ckpt.msgpack", "best_ckpt.msgpack", "ema_ckpt.msgpack",
                  "best_inference_ckpt.msgpack"}
    if not want_files <= set(files_found):
        raise AssertionError(f"path F: checkpoint files {files_found}")
    none = {c.__name__: 0 for c in counters}
    for n, counts in steps:
        want = (none if not cuda else
                {**none, "dhconv_filter": layers * n + layers,
                 "dhconv_filter_dx": layers, "dhconv_filter_dw": layers})
        print(f"path F: train step of {n} steps: launches {counts} (want "
              f"{want})")
        if counts != want:
            raise AssertionError(f"path F: launches of a {n}-step train step")
    # per validation batch: the loss of the longest rollout and the
    # one-step prediction; per inference step: one forward
    want = {"validate": {**none, "dhconv_filter": layers * (longest + 1)
                         * ((F_TIMES - longest) // R_BATCH)},
            "inference_one_epoch": {
                **none, "dhconv_filter": layers * F_INFERENCE_STEPS}}
    for phase in want:
        print(f"path F: launches per {phase} call {launches[phase]} (want "
              f"{want[phase] if cuda else none})")
        if any(c != (want[phase] if cuda else none)
               for c in launches[phase]):
            raise AssertionError(f"path F: launches in {phase}")
    if peaks[longest] - peaks[1] > 3.0:
        raise AssertionError("path F: the longest train step's peak exceeds "
                             "the 1-step peak by more than 3 GB")
    total = {c.__name__: sum(n[c.__name__] for calls in launches.values()
                             for n in calls) for c in counters}
    return total, peaks, seconds[longest]


def reference_finetune_phase(device="cuda", sizes=None):
    """Reference phase F: one epoch of a small bf16 copy of path F's config
    (embed 128, 2 layers, 16x32, MSE loss, as reference R) through the
    training entry's ``main`` on ``device`` and on the CPU, with every
    fine-tuning option on: the base weights of a one-epoch CPU run of
    reference R's config with the encoder excluded (both sides start it
    from the same draw), frozen filters, L2-SP (``alpha`` and ``beta``),
    the decoder copied back after each update, gradient accumulation over
    2 batches, and Adam's state from the base run's ``ckpt.msgpack``; the
    same noise on both. The frozen and copied weights must be bit-equal to
    the base's on both devices, the losses agree within
    ``flagship.TRAIN_LOSS_TOL`` and each other weight's and EMA weight's
    change from the start within ``R_CHANGE_TOL``. Returns the errors."""
    import contextlib
    import json
    import tempfile

    import numpy as np
    import torch

    from ace_tpu_torch import flagship
    from ace_tpu_torch.models.conditional_sfno import NoiseConditionedSFNO
    from ace_tpu_torch.stepper.parameter_init import read_base_weights
    from ace_tpu_torch.stepper.stepper import Stepper
    from ace_tpu_torch.train.train import main as train_main

    sizes = sizes or dict(nlat=16, nlon=32, embed=128, layers=2)
    _, missing = inference_packages()
    files = (h5py_in_memory() if "h5py" in missing
             else contextlib.nullcontext())
    drawn = {}
    init_params, make_noise = Stepper.init_params, (
        NoiseConditionedSFNO.make_noise)

    def fixed_init(self, generator=None):
        # the CPU run draws the weights, the card's loads the same
        if not drawn:
            Stepper.init_params = init_params
            try:
                flagship.draw_check_weights(self,
                                            torch.Generator().manual_seed(3))
            finally:
                Stepper.init_params = fixed_init
            drawn.update({k: v.detach().cpu().clone() for k, v in
                          self.module.state_dict().items()})
        self.load_state_dict({k: v.to(self.device)
                              for k, v in drawn.items()})

    def fixed_noise(self, batch, generator):
        noise = np.random.RandomState(batch).randn(
            batch, *self.img_shape, self.noise_embed_dim)
        return torch.as_tensor(noise, dtype=torch.float32).to(
            next(self.parameters()).device)

    frozen, copied = ["*filter*"], ["*decoder*"]
    losses, changes, held = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp, files:
        step = _yaml(TRAIN_CONFIG)["stepper"]["step"]["config"]
        names = sorted(set(step["in_names"]) | set(step["out_names"]))
        paths = _training_files(tmp, names, sizes["nlat"], sizes["nlon"],
                                torch.Generator().manual_seed(8), "cpu",
                                splits=F_SPLITS)
        base_dir = os.path.join(tmp, "base")
        config, _ = _train_config(
            {**paths, "train": paths["subset_0"]}, base_dir, sizes["embed"],
            sizes["layers"], inference=False, loss={"type": "MSE"})
        train_main([_write_yaml(os.path.join(tmp, "base.yaml"), config)],
                   device="cpu")
        ckpts = os.path.join(base_dir, "training_checkpoints")
        base = os.path.join(ckpts, "best_ckpt.msgpack")
        base_state, _ = read_base_weights(base)
        Stepper.init_params = fixed_init
        NoiseConditionedSFNO.make_noise = fixed_noise
        try:
            for dev in ("cpu", device):
                out_dir = os.path.join(tmp, f"finetune_{dev}")
                config = _finetune_config(paths, base, out_dir, tmp, names)
                del config["inference"]
                config["stepper_training"]["loss"] = {"type": "MSE"}
                config["stepper_training"]["parameter_init"].update(
                    exclude_parameters=["*encoder*"],
                    frozen_parameters={"include": frozen},
                    alpha=0.05, beta=0.01)
                config["copy_weights_after_batch"] = {"include": copied}
                config["optimization"].update(
                    gradient_accumulation_steps=2,
                    resume_optimizer_ckpt_path=os.path.join(
                        ckpts, "ckpt.msgpack"))
                path = _write_yaml(os.path.join(tmp, f"ft_{dev}.yaml"),
                                   config)
                trainer = train_main([path], device=dev)
                with open(os.path.join(out_dir, "metrics.jsonl")) as f:
                    line = json.loads(f.readline())
                losses[dev] = (line["train/loss"], line["val/loss"])
                ts = trainer.train_stepper
                names_p = ts.parameter_names()
                start = {k: (drawn[k] if "encoder" in k else base_state[k])
                         for k in names_p}
                state = {k: v.detach().cpu() for k, v in
                         trainer.stepper.module.state_dict().items()}
                held[dev] = [k for k in names_p
                             if ("filter" in k or "decoder" in k)
                             and not torch.equal(state[k], base_state[k])]
                changes[dev] = {
                    f"{label}/{name}": (t.detach().cpu().double()
                                        - start[name].double())
                    for label, group in (("param", ts.parameters()),
                                         ("ema", ts.ema.ema_params))
                    for name, t in zip(names_p, group)
                    if not ("filter" in name or "decoder" in name)
                }
                opt = ts.optimization
                counts = (opt._count, opt.adam_count, opt.schedule_count)
                del trainer, ts
        finally:
            Stepper.init_params, NoiseConditionedSFNO.make_noise = (
                init_params, make_noise)
    n_held = sum(("filter" in k or "decoder" in k) for k in base_state)
    errs = {key: abs(a - b) / abs(b) for key, a, b in
            zip(("train_loss", "val_loss"), losses[device], losses["cpu"])}
    change_errs = {
        k: float((changes[device][k] - ref).norm()
                 / ref.norm().clamp_min(1e-30))
        for k, ref in changes["cpu"].items()
    }
    worst = max(change_errs, key=change_errs.get)
    errs["change"] = change_errs[worst]
    errs["moved"] = sum(bool(ref.norm() > 0)
                        for ref in changes["cpu"].values())
    print(f"reference F: one fine-tuning epoch through main, {device} / CPU "
          f"(counts: batches, Adam's, the schedule's {counts}): train loss "
          f"{losses[device][0]:.6g} / {losses['cpu'][0]:.6g}, validation "
          f"loss {losses[device][1]:.6g} / {losses['cpu'][1]:.6g}; relative "
          f"errors {errs['train_loss']:.3g}, {errs['val_loss']:.3g} (tol "
          f"{flagship.TRAIN_LOSS_TOL}); {n_held} frozen or copied tensors, "
          f"those off the base: card {held[device]}, CPU {held['cpu']}; "
          f"each other tensor's change, relative L2: largest "
          f"{errs['change']:.3g} ({worst}) over {len(change_errs)} tensors, "
          f"{errs['moved']} moved on the CPU (tol {R_CHANGE_TOL})")
    if not n_held or held[device] or held["cpu"]:
        raise AssertionError("reference F: a frozen or copied weight left "
                             "the base's")
    if not errs["moved"]:
        raise AssertionError("reference F: the epoch moved no weight")
    if not (max(errs["train_loss"], errs["val_loss"])
            <= flagship.TRAIN_LOSS_TOL and errs["change"] <= R_CHANGE_TOL):
        raise AssertionError(
            f"reference F: the epoch on the card disagrees with the CPU "
            f"(losses {errs['train_loss']:.3g}, {errs['val_loss']:.3g}; "
            f"change {errs['change']:.3g} in {worst})")
    return {**errs, "worst": worst, "counts": counts}


# path S: the ACE2-SHiELD AMIP recipe (SphericalFourierNeuralOperatorNet,
# float32 as shipped) through the training and inference entries
SHIELD_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "configs", "baselines", "amip-c96-shield",
                             "train-ace2.yaml")
# batch 2 for both loaders (the YAML: 16 and 128); each of the training
# concat's four subsets reads its own file of 4 six-hourly times (2
# windows of the YAML's 2 forward steps: 4 batches), each of the two
# validation subsets 3 times (1 batch); one file of N_STEPS + 1 times for
# the inline entry (4 steps from the YAML's first initial condition and
# the time after it) and path S-I (N_STEPS steps from its first time)
S_BATCH = 2
S_SPLITS = (("subset_0", 4, "1995-12-30T00:00"),
            ("subset_1", 4, "1995-12-30T00:00"),
            ("subset_2", 4, "2011-01-01T00:00"),
            ("subset_3", 4, "2011-01-01T00:00"),
            ("valid_0", 3, "1996-01-01T00:00"),
            ("valid_1", 3, "1996-01-01T00:00"),
            ("inference", N_STEPS + 1, "1996-01-01T00:00"))
S_INFERENCE_STEPS = 4
S_INFERENCE_TIMES = ["1996-01-01T00:00:00", "1996-01-01T06:00:00"]
S_WINDOW = 5
# path S-bf16: train steps after the warm-up, at batch 1
S_BF16_STEPS = 3
# reference phase S, float32 card against CPU (both full float32, TF32
# off): each output's error over its spatial anomaly, the loss
# (relative) and each gradient (relative L2)
S_F32_TOL = 1e-4
S_F32_LOSS_TOL = 1e-4
S_F32_GRAD_TOL = 1e-3


def _shield_names():
    step = _yaml(SHIELD_CONFIG)["stepper"]["step"]["config"]
    return sorted(set(step["in_names"]) | set(step["out_names"]))


def _monthly_reference(tmp, paths, names, split):
    """A synthetic monthly-means reference (``[sample, month, lat, lon]``,
    ``counts`` and ``valid_time``, as ``MonthlyMeanWriter`` writes it): 12
    months of 1996, each variable's map at its centering value."""
    import numpy as np

    from ace_tpu_torch.core.normalizer import load_scalar_dict_from_file
    from ace_tpu_torch.data.store import encode_cf_time, write_h5
    from ace_tpu_torch.data.time import TimeCoord, encode_time

    means = load_scalar_dict_from_file(paths["centering"])
    nlat, nlon = _data_grid(paths, split)
    micros = np.asarray([[encode_time(1996, m, 15) for m in range(1, 13)]])
    values, units, calendar = encode_cf_time(TimeCoord(micros))
    data = {k: np.full((1, 12, nlat, nlon), means[k], np.float32)
            for k in names}
    dims = {k: ("sample", "month", "lat", "lon") for k in names}
    data["counts"] = np.ones((1, 12))
    data["valid_time"] = values
    dims["counts"] = dims["valid_time"] = ("sample", "month")
    path = os.path.join(tmp, "monthly_mean_data.nc")
    write_h5(path, data, dims,
             attrs={"valid_time": {"units": units, "calendar": calendar}})
    return path


def _shield_config(paths, experiment_dir, tmp, names, sizes=None):
    """The shipped ACE2-SHiELD AMIP config with path S's cuts: each subset
    of both loaders' ``concat`` reads its own synthetic file (times inside
    the subset), batch ``S_BATCH``, one epoch, the stats files, one inline
    inference entry of ``S_INFERENCE_STEPS`` steps from 2 of the YAML's
    initial conditions with its aggregator flags and synthetic time-mean
    and monthly references, no Weights & Biases; ``sizes`` (``embed``,
    ``layers``) makes the small copies the CPU runs."""
    config = _yaml(SHIELD_CONFIG)
    config["experiment_dir"] = experiment_dir
    config["max_epochs"] = 1
    config["logging"].update(log_to_wandb=False, log_to_screen=False)
    for loader, prefix in (("train_loader", "subset"),
                           ("validation_loader", "valid")):
        for i, entry in enumerate(config[loader]["dataset"]["concat"]):
            entry["data_path"] = paths[f"{prefix}_{i}"]
        config[loader]["batch_size"] = S_BATCH
    step = config["stepper"]["step"]["config"]
    norm = step["normalization"]
    norm["network"] = {"global_means_path": paths["centering"],
                       "global_stds_path": paths["scaling-full-field"]}
    norm["residual"] = {"global_means_path": paths["centering"],
                        "global_stds_path": paths["scaling-residual"]}
    if sizes:
        step["builder"]["config"].update(embed_dim=sizes["embed"],
                                         num_layers=sizes["layers"])
    (entry,) = config["inference"]
    entry.update(n_forward_steps=S_INFERENCE_STEPS,
                 forward_steps_in_memory=S_INFERENCE_STEPS)
    entry["loader"]["dataset"]["data_path"] = paths["inference"]
    entry["loader"]["start_indices"]["times"] = S_INFERENCE_TIMES
    entry["aggregator"].update(
        time_mean_reference_data=_time_mean_reference(tmp, paths, names,
                                                       "inference"),
        monthly_reference_data=_monthly_reference(tmp, paths, names,
                                                  "inference"))
    return config


def shield_train_path(counters, device="cuda", sizes=None, then=None):
    """Path S-R: ``python -m ace_tpu_torch.train``'s ``main`` on
    ``configs/baselines/amip-c96-shield/train-ace2.yaml`` with the cuts of
    ``_shield_config`` (at its full width, embed 384, 8 layers, 180x360,
    float32, unless ``sizes`` gives ``nlat``, ``nlon``, ``embed`` and
    ``layers``) over synthetic files of its 56 variables, through
    ``_recipe_train_path``."""
    return _recipe_train_path("path S-R", SHIELD_CONFIG, _shield_names(),
                              S_SPLITS, _shield_config, S_BATCH, counters,
                              device, sizes, then)


def _recipe_train_path(label, source, names, splits, make_config, batch,
                       counters, device="cuda", sizes=None, then=None):
    """A recipe's training entry: ``main`` on the config that
    ``make_config(paths, experiment_dir, tmp, names, sizes)`` makes of the
    YAML ``source`` over synthetic files of ``names`` (``splits``; at
    180x360 unless ``sizes`` gives ``nlat`` and ``nlon``). Checks finite
    metrics, the four checkpoint files, no launch of any kernel (float32
    takes the einsums, as in JAX) in the batch loop, validation and
    inline inference, and (on the card) that the batch loop never waits
    for the device; prints the loop's rate, the phases, the checkpoints'
    bytes and seconds and the peak. ``then(paths, config, best)`` runs
    after the gates inside the context that holds the files. Returns the
    launches and the loop's rate."""
    import contextlib
    import tempfile

    import torch

    from ace_tpu_torch.core.timing import GlobalTimer
    from ace_tpu_torch.train.train import main as train_main

    sizes = sizes or {}
    nlat, nlon = sizes.get("nlat", 180), sizes.get("nlon", 360)
    cuda = torch.device(device).type == "cuda"
    _, missing = inference_packages()
    files = h5py_in_memory() if "h5py" in missing else (
        contextlib.nullcontext())
    with tempfile.TemporaryDirectory() as tmp, files:
        paths = _training_files(tmp, names, nlat, nlon,
                                torch.Generator(device).manual_seed(11),
                                device, splits=splits)
        out_dir = os.path.join(tmp, "experiment")
        config = make_config(paths, out_dir, tmp, names, sizes)
        path = _write_yaml(os.path.join(tmp, "recipe.yaml"), config)
        launches, rates, restored, records = {}, [], {}, []
        GlobalTimer.reset()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with (_phase_probes(counters, launches, rates, cuda, restored),
              _record_checkpoints(records, lambda stepper, kwargs: None)):
            trainer = train_main([path], device=device)
        if cuda:
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
        phases = GlobalTimer.get_instance().get_durations()
        n_params = sum(p.numel() for p in trainer.stepper.module.parameters())
        builder = trainer.stepper.step.config
        while not hasattr(builder, "builder"):
            builder = builder.wrapped_step.instance
        builder = builder.builder.instance
        del trainer
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        ckpt_dir = os.path.join(out_dir, "training_checkpoints")
        files_found = sorted(os.listdir(ckpt_dir))
        (line,) = _finite_metrics(os.path.join(out_dir, "metrics.jsonl"), 1)
        print(f"{label}: {source} at {nlat}x{nlon}, "
              f"{len(names)} variables, embed {builder.embed_dim}, "
              f"{builder.num_layers} layers, {n_params} parameters, batch "
              f"{batch}: batch loop {rates[0]:.4f} train steps/s "
              f"({rates[0] * batch:.4f} samples/s); phases "
              f"{ {k: round(v, 4) for k, v in sorted(phases.items())} }; "
              f"peak device memory {peak:.2f} GB")
        for kind, name, seconds, size in records:
            print(f"{label}: {kind} {name}: {size} bytes in {seconds:.3f} s")
        print(f"{label}: train/loss {line['train/loss']:.6g}, val/loss "
              f"{line['val/loss']:.6g}, inference error "
              f"{line['inference/inference_error']:.6g}; {len(line)} finite "
              f"metrics")
        want_files = {"ckpt.msgpack", "best_ckpt.msgpack", "ema_ckpt.msgpack",
                      "best_inference_ckpt.msgpack"}
        if not want_files <= set(files_found):
            raise AssertionError(f"{label}: checkpoint files {files_found}")
        none = {c.__name__: 0 for c in counters}
        for phase, counts in launches.items():
            print(f"{label}: launches per {phase} call {counts} (want none)")
            if any(c != none for c in counts):
                raise AssertionError(f"{label}: launches in {phase}")
        if then is not None:
            then(paths, config, os.path.join(ckpt_dir, "best_ckpt.msgpack"))
    total = {c.__name__: sum(n[c.__name__] for calls in launches.values()
                             for n in calls) for c in counters}
    return total, rates[0]


def _read_series(path, names):
    from ace_tpu_torch.data.store import open_file_dataset

    ds = open_file_dataset(os.path.join(path, "data.nc"))
    return {k: ds[k].read(()) for k in names}


def shield_inference_path(counters, paths, ckpt, device="cuda",
                          n_steps=N_STEPS, window=S_WINDOW):
    """Path S-I: ``python -m ace_tpu_torch.inference``'s ``main`` over path
    S-R's ``best_ckpt.msgpack``: batch 1 (the first time of the inference
    file), ``n_steps`` steps in windows of ``window``, writer off (then on,
    for the predictions). Checks finite outputs, no launch, no
    synchronizing call in ``run_inference`` (on the card), the written
    predictions within 1e-5 of each channel's spatial std of one
    ``Stepper.predict`` and the dry-air mass within 1 Pa. Returns the
    launches and the rate."""
    import tempfile

    import torch

    from ace_tpu_torch.stepper import checkpoint

    check_sync = torch.device(device).type == "cuda"
    stepper = checkpoint.load_stepper(ckpt, device=device)
    names = sorted(set(stepper.prognostic_names)
                   | set(stepper.forcing_window_names))
    series = _read_series(paths["inference"], names)
    with tempfile.TemporaryDirectory() as tmp:
        runs, written = _entry_from_files(
            tmp, ckpt, None, None, None, counters, device, n_steps, window,
            check_sync, data_dir=paths["inference"], starts=(0,),
            label="path S-I")
    errs, worst, drift = _check_written("path S-I", stepper, series, written,
                                        [0], n_steps)
    summary, launches, phases, peak = runs[False]
    rate = summary["total_steps_per_second"]
    print(f"path S-I: {summary['total_steps']} steps at {rate:.4f} steps/s "
          f"(batch 1, windows of {window}, writer off; "
          f"{runs[True][0]['total_steps_per_second']:.4f} with it on); "
          f"phases { {k: round(v, 4) for k, v in sorted(phases.items())} }; "
          f"peak device memory {peak:.2f} GB; launches {launches}")
    print(f"path S-I: written predictions vs one {n_steps}-step predict: "
          f"largest error {errs[worst]:.3g} of the channel's spatial std "
          f"({worst}; tol 1e-5); dry-air mass drift {drift:.4f} Pa")
    if launches != {c.__name__: 0 for c in counters}:
        raise AssertionError(f"path S-I: launches {launches}")
    if not errs[worst] <= 1e-5:
        raise AssertionError("path S-I: the written predictions disagree "
                             "with Stepper.predict")
    if not drift < 1.0:
        raise AssertionError("path S-I: the dry-air mass is not conserved")
    return launches, rate


def shield_bf16_path(counters, paths, config, device="cuda",
                     n_steps=N_STEPS, train_steps=S_BF16_STEPS):
    """Path S-bf16: path S-R's config with ``compute_dtype: bfloat16`` (its
    one change; batch 1) built through ``TrainConfig.build_trainer``:
    a warm-up train step, ``train_steps`` more on one batch (each holding
    per block and forward step one K1, 1b and 1c, no synchronizing call),
    the loss after them below the warm-up's, then an ``n_steps``-step
    rollout from the inference file (one K1 per block and step). Returns
    the launches of both and their rates."""
    import copy

    import numpy as np
    import torch

    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.stepper.stepper import PrognosticState
    from ace_tpu_torch.train.trainer import TrainConfig

    cuda = torch.device(device).type == "cuda"
    config = copy.deepcopy(config)
    builder = config["stepper"]["step"]["config"]["builder"]["config"]
    builder["compute_dtype"] = "bfloat16"
    layers = builder["num_layers"]
    config["train_loader"]["batch_size"] = 1
    trainer = from_dict(TrainConfig, config).build_trainer(device=device)
    ts = trainer.train_stepper
    ts.init(torch.Generator(device).manual_seed(0))
    batch = next(iter(trainer.train_data)).data
    gen = trainer.generator
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    first = ts.train_step(batch, gen)
    steps = []

    def train():
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = ts.train_step(batch, gen)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for _ in range(train_steps):
        steps.append(counted(counters, train))
    after = float(ts.valid_step(batch, gen)["loss"])
    train_peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    losses = [float(first["loss"])] + [float(m["loss"]) for (m, _), _ in
                                       steps] + [after]
    rate = len(steps) / sum(s for (_, s), _ in steps)

    stepper = ts.stepper
    names = sorted(set(stepper.prognostic_names)
                   | set(stepper.forcing_window_names))
    series = _read_series(paths["inference"], names)
    ic = PrognosticState(data={
        k: torch.as_tensor(series[k][None, :1]).to(device)
        for k in stepper.prognostic_names})
    forcing = {k: torch.as_tensor(series[k][None, :n_steps + 1]).to(device)
               for k in stepper.forcing_window_names}
    stepper.predict(ic, {k: v[:, :2] for k, v in forcing.items()})
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def rollout():
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            outputs, _ = stepper.predict(ic, forcing)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
        return outputs, time.perf_counter() - t0

    (outputs, seconds), launches_r = counted(counters, rollout)
    roll_peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    finite = all(bool(torch.isfinite(v).all()) for v in outputs.values())
    none = {c.__name__: 0 for c in counters}
    want_t = none if not cuda else {
        **none, "dhconv_filter": 2 * layers, "dhconv_filter_dx": 2 * layers,
        "dhconv_filter_dw": 2 * layers}
    want_r = none if not cuda else {**none,
                                    "dhconv_filter": layers * n_steps}
    print(f"path S-bf16: {len(steps)} train steps at batch 1 (2 forward "
          f"steps) {rate:.4f} train steps/s, peak {train_peak:.2f} GB; "
          f"losses {[round(v, 6) for v in losses]} (warm-up, the steps, "
          f"after the updates); launches per train step "
          f"{[n for _, n in steps]} (want {want_t})")
    print(f"path S-bf16: {n_steps}-step rollout {n_steps / seconds:.4f} "
          f"steps/s at batch 1, peak {roll_peak:.2f} GB, outputs finite "
          f"{finite}; launches {launches_r} (want {want_r})")
    del trainer, ts, stepper
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if not (all(map(math.isfinite, losses)) and finite):
        raise AssertionError("path S-bf16: a loss or an output is not finite")
    if not after < losses[0]:
        raise AssertionError("path S-bf16: the loss after the updates is not "
                             "below the warm-up step's")
    if any(n != want_t for _, n in steps) or launches_r != want_r:
        raise AssertionError("path S-bf16: launches")
    total = {k: sum(n[k] for _, n in steps) + launches_r[k] for k in none}
    return total, rate, n_steps / seconds


def sfno_stepper_config(nlat=16, nlon=32, embed=128, layers=2,
                        compute_dtype="float32", **builder):
    """A small stepper config of path S's shape: the SHiELD YAML's
    ``SphericalFourierNeuralOperatorNet`` (dhconv, instance norms, learned
    position embedding, big skip) over 2 of its levels' variables with the
    dry-air corrector and prescribed SST, and its dataset info; ``builder``
    overrides the network's fields."""
    from ace_tpu_torch import flagship
    from ace_tpu_torch.core.step import StepSelector
    from ace_tpu_torch.stepper.stepper import StepperConfig

    config, info = flagship.stepper_config(nlat, nlon, nz=2)
    step = config.step.config
    fields = dict(_yaml(SHIELD_CONFIG)["stepper"]["step"]["config"][
        "builder"]["config"])
    fields.update(embed_dim=embed, num_layers=layers,
                  compute_dtype=compute_dtype, **builder)
    step["builder"] = {"type": "SphericalFourierNeuralOperatorNet",
                       "config": fields}
    # the scales of flagship.synthetic_inputs' draws
    network = step["normalization"]["network"]
    network["means"]["PRESsfc"], network["stds"]["PRESsfc"] = 1.0e5, 100.0
    for name in network["stds"]:
        if name.startswith("specific_total_water"):
            network["stds"][name] = 1e-3
    return StepperConfig(step=StepSelector(type="single_module",
                                           config=step)), info


def _reference_s_case(label, counters, device, dtype, builder, tols,
                      embed=128):
    """One case of reference phase S: ``_reference_case`` on a small SFNO
    of path S's shape (``sfno_stepper_config``; ``builder`` overrides its
    network's fields), a 2-step rollout."""
    from ace_tpu_torch import flagship

    def inputs(stepper, gen):
        ic, forcing = flagship.synthetic_inputs(stepper, 2, batch=2,
                                                generator=gen)
        return ic, forcing, flagship.synthetic_batch(
            stepper, 2, n_forward_steps=2, generator=gen)

    return _reference_case(
        f"reference S ({label})", counters, device, tols,
        lambda dt: sfno_stepper_config(embed=embed, compute_dtype=dt,
                                       **builder), dtype, inputs)


def _sfno_zero_gradients(names):
    """A block's output bias, but the last's (the next block's instance
    norm removes it)."""
    import re

    blocks = {}
    for k in names:
        match = re.search(r"^(.*)block_(\d+)\.mlp\.fc2\.bias$", k)
        if match:
            blocks.setdefault(match.group(1), []).append(
                (int(match.group(2)), k))
    return {k for found in blocks.values() for i, k in found
            if i < max(found)[0]}


def _reference_case(label, counters, device, tols, make, dtype, inputs,
                    prepare=None, n_steps=2,
                    zero_gradients=_sfno_zero_gradients, labels=None,
                    stepwise=False, loss_config=None, n_ensemble=1):
    """A rollout and one train step (MSE, or the step loss config
    ``loss_config`` over ``n_ensemble`` members; ``n_steps`` forward
    steps) of
    the small model of ``make(dtype) -> (StepperConfig, DatasetInfo)`` on
    ``device``
    and the CPU from the same weights (``flagship.draw_check_weights``) and
    inputs (``inputs(stepper, generator) -> (ic, forcing, batch)``, drawn
    on the CPU); ``prepare(train_stepper)`` runs on each side before;
    ``labels`` (on the CPU) go to the train step.

    Each output is held within ``out_tol`` of its spatial anomaly plus
    1e-5 of its largest value (the dry-air target: a float32 global mean
    of ~1e5 Pa rounds differently on the two devices), over the cells
    where it is not NaN, which must be the same on both sides. With
    ``stepwise`` (which needs the noise fixed by ``prepare``, or none),
    each step after the first is held against the CPU's step from the
    card's state before it, not against the CPU's rollout, which the
    first step's rounding has moved by then. Each gradient is held within ``grad_tol`` of its norm plus 1e-6 of the largest
    gradient's norm plus, in bf16, twice its own distance on the CPU from
    the float32 model's gradient: the instance norms make some gradients
    sums whose terms cancel to a small fraction of them, which keep the
    bf16 rounding of those terms on the card and on the CPU alike. A
    bias that adds a per-channel constant which an instance norm removes
    (``zero_gradients(names)``) has a true gradient of zero, and each
    side's is held below ``grad_tol`` of the largest gradient's norm.
    Returns the card's launches."""
    import torch

    from ace_tpu_torch import flagship
    from ace_tpu_torch.core.loss import StepLossConfig
    from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.stepper.train import StepperTrainConfig, TrainStepper

    def train_stepper(config, info, dev):
        return TrainStepper(
            config.get_stepper(info, device=dev),
            StepperTrainConfig(n_forward_steps=n_steps, loss=from_dict(
                StepLossConfig, loss_config or {"type": "MSE"}),
                n_ensemble=n_ensemble),
            OptimizationConfig(lr=1e-4, optimizer_type="AdamW"),
            EMAConfig())

    config, info = make(dtype)
    sides = [train_stepper(config, info, dev) for dev in ("cpu", device)]
    if prepare is not None:
        for ts in sides:
            prepare(ts)
    gen = torch.Generator().manual_seed(3)
    flagship.draw_check_weights(sides[0].stepper, gen)
    weights = sides[0].module.state_dict()
    sides[1].stepper.load_state_dict(weights)
    ic, forcing, batch = inputs(sides[0].stepper, gen)
    out = []
    for ts in sides:
        dev = ts.stepper.device

        def run():
            moved = type(ic)(data={k: v.to(dev) for k, v in ic.data.items()})
            outputs, _ = ts.stepper.predict(
                moved, {k: v.to(dev) for k, v in forcing.items()})
            loss, grads = flagship.train_gradients(
                ts, {k: v.to(dev) for k, v in batch.items()},
                labels=None if labels is None else labels.to(dev))
            return outputs, loss, grads

        out.append(counted(counters, run))
    (ref, ref_loss, ref_grads), _ = out[0]
    (res, loss, grads), launches = out[1]
    noise = {k: 0.0 for k in ref_grads}
    if dtype == "bfloat16":
        f32_config, _ = make("float32")
        f32 = train_stepper(f32_config, info, "cpu")
        if prepare is not None:
            prepare(f32)
        f32.stepper.load_state_dict(weights)
        _, f32_grads = flagship.train_gradients(f32, batch, labels=labels)
        noise = {k: float((r.double() - f32_grads[k].double()).norm())
                 for k, r in ref_grads.items()}
    out_tol, loss_tol, grad_tol = tols
    gated = ref
    if stepwise:
        # each step after the first against the CPU's step from the card's
        # state before it (with the noise fixed, the CPU's step from its
        # own state is within 0.01 of the allowed of its rollout's: PRESsfc
        # rounds apart)
        gated = {k: v.clone() for k, v in ref.items()}
        for t in range(1, next(iter(ref.values())).shape[1]):
            state = type(ic)(data={k: res[k][:, t - 1:t].cpu()
                                   for k in ic.data})
            one, _ = sides[0].stepper.predict(
                state, {k: v[:, t:t + 2] for k, v in forcing.items()})
            for k in gated:
                gated[k][:, t] = one[k][:, 0]

    def ratio(got, r):
        """Each output's error over the allowed, ``[batch, time]``, or
        None where the NaN cells differ."""
        got, r = got.float().cpu(), r.float()
        if not torch.equal(torch.isnan(r), torch.isnan(got)):
            return None
        anomaly = (r - r.nanmean((-2, -1), keepdim=True)).abs().nan_to_num(
            0.0).amax((-2, -1))
        err = (got - r).abs().nan_to_num(0.0).amax((-2, -1))
        allowed = (out_tol * anomaly
                   + 1e-5 * r.abs().nan_to_num(0.0).amax((-2, -1)))
        return err / allowed

    ratios = {}
    for k, r in gated.items():
        found = ratio(res[k], r)
        ratios[k] = math.inf if found is None else float(found.max())
    worst_out = max(ratios, key=ratios.get)
    if stepwise:
        # the card's later steps against the CPU's rollout, and the CPU's
        # step from the card's state against it: the first step's rounding
        # carried through the model (both on the CPU)
        later = [max(float(x[:, 1:].max()) for x in
                     (ratio(a[k], ref[k]) for k in ref) if x is not None)
                 for a in (res, gated)]
        print(f"{label}: later steps against the CPU's rollout: {device} "
              f"{later[0]:.3g}, the CPU's step from the {device}'s state "
              f"{later[1]:.3g} of the allowed")
    loss_err = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    largest = max(float(r.double().norm()) for r in ref_grads.values())
    zero = zero_gradients(ref_grads)
    gerrs = {k: float((grads[k].double().cpu() - r.double()).norm())
             / (grad_tol * float(r.double().norm()) + 1e-6 * largest
                + 2 * noise[k])
             for k, r in ref_grads.items() if k not in zero}
    for k in zero:
        gerrs[k] = max(float(g[k].double().norm()) for g in (grads, ref_grads)
                       ) / (grad_tol * largest)
    rel = flagship.gradient_error(grads, ref_grads)
    worst = sorted(gerrs, key=gerrs.get, reverse=True)[:3]
    shown = worst + sorted(k for k in gerrs if k.endswith("filter.weight")
                           and k not in worst)
    print(f"{label}: {device} vs CPU: rollout error "
          f"{ratios[worst_out]:.3g} of the allowed ({worst_out}; {out_tol} of "
          f"the anomaly + 1e-5 of the largest value); loss {float(loss):.6g} "
          f"/ {float(ref_loss):.6g}, relative error {loss_err:.3g} (tol "
          f"{loss_tol}); gradients, largest errors of the allowed, then the "
          f"filters': "
          + ", ".join(f"{k} {gerrs[k]:.3g} (relative L2 {rel[k]:.3g}, norm "
                      f"{float(ref_grads[k].norm()) / largest:.2g} of the "
                      f"largest, CPU bf16 vs f32 {noise[k] / largest:.2g})"
                      for k in shown)
          + f" (tol {grad_tol} of the norm + 1e-6 of the largest + twice "
          f"the CPU's bf16 distance from f32) over {len(rel)} parameters; "
          f"launches {launches}")
    if not (ratios[worst_out] <= 1 and loss_err <= loss_tol
            and gerrs[worst[0]] <= 1):
        raise AssertionError(f"{label}: the card disagrees with the CPU")
    return launches


def reference_sfno_phase(counters, device="cuda", embed=128):
    """Reference phase S: a small SFNO of path S's shape (embed 128, 2
    layers, 16x32) on ``device`` against the CPU: float32 (the einsums,
    both sides full float32) within ``S_F32_*``; bfloat16 (K1, 1b, 1c on
    the card against their plain versions on the CPU) within
    ``flagship.CHECK_TOL`` and the train step's limits; the diagonal
    operator and the FFT transform in float32. Returns the bf16 case's
    launches."""
    from ace_tpu_torch import flagship

    f32 = (S_F32_TOL, S_F32_LOSS_TOL, S_F32_GRAD_TOL)
    none = {c.__name__: 0 for c in counters}
    cuda = device != "cpu"
    for label, builder in (("f32 dhconv", {}),
                           ("f32 diagonal", {"operator_type": "diagonal"}),
                           ("f32 fft", {"spectral_transform": "fft"})):
        launches = _reference_s_case(label, counters, device, "float32",
                                     builder, f32, embed)
        if launches != none:
            raise AssertionError(f"reference S ({label}): launches "
                                 f"{launches}")
    launches = _reference_s_case(
        "bf16 dhconv", counters, device, "bfloat16", {},
        (flagship.CHECK_TOL, flagship.TRAIN_LOSS_TOL,
         flagship.TRAIN_GRAD_TOL), embed)
    # 2 rollout steps and 2 loss steps of 2 blocks: K1 in each forward,
    # 1b and 1c in each backward
    want = none if not cuda else {**none, "dhconv_filter": 8,
                                  "dhconv_filter_dx": 4,
                                  "dhconv_filter_dw": 4}
    if launches != want:
        raise AssertionError(f"reference S (bf16): launches {launches}, "
                             f"want {want}")
    return launches


def shield_paths(counters, smi, sizes=None, device="cuda"):
    """Reference phase S, then paths S-R, S-I and S-bf16: the launches of
    each. ``sizes`` (``nlat``, ``nlon``, ``embed``, ``layers``) makes the
    small copies the CPU runs (the reference phase at that embed)."""
    reference_sfno_phase(counters, device, (sizes or {}).get("embed", 128))
    print(smi)
    out = {}

    def then(paths, config, best):
        print(smi)
        out["S-I"], _ = shield_inference_path(counters, paths, best,
                                              device=device)
        print(smi)
        out["S-bf16"], _, _ = shield_bf16_path(counters, paths, config,
                                               device=device)

    out["S-R"], _ = shield_train_path(counters, device=device, sizes=sizes,
                                      then=then)
    return out


SOM_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                       "baselines", "shield-som")
SOM_TRAIN = os.path.join(SOM_DIR, "ace-train-config.yaml")
SOM_INFERENCE = os.path.join(
    SOM_DIR, "ace-abrupt-4xCO2-inference-ensemble-config.yaml")
SOM_EVALUATOR = os.path.join(SOM_DIR, "ace-2pctCO2-evaluator-config.yaml")
# path M-bf16's and reference M's multi-call: CO2 quadrupled, the six
# radiative fluxes kept under the suffix
M_FLUXES = ["ULWRFtoa", "USWRFtoa", "DLWRFsfc", "ULWRFsfc", "DSWRFsfc",
            "USWRFsfc"]
M_MULTI_CALL = {"forcing_name": "global_mean_co2",
                "forcing_multipliers": {"_4xCO2": 4.0},
                "output_names": M_FLUXES}
# batch 2 for both loaders (the YAML: 16 and 32); each subset of the
# training concat reads its own file of 4 six-hourly times inside its
# range (2 windows of the YAML's 2 forward steps: 4 batches, one epoch),
# each validation subset 3 times (1 batch); one file of N_STEPS + 1 times
# from the YAML's first inline start for the inline entry (4 steps from
# that start and the time after it) and path M-bf16's rollout
M_BATCH = 2
M_SPLITS = (("subset_0", 4, "2031-01-01T06:00"),
            ("subset_1", 4, "2073-01-01T06:00"),
            ("valid_0", 3, "2059-01-01T06:00"),
            ("valid_1", 3, "2071-01-01T06:00"),
            ("inference", N_STEPS + 1, "2031-01-01T06:00"))
M_INFERENCE_STEPS = 4
M_INFERENCE_TIMES = ["2031-01-01T06:00:00", "2031-01-01T12:00:00"]
# path M-I: its first 4 of the YAML's 36 monthly initial conditions
M_I_STARTS = 4
M_BF16_STEPS = 3
# the slab-SST gate: the largest error over the SST's largest value
M_SLAB_TOL = 1e-6
# path M-bf16: a suffixed output against a call of the wrapped step with
# the forcing scaled, over the field's largest value
M_MULTI_CALL_TOL = 1e-6


def _som_names():
    step = _yaml(SOM_TRAIN)["stepper"]["step"]["config"]["wrapped_step"][
        "config"]
    slab = step["ocean"]["slab"]
    return sorted(set(step["in_names"]) | set(step["out_names"])
                  | {slab["mixed_layer_depth_name"], slab["q_flux_name"]})


def _som_dataset(entry, path):
    """A dataset entry of the SOM YAMLs over a synthetic netCDF directory
    (the YAMLs read zarr stores that are not in the repo)."""
    entry.update(data_path=path, file_pattern="data.nc", engine="netcdf4")


def _som_config(paths, experiment_dir, tmp, names, sizes=None):
    """The shipped ACE2-SOM training config with path M-R's cuts: each
    subset of both loaders' ``concat`` reads its own synthetic file (times
    inside the subset), batch ``M_BATCH``, one epoch, the stats files, one
    inline entry of ``M_INFERENCE_STEPS`` steps from the YAML's first
    initial condition and the time after it, no Weights & Biases;
    ``sizes`` (``embed``, ``layers``) makes the small copies the CPU runs."""
    config = _yaml(SOM_TRAIN)
    config["experiment_dir"] = experiment_dir
    config["max_epochs"] = 1
    config["logging"].update(log_to_wandb=False, log_to_screen=False)
    for loader, prefix in (("train_loader", "subset"),
                           ("validation_loader", "valid")):
        for i, entry in enumerate(config[loader]["dataset"]["concat"]):
            _som_dataset(entry, paths[f"{prefix}_{i}"])
        config[loader]["batch_size"] = M_BATCH
    step = config["stepper"]["step"]["config"]["wrapped_step"]["config"]
    norm = step["normalization"]
    norm["network"] = {"global_means_path": paths["centering"],
                       "global_stds_path": paths["scaling-full-field"]}
    norm["residual"] = {"global_means_path": paths["centering"],
                        "global_stds_path": paths["scaling-residual"]}
    if sizes:
        step["builder"]["config"].update(embed_dim=sizes["embed"],
                                         num_layers=sizes["layers"])
    (entry,) = config["inference"]
    entry.update(n_forward_steps=M_INFERENCE_STEPS,
                 forward_steps_in_memory=M_INFERENCE_STEPS)
    _som_dataset(entry["loader"]["dataset"], paths["inference"])
    entry["loader"]["start_indices"]["times"] = M_INFERENCE_TIMES
    return config


def som_train_path(counters, device="cuda", sizes=None, then=None):
    """Path M-R: ``python -m ace_tpu_torch.train``'s ``main`` on
    ``configs/baselines/shield-som/ace-train-config.yaml`` (the multi-call
    wrapper with ``config: null``, the slab ocean, the energy-budget
    corrector with 1.14 W/m2 of unaccounted heating) with the cuts of
    ``_som_config`` (at its full width, embed 384, 8 layers, 180x360,
    float32, unless ``sizes`` gives ``nlat``, ``nlon``, ``embed`` and
    ``layers``) over synthetic files of its 59 variables, the six fluxes'
    suffixed targets of path M-bf16 beside them, through
    ``_recipe_train_path``."""
    from ace_tpu_torch.core.step.multi_call import get_multi_call_name

    names = _som_names()
    suffix, = M_MULTI_CALL["forcing_multipliers"]
    targets = [get_multi_call_name(n, suffix) for n in M_FLUXES]
    return _recipe_train_path("path M-R", SOM_TRAIN, names + targets,
                              M_SPLITS, _som_config, M_BATCH, counters,
                              device, sizes, then)


def _write_series(path, series, time, nz=8):
    """``series`` (``{name: [time, lat, lon]}``) as a netCDF file at
    ``path``, with the grid and a vertical coordinate of ``nz`` levels."""
    import numpy as np

    from ace_tpu_torch.core.coordinates import gaussian_latitudes
    from ace_tpu_torch.data.store import write_h5

    _, nlat, nlon = next(iter(series.values())).shape
    data = dict(series)
    dims = {k: ("time", "lat", "lon") for k in data}
    ak = np.concatenate([np.linspace(100.0, 5000.0, nz // 2),
                         np.linspace(5000.0, 0.0, nz // 2 + 1)])
    for i, (a, b) in enumerate(zip(ak, np.linspace(0.0, 1.0, nz + 1))):
        data[f"ak_{i}"], data[f"bk_{i}"] = np.float32(a), np.float32(b)
        dims[f"ak_{i}"] = dims[f"bk_{i}"] = ()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_h5(path, data, dims,
             coords={"lat": gaussian_latitudes(nlat),
                     "lon": np.linspace(0, 360, nlon, endpoint=False)},
             time=time)
    return path


def _recording(cls, name, records):
    """A context in which each call of ``cls.name`` appends its arguments
    and result to ``records`` (references: nothing waits for the
    device)."""
    import contextlib

    original = getattr(cls, name)

    def recorded(self, *args, **kwargs):
        result = original(self, *args, **kwargs)
        records.append((args, result))
        return result

    @contextlib.contextmanager
    def context():
        setattr(cls, name, recorded)
        try:
            yield
        finally:
            setattr(cls, name, original)

    return context()


def _slab_error(records, timestep):
    """The largest error, over the SST's largest value, of the SST the
    ocean wrote against ``f (SST_in + dt (F_net + q) / (rho c h)) + (1 -
    f) SST_gen`` evaluated on the host in float64 from each recorded
    call's own input, output and forcing tensors (``f`` the next step's
    ocean fraction: ``interpolate`` is on)."""
    import numpy as np

    from ace_tpu_torch.core.constants import (
        DENSITY_OF_WATER,
        SPECIFIC_HEAT_OF_WATER,
    )

    worst = 0.0
    for (input_data, gen, target), out in records:
        def host(d, k):
            return d[k].detach().double().cpu().numpy()

        f_net = (host(gen, "DSWRFsfc") - host(gen, "USWRFsfc")
                 + host(gen, "DLWRFsfc") - host(gen, "ULWRFsfc")
                 - host(gen, "LHTFLsfc") - host(gen, "SHTFLsfc"))
        frac = host(target, "ocean_fraction")
        slab = host(input_data, "surface_temperature") + timestep * (
            f_net + host(target, "prescribed_qflux")) / (
            DENSITY_OF_WATER * SPECIFIC_HEAT_OF_WATER
            * host(target, "prescribed_mixed_layer_depth"))
        want = frac * slab + (1 - frac) * host(gen, "surface_temperature")
        got = host(out, "surface_temperature")
        worst = max(worst, float(np.abs(got - want).max()
                                 / np.abs(want).max()))
    return worst


def som_inference_files(tmp, stepper, device, n_steps=N_STEPS,
                        n_starts=M_I_STARTS, seed=13):
    """Path M-I's synthetic files under ``tmp``, drawn from ``seed`` on
    ``device``: the prognostic variables of ``stepper`` at the first
    ``n_starts`` initial conditions of the inference YAML (one file at
    those times), and its forcing variables every 6 hours from the first
    to ``n_steps`` steps after the last. Returns the paths, the times,
    the host arrays and each start's offset into the forcing."""
    import numpy as np
    import torch

    from ace_tpu_torch.data.time import TimeCoord, parse_datetime_string

    nlat, nlon = stepper.dataset_info.img_shape
    times = _yaml(SOM_INFERENCE)["initial_condition"]["start_indices"][
        "times"][:n_starts]
    micros = np.asarray([parse_datetime_string(t) for t in times])
    offsets = [int((m - micros[0]) // (21600 * 10**6)) for m in micros]
    n_times = offsets[-1] + n_steps + 1
    gen = torch.Generator(device).manual_seed(seed)
    ic = {k: _draw(k, (n_starts, nlat, nlon), gen, device).cpu().numpy()
          for k in stepper.prognostic_names}
    forcing = {k: _draw(k, (n_times, nlat, nlon), gen, device).cpu().numpy()
               for k in stepper.forcing_window_names}
    ic_path = _write_series(os.path.join(tmp, "ic", "data.nc"), ic,
                            TimeCoord(micros))
    forcing_dir = os.path.dirname(_write_series(
        os.path.join(tmp, "forcing", "data.nc"), forcing,
        TimeCoord.from_range(times[0], n_times, 21600)))
    return dict(ic_path=ic_path, forcing_dir=forcing_dir, times=times,
                ic=ic, forcing=forcing, offsets=offsets)


def som_inference_config(path, out_dir, ckpt, files, n_steps, save):
    """The ACE2-SOM inference YAML with path M-I's cuts (``files`` of
    ``som_inference_files``, ``n_steps`` steps, ``save``: the prediction
    files on), written to ``path``."""
    config = _yaml(SOM_INFERENCE)
    config.update(experiment_dir=out_dir, checkpoint_path=ckpt,
                  n_forward_steps=n_steps)
    config["logging"].update(log_to_wandb=False, log_to_screen=False)
    _som_dataset(config["forcing_loader"]["dataset"], files["forcing_dir"])
    config["initial_condition"].update(path=files["ic_path"],
                                       engine="netcdf4")
    config["initial_condition"]["start_indices"]["times"] = files["times"]
    config["data_writer"]["save_prediction_files"] = save
    return _write_yaml(path, config)


def som_inference_path(counters, ckpt, device="cuda", n_steps=N_STEPS,
                       n_starts=M_I_STARTS):
    """Path M-I: ``python -m ace_tpu_torch.inference``'s ``main`` on
    ``configs/baselines/shield-som/ace-abrupt-4xCO2-inference-ensemble-config.yaml``
    over path M-R's ``best_ckpt.msgpack``: its ``stepper_override`` (no
    multi-call), its ``overwrite.constant`` of ``global_mean_co2`` on the
    forcing, its windows of 1 step and its writer; cut to ``n_steps``
    steps from its first ``n_starts`` initial conditions (one batch), over
    ``som_inference_files``. Checks no launch, no synchronizing call in
    ``run_inference``, then (a second run with the prediction files on)
    every step's forcing ``global_mean_co2`` equal to the constant, the
    slab SST of every step within ``M_SLAB_TOL`` (``_slab_error``), and
    the written predictions within 1e-5 of each channel's spatial std of
    one ``Stepper.predict``. Returns the launches and the rate."""
    import tempfile

    import numpy as np
    import torch

    from ace_tpu_torch.core.ocean import Ocean
    from ace_tpu_torch.core.step.single_module import SingleModuleStep
    from ace_tpu_torch.data.store import open_file_dataset
    from ace_tpu_torch.inference.inference import main as inference_main
    from ace_tpu_torch.stepper import checkpoint
    from ace_tpu_torch.stepper.stepper import (
        PrognosticState,
        StepperOverrideConfig,
    )

    check_sync = torch.device(device).type == "cuda"
    base = _yaml(SOM_INFERENCE)
    override = StepperOverrideConfig(**base["stepper_override"])
    stepper = checkpoint.load_stepper(ckpt, override=override, device=device)
    co2 = base["forcing_loader"]["dataset"]["overwrite"]["constant"][
        "global_mean_co2"]
    with tempfile.TemporaryDirectory() as tmp:
        files = som_inference_files(tmp, stepper, device, n_steps, n_starts)
        runs, steps, oceans = {}, [], []
        for save in (False, True):
            path = som_inference_config(
                os.path.join(tmp, f"m_i_{save}.yaml"),
                os.path.join(tmp, f"out_{save}"), ckpt, files, n_steps, save)
            if save:
                with (_recording(SingleModuleStep, "step", steps),
                      _recording(Ocean, "__call__", oceans)):
                    runs[save] = _timed_run(
                        counters, lambda: inference_main([path],
                                                         device=device),
                        False)
            else:
                runs[save] = _timed_run(
                    counters, lambda: inference_main([path], device=device),
                    check_sync)
        ds = open_file_dataset(os.path.join(
            tmp, "out_True", "autoregressive_predictions.nc"))
        written = {k: ds[k].read(()) for k in ds.keys()}
    co2_seen = {float(v) for (args,), _ in steps
                for v in args.input["global_mean_co2"].unique().cpu()}
    slab = _slab_error(oceans, stepper.dataset_info.timestep.total_seconds())
    forcing, offsets = files["forcing"], files["offsets"]
    forcing["global_mean_co2"][:] = co2
    ref, _ = stepper.predict(
        PrognosticState(data={k: torch.as_tensor(v[:, None]).to(device)
                              for k, v in files["ic"].items()}),
        {k: torch.as_tensor(np.stack([v[o:o + n_steps + 1]
                                      for o in offsets])).to(device)
         for k, v in forcing.items()},
        generator=torch.Generator(device).manual_seed(0))
    errs = {}
    for k in stepper.out_names:
        r = ref[k].float()
        out = torch.as_tensor(written[k]).to(r.device)
        if out.shape != r.shape:
            raise AssertionError(f"path M-I: {k} written as "
                                 f"{tuple(out.shape)}")
        err = float((out - r).abs().max())
        errs[k] = err / float(r.std(dim=(-2, -1)).mean()) if err else 0.0
    worst = max(errs, key=errs.get)
    summary, launches, phases, peak = runs[False]
    rate = summary["total_steps_per_second"]
    print(f"path M-I: {SOM_INFERENCE}: {summary['total_steps']} sample-steps "
          f"({n_steps} steps of {n_starts} initial conditions "
          f"{files['times']}) at {rate:.4f} sample-steps/s (windows of "
          f"{base['forward_steps_in_memory']}, the YAML's writer; "
          f"{runs[True][0]['total_steps_per_second']:.4f} with the prediction "
          f"files on); phases "
          f"{ {k: round(v, 4) for k, v in sorted(phases.items())} }; peak "
          f"device memory {peak:.2f} GB; launches {launches}")
    print(f"path M-I: forcing global_mean_co2 {sorted(co2_seen)} in "
          f"{len(steps)} steps (want {co2}); slab SST of {len(oceans)} "
          f"steps: largest error {slab:.3g} of the SST (tol {M_SLAB_TOL}); "
          f"written predictions vs one {n_steps}-step predict: largest "
          f"error {errs[worst]:.3g} of the channel's spatial std ({worst}; "
          f"tol 1e-5)")
    if launches != {c.__name__: 0 for c in counters}:
        raise AssertionError(f"path M-I: launches {launches}")
    if co2_seen != {float(np.float32(co2))} or len(steps) != n_steps:
        raise AssertionError("path M-I: the forcing's global_mean_co2 is not "
                             "the overwrite constant")
    if not (len(oceans) == n_steps and slab <= M_SLAB_TOL):
        raise AssertionError("path M-I: the slab SST disagrees")
    if not errs[worst] <= 1e-5:
        raise AssertionError("path M-I: the written predictions disagree "
                             "with Stepper.predict")
    return launches, rate


def _override_multi_call(stepper, config, multi_call, device):
    """A stepper of ``config`` (a ``StepperConfig``) with
    ``stepper_override.multi_call`` set to ``multi_call``, holding
    ``stepper``'s weights."""
    import json

    from ace_tpu_torch.stepper.stepper import (
        StepperConfig,
        StepperOverrideConfig,
    )

    state = StepperOverrideConfig(multi_call=multi_call).apply(
        json.loads(json.dumps(config.get_state())))
    out = StepperConfig.from_state(state).get_stepper(stepper.dataset_info,
                                                      device=device)
    out.load_state_dict(stepper.module.state_dict())
    return out


def _dhconv_filters(module):
    """The number of dhconv filters in ``module`` (each launches K1 once
    per call, and 1b and 1c once per backward, in bf16)."""
    from ace_tpu_torch.models.sfno import SpectralConvS2

    return sum(isinstance(m, SpectralConvS2) and m.operator_type == "dhconv"
               and not m.separable for m in module.modules())


def som_bf16_path(counters, paths, config, device="cuda", n_steps=N_STEPS,
                  train_steps=M_BF16_STEPS):
    """Path M-bf16: path M-R's config with ``compute_dtype: bfloat16`` and
    the multi-call ``M_MULTI_CALL`` in the loss
    (``include_multi_call_in_loss``; its six suffixed targets are in the
    synthetic files), batch 1, built through ``TrainConfig.build_trainer``:
    a warm-up train step and ``train_steps`` more on one batch (2 forward
    steps of 2 calls: 4 K1, 1b and 1c per filter, no synchronizing call);
    then an ``n_steps``-step rollout with the multi-call set through
    ``stepper_override.multi_call`` (2 K1 per filter and step), whose
    suffixed outputs of the first step equal a 1-step rollout of the
    wrapped step with ``global_mean_co2`` x 4 within
    ``M_MULTI_CALL_TOL``. Returns the launches of both and their rates."""
    import copy

    import torch

    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.core.step.multi_call import get_multi_call_name
    from ace_tpu_torch.stepper.stepper import PrognosticState
    from ace_tpu_torch.train.trainer import TrainConfig

    cuda = torch.device(device).type == "cuda"
    config = copy.deepcopy(config)
    step = config["stepper"]["step"]["config"]
    step.update(config=M_MULTI_CALL, include_multi_call_in_loss=True)
    step["wrapped_step"]["config"]["builder"]["config"]["compute_dtype"] = (
        "bfloat16")
    config["train_loader"]["batch_size"] = 1
    trainer = from_dict(TrainConfig, config).build_trainer(device=device)
    ts = trainer.train_stepper
    ts.init(torch.Generator(device).manual_seed(0))
    filters = _dhconv_filters(ts.module)
    calls = 1 + len(M_MULTI_CALL["forcing_multipliers"])
    batch = next(iter(trainer.train_data)).data
    gen = trainer.generator
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    first = ts.train_step(batch, gen)
    steps = []

    def train():
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = ts.train_step(batch, gen)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for _ in range(train_steps):
        steps.append(counted(counters, train))
    train_peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    losses = [float(first["loss"])] + [float(m["loss"]) for (m, _), _ in
                                       steps]
    loss_names = ts.step_loss.loss.out_names
    rate = len(steps) / sum(s for (_, s), _ in steps)

    stepper = _override_multi_call(ts.stepper, trainer.config.stepper,
                                   M_MULTI_CALL, device)
    wrapped = _override_multi_call(ts.stepper, trainer.config.stepper,
                                   None, device)
    del trainer, ts
    gc.collect()
    names = sorted(set(stepper.prognostic_names)
                   | set(stepper.forcing_window_names))
    series = _read_series(paths["inference"], names)
    ic = PrognosticState(data={
        k: torch.as_tensor(series[k][None, :1]).to(device)
        for k in stepper.prognostic_names})
    forcing = {k: torch.as_tensor(series[k][None, :n_steps + 1]).to(device)
               for k in stepper.forcing_window_names}
    stepper.predict(ic, {k: v[:, :2] for k, v in forcing.items()})
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def rollout():
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            outputs, _ = stepper.predict(ic, forcing)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
        return outputs, time.perf_counter() - t0

    (outputs, seconds), launches_r = counted(counters, rollout)
    roll_peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    finite = all(bool(torch.isfinite(v).all()) for v in outputs.values())
    scaled = dict(forcing)
    name = M_MULTI_CALL["forcing_name"]
    (suffix, multiplier), = M_MULTI_CALL["forcing_multipliers"].items()
    scaled[name] = multiplier * forcing[name]
    alone, _ = wrapped.predict(ic, {k: v[:, :2] for k, v in scaled.items()})
    errs = {}
    for k in M_FLUXES:
        want = alone[k][:, 0].float()
        got = outputs[get_multi_call_name(k, suffix)][:, 0].float()
        errs[k] = float((got - want).abs().max() / want.abs().max())
    worst = max(errs, key=errs.get)
    none = {c.__name__: 0 for c in counters}
    per_call = 2 * calls * filters  # 2 forward steps
    want_t = none if not cuda else {
        **none, "dhconv_filter": per_call, "dhconv_filter_dx": per_call,
        "dhconv_filter_dw": per_call}
    want_r = none if not cuda else {
        **none, "dhconv_filter": calls * filters * n_steps}
    print(f"path M-bf16: {len(steps)} train steps at batch 1 (2 forward "
          f"steps of {calls} calls, {len(loss_names)} loss variables) "
          f"{rate:.4f} train steps/s, peak {train_peak:.2f} GB; losses "
          f"{[round(v, 6) for v in losses]} (warm-up, the steps); launches "
          f"per train step {[n for _, n in steps]} (want {want_t})")
    print(f"path M-bf16: {n_steps}-step rollout {n_steps / seconds:.4f} "
          f"steps/s at batch 1, peak {roll_peak:.2f} GB, outputs finite "
          f"{finite}; launches {launches_r} (want {want_r}); first step's "
          f"suffixed outputs vs the wrapped step with {name} x "
          f"{multiplier}: largest error {errs[worst]:.3g} of the field "
          f"({worst}; tol {M_MULTI_CALL_TOL})")
    del stepper, wrapped
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if not (all(map(math.isfinite, losses)) and finite):
        raise AssertionError("path M-bf16: a loss or an output is not finite")
    if not all(get_multi_call_name(k, suffix) in loss_names
               for k in M_FLUXES):
        raise AssertionError("path M-bf16: the suffixed outputs are not in "
                             "the loss")
    if not errs[worst] <= M_MULTI_CALL_TOL:
        raise AssertionError("path M-bf16: a suffixed output disagrees with "
                             "the wrapped step's call")
    if any(n != want_t for _, n in steps) or launches_r != want_r:
        raise AssertionError("path M-bf16: launches")
    total = {k: sum(n[k] for _, n in steps) + launches_r[k] for k in none}
    return total, rate, n_steps / seconds


def _som_stats(name):
    """(mean, std) of a variable's normalization in reference M: those of
    its synthetic draw (``_field_scale``), the ocean fraction's of a
    fraction."""
    if name == "ocean_fraction":
        return 0.5, 0.3
    mean, std, _ = _field_scale(name)
    return mean, std


def som_step_configs(nlat=16, nlon=32, embed=64, layers=2,
                     compute_dtype="float32", nz=2):
    """Reference M's steps, at ``nz`` of the SOM recipe's levels: the
    SOM YAML's wrapped step (its SphericalFourierNeuralOperatorNet at
    ``embed`` and ``layers``, the slab ocean, its corrector) with explicit
    statistics, inside each step type and option path M's slice ports.
    Returns ``{case: step selector dict}`` and the port's dataset info;
    the dicts build in both packages."""
    import copy
    import re

    from ace_tpu_torch import flagship

    def keep(name):
        match = re.search(r"_(\d+)$", name)
        return match is None or int(match.group(1)) < nz

    base = copy.deepcopy(_yaml(SOM_TRAIN)["stepper"]["step"]["config"][
        "wrapped_step"]["config"])
    for key in ("in_names", "out_names"):
        base[key] = [n for n in base[key] if keep(n)]
    corrector = base["corrector"]
    corrector["force_positive_names"] = [
        n for n in corrector["force_positive_names"] if keep(n)]
    base["builder"]["config"].update(embed_dim=embed, num_layers=layers,
                                     compute_dtype=compute_dtype)
    names = sorted(set(base["in_names"]) | set(base["out_names"]))
    stats = {k: _som_stats(k) for k in names}
    means = {k: m for k, (m, _) in stats.items()}
    base["normalization"] = {
        "network": {"means": means, "stds": {k: s for k, (_, s) in
                                             stats.items()}},
        "residual": {"means": means, "stds": {k: 0.5 * s for k, (_, s) in
                                              stats.items()}}}
    decoded = ["TMP850", "h500"]
    decoder = {"secondary_diagnostic_names": decoded,
               "network": {"type": "MLP", "config": {"hidden_channels": 32}}}
    prognostic = sorted(set(base["in_names"]) & set(base["out_names"]))
    forcings = [n for n in base["in_names"] if n not in prognostic]
    diagnostics = [n for n in base["out_names"] if n not in prognostic]

    def single(**options):
        config = copy.deepcopy(base)
        if "secondary_decoder" in options:
            config["out_names"] = [n for n in config["out_names"]
                                   if n not in decoded]
        config.update(options)
        return {"type": "single_module", "config": config}

    def radiation(detach):
        only = ["DSWRFtoa", "global_mean_co2"]
        return {"type": "separate_radiation", "config": dict(
            builder=base["builder"], radiation_builder=base["builder"],
            main_prognostic_names=prognostic,
            shared_forcing_names=[n for n in forcings if n not in only],
            radiation_only_forcing_names=only,
            radiation_diagnostic_names=M_FLUXES,
            main_diagnostic_names=[n for n in diagnostics
                                   if n not in M_FLUXES],
            normalization=base["normalization"], ocean=base["ocean"],
            corrector=base["corrector"],
            next_step_forcing_names=base["next_step_forcing_names"],
            detach_radiation=detach, residual_prediction=True)}

    secondary = ["PRATEsfc", "TMP850"]
    cases = {
        "multi_call slab": {"type": "multi_call", "config": {
            "wrapped_step": single(), "config": M_MULTI_CALL,
            "include_multi_call_in_loss": True}},
        "per-channel global-mean removal, secondary decoder": single(
            global_mean_removal={
                "names": ["air_temperature_0", "air_temperature_1", "TMP2m"],
                "append_as_input": True},
            secondary_decoder=decoder),
        "shared global-mean removal, channel masks, input dropout": single(
            global_mean_removal={
                "names": ["TMP2m", "air_temperature_0", "air_temperature_1"],
                "mode": "shared", "reference_field": "TMP2m",
                "append_as_input": True},
            include_channel_mask_inputs=True,
            input_dropout={"default": {"max_masked_vars": 3},
                           "override_groups": [{
                               "variables": ["HGTsfc", "land_fraction"],
                               "masking": {"rate": 0.5}}]}),
        "separate_radiation": radiation(False),
        "separate_radiation detached": radiation(True),
        "secondary_module with a decoder": {
            "type": "secondary_module", "config": dict(
                builder=base["builder"], secondary_builder=base["builder"],
                in_names=base["in_names"],
                out_names=[n for n in base["out_names"]
                           if n not in secondary + ["h500"]],
                normalization=base["normalization"],
                secondary_out_names=secondary,
                secondary_residual_out_names=["Q2m"],
                secondary_decoder={**decoder,
                                   "secondary_diagnostic_names": ["h500"]},
                ocean=base["ocean"], corrector=base["corrector"],
                next_step_forcing_names=base["next_step_forcing_names"],
                residual_prediction=True)},
    }
    _, info = flagship.stepper_config(nlat, nlon, nz=nz)
    return cases, info


def som_inputs(stepper, n_steps, batch, generator):
    """A random initial condition, ``n_steps + 1`` forcing times and a
    training batch of 2 forward steps for ``stepper``, drawn with
    ``_draw`` (the slab's depths and q-fluxes in ``SLAB_DRAWS``' ranges)
    on the stepper's device."""
    from ace_tpu_torch.stepper.stepper import PrognosticState

    nlat, nlon = stepper.dataset_info.img_shape
    step = stepper.step

    def draw(name, n):
        return _draw(name, (batch, n, nlat, nlon), generator, stepper.device)

    ic = PrognosticState(data={k: draw(k, 1)
                               for k in stepper.prognostic_names})
    forcing = {k: draw(k, n_steps + 1)
               for k in stepper.forcing_window_names}
    data = {k: draw(k, 3) for k in
            sorted(set(step.input_names) | set(step.loss_names))}
    return ic, forcing, data


def fixed_dropout_presence(train_stepper, dropped=("HGTsfc", "TMP2m")):
    """Make an input-dropout step drop ``dropped`` in every train (not
    deterministic) call, whatever its generator draws: the card and the
    CPU then drop the same channels."""
    import torch

    step = train_stepper.stepper.step
    step = getattr(step, "wrapped", step)
    if getattr(step, "input_masking", None) is None:
        return
    device = step.device

    def presence(args):
        if args.deterministic:
            return None
        return {n: torch.tensor(n not in dropped, device=device)
                for n in step.in_packer.names}

    step.draw_input_dropout_presence = presence


def reference_som_phase(counters, device="cuda", embed=64, n_steps=4):
    """Reference phase M: each step of ``som_step_configs`` (embed
    ``embed``, 2 layers, 16x32) on ``device`` against the CPU through
    ``_reference_case``: an ``n_steps``-step rollout and one train step
    (MSE, 2 forward steps), float32 within ``S_F32_*`` and bfloat16
    within ``flagship.CHECK_TOL`` and the train step's limits (reference
    S's), input dropout's presence passed in (``fixed_dropout_presence``).
    On the card float32 launches nothing; bfloat16 launches per dhconv
    filter K1 once a call (a multi-call's 2 calls a step) and 1b and 1c
    once a call's backward. Returns the bf16 launches, by case."""
    from ace_tpu_torch import flagship
    from ace_tpu_torch.core.step import StepSelector
    from ace_tpu_torch.stepper.stepper import StepperConfig

    f32 = (S_F32_TOL, S_F32_LOSS_TOL, S_F32_GRAD_TOL)
    bf16 = (flagship.CHECK_TOL, flagship.TRAIN_LOSS_TOL,
            flagship.TRAIN_GRAD_TOL)
    none = {c.__name__: 0 for c in counters}
    cuda = device != "cpu"
    cases, _ = som_step_configs(embed=embed)
    out = {}
    for case in cases:
        def make(dtype, case=case):
            configs, info = som_step_configs(embed=embed,
                                             compute_dtype=dtype)
            return StepperConfig(step=StepSelector(**configs[case])), info

        for dtype, tols in (("float32", f32), ("bfloat16", bf16)):
            label = f"reference M ({case}, {dtype})"
            launches = _reference_case(
                label, counters, device, tols, make, dtype,
                lambda stepper, gen: som_inputs(stepper, n_steps, 2, gen),
                prepare=fixed_dropout_presence)
            config, info = make(dtype)
            stepper = config.get_stepper(info, device="cpu")
            filters = _dhconv_filters(stepper.module)
            multi_call = getattr(stepper.step.config, "config", None)
            calls = 1 + (len(multi_call.forcing_multipliers)
                         if multi_call is not None else 0)
            want = none
            if cuda and dtype == "bfloat16":
                per = calls * filters
                want = {**none, "dhconv_filter": per * (n_steps + 2),
                        "dhconv_filter_dx": 2 * per,
                        "dhconv_filter_dw": 2 * per}
            if launches != want:
                raise AssertionError(f"{label}: launches {launches}, want "
                                     f"{want}")
            if dtype == "bfloat16":
                out[case] = launches
    return out


def som_paths(counters, smi, sizes=None, device="cuda"):
    """Reference phase M, then paths M-R, M-I and M-bf16: the launches of
    each path. ``sizes`` (``nlat``, ``nlon``, ``embed``, ``layers``) makes
    the small copies the CPU runs (the reference phase at that embed)."""
    reference_som_phase(counters, device, (sizes or {}).get("embed", 64))
    out = {}
    print(smi)

    def then(paths, config, best):
        print(smi)
        out["M-I"], _ = som_inference_path(counters, best, device=device)
        print(smi)
        out["M-bf16"], _, _ = som_bf16_path(counters, paths, config,
                                            device=device)

    out["M-R"], _ = som_train_path(counters, device=device, sizes=sizes,
                                   then=then)
    return out


OCEAN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "configs", "baselines", "cm4-piControl",
                         "uncoupled-ocean")
OCEAN_TRAIN = os.path.join(OCEAN_DIR, "train-config.yaml")
OCEAN_EVALUATOR = os.path.join(OCEAN_DIR, "evaluator-config.yaml")
# the three stores of the YAMLs' merge lists, in their order: the ocean
# state with the depth coordinate and the masks, the sea ice and land
# fraction, the atmosphere's surface fluxes
O_SOURCES = ("coupled-ocean", "ocean", "atmosphere")
O_ICE_NAMES = ("HI", "ocean_sea_ice_fraction", "land_fraction")
O_LEVELS = 19
O_TIMESTEP = 5 * 86400
O_CALENDAR = "noleap"
# the share of the grid the synthetic land mask covers
O_LAND = 0.3
# batch 4 for both loaders (the YAML: 16); the training files hold 12
# five-daily times before the training subset's stop (8 windows of the
# YAML's 4 forward steps: 2 batches, one epoch), the validation files 8
# from its start (1 batch); the inline entry runs 4 steps (1440) from the
# YAML's first initial condition and the 7 times after it (8 initial
# conditions, as the YAML's 8 starts 20 years apart, which an evenly
# spaced file would need 10,225 times to hold); path O-E 20 steps (2920)
# from the evaluator's start
O_BATCH = 4
O_INFERENCE_STEPS = 4
O_INFERENCE_STARTS = 8
O_E_STEPS = 20
O_SPLITS = (("train", 12, "0305-01-01"), ("valid", 8, "0306-01-01"),
            ("inference", O_INFERENCE_STARTS + O_INFERENCE_STEPS,
             "0151-01-06"),
            ("evaluator", O_E_STEPS + 1, "0311-01-01"))
# the ocean's synthetic draws by prefix: (mean, std, kind), the mean a
# function of the cosine squared of the latitude ``c`` and, for the 3-D
# fields, of the level's depth ``z`` (m); thetao in degC, sst in K
O_DRAWS = {
    "thetao": (lambda c, z: 1.5 + (28.0 * c - 1.0) * math.exp(-z / 800.0),
               0.5, "normal"),
    "so": (lambda c, z: 34.0 + 2.0 * c * math.exp(-z / 800.0), 0.2,
           "positive"),
    "uo": (lambda c, z: 0.0, 0.1, "normal"),
    "vo": (lambda c, z: 0.0, 0.1, "normal"),
    "sst": (lambda c, z: 271.5 + 30.0 * c, 1.0, "normal"),
    "zos": (lambda c, z: 1.5 * c - 0.8, 0.1, "normal"),
    "HI": (lambda c, z: 2.0 * (1.0 - c) ** 4, 0.2, "positive"),
    "ocean_sea_ice_fraction": (lambda c, z: (1.0 - c) ** 4, 0.1,
                               "fraction"),
}


def _ocean_names():
    step = _yaml(OCEAN_TRAIN)["stepper"]["step"]["config"]
    return sorted(set(step["in_names"]) | set(step["out_names"]))


def ocean_grid_and_masks(nlat, nlon, seed=17):
    """The synthetic ocean's grid (1 degree cell centres at 180x360), and
    its depth coordinate and masks drawn from ``seed``: a smooth land mask
    over ``O_LAND`` of the grid, the sea floor ``deptho`` (NaN over land)
    uniform between the first interface below the surface and the last,
    interfaces ``idepth`` from 0 to 5500 m, and the per-level ``mask_N``
    (wet where the floor lies below the level's top: each level wet only
    where the one above is) with ``mask_2d`` the surface's."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lat = np.linspace(-90 + 90 / nlat, 90 - 90 / nlat, nlat)
    lon = (np.arange(nlon) + 0.5) * 360 / nlon
    coarse = torch.from_numpy(rng.standard_normal(
        (max(nlat // 10, 2), max(nlon // 10, 2))))
    field = torch.nn.functional.interpolate(
        coarse[None, None], size=(nlat, nlon), mode="bilinear",
        align_corners=False)[0, 0].numpy()
    ocean = field > np.quantile(field, O_LAND)
    idepth = (5500.0 * (np.arange(O_LEVELS + 1) / O_LEVELS) ** 2)
    floor = idepth[1] + (idepth[-1] - idepth[1]) * rng.random((nlat, nlon))
    deptho = np.where(ocean, floor, np.nan).astype(np.float32)
    masks = {f"mask_{k}": (ocean & (floor > idepth[k])).astype(np.float32)
             for k in range(O_LEVELS)}
    masks["mask_2d"] = masks["mask_0"]
    return {"lat": lat, "lon": lon}, idepth.astype(np.float32), deptho, masks


def _ocean_source(name):
    """The store of ``O_SOURCES`` that holds ``name``."""
    if name in O_ICE_NAMES:
        return "ocean"
    prefix, _, level = name.rpartition("_")
    if (prefix if level.isdigit() else name) in O_DRAWS:
        return "coupled-ocean"
    return "atmosphere"


def _ocean_draw(name, shape, generator, device, lat, idepth):
    """A synthetic field of ``name`` on latitudes ``lat`` (degrees):
    ``O_DRAWS``' draw for the ocean and ice (at the middle of the level's
    layer of ``idepth`` for the 3-D fields), ``_draw``'s for the
    fluxes."""
    import numpy as np
    import torch

    prefix, _, level = name.rpartition("_")
    key = prefix if level.isdigit() and prefix in O_DRAWS else name
    if key not in O_DRAWS:
        return _draw(name, shape, generator, device)
    mean_of, std, kind = O_DRAWS[key]
    depth = (0.5 * float(idepth[int(level)] + idepth[int(level) + 1])
             if key != name else 0.0)
    cos2 = np.cos(np.deg2rad(lat))[:, None] ** 2
    mean = torch.as_tensor(
        np.vectorize(lambda c: mean_of(c, depth))(cos2),
        dtype=torch.float32).to(device)
    v = torch.randn(shape, generator=generator, device=device) * std + mean
    if kind == "positive":
        return v.abs()
    if kind == "fraction":
        return v.clamp(0, 1)
    return v


def ocean_files(tmp, nlat, nlon, generator, device, splits=O_SPLITS,
                single=False, timestep=O_TIMESTEP):
    """The synthetic stores of the uncoupled-ocean YAMLs under ``tmp``:
    for each split of ``splits`` (name, number of five-daily times, first
    time) one netCDF file for each of ``O_SOURCES``, the ocean's with the
    depth coordinate (``idepth_N``, ``deptho``) and the masks, its fields
    NaN where their mask is 0; the ice's with the static land fraction;
    the atmosphere's fluxes finite everywhere; and the two stats files
    (from the training split, over the wet cells). Drawn from
    ``generator`` on ``device``; ``single`` writes the same draws as one
    file a split (what ``ace_tpu``'s loader reads: its merged loader
    fails). ``timestep`` is the seconds between times. Returns the paths
    (``paths[split][source]`` a directory) and the masks."""
    import numpy as np

    from ace_tpu_torch.core.masking import MaskProvider
    from ace_tpu_torch.data.store import write_h5
    from ace_tpu_torch.data.time import TimeCoord

    coords, idepth, deptho, masks = ocean_grid_and_masks(nlat, nlon)
    provider = MaskProvider(masks)
    by_source = {source: [n for n in _ocean_names()
                          if _ocean_source(n) == source
                          and n != "land_fraction"]
                 for source in O_SOURCES}
    paths, train = {}, {}
    for split, n, start in splits:
        time = TimeCoord.from_range(start, n, timestep, O_CALENDAR)
        paths[split], combined, combined_dims = {}, {}, {}
        for source in O_SOURCES:
            data, dims = {}, {}
            for name in by_source[source]:
                v = _ocean_draw(name, (n, nlat, nlon), generator, device,
                                coords["lat"], idepth).cpu().numpy()
                key = provider.mask_key_for(name)
                if source != "atmosphere" and key is not None:
                    v = np.where(masks[key] != 0, v, np.nan).astype(
                        np.float32)
                data[name], dims[name] = v, ("time", "lat", "lon")
            if split == "train":
                train.update(data)
            if source == "coupled-ocean":
                for k, m in {**masks, "deptho": deptho}.items():
                    data[k], dims[k] = m, ("lat", "lon")
                for i, z in enumerate(idepth):
                    data[f"idepth_{i}"], dims[f"idepth_{i}"] = z, ()
            if source == "ocean":
                land = 1.0 - masks["mask_2d"]
                data["land_fraction"], dims["land_fraction"] = land, (
                    "lat", "lon")
                if split == "train":
                    train["land_fraction"] = land[None]
            if single:
                combined.update(data)
                combined_dims.update(dims)
                data, dims = combined, combined_dims
                if source != O_SOURCES[-1]:
                    continue
            directory = os.path.join(tmp, split,
                                     "single" if single else source)
            os.makedirs(directory)
            write_h5(os.path.join(directory, "data.nc"), data, dims,
                     coords=coords, time=time)
            paths[split][source] = directory
        if single:
            paths[split] = dict.fromkeys(O_SOURCES, directory)
    for label, stat in (("centering", np.nanmean),
                        ("scaling-full-field", np.nanstd)):
        paths[label] = os.path.join(tmp, f"{label}.nc")
        values = {k: np.asarray(stat(v), np.float32) for k, v in train.items()}
        write_h5(paths[label], values, {k: () for k in values})
    return paths, masks


def _ocean_dataset(entries, split_paths):
    """Point each entry of a YAML's ``merge`` list at its synthetic store
    (the YAMLs read zarr stores that are not in the repo)."""
    for entry, source in zip(entries, O_SOURCES):
        entry.update(data_path=split_paths[source], file_pattern="data.nc",
                     engine="netcdf4")


def _ocean_config(paths, experiment_dir, tmp, names, sizes=None):
    """The shipped uncoupled-ocean training config with path O-R's cuts:
    each merge entry reads its synthetic store, batch ``O_BATCH``, one
    epoch, the stats files, the inline entry of ``O_INFERENCE_STEPS``
    steps from ``O_INFERENCE_STARTS`` initial conditions, no Weights &
    Biases; ``sizes`` (``ch_width``, ``dilation``) makes the small copies
    the CPU runs."""
    from ace_tpu_torch.data.time import TimeCoord, format_time

    config = _yaml(OCEAN_TRAIN)
    config["experiment_dir"] = experiment_dir
    config["max_epochs"] = 1
    config["logging"].update(log_to_wandb=False, log_to_screen=False)
    for loader, split in (("train_loader", "train"),
                          ("validation_loader", "valid")):
        _ocean_dataset(config[loader]["dataset"]["merge"], paths[split])
        config[loader]["batch_size"] = O_BATCH
    step = config["stepper"]["step"]["config"]
    step["normalization"]["network"] = {
        "global_means_path": paths["centering"],
        "global_stds_path": paths["scaling-full-field"]}
    if sizes:
        step["builder"]["config"].update(ch_width=sizes["ch_width"],
                                         dilation=sizes["dilation"])
    (entry,) = config["inference"]
    entry.update(n_forward_steps=O_INFERENCE_STEPS,
                 forward_steps_in_memory=O_INFERENCE_STEPS)
    loader = entry["loader"]
    _ocean_dataset(loader["dataset"]["merge"], paths["inference"])
    first = loader["start_indices"]["times"][0]
    starts = TimeCoord.from_range(first, O_INFERENCE_STARTS, O_TIMESTEP,
                                  O_CALENDAR)
    loader["start_indices"]["times"] = [
        format_time(t, O_CALENDAR) for t in starts.values]
    return config


def _ocean_probes(records, limit=8):
    """A context in which the first ``limit`` calls of every output masker
    (``MaskProvider.build_output_masker``'s) and every input masker
    (``StaticSpatialMaskingConfig.build``'s) a stepper builds append to
    ``records`` device counts, made without waiting for the device: for
    each masked output its cells whose NaN does not match a dry cell of
    its mask (or that are infinite), its negative cells for the
    corrector's ``force_positive_names`` and those outside [0, 1] for the
    sea-ice fraction (``("out", name, count)``); for each input after the
    input masking its non-finite cells (``("in", name, count)``)."""
    import contextlib

    import torch

    from ace_tpu_torch.core.masking import (
        MaskProvider,
        StaticSpatialMaskingConfig,
    )

    step = _yaml(OCEAN_TRAIN)["stepper"]["step"]["config"]
    positive = set(step["corrector"]["config"]["force_positive_names"])
    ice = step["corrector"]["config"]["sea_ice_fraction_correction"][
        "sea_ice_fraction_name"]
    build_out, build_in = (MaskProvider.build_output_masker,
                           StaticSpatialMaskingConfig.build)
    calls = {"out": 0, "in": 0}

    def output_masker(self, *args, **kwargs):
        masker = build_out(self, *args, **kwargs)

        def recorded(data):
            out = masker(data)
            calls["out"] += 1
            if calls["out"] <= limit:
                with torch.no_grad():
                    for name, v in out.items():
                        key = self.mask_key_for(name)
                        if key is None:
                            continue
                        dry = ~self.on_device(key, "wet", v.device)
                        bad = (torch.isnan(v) != dry) | torch.isinf(v)
                        if name in positive:
                            bad = bad | (v < 0)
                        if name == ice:
                            bad = bad | (v < 0) | (v > 1)
                        records.append(("out", name, bad.sum()))
            return out
        return recorded

    def input_masker(self, *args, **kwargs):
        masker = build_in(self, *args, **kwargs)

        def recorded(data):
            out = masker(data)
            calls["in"] += 1
            if calls["in"] <= limit:
                with torch.no_grad():
                    for name, v in out.items():
                        records.append(("in", name,
                                        (~torch.isfinite(v)).sum()))
            return out
        return recorded

    @contextlib.contextmanager
    def context():
        MaskProvider.build_output_masker = output_masker
        StaticSpatialMaskingConfig.build = input_masker
        try:
            yield
        finally:
            MaskProvider.build_output_masker = build_out
            StaticSpatialMaskingConfig.build = build_in

    return context()


def _check_ocean_probes(label, records):
    """The gates of ``_ocean_probes``' counts (read once, after the run)."""
    import torch

    if not records:
        raise AssertionError(f"{label}: no masker was called")
    counts = torch.stack([c for _, _, c in records]).cpu().tolist()
    bad = sorted({(kind, name) for (kind, name, _), n in zip(records, counts)
                  if n})
    n_out = sum(kind == "out" for kind, _, _ in records)
    print(f"{label}: {n_out} masked outputs checked (NaN exactly on the dry "
          f"cells, finite elsewhere, force_positive_names >= 0, the sea-ice "
          f"fraction in [0, 1]) and {len(records) - n_out} masked inputs "
          f"(finite); failing: {bad[:10]}")
    if bad:
        raise AssertionError(f"{label}: masking gates fail for {bad[:10]}")


def ocean_train_path(counters, device="cuda", sizes=None, then=None):
    """Path O-R: ``python -m ace_tpu_torch.train``'s ``main`` on
    ``configs/baselines/cm4-piControl/uncoupled-ocean/train-config.yaml``
    (Samudra, the ocean corrector, input masking, FusedAdam with weight
    decay) with the cuts of ``_ocean_config`` (at its full width, 180x360,
    float32, unless ``sizes`` gives ``nlat``, ``nlon``, ``ch_width`` and
    ``dilation``) over ``ocean_files``' three merged stores of its 90
    variables: one epoch, then ``--override max_epochs=2``, which must
    resume at epoch 1 with its state bit for bit. Checks finite losses,
    the checkpoint files, no kernel launch, no sync in the batch loop (on
    the card), and ``_ocean_probes``' masking gates; prints the loop's
    rate, the phases, the checkpoints' bytes and seconds and the peak.
    ``then(paths, config, best)`` runs after the gates inside the context
    that holds the files. Returns the launches and the loop's rates."""
    import contextlib
    import tempfile

    import torch

    label = "path O-R"
    sizes = sizes or {}
    nlat, nlon = sizes.get("nlat", 180), sizes.get("nlon", 360)
    _, missing = inference_packages()
    files = h5py_in_memory() if "h5py" in missing else (
        contextlib.nullcontext())
    with tempfile.TemporaryDirectory() as tmp, files:
        paths, masks = ocean_files(tmp, nlat, nlon,
                                   torch.Generator(device).manual_seed(11),
                                   device)
        names = _ocean_names()
        out_dir = os.path.join(tmp, "experiment")
        config = _ocean_config(paths, out_dir, tmp, names, sizes)
        path = _write_yaml(os.path.join(tmp, "ocean.yaml"), config)
        builder = config["stepper"]["step"]["config"]["builder"]["config"]
        wet = {k: float(m.mean()) for k, m in masks.items()}
        print(f"{label}: {OCEAN_TRAIN} at {nlat}x{nlon}, {len(names)} "
              f"variables in 3 merged stores, Samudra ch_width "
              f"{builder['ch_width']}, dilation {builder['dilation']}, batch "
              f"{O_BATCH}; wet share of mask_0 {wet['mask_0']:.3f}, of "
              f"mask_{O_LEVELS - 1} {wet[f'mask_{O_LEVELS - 1}']:.3f}")
        probes = []
        runs, launches, rates, restored, records, n_params = (
            _epoch_then_resume(label, path, counters, device,
                               lambda: [_ocean_probes(probes)]))
        _check_ocean_probes(label, probes)
        ckpt_dir = os.path.join(out_dir, "training_checkpoints")
        files_found = sorted(os.listdir(ckpt_dir))
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        nonfinite = sorted(k for line in lines for k, v in line.items()
                           if not math.isfinite(v))
        print(f"{label}: {n_params} parameters; batch loop "
              f"{rates[0]:.4f} (epoch 1) and {rates[1]:.4f} (epoch 2) train "
              f"steps/s at batch {O_BATCH} ({rates[1] * O_BATCH:.4f} "
              f"samples/s); losses by epoch: train "
              f"{[line['train/loss'] for line in lines]}, validation "
              f"{[line['val/loss'] for line in lines]}; {len(lines[-1])} "
              f"metrics, not finite (as in ace_tpu: a field without a wet "
              f"neighbour pair, a spectrum of zeros): {nonfinite[:6]}")
        losses = [line[k] for line in lines for k in line
                  if k.startswith(("train/loss", "val/loss"))]
        if len(lines) != 2 or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{label}: losses not finite or epochs "
                                 f"missing")
        want_files = {"ckpt.msgpack", "best_ckpt.msgpack", "ema_ckpt.msgpack",
                      "best_inference_ckpt.msgpack"}
        if not want_files <= set(files_found):
            raise AssertionError(f"{label}: checkpoint files {files_found}")
        _check_resume(label, runs, restored)
        _check_no_launches(label, counters, launches)
        if then is not None:
            then(paths, config, os.path.join(ckpt_dir, "best_ckpt.msgpack"))
    total = {c.__name__: sum(n[c.__name__] for calls in launches.values()
                             for n in calls) for c in counters}
    return total, rates


def _epoch_then_resume(label, path, counters, device="cuda", extra=None):
    """The training entry's ``main`` on the YAML ``path`` for its one
    epoch, then again with ``--override max_epochs=2``, which resumes from
    ``ckpt.msgpack``; ``extra()`` gives more contexts for each run. Each
    run goes through ``_phase_probes`` (launches by phase, the batch
    loop's rate, no sync in it on the card, the state just after
    ``restore``) and ``_record_checkpoints``; prints each run's phases and
    peak and each checkpoint's bytes and seconds. Returns each run's
    start epoch, batches seen, phases, peak and end state, the launches,
    the rates, the restored state, the checkpoint records and the number
    of parameters."""
    import contextlib

    import torch

    from ace_tpu_torch.core.timing import GlobalTimer
    from ace_tpu_torch.train.train import main as train_main

    cuda = torch.device(device).type == "cuda"
    launches, rates, restored, records, runs = {}, [], {}, [], []
    for argv in ([path], [path, "--override", "max_epochs=2"]):
        GlobalTimer.reset()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with contextlib.ExitStack() as stack:
            stack.enter_context(_phase_probes(counters, launches, rates, cuda,
                                              restored))
            stack.enter_context(_record_checkpoints(
                records, lambda stepper, kwargs: None))
            for context in (extra() if extra is not None else []):
                stack.enter_context(context)
            trainer = train_main(argv, device=device)
        if cuda:
            torch.cuda.synchronize()
        runs.append({
            "start_epoch": trainer.start_epoch,
            "num_batches_seen": trainer.num_batches_seen,
            "phases": GlobalTimer.get_instance().get_durations(),
            "peak": (torch.cuda.max_memory_allocated() / 1e9 if cuda
                     else 0.0),
            "state": _state_checksums(trainer),
        })
        n_params = sum(p.numel() for p in trainer.stepper.module.parameters())
        del trainer
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    for name, run in zip(("epoch 1", "resume"), runs):
        phases = {k: round(v, 4) for k, v in sorted(run["phases"].items())}
        print(f"{label} ({name}): phases {phases}; peak device memory "
              f"{run['peak']:.2f} GB")
    for kind, name, seconds, size in records:
        print(f"{label}: {kind} {name}: {size} bytes in {seconds:.3f} s")
    return runs, launches, rates, restored, records, n_params


def _check_resume(label, runs, restored):
    """The second run of ``_epoch_then_resume`` started at epoch 1 from
    the first run's end state, bit for bit."""
    first, second = runs
    if second["start_epoch"] != 1:
        raise AssertionError(f"{label}: the second run started at epoch "
                             f"{second['start_epoch']}, not 1")
    differ = [k for k, v in first["state"].items() if restored.get(k) != v]
    print(f"{label}: resumed state against the first run's end: "
          f"{len(first['state']) - len(differ)} of {len(first['state'])} "
          f"checksums equal")
    if differ:
        raise AssertionError(f"{label}: the resumed state differs: "
                             f"{differ[:5]}")


def _check_no_launches(label, counters, launches):
    none = {c.__name__: 0 for c in counters}
    for phase, counts in launches.items():
        print(f"{label}: launches per {phase} call {counts} (want none)")
        if any(c != none for c in counts):
            raise AssertionError(f"{label}: launches in {phase}")


# path O-E: every aggregator flag that needs no reference file (the YAML
# turns on the histograms)
O_E_FLAGS = {"log_histograms": True, "log_enso_index": True,
             "log_seasonal_means": True, "log_near_zero_fraction": True,
             "log_video": True, "log_extended_video": True,
             "log_trends": True, "log_annual_means": True,
             "log_step_means": [{"step": O_E_STEPS // 2}]}
# path O-E's gates: the predictions against Stepper.predict (of each
# channel's spatial std over the wet cells), the derived heat content
# against float64 (of its largest value), the global means (of the
# field's largest value)
O_E_PREDICT_TOL = 1e-5
O_E_OHC_TOL = 1e-6
O_E_MEAN_TOL = 1e-6


def _read_merged(split_paths, names):
    """``names``' arrays from a split's stores (static ones as stored)."""
    from ace_tpu_torch.data.store import open_file_dataset

    out = {}
    for source in O_SOURCES:
        ds = open_file_dataset(os.path.join(split_paths[source], "data.nc"))
        out.update({k: ds[k].read(()) for k in names
                    if k in ds.keys() and k not in out})
    return out


def _masked_nan_errors(got, want):
    """Each variable's largest error on the wet cells over its spatial std
    there, and the variables whose NaN cells differ."""
    import numpy as np

    errs, nan_differs = {}, []
    for k, w in want.items():
        g = np.asarray(got[k], np.float64)
        w = np.asarray(w, np.float64)
        if not np.array_equal(np.isnan(g), np.isnan(w)):
            nan_differs.append(k)
            continue
        wet = ~np.isnan(w)
        scale = float(np.std(w[wet])) if wet.any() else 1.0
        errs[k] = (float(np.abs(g[wet] - w[wet]).max()) / max(scale, 1e-30)
                   if wet.any() else 0.0)
    return errs, nan_differs


def _video_drains_allowed(drains):
    """A context in which the video aggregator's drains (copies to the
    host once its pending windows pass a size: they wait for the device,
    by design) may synchronize inside a sync-checked loop; each drain
    appends its seconds to ``drains``."""
    import contextlib

    import torch

    from ace_tpu_torch.aggregator.video import VideoAggregator

    drain = VideoAggregator._drain

    def allowed(self):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        t0 = time.perf_counter()
        try:
            return drain(self)
        finally:
            drains.append(time.perf_counter() - t0)
            torch.cuda.set_sync_debug_mode(mode)

    @contextlib.contextmanager
    def context():
        VideoAggregator._drain = allowed
        try:
            yield
        finally:
            VideoAggregator._drain = drain

    return context()


def ocean_evaluator_path(counters, paths, ckpt, device="cuda",
                         n_steps=O_E_STEPS):
    """Path O-E: ``python -m ace_tpu_torch.evaluator``'s ``main`` on
    ``configs/baselines/cm4-piControl/uncoupled-ocean/evaluator-config.yaml``
    over path O-R's ``ckpt`` as shipped but for ``n_steps`` steps (2920)
    over ``ocean_files``' evaluator stores from its start, Weights & Biases
    off, and every aggregator flag of ``O_E_FLAGS``. Checks no launch, no
    synchronizing call in ``run_inference`` (on the card; the histograms'
    wait on the window before and the video's drains, which wait for the
    device by design, allowed and counted), the predictions the aggregators
    see within ``O_E_PREDICT_TOL`` of one ``Stepper.predict`` with NaN on
    the same cells, the derived ``ocean_heat_content`` within
    ``O_E_OHC_TOL`` of a float64 depth integral of the step's own
    ``thetao`` times rho c_p, the written time-mean maps NaN exactly on the
    dry cells, and the global-mean series the area-weighted means over
    the wet cells (float64, within ``O_E_MEAN_TOL``). Returns the
    launches, the summary, the phases and the peak."""
    import contextlib
    import tempfile

    import numpy as np
    import torch

    from ace_tpu_torch.aggregator.inference import (
        InferenceEvaluatorAggregator,
    )
    from ace_tpu_torch.core.constants import (
        DENSITY_OF_SEA_WATER_CM4,
        SPECIFIC_HEAT_OF_SEA_WATER_CM4,
    )
    from ace_tpu_torch.core.coordinates import dz_from_idepth
    from ace_tpu_torch.core.timing import GlobalTimer
    from ace_tpu_torch.data.store import open_file_dataset
    from ace_tpu_torch.inference import evaluator
    from ace_tpu_torch.stepper.checkpoint import load_stepper
    from ace_tpu_torch.stepper.stepper import PrognosticState

    label = "path O-E"
    cuda = torch.device(device).type == "cuda"
    config = _yaml(OCEAN_EVALUATOR)
    records, waits, drains = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "evaluator")
        config.update(experiment_dir=out_dir, checkpoint_path=ckpt,
                      n_forward_steps=n_steps)
        config["logging"].update(log_to_wandb=False, log_to_screen=False)
        _ocean_dataset(config["loader"]["dataset"]["merge"],
                       paths["evaluator"])
        config["aggregator"].update(O_E_FLAGS)
        path = _write_yaml(os.path.join(tmp, "evaluator.yaml"), config)
        GlobalTimer.reset()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        guard = (no_sync_in_run_inference(evaluator, event_waits=waits)
                 if cuda else contextlib.nullcontext())
        allowed = (_video_drains_allowed(drains) if cuda
                   else contextlib.nullcontext())
        with guard, allowed, _recording(
                InferenceEvaluatorAggregator, "record_batch", records):
            summary, launches = counted(
                counters, lambda: evaluator.main([path], device=device))
        phases = GlobalTimer.get_instance().get_durations()
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
        time_mean = open_file_dataset(os.path.join(
            out_dir, "diagnostics", "time_mean_diagnostics.nc"))
        maps = {k[len("gen_map-"):]: np.asarray(time_mean[k].read(()))
                for k in time_mean.keys() if k.startswith("gen_map-")}
        series = open_file_dataset(os.path.join(
            out_dir, "diagnostics", "mean_diagnostics.nc"))
        gen_series = {k[len("gen_series-"):]: np.asarray(series[k].read(()))
                      for k in series.keys() if k.startswith("gen_series-")}

    stepper = load_stepper(ckpt, device=device)
    info = stepper.dataset_info
    provider, depth = info.mask_provider, info.depth_coordinate
    gen = {k: torch.cat([args[0][k] for args, _ in records], dim=1)
           for k in records[0][0][0]}
    data = _read_merged(paths["evaluator"], sorted(
        set(stepper.prognostic_names) | set(stepper.forcing_window_names)))
    shape = next(v.shape for v in data.values() if v.ndim == 3)

    def series_of(k):
        v = np.asarray(data[k], np.float32)
        return torch.as_tensor(np.broadcast_to(v, shape).copy())[None].to(
            device)

    ic = PrognosticState(data={k: series_of(k)[:, :1]
                               for k in stepper.prognostic_names})
    forcing = {k: series_of(k)[:, :n_steps + 1]
               for k in stepper.forcing_window_names}
    outputs, _ = stepper.predict(ic, forcing, n_forward=n_steps)
    host = {k: v.detach().double().cpu().numpy() for k, v in gen.items()}
    errs, nan_differs = _masked_nan_errors(
        host, {k: v.double().cpu().numpy() for k, v in outputs.items()})
    worst = max(errs, key=errs.get)

    # the heat content from the step's own temperatures, in float64
    dz = dz_from_idepth(depth.idepth.astype(np.float64),
                        depth.mask.astype(np.float64),
                        None if depth.deptho is None
                        else depth.deptho.astype(np.float64))
    thetao = np.stack([host[f"thetao_{k}"] for k in range(dz.shape[-1])], -1)
    ohc = (np.nan_to_num(thetao * dz).sum(-1) * DENSITY_OF_SEA_WATER_CM4
           * SPECIFIC_HEAT_OF_SEA_WATER_CM4)
    ohc = np.where(depth.mask[..., 0] > 0, ohc, np.nan)
    got = host["ocean_heat_content"]
    ohc_nan_equal = np.array_equal(np.isnan(got), np.isnan(ohc))
    ohc_err = float(np.nanmax(np.abs(got - ohc)) / np.nanmax(np.abs(ohc)))

    # the time-mean maps: NaN exactly where the variable's mask is 0
    map_bad = [k for k, m in maps.items()
               if provider.mask_key_for(k) is not None and not np.array_equal(
                   np.isnan(m), provider.get_mask_for(k) == 0)]
    # the global-mean series: the mean over the wet cells, in float64
    area = info.horizontal_coordinates.area_weights.astype(np.float64)
    mean_errs = {}
    for k, values in gen_series.items():
        key = provider.mask_key_for(k)
        w = area * (provider.masks[key] if key is not None else 1.0)
        x = host[k][0]
        want = (np.where(w > 0, np.nan_to_num(x), 0.0) * w).sum((-2, -1)) / (
            w.sum())
        mean_errs[k] = float(np.abs(values - want).max()
                             / max(np.abs(want).max(), 1e-30))
    worst_mean = max(mean_errs, key=mean_errs.get)
    logs = summary["logs"]
    nonfinite = sorted(k for k, v in logs.items() if not np.isfinite(v))
    rate = summary["total_steps_per_second"]
    print(f"{label}: {OCEAN_EVALUATOR} at {info.img_shape}, {n_steps} steps "
          f"from {config['loader']['start_indices']['times'][0]} at batch 1: "
          f"{rate:.4f} steps/s; histograms filled in "
          f"{summary['histogram_host_seconds']:.3f} s of host time; phases "
          f"{ {k: round(v, 4) for k, v in sorted(phases.items())} }; peak "
          f"device memory {peak:.2f} GB; waits on the window before "
          f"{len(waits)}; video drains {len(drains)} in "
          f"{sum(drains):.3f} s; launches {launches}; {len(logs)} logs, "
          f"not finite "
          f"(as in ace_tpu: a mean without mask weights over NaN cells) "
          f"{len(nonfinite)}")
    print(f"{label}: predictions vs one {n_steps}-step Stepper.predict: "
          f"largest error {errs[worst]:.3g} of the channel's wet std "
          f"({worst}; tol {O_E_PREDICT_TOL}), NaN cells differ for "
          f"{nan_differs[:5]}; ocean_heat_content vs float64 depth_integral "
          f"x rho c_p: {ohc_err:.3g} of its largest value (tol "
          f"{O_E_OHC_TOL}), NaN cells equal {ohc_nan_equal}; time-mean maps "
          f"not NaN exactly on the dry cells: {map_bad[:5]}; global-mean "
          f"series vs the float64 mean over the wet cells: "
          f"{mean_errs[worst_mean]:.3g} ({worst_mean}; tol {O_E_MEAN_TOL})")
    if launches != {c.__name__: 0 for c in counters}:
        raise AssertionError(f"{label}: launches {launches}")
    if not (errs[worst] <= O_E_PREDICT_TOL and not nan_differs):
        raise AssertionError(f"{label}: the predictions disagree with "
                             "Stepper.predict")
    if not (ohc_err <= O_E_OHC_TOL and ohc_nan_equal):
        raise AssertionError(f"{label}: ocean_heat_content disagrees with "
                             "its float64 depth integral")
    if map_bad or not mean_errs[worst_mean] <= O_E_MEAN_TOL:
        raise AssertionError(f"{label}: the aggregated fields are not "
                             "masked")
    if cuda and waits:
        raise AssertionError(f"{label}: {len(waits)} waits on a CUDA event "
                             "in the window loop (one window)")
    return launches, summary, phases, peak


# reference phase O: Samudra at widths 16-32 on 16x32, 3 steps; 3 levels
# (a 2x4 bottleneck: a fourth level's 1x2, normalized over 2 cells, turns
# float32 rounding into 2e-5 of the outputs on either side)
O_REFERENCE_SIZES = {"nlat": 16, "nlon": 32, "ch_width": [16, 24, 32],
                     "dilation": [1, 2, 2]}
O_REFERENCE_STEPS = 3


def ocean_stepper_config(nlat=16, nlon=32, ch_width=(16, 20, 24, 32),
                         dilation=(1, 2, 2, 2)):
    """The uncoupled-ocean YAML's stepper (Samudra, the ocean corrector,
    input masking) at ``ch_width`` and ``dilation``, normalized by the
    synthetic draws' statistics, and the dataset info of
    ``ocean_grid_and_masks``' grid, depth coordinate and masks at five
    days a step."""
    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.stepper.stepper import StepperConfig

    stepper, info = ocean_stepper_dict(nlat, nlon, ch_width, dilation)
    return from_dict(StepperConfig, stepper), info


def ocean_stepper_dict(nlat=16, nlon=32, ch_width=(16, 20, 24, 32),
                       dilation=(1, 2, 2, 2), timestep=O_TIMESTEP):
    """``ocean_stepper_config``'s stepper as a config dict (what either
    package's ``from_dict`` reads), and the port's dataset info at
    ``timestep`` seconds a step."""
    import datetime

    import numpy as np
    import torch

    from ace_tpu_torch.core.coordinates import (
        DepthCoordinate,
        LatLonCoordinates,
    )
    from ace_tpu_torch.core.dataset_info import DatasetInfo
    from ace_tpu_torch.core.masking import MaskProvider

    coords, idepth, deptho, masks = ocean_grid_and_masks(nlat, nlon)
    provider = MaskProvider(masks)
    stepper = _yaml(OCEAN_TRAIN)["stepper"]
    step = stepper["step"]["config"]
    step["builder"]["config"].update(ch_width=list(ch_width),
                                     dilation=list(dilation))
    sample = ocean_inputs(sorted(set(step["in_names"])
                                 | set(step["out_names"])),
                          (2, nlat, nlon), torch.Generator().manual_seed(0),
                          coords["lat"], idepth, provider)
    step["normalization"] = {"network": {
        "means": {k: float(np.nanmean(v)) for k, v in sample.items()},
        "stds": {k: float(np.nanstd(v)) for k, v in sample.items()}}}
    info = DatasetInfo(
        horizontal_coordinates=LatLonCoordinates(lat=coords["lat"],
                                                 lon=coords["lon"]),
        vertical_coordinate=DepthCoordinate(
            idepth=idepth, deptho=deptho,
            mask=np.stack([masks[f"mask_{k}"] for k in range(O_LEVELS)],
                          -1)),
        timestep=datetime.timedelta(seconds=timestep),
        mask_provider=provider)
    return stepper, info


def ocean_inputs(names, shape, generator, lat, idepth, provider):
    """``_ocean_draw``'s fields of ``names`` (``[..., lat, lon]`` CPU
    tensors), NaN on the dry cells of each ocean field's mask; the land
    fraction 1 on the surface's dry cells, 0 elsewhere."""
    import torch

    out = {}
    for name in names:
        if name == "land_fraction":
            dry = provider.masks["mask_2d"] == 0
            out[name] = torch.as_tensor(dry, dtype=torch.float32).expand(
                shape).clone()
            continue
        v = _ocean_draw(name, shape, generator, "cpu", lat, idepth)
        if _ocean_source(name) != "atmosphere":
            wet = provider.on_device(provider.mask_key_for(name), "wet",
                                     "cpu")
            v = torch.where(wet, v, torch.full((), float("nan")))
        out[name] = v
    return out


def _samudra_zero_gradients(names):
    """The biases of a ConvNeXt block's two wide convolutions: each adds a
    per-channel constant that the instance norm after it removes."""
    return {k for k in names if k.endswith((".conv1.bias", ".conv2.bias"))}


def reference_ocean_phase(counters, device="cuda"):
    """Reference phase O: a small copy of path O's stepper
    (``ocean_stepper_config`` at ``O_REFERENCE_SIZES``, float32) on
    ``device`` against the CPU: a ``O_REFERENCE_STEPS``-step rollout from
    an initial condition with NaN on the dry cells, and one train step of
    as many steps, within reference S's float32 limits, with no kernel
    launch."""
    from ace_tpu_torch.stepper.stepper import PrognosticState

    sizes = O_REFERENCE_SIZES
    n = O_REFERENCE_STEPS

    def inputs(stepper, gen):
        info = stepper.dataset_info
        lat = info.horizontal_coordinates.lat
        idepth = info.vertical_coordinate.idepth
        provider = info.mask_provider
        step = stepper.step
        shape = (2, n + 1, sizes["nlat"], sizes["nlon"])
        names = sorted(set(step.input_names) | set(step.output_names))
        batch = ocean_inputs(names, shape, gen, lat, idepth, provider)
        ic = PrognosticState(data={k: batch[k][:, :1]
                                   for k in stepper.prognostic_names})
        forcing = {k: batch[k] for k in stepper.forcing_window_names}
        return ic, forcing, batch

    launches = _reference_case(
        "reference O (Samudra, f32)", counters, device,
        (S_F32_TOL, S_F32_LOSS_TOL, S_F32_GRAD_TOL),
        lambda dtype: ocean_stepper_config(
            sizes["nlat"], sizes["nlon"], sizes["ch_width"],
            sizes["dilation"]),
        "float32", inputs, n_steps=n,
        zero_gradients=_samudra_zero_gradients)
    if launches != {c.__name__: 0 for c in counters}:
        raise AssertionError(f"reference O: launches {launches}")
    return launches


def ocean_paths(counters, smi, sizes=None, device="cuda"):
    """Reference phase O, then paths O-R and O-E: the launches of each
    path. ``sizes`` (``nlat``, ``nlon``, ``ch_width``, ``dilation``) makes
    the small copies the CPU runs."""
    t0 = time.perf_counter()
    reference_ocean_phase(counters, device)
    out = {}
    print(smi)

    def then(paths, config, best):
        print(smi)
        out["O-E"], _, _, _ = ocean_evaluator_path(counters, paths, best,
                                                   device=device)

    out["O-R"], _ = ocean_train_path(counters, device=device, sizes=sizes,
                                     then=then)
    print(f"path O (reference O, O-R, O-E): {time.perf_counter() - t0:.1f} s")
    return out


C_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                     "baselines", "cm4-piControl")
C_TRAIN = os.path.join(C_DIR, "train-config.yaml")
C_FINETUNE = os.path.join(C_DIR, "finetune-config.yaml")
C_EVALUATOR = os.path.join(C_DIR, "evaluator-config.yaml")
C_ATMOS_TRAIN = os.path.join(C_DIR, "uncoupled-atmos", "train-config.yaml")
# the two atmosphere stores of the YAMLs' merge lists, in their order: the
# coupled run's atmosphere (its state, fluxes and fractions, and the
# vertical coordinate), and the land and forcing fields
C_SOURCES = ("coupled-atmosphere", "atmosphere-land")
C_LAND_NAMES = ("land_fraction", "lake_fraction", "HGTsfc", "DSWRFtoa")
C_STATIC_NAMES = ("land_fraction", "lake_fraction", "HGTsfc")
C_ATMOS_TIMESTEP = 6 * 3600
C_INNER = O_TIMESTEP // C_ATMOS_TIMESTEP
# batch 1 for both loaders (the YAMLs: 16); ocean times per split, each
# atmosphere time 20 i at ocean time i: the training files 5 (1 pair of
# the YAML's 4 coupled steps: 1 batch an epoch), the validation files 5
# (1 pair), the evaluator's 5 (4 coupled steps from its start)
C_BATCH = 1
C_SPLITS = (("train", 5, "0151-01-06"), ("valid", 5, "0306-01-01"),
            ("evaluator", 5, "0311-01-01"))
# path C-F: 2 coupled steps (4), the training subset cut to its first 2
# ocean starts (2 pairs); path C-E: 4 coupled steps (2920) in windows of
# 2 (20); path C-bf16: 2 coupled steps, train steps after the warm-up
C_F_COUPLED_STEPS = 2
C_E_STEPS = 4
C_E_IN_MEMORY = 2
C_BF16_COUPLED_STEPS = 2
C_BF16_STEPS = 2
# path C-R's exchange gates: the predicted ocean fraction against float64
# (absolute), the fluxes the ocean receives against the float64 mean of
# the atmosphere's outputs (of the field's largest value); path C-E's
# predictions against CoupledStepper.predict (of the variable's largest
# value)
C_FRACTION_TOL = 1e-6
C_FLUX_TOL = 1e-6
C_E_PREDICT_TOL = 1e-5
# reference phase C: the SFNO at embed 32 with 2 layers, Samudra at widths
# 16-32 over 3 levels, 16x32, 4 atmosphere steps an ocean step, 2 ocean
# steps
C_REFERENCE_SIZES = {"nlat": 16, "nlon": 32, "embed": 32, "layers": 2,
                     "ch_width": [16, 24, 32], "dilation": [1, 2, 2],
                     "n_inner": 4}
C_REFERENCE_OUTER = 2
# reference phase C's limit for the atmosphere corrector's moisture-budget
# fields, of each one's largest value: the correction divides by float32
# global means that the card and the CPU sum in other orders (the CPU
# tests hold ace_tpu and the port within the same 1e-3 of these two
# fields, ROADMAP Queue 3)
C_BUDGET_TOL = 1e-3
C_BUDGET_NAMES = ("PRATEsfc", "tendency_of_total_water_path_due_to_advection")


def _coupled_atmos_names():
    step = _yaml(C_TRAIN)["stepper"]["atmosphere"]["stepper"]["step"][
        "config"]
    return sorted(set(step["in_names"]) | set(step["out_names"]))


def _coupled_draw(name, shape, generator, device, land):
    """A synthetic atmosphere field: ``_draw``'s, a lake fraction in [0,
    0.05] off the land, the land fraction ``land`` (1 on the ocean's dry
    cells), the sea-ice fraction of the ocean's draw (0 on land) and the
    ocean fraction ``clip(1 - land - ice, 0)``."""
    import numpy as np
    import torch

    land = torch.as_tensor(land, dtype=torch.float32, device=device)
    if name == "land_fraction":
        return land.expand(shape).clone()
    if name == "lake_fraction":
        return 0.05 * torch.rand(shape, generator=generator,
                                 device=device) * (1 - land)
    if name in ("sea_ice_fraction", "ocean_fraction"):
        lat = np.linspace(-90 + 90 / shape[-2], 90 - 90 / shape[-2],
                          shape[-2])
        ice = _ocean_draw("ocean_sea_ice_fraction", shape, generator, device,
                          lat, None) * (land < 1)
        if name == "sea_ice_fraction":
            return ice
        return (1 - land - ice).clamp(min=0)
    return _draw(name, shape, generator, device)


def coupled_files(tmp, nlat, nlon, generator, device, splits=C_SPLITS,
                  n_inner=C_INNER, single=False):
    """The synthetic stores of the CM4 coupled YAMLs under ``tmp``: for
    each split of ``splits`` (name, number of ocean times, first time)
    ``ocean_files``' ocean stores at ``n_inner`` six-hourly steps a time,
    and the atmosphere's two stores (``C_SOURCES``; ``single``: one file
    holding both, what ``ace_tpu``'s loader reads) of its variables at
    ``(n - 1) n_inner + 1`` six-hourly times from the same first time,
    with the 8-level vertical coordinate, the land, lake and surface
    height static; and each component's stats files (from the training
    split). Drawn from ``generator`` on ``device``. Returns the paths:
    ``paths["ocean"]`` as ``ocean_files`` gives them,
    ``paths["atmosphere"][split][source]`` a directory and
    ``paths["atmosphere"][label]`` a stats file."""
    import numpy as np

    from ace_tpu_torch.data.store import write_h5
    from ace_tpu_torch.data.time import TimeCoord

    ocean, masks = ocean_files(os.path.join(tmp, "ocean"), nlat, nlon,
                               generator, device, splits=splits,
                               single=single,
                               timestep=n_inner * C_ATMOS_TIMESTEP)
    coords, _, _, _ = ocean_grid_and_masks(nlat, nlon)
    land = 1.0 - masks["mask_2d"]
    nz = 8
    ak = np.concatenate([np.linspace(100.0, 5000.0, nz // 2),
                         np.linspace(5000.0, 0.0, nz // 2 + 1)])
    bk = np.linspace(0.0, 1.0, nz + 1)
    names = _coupled_atmos_names()
    static = {name: _coupled_draw(name, (nlat, nlon), generator, device,
                                  land).cpu().numpy()
              for name in C_STATIC_NAMES}
    atmos, train = {}, {}
    for split, n, start in splits:
        n_atmos = (n - 1) * n_inner + 1
        time = TimeCoord.from_range(start, n_atmos, C_ATMOS_TIMESTEP,
                                    O_CALENDAR)
        by_source = {source: ({}, {}) for source in C_SOURCES}
        for name in names:
            source = C_SOURCES[name in C_LAND_NAMES]
            data, dims = by_source[source]
            if name in static:
                data[name], dims[name] = static[name], ("lat", "lon")
            else:
                data[name] = _coupled_draw(name, (n_atmos, nlat, nlon),
                                           generator, device,
                                           land).cpu().numpy()
                dims[name] = ("time", "lat", "lon")
            if split == splits[0][0]:
                train[name] = data[name]
        data, dims = by_source[C_SOURCES[0]]
        for i, (a, b) in enumerate(zip(ak, bk)):
            data[f"ak_{i}"], data[f"bk_{i}"] = np.float32(a), np.float32(b)
            dims[f"ak_{i}"] = dims[f"bk_{i}"] = ()
        if single:
            for source in C_SOURCES[1:]:
                data.update(by_source[source][0])
                dims.update(by_source[source][1])
            by_source = {"single": (data, dims)}
        atmos[split] = {}
        for source, (data, dims) in by_source.items():
            directory = os.path.join(tmp, "atmosphere", split, source)
            os.makedirs(directory)
            write_h5(os.path.join(directory, "data.nc"), data, dims,
                     coords=coords, time=time)
            atmos[split][source] = directory
        if single:
            atmos[split] = dict.fromkeys(C_SOURCES, directory)
    stats = {
        "centering": {k: np.mean(v) for k, v in train.items()},
        "scaling-full-field": {k: np.std(v) for k, v in train.items()},
        "scaling-residual": {k: np.std(np.diff(v, axis=0))
                             for k, v in train.items()},
    }
    for label, values in stats.items():
        atmos[label] = os.path.join(tmp, "atmosphere", f"{label}.nc")
        write_h5(atmos[label], {k: np.asarray(v, np.float32)
                                for k, v in values.items()},
                 {k: () for k in values})
    return {"ocean": ocean, "atmosphere": atmos}, masks


def _coupled_dataset(entries, split_paths, sources):
    """Point each entry of a YAML's ``merge`` list at its synthetic store
    (the YAMLs read zarr stores that are not in the repo)."""
    for entry, source in zip(entries, sources):
        entry.update(data_path=split_paths[source], file_pattern="data.nc",
                     engine="netcdf4")


def _coupled_normalization(stepper, paths, component, sizes):
    """Point a component stepper's stats at the synthetic files and apply
    ``sizes``' widths (``embed`` and ``layers`` for the SFNO, ``ch_width``
    and ``dilation`` for Samudra)."""
    step = stepper["step"]["config"]
    norm = step["normalization"]
    builder = step["builder"]["config"]
    if component == "atmosphere":
        stats = paths["atmosphere"]
        norm["network"] = {"global_means_path": stats["centering"],
                           "global_stds_path": stats["scaling-full-field"]}
        norm["residual"] = {"global_means_path": stats["centering"],
                            "global_stds_path": stats["scaling-residual"]}
        if "embed" in sizes:
            builder.update(embed_dim=sizes["embed"],
                           num_layers=sizes["layers"])
    else:
        stats = paths["ocean"]
        norm["network"] = {"global_means_path": stats["centering"],
                           "global_stds_path": stats["scaling-full-field"]}
        if "ch_width" in sizes:
            builder.update(ch_width=list(sizes["ch_width"]),
                           dilation=list(sizes["dilation"]))


def coupled_checkpoints(tmp, paths, device, sizes=None):
    """The component checkpoints the coupled training YAML starts from,
    written by ``save_stepper`` with weights drawn from a seed: the
    uncoupled-atmosphere YAML's stepper and the coupled YAML's ocean
    stepper (the uncoupled-ocean YAML's), over the training split's
    merged stores and the stats files. Returns their paths."""
    import torch

    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.data.dataset import MergeDatasetConfig
    from ace_tpu_torch.stepper.checkpoint import save_stepper
    from ace_tpu_torch.stepper.stepper import StepperConfig

    sizes = sizes or {}
    generator = torch.Generator(device).manual_seed(5)
    stores = {
        "atmosphere": (_yaml(C_ATMOS_TRAIN)["stepper"],
                       paths["atmosphere"]["train"], C_SOURCES),
        "ocean": (_yaml(C_TRAIN)["stepper"]["ocean"]["stepper"],
                  paths["ocean"]["train"], O_SOURCES[:2]),
    }
    out = {}
    for component, (stepper, split_paths, sources) in stores.items():
        _coupled_normalization(stepper, paths, component, sizes)
        info = from_dict(MergeDatasetConfig, {"merge": [
            {"data_path": split_paths[s], "file_pattern": "data.nc"}
            for s in sources]}).build().dataset_info
        config = from_dict(StepperConfig, stepper)
        built = config.get_stepper(info, device=device)
        built.init_params(generator)
        out[component] = os.path.join(tmp, f"{component}_base.msgpack")
        save_stepper(out[component], built, config)
        del built
    return out


def _stop_after_first(start, timestep):
    """The date of the time one ``timestep`` (s) after ``start``: a subset
    ending there holds 2 ocean starts."""
    from ace_tpu_torch.data.time import TimeCoord, format_time

    second = TimeCoord.from_range(start, 2, timestep, O_CALENDAR).values[1]
    return format_time(second, O_CALENDAR)[:10]


def _coupled_config(paths, experiment_dir, sizes=None, source=C_TRAIN,
                    weights=None, checkpoint_path=None, n_coupled_steps=None,
                    first_pairs=False):
    """A CM4 coupled training YAML (``source``: the train or the finetune
    YAML) with path C-R's cuts: each merge entry reads its synthetic
    store, batch ``C_BATCH``, one epoch, the stats files, no Weights &
    Biases; ``weights`` (the train YAML) the component checkpoints,
    ``checkpoint_path`` (the finetune YAML) a coupled trainer's
    ``training_checkpoints``; ``n_coupled_steps`` in place of the YAML's;
    ``first_pairs`` cuts the training subset to its first 2 ocean starts.
    ``sizes`` (``embed``, ``layers``, ``ch_width``, ``dilation`` and
    ``n_inner``, the atmosphere steps an ocean step, in the ocean's
    ``timedelta``) makes the small copies the CPU runs."""
    sizes = sizes or {}
    n_inner = sizes.get("n_inner", C_INNER)
    config = _yaml(source)
    config["experiment_dir"] = experiment_dir
    config["max_epochs"] = 1
    config["logging"].update(log_to_wandb=False, log_to_screen=False)
    for loader, split in (("train_loader", "train"),
                          ("validation_loader", "valid")):
        config[loader]["batch_size"] = C_BATCH
        dataset = config[loader]["dataset"]
        _coupled_dataset(dataset["ocean"]["merge"], paths["ocean"][split],
                         O_SOURCES)
        _coupled_dataset(dataset["atmosphere"]["merge"],
                         paths["atmosphere"][split], C_SOURCES)
        if first_pairs and split == "train":
            for component in ("ocean", "atmosphere"):
                for entry in dataset[component]["merge"]:
                    entry["subset"]["stop_time"] = _stop_after_first(
                        entry["subset"]["start_time"],
                        n_inner * C_ATMOS_TIMESTEP)
    stepper = config["stepper"]
    for component in ("atmosphere", "ocean"):
        _coupled_normalization(stepper[component]["stepper"], paths,
                               component, sizes)
    if n_inner != C_INNER:
        stepper["ocean"]["timedelta"] = f"{n_inner * 6}h"
    training = config["stepper_training"]
    if n_coupled_steps is not None:
        training["n_coupled_steps"] = n_coupled_steps
    for component, path in (weights or {}).items():
        training[component]["parameter_init"]["weights_path"] = path
    if checkpoint_path is not None:
        training["parameter_init"]["checkpoint_path"] = checkpoint_path
    return config


def _coupled_evaluator_config(paths, checkpoint_path, experiment_dir,
                              n_steps=C_E_STEPS, in_memory=C_E_IN_MEMORY):
    """The CM4 coupled evaluator YAML over a coupled trainer's
    ``training_checkpoints``, ``n_steps`` coupled steps (2920) in windows
    of ``in_memory`` (20) from its start over the evaluator stores, no
    Weights & Biases."""
    config = _yaml(C_EVALUATOR)
    config.update(experiment_dir=experiment_dir,
                  checkpoint_path=checkpoint_path, n_coupled_steps=n_steps,
                  coupled_steps_in_memory=in_memory)
    config["logging"].update(log_to_wandb=False, log_to_screen=False)
    dataset = config["loader"]["dataset"]
    _coupled_dataset(dataset["ocean"]["merge"], paths["ocean"]["evaluator"],
                     O_SOURCES)
    _coupled_dataset(dataset["atmosphere"]["merge"],
                     paths["atmosphere"]["evaluator"], C_SOURCES)
    return config


def _tensor_checksums(tensors):
    """Two int64 sums of each tensor's bits (one weighted by position),
    computed on the tensors' device, by name."""
    import torch

    sums = []
    for t in tensors.values():
        bits = t.detach().contiguous().view(
            torch.int16 if t.element_size() == 2 else torch.int32
        ).reshape(-1).to(torch.int64)
        weight = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        sums.append(torch.stack([bits.sum(), (bits * weight).sum()]))
    if not sums:
        return {}
    values = torch.stack(sums).cpu().tolist()
    return dict(zip(tensors, map(tuple, values)))


def _file_checksums(path, device):
    """``_tensor_checksums`` of a checkpoint file's weights, on
    ``device``."""
    from ace_tpu_torch.stepper.parameter_init import read_base_weights

    weights, _ = read_base_weights(path)
    return _tensor_checksums({k: v.to(device) for k, v in weights.items()})


def _exchange_probes(records):
    """A context in which every call of ``CoupledStepper.exchange_pre``
    and ``exchange_post`` appends to ``records`` device counts and errors,
    made without waiting for the device and without gradients: the
    non-finite cells of the atmosphere's forcing window and initial
    condition after the exchange (``("finite", count)``), the predicted
    ocean fraction's largest error against ``clip(1 - land -
    nan_to_num(ice), 0)`` in float64, zero on the dry cells
    (``("fraction", error)``), and for each flux the ocean receives its
    largest error against the float64 mean of the atmosphere's outputs
    over the inner steps, of that mean's largest value, both times of the
    window (``("flux", name, error)``)."""
    import contextlib

    import torch

    from ace_tpu_torch.coupled.stepper import CoupledStepper

    pre, post = CoupledStepper.exchange_pre, CoupledStepper.exchange_post

    def probe_pre(self, ocean_data, atmos_window, atmos_ic):
        win, new_ic = pre(self, ocean_data, atmos_window, atmos_ic)
        with torch.no_grad():
            records.append(("finite", sum(
                (~torch.isfinite(v)).sum()
                for v in (*win.values(), *new_ic.values()))))
            ofrac = self.config.ocean_fraction_prediction
            if ofrac is not None:
                ice = torch.nan_to_num(
                    ocean_data[ofrac.sea_ice_fraction_name].double())
                land = atmos_window[ofrac.land_fraction_name].double()
                want = (1 - land - ice).clamp(min=0)
                provider = self.ocean.dataset_info.mask_provider
                key = provider.mask_key_for(self.ocean_fraction_name)
                want = torch.where(provider.on_device(key, "wet",
                                                      want.device),
                                   want, 0.0)
                got = win[self.ocean_fraction_name].double()
                records.append(("fraction", (got - want).abs().max()))
        return win, new_ic

    def probe_post(self, a_out, shared_window, ocean_window):
        win = post(self, a_out, shared_window, ocean_window)
        with torch.no_grad():
            for k in self._atmosphere_to_ocean_forcing_names:
                want = a_out[k].double().mean(1, keepdim=True)
                err = (win[k].double() - want).abs().max()
                records.append(("flux", k, err / want.abs().max()))
        return win

    @contextlib.contextmanager
    def context():
        CoupledStepper.exchange_pre = probe_pre
        CoupledStepper.exchange_post = probe_post
        try:
            yield
        finally:
            CoupledStepper.exchange_pre = pre
            CoupledStepper.exchange_post = post

    return context()


def _check_exchange_probes(label, records):
    """The gates of ``_exchange_probes``' records (read once, after the
    run)."""
    import torch

    if not records:
        raise AssertionError(f"{label}: no exchange was made")
    values = torch.stack([r[-1].double() for r in records]).cpu().tolist()
    nonfinite = sum(v for r, v in zip(records, values) if r[0] == "finite")
    fraction = max((v for r, v in zip(records, values)
                    if r[0] == "fraction"), default=0.0)
    fluxes = {}
    for r, v in zip(records, values):
        if r[0] == "flux":
            fluxes[r[1]] = max(fluxes.get(r[1], 0.0), v)
    worst = max(fluxes, key=fluxes.get)
    n_pre = sum(r[0] == "finite" for r in records)
    print(f"{label}: {n_pre} exchanges: non-finite cells in the "
          f"atmosphere's state and inputs after the exchange "
          f"{int(nonfinite)}; predicted ocean fraction vs float64 "
          f"clip(1 - land - nan_to_num(ice), 0): {fraction:.3g} (tol "
          f"{C_FRACTION_TOL}); fluxes to the ocean vs the float64 mean of "
          f"the atmosphere's outputs: {fluxes[worst]:.3g} of the largest "
          f"value ({worst}; tol {C_FLUX_TOL}) over {len(fluxes)} fluxes")
    if nonfinite or not (fraction <= C_FRACTION_TOL
                         and fluxes[worst] <= C_FLUX_TOL):
        raise AssertionError(f"{label}: the exchange gates fail")


def _timed_saves(records):
    """A context in which the coupled trainer's checkpoint writes are
    timed into ``records`` (file, seconds, bytes)."""
    import contextlib

    from ace_tpu_torch.coupled import train as coupled_train

    save = coupled_train.save_stepper

    def timed(path, *args, **kwargs):
        t0 = time.perf_counter()
        save(path, *args, **kwargs)
        records.append((os.path.basename(path), time.perf_counter() - t0,
                        os.path.getsize(path)))

    @contextlib.contextmanager
    def context():
        coupled_train.save_stepper = timed
        try:
            yield
        finally:
            coupled_train.save_stepper = save

    return context()


def _learning_rates(records):
    """A context in which each optimizer update appends its learning rate
    (the schedule at the update count) to ``records``."""
    import contextlib

    from ace_tpu_torch.core.optimization import Optimization

    update = Optimization._update

    def recorded(self, *args, **kwargs):
        records.append(self.schedule(self.schedule_count) * self.lr_scale)
        return update(self, *args, **kwargs)

    @contextlib.contextmanager
    def context():
        Optimization._update = recorded
        try:
            yield
        finally:
            Optimization._update = update

    return context()


def _coupled_run(label, counters, path, device, main):
    """``main([path], device=device)`` with the coupled trainer's phases
    probed (``_phase_probes``: launches, the batch loop's rate, no sync
    there on the card), its checkpoint writes timed and its exchanges
    probed; returns the trainer, the launches by phase, the batch loop's
    rates, the write records, the exchange records, the phases and the
    peak memory."""
    import torch

    from ace_tpu_torch.core.timing import GlobalTimer
    from ace_tpu_torch.coupled.train import CoupledTrainer

    cuda = torch.device(device).type == "cuda"
    launches, rates, saves, exchanges = {}, [], [], []
    GlobalTimer.reset()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with (_phase_probes(counters, launches, rates, cuda, None,
                        trainer_cls=CoupledTrainer,
                        phases=("_train_batches", "_validate")),
          _timed_saves(saves), _exchange_probes(exchanges)):
        trainer = main([path], device=device)
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    phases = GlobalTimer.get_instance().get_durations()
    none = {c.__name__: 0 for c in counters}
    for phase, counts in launches.items():
        print(f"{label}: launches per {phase} call {counts} (want none)")
        if any(c != none for c in counts):
            raise AssertionError(f"{label}: launches in {phase}")
    for name, seconds, size in saves:
        print(f"{label}: write {name}: {size} bytes in {seconds:.3f} s")
    return trainer, launches, rates, saves, exchanges, phases, peak


def _coupled_losses(label, experiment_dir, atmosphere_active):
    """metrics.jsonl's one line: finite losses, and an atmosphere loss of
    0 when its loss is off."""
    with open(os.path.join(experiment_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    (line,) = lines
    keys = ("loss", "atmosphere_loss", "ocean_loss", "val_loss")
    print(f"{label}: " + ", ".join(f"{k} {line[k]:.6g}" for k in keys))
    if not all(math.isfinite(line[k]) for k in keys):
        raise AssertionError(f"{label}: losses not finite")
    if (line["atmosphere_loss"] != 0) != atmosphere_active:
        raise AssertionError(f"{label}: atmosphere_loss "
                             f"{line['atmosphere_loss']}")
    return line


def coupled_train_path(counters, device="cuda", sizes=None, then=None):
    """Path C-R: ``python -m ace_tpu_torch.coupled``'s ``main`` on
    ``configs/baselines/cm4-piControl/train-config.yaml`` (the frozen CM4
    atmosphere, the SFNO at embed 384 and 8 layers, coupled to Samudra at
    widths 200-400, 4 coupled steps of 20 atmosphere steps, the ocean
    fraction predicted, the ocean alone in the loss) with the cuts of
    ``_coupled_config`` (at its full width, 180x360, float32, unless
    ``sizes`` gives the small sizes) over ``coupled_files``' merged
    stores, from ``coupled_checkpoints``' component weights. Checks
    finite losses with an atmosphere loss of 0; the atmosphere's weights
    bit-equal to its checkpoint after the epoch, in the trainer and in
    the written file; the ocean's changed; no launch and (on the card) no
    sync in the batch loop; ``_exchange_probes``' gates; and a restart (a
    second trainer on the same directory) loading weights bit-equal to
    the files it finds. Prints the loop's rate, the phases, the
    checkpoints' bytes and seconds and the peak. ``then(paths,
    checkpoints, ckpt_dir)`` runs after the gates inside the context that
    holds the files. Returns the launches and the loop's rate."""
    import contextlib
    import tempfile

    import torch

    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.coupled.train import CoupledTrainConfig, CoupledTrainer
    from ace_tpu_torch.coupled.train import main as coupled_main
    from ace_tpu_torch.stepper.parameter_init import read_base_weights

    label = "path C-R"
    sizes = sizes or {}
    nlat, nlon = sizes.get("nlat", 180), sizes.get("nlon", 360)
    n_inner = sizes.get("n_inner", C_INNER)
    _, missing = inference_packages()
    files = h5py_in_memory() if "h5py" in missing else (
        contextlib.nullcontext())
    with tempfile.TemporaryDirectory() as tmp, files:
        t0 = time.perf_counter()
        paths, _ = coupled_files(tmp, nlat, nlon,
                                 torch.Generator(device).manual_seed(11),
                                 device, n_inner=n_inner)
        base = coupled_checkpoints(tmp, paths, device, sizes)
        print(f"{label}: synthetic stores and component checkpoints in "
              f"{time.perf_counter() - t0:.1f} s")
        out_dir = os.path.join(tmp, "experiment")
        config = _coupled_config(paths, out_dir, sizes, weights=base)
        path = _write_yaml(os.path.join(tmp, "coupled.yaml"), config)
        trainer, launches, rates, saves, exchanges, phases, peak = (
            _coupled_run(label, counters, path, device, coupled_main))
        _check_exchange_probes(label, exchanges)
        line = _coupled_losses(label, out_dir, atmosphere_active=False)
        ckpt_dir = os.path.join(out_dir, "training_checkpoints")
        files_found = sorted(os.listdir(ckpt_dir))
        coupled = trainer.coupled
        n_params = {c: sum(p.numel() for p in getattr(coupled, c).module
                           .parameters()) for c in ("atmosphere", "ocean")}
        # the frozen atmosphere: bit-equal to its checkpoint, in the
        # trainer and in the file the trainer wrote
        base_atmos, _ = read_base_weights(base["atmosphere"])
        differ = [k for k, v in coupled.atmosphere.module.state_dict().items()
                  if not torch.equal(v.cpu(), base_atmos[k])]
        written, _ = read_base_weights(os.path.join(
            ckpt_dir, "atmosphere_ckpt.msgpack"))
        differ += [f"file:{k}" for k, v in written.items()
                   if not torch.equal(v, base_atmos[k])]
        base_ocean, _ = read_base_weights(base["ocean"])
        changed = [k for k, v in coupled.ocean.module.state_dict().items()
                   if not torch.equal(v.cpu(), base_ocean[k])]
        del trainer, coupled, base_atmos, written
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        # a restart: a second trainer on the same directory starts from
        # the files it finds
        second = CoupledTrainer(from_dict(CoupledTrainConfig, config),
                                device=device)
        second.init_weights()
        restarted = {c: _tensor_checksums(
            getattr(second.coupled, c).module.state_dict())
            for c in ("atmosphere", "ocean")}
        del second
        gc.collect()
        on_disk = {c: _file_checksums(os.path.join(
            ckpt_dir, f"{c}_ckpt.msgpack"), device)
            for c in ("atmosphere", "ocean")}
        restart_differ = [f"{c}/{k}" for c in on_disk
                          for k, v in on_disk[c].items()
                          if restarted[c].get(k) != v]
        print(f"{label}: {C_TRAIN} at {nlat}x{nlon}, {n_inner} atmosphere "
              f"steps an ocean step, {config['stepper_training']['n_coupled_steps']} "
              f"coupled steps a sample, batch {C_BATCH}; parameters "
              f"{n_params}; batch loop {rates[0]:.4f} train steps/s; phases "
              f"{ {k: round(v, 4) for k, v in sorted(phases.items())} }; "
              f"peak device memory {peak:.2f} GB; files {files_found}")
        print(f"{label}: the atmosphere's weights differing from its "
              f"checkpoint: {differ[:5]} (want none); the ocean's changed: "
              f"{len(changed)} of {len(base_ocean)} tensors; restart: "
              f"{sum(len(v) for v in on_disk.values()) - len(restart_differ)}"
              f" of {sum(len(v) for v in on_disk.values())} checksums equal "
              f"to the files")
        want_files = {f"{c}{s}.msgpack" for c in ("atmosphere", "ocean")
                      for s in ("_ckpt", "_ema_ckpt")}
        if set(files_found) != want_files:
            raise AssertionError(f"{label}: checkpoint files {files_found}")
        if differ or not changed:
            raise AssertionError(f"{label}: the atmosphere moved or the "
                                 "ocean did not")
        if restart_differ:
            raise AssertionError(f"{label}: the restart's weights differ "
                                 f"from the files: {restart_differ[:5]}")
        if then is not None:
            then(paths, base, ckpt_dir)
    total = {c.__name__: sum(n[c.__name__] for calls in launches.values()
                             for n in calls) for c in counters}
    return total, rates[0], line


def coupled_finetune_path(counters, paths, ckpt_dir, device="cuda",
                          sizes=None):
    """Path C-F: the coupled trainer's ``main`` on
    ``configs/baselines/cm4-piControl/finetune-config.yaml`` (both
    components trained, the atmosphere's loss over its first 2 steps,
    ``CosineAnnealingLR``) from path C-R's ``training_checkpoints`` as its
    ``parameter_init.checkpoint_path``, with C-R's cuts, 2 coupled steps
    and the training subset's first 2 ocean starts. Checks finite losses
    (the atmosphere's active), both components' weights changed, each
    update's learning rate that of ``ace_tpu``'s ``CosineAnnealingLR``
    (T_max the epochs, stepped per update), no launch and (on the card) no
    sync in the batch loop. Returns the launches and the loop's rate."""
    import tempfile

    import torch

    from ace_tpu_torch.coupled.train import main as coupled_main
    from ace_tpu_torch.stepper.parameter_init import read_base_weights

    label = "path C-F"
    lrs = []
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "finetune")
        config = _coupled_config(paths, out_dir, sizes, source=C_FINETUNE,
                                 checkpoint_path=ckpt_dir,
                                 n_coupled_steps=C_F_COUPLED_STEPS,
                                 first_pairs=True)
        path = _write_yaml(os.path.join(tmp, "finetune.yaml"), config)
        with _learning_rates(lrs):
            trainer, launches, rates, _, exchanges, phases, peak = (
                _coupled_run(label, counters, path, device, coupled_main))
        _check_exchange_probes(label, exchanges)
        line = _coupled_losses(label, out_dir, atmosphere_active=True)
        unchanged = {}
        for c in ("atmosphere", "ocean"):
            before, _ = read_base_weights(os.path.join(
                ckpt_dir, f"{c}_ckpt.msgpack"))
            state = getattr(trainer.coupled, c).module.state_dict()
            unchanged[c] = all(torch.equal(v.cpu(), before[k])
                               for k, v in state.items())
        del trainer
        gc.collect()
    opt = config["optimization"]
    t_max = opt["scheduler"].get("kwargs", {}).get("T_max",
                                                   config["max_epochs"])
    want = [opt["lr"] * 0.5 * (1 + math.cos(math.pi * min(i, t_max) / t_max))
            for i in range(len(lrs))]
    print(f"{label}: {C_FINETUNE}, {C_F_COUPLED_STEPS} coupled steps; batch "
          f"loop {rates[0]:.4f} train steps/s; phases "
          f"{ {k: round(v, 4) for k, v in sorted(phases.items())} }; peak "
          f"device memory {peak:.2f} GB; learning rate by update {lrs} "
          f"(CosineAnnealingLR: {want}); unchanged components "
          f"{[c for c, u in unchanged.items() if u]}")
    if any(unchanged.values()):
        raise AssertionError(f"{label}: a component did not train")
    if not lrs or any(abs(a - b) > 1e-12 * opt["lr"]
                      for a, b in zip(lrs, want)):
        raise AssertionError(f"{label}: the learning rates differ from "
                             "CosineAnnealingLR")
    total = {c.__name__: sum(n[c.__name__] for calls in launches.values()
                             for n in calls) for c in counters}
    return total, rates[0], line


def _no_sync_in(owner, name):
    """A context in which ``owner.<name>`` raises at any synchronizing
    call on the card; returns the seconds of each call (host clock, ending
    in a synchronize) in a list."""
    import contextlib

    import torch

    fn = getattr(owner, name)
    seconds = []

    def checked(*args, **kwargs):
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            result = fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return result

    @contextlib.contextmanager
    def context():
        setattr(owner, name, checked)
        try:
            yield seconds
        finally:
            setattr(owner, name, fn)

    return context()


def coupled_evaluator_path(counters, paths, ckpt_dir, device="cuda",
                           sizes=None):
    """Path C-E: ``python -m ace_tpu_torch.coupled.evaluator``'s ``main``
    on ``configs/baselines/cm4-piControl/evaluator-config.yaml`` over path
    C-R's ``training_checkpoints``, ``C_E_STEPS`` coupled steps (2920) in
    windows of ``C_E_IN_MEMORY`` (20) from ``0311-01-01`` over the
    evaluator stores. Checks no launch, no sync in the window loop (on the
    card), each window's predictions against one ``CoupledStepper.predict``
    over all the coupled steps from the same initial condition and forcing
    (within ``C_E_PREDICT_TOL`` of each variable's largest value, NaN on
    the same cells), finite ``inference/atmosphere/*`` logs and
    ``inference/ocean/*`` NaN exactly for the masked variables (every
    ocean output: a mean of a NaN-filled field, as in ``ace_tpu``). Returns
    the launches and the atmosphere steps/s."""
    import contextlib
    import tempfile

    import torch

    from ace_tpu_torch.core.timing import GlobalTimer
    from ace_tpu_torch.coupled import evaluator
    from ace_tpu_torch.coupled import inference as coupled_inference
    from ace_tpu_torch.coupled.stepper import CoupledStepper

    label = "path C-E"
    cuda = torch.device(device).type == "cuda"
    n_inner = (sizes or {}).get("n_inner", C_INNER)
    calls = []
    predict = CoupledStepper.predict

    def recorded(self, state, atmos_forcing, ocean_forcing, *args, **kw):
        out = predict(self, state, atmos_forcing, ocean_forcing, *args, **kw)
        calls.append((self, state, atmos_forcing, ocean_forcing, out))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "evaluator")
        config = _coupled_evaluator_config(paths, ckpt_dir, out_dir)
        path = _write_yaml(os.path.join(tmp, "evaluator.yaml"), config)
        GlobalTimer.reset()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        guard = (_no_sync_in(coupled_inference, "run_windows") if cuda
                 else contextlib.nullcontext([]))
        CoupledStepper.predict = recorded
        try:
            with guard as loop_seconds:
                logs, launches = counted(
                    counters, lambda: evaluator.main([path], device=device))
        finally:
            CoupledStepper.predict = predict
        phases = GlobalTimer.get_instance().get_durations()
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    coupled, state = calls[0][0], calls[0][1]
    atmos_forcing = {k: torch.cat([calls[0][2][k]] + [c[2][k][:, 1:]
                                                      for c in calls[1:]], 1)
                     for k in calls[0][2]}
    ocean_forcing = {k: torch.cat([calls[0][3][k]] + [c[3][k][:, 1:]
                                                      for c in calls[1:]], 1)
                     for k in calls[0][3]}
    a_ref, o_ref, _ = coupled.predict(state, atmos_forcing, ocean_forcing)
    errs, nan_differs = {}, []
    for i, ref in enumerate((a_ref, o_ref)):
        for k, r in ref.items():
            got = torch.cat([c[4][i][k] for c in calls], 1)
            if not torch.equal(torch.isnan(got), torch.isnan(r)):
                nan_differs.append(k)
            scale = r.abs().nan_to_num(0.0).max().clamp_min(1e-30)
            errs[k] = float((got - r).abs().nan_to_num(0.0).max() / scale)
    worst = max(errs, key=errs.get)
    provider = coupled.ocean.dataset_info.mask_provider
    atmos_logs = {k: v for k, v in logs.items()
                  if k.startswith("inference/atmosphere/")}
    ocean_logs = {k: v for k, v in logs.items()
                  if k.startswith("inference/ocean/")}
    bad_atmos = [k for k, v in atmos_logs.items() if not math.isfinite(v)]
    bad_ocean = [k for k, v in ocean_logs.items()
                 if math.isnan(v) != (provider.mask_key_for(
                     k.rsplit("/", 1)[-1]) is not None)]
    n_atmos_steps = C_E_STEPS * n_inner
    rate = (n_atmos_steps / loop_seconds[0] if loop_seconds
            else float("nan"))
    print(f"{label}: {C_EVALUATOR} over C-R's checkpoints, {C_E_STEPS} "
          f"coupled steps ({n_atmos_steps} atmosphere steps) in windows of "
          f"{C_E_IN_MEMORY} at batch 1: window loop {rate:.4f} atmosphere "
          f"steps/s; phases "
          f"{ {k: round(v, 4) for k, v in sorted(phases.items())} }; peak "
          f"device memory {peak:.2f} GB; launches {launches}")
    print(f"{label}: predictions vs one CoupledStepper.predict: largest "
          f"error {errs[worst]:.3g} of the variable's largest value ({worst};"
          f" tol {C_E_PREDICT_TOL}), NaN cells differ for {nan_differs[:5]};"
          f" {len(atmos_logs)} inference/atmosphere logs, not finite "
          f"{bad_atmos[:5]}; {len(ocean_logs)} inference/ocean logs, NaN "
          f"other than on the masked variables {bad_ocean[:5]}")
    if launches != {c.__name__: 0 for c in counters}:
        raise AssertionError(f"{label}: launches {launches}")
    if nan_differs or not errs[worst] <= C_E_PREDICT_TOL:
        raise AssertionError(f"{label}: the predictions disagree with "
                             "CoupledStepper.predict")
    if bad_atmos or bad_ocean or not atmos_logs or not ocean_logs:
        raise AssertionError(f"{label}: logs not as expected")
    return launches, rate


def coupled_bf16_path(counters, paths, base, device="cuda", sizes=None):
    """Path C-bf16: path C-R's config with the atmosphere builder's
    ``compute_dtype: bfloat16``, ``C_BF16_COUPLED_STEPS`` coupled steps
    at batch 1: a warm-up train step, then ``C_BF16_STEPS`` train steps
    on the same batch, each launching exactly, per atmosphere block, K1 in
    the forward of every atmosphere step and again in the recompute of
    every step after the first outer step, 1b in those steps' backward
    and no 1c (the atmosphere is frozen; outer step 1 depends on data
    alone), with no sync on the card and finite losses; then a coupled
    rollout of 1 outer step (K1 in each block of each step). Returns the
    launches and the train steps/s."""
    import tempfile

    import torch

    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.coupled.stepper import CoupledPrognosticState
    from ace_tpu_torch.coupled.train import CoupledTrainConfig, CoupledTrainer
    from ace_tpu_torch.stepper.stepper import PrognosticState

    label = "path C-bf16"
    cuda = torch.device(device).type == "cuda"
    sizes = sizes or {}
    n_inner = sizes.get("n_inner", C_INNER)
    with tempfile.TemporaryDirectory() as tmp:
        config = _coupled_config(paths, tmp, sizes, weights=base,
                                 n_coupled_steps=C_BF16_COUPLED_STEPS)
        builder = config["stepper"]["atmosphere"]["stepper"]["step"][
            "config"]["builder"]["config"]
        builder["compute_dtype"] = "bfloat16"
        trainer = CoupledTrainer(from_dict(CoupledTrainConfig, config),
                                 device=device)
        trainer.init_weights()
        atmos_batch, ocean_batch = trainer._batch([0])
        layers = builder["num_layers"]
        none = {c.__name__: 0 for c in counters}
        n_outer = C_BF16_COUPLED_STEPS
        want_step = none if not cuda else {
            **none, "dhconv_filter": (2 * n_outer - 1) * n_inner * layers,
            "dhconv_filter_dx": (n_outer - 1) * n_inner * layers}
        want_rollout = none if not cuda else {
            **none, "dhconv_filter": n_inner * layers}
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        warm, warm_launches = counted(
            counters, lambda: trainer.train_step(atmos_batch, ocean_batch))
        if cuda:
            torch.cuda.synchronize()
        steps, step_launches = [], []
        t0 = time.perf_counter()
        for _ in range(C_BF16_STEPS):
            if cuda:
                torch.cuda.set_sync_debug_mode("error")
            try:
                metrics, launches = counted(
                    counters,
                    lambda: trainer.train_step(atmos_batch, ocean_batch))
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode("default")
            steps.append(metrics)
            step_launches.append(launches)
        if cuda:
            torch.cuda.synchronize()
        rate = C_BF16_STEPS / (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
        coupled = trainer.coupled
        ic = CoupledPrognosticState(
            atmosphere_data=PrognosticState(data={
                k: atmos_batch[k][:, :1]
                for k in coupled.atmosphere.prognostic_names}),
            ocean_data=PrognosticState(data={
                k: ocean_batch[k][:, :1]
                for k in coupled.ocean.prognostic_names}))
        (a_out, o_out, _), rollout_launches = counted(
            counters, lambda: coupled.predict(
                ic, {k: v[:, :n_inner + 1] for k, v in atmos_batch.items()},
                {k: v[:, :2] for k, v in ocean_batch.items()}))
        finite = all(bool(torch.isfinite(v).all()) for v in a_out.values())
        del trainer, coupled
        gc.collect()
    losses = [float(m["loss"]) for m in (warm, *steps)]
    print(f"{label}: {C_TRAIN} with the atmosphere in bfloat16, "
          f"{n_outer} coupled steps, batch 1: losses {losses}; "
          f"{rate:.4f} train steps/s; peak device memory {peak:.2f} GB; "
          f"launches: warm-up {warm_launches}, each step {step_launches} "
          f"(want {want_step}), a rollout of 1 outer step "
          f"{rollout_launches} (want {want_rollout}); the rollout's "
          f"atmosphere finite {finite}")
    if not all(map(math.isfinite, losses)) or not finite:
        raise AssertionError(f"{label}: losses or outputs not finite")
    if (warm_launches != want_step
            or any(n != want_step for n in step_launches)
            or rollout_launches != want_rollout):
        raise AssertionError(f"{label}: launch counts")
    total = {c.__name__: warm_launches[c.__name__]
             + sum(n[c.__name__] for n in step_launches)
             + rollout_launches[c.__name__] for c in counters}
    return total, rate


def coupled_stepper_dicts(nlat=16, nlon=32, embed=32, layers=2,
                          ch_width=(16, 24, 32), dilation=(1, 2, 2),
                          n_inner=4, compute_dtype="float32"):
    """A small coupled stepper of the CM4 coupled YAML's shape, as a config
    dict (what either package's ``from_dict`` reads: the YAML's stepper
    block with the SFNO at ``embed`` and ``layers``, Samudra at
    ``ch_width`` and ``dilation``, statistics of the synthetic draws and
    no timedeltas) and the port's dataset infos of the two components
    (the ocean's grid, depth coordinate and masks at ``n_inner``
    six-hourly steps a step; the atmosphere's 8-level vertical
    coordinate on the same grid)."""
    import datetime

    import numpy as np
    import torch

    from ace_tpu_torch.core.coordinates import HybridSigmaPressureCoordinate
    from ace_tpu_torch.core.dataset_info import DatasetInfo

    stepper = _yaml(C_TRAIN)["stepper"]
    ocean, ocean_info = ocean_stepper_dict(
        nlat, nlon, ch_width, dilation,
        timestep=n_inner * C_ATMOS_TIMESTEP)
    stepper["ocean"] = {"stepper": ocean}
    atmos = stepper["atmosphere"]["stepper"]
    step = atmos["step"]["config"]
    step["builder"]["config"].update(embed_dim=embed, num_layers=layers,
                                     compute_dtype=compute_dtype)
    names = sorted(set(step["in_names"]) | set(step["out_names"]))
    land = 1.0 - ocean_info.mask_provider.masks["mask_2d"]
    sample = {k: _coupled_draw(k, (4, nlat, nlon),
                               torch.Generator().manual_seed(0), "cpu", land)
              for k in names}
    step["normalization"] = {"network": {
        "means": {k: float(v.mean()) for k, v in sample.items()},
        "stds": {k: float(v.std()) for k, v in sample.items()}}}
    stepper["atmosphere"] = {"stepper": atmos}
    nz = 8
    atmos_info = DatasetInfo(
        horizontal_coordinates=ocean_info.horizontal_coordinates,
        vertical_coordinate=HybridSigmaPressureCoordinate(
            ak=np.concatenate([np.linspace(100.0, 5000.0, nz // 2),
                               np.linspace(5000.0, 0.0, nz // 2 + 1)]),
            bk=np.linspace(0.0, 1.0, nz + 1)),
        timestep=datetime.timedelta(seconds=C_ATMOS_TIMESTEP))
    return stepper, atmos_info, ocean_info


def coupled_inputs(coupled, n_outer, batch, generator):
    """A random initial condition and forcing for ``coupled`` (CPU
    tensors): the atmosphere's ``_coupled_draw`` fields and the ocean's
    ``ocean_inputs`` (NaN on the dry cells) over ``n_outer`` outer steps;
    returns the ``CoupledPrognosticState``, the forcing of each component
    and each component's batch (every variable, ``[batch, T + 1, lat,
    lon]``)."""
    from ace_tpu_torch.coupled.stepper import CoupledPrognosticState
    from ace_tpu_torch.stepper.stepper import PrognosticState

    n_inner = coupled.n_inner_steps
    a_info, o_info = (coupled.atmosphere.dataset_info,
                      coupled.ocean.dataset_info)
    nlat, nlon = a_info.img_shape
    provider = o_info.mask_provider
    land = 1.0 - provider.masks["mask_2d"]
    atmos = {k: _coupled_draw(k, (batch, n_outer * n_inner + 1, nlat, nlon),
                              generator, "cpu", land)
             for k in coupled.all_atmosphere_names}
    ocean = ocean_inputs(
        coupled.all_ocean_names, (batch, n_outer + 1, nlat, nlon), generator,
        o_info.horizontal_coordinates.lat,
        o_info.vertical_coordinate.idepth, provider)
    ic = CoupledPrognosticState(
        atmosphere_data=PrognosticState(data={
            k: atmos[k][:, :1] for k in coupled.atmosphere.prognostic_names}),
        ocean_data=PrognosticState(data={
            k: ocean[k][:, :1] for k in coupled.ocean.prognostic_names}))
    atmos_forcing = {k: atmos[k] for k in coupled.atmosphere_forcing_window_names}
    ocean_forcing = {k: ocean[k] for k in coupled.ocean_forcing_window_names}
    return ic, atmos_forcing, ocean_forcing, atmos, ocean


def reference_coupled_phase(counters, device="cuda"):
    """Reference phase C: a small coupled system of the CM4 coupled YAML's
    shape (``coupled_stepper_dicts`` at ``C_REFERENCE_SIZES``, float32, the
    ocean fraction predicted, NaN on the dry cells) on ``device`` against
    the CPU from the same weights and inputs: both components' outputs
    over ``C_REFERENCE_OUTER`` outer steps (NaN on the same cells, within
    reference S's float32 limits of each channel's anomaly plus 1e-5 of
    its largest value, ``C_BUDGET_TOL`` for ``C_BUDGET_NAMES``), and the
    coupled training loss (the ocean's MSE
    over both ocean steps, the atmosphere frozen) and every ocean
    gradient through ``predict_with_grad``, with no kernel launch."""
    import torch

    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.core.loss import StepLossConfig
    from ace_tpu_torch.coupled.stepper import CoupledStepperConfig

    label = "reference C (SFNO and Samudra, f32)"
    sizes = dict(C_REFERENCE_SIZES)
    stepper, a_info, o_info = coupled_stepper_dicts(**sizes)
    config = from_dict(CoupledStepperConfig, stepper)
    sides = [config.get_stepper(a_info, o_info, device=dev)
             for dev in ("cpu", device)]
    gen = torch.Generator().manual_seed(3)
    sides[0].init_params(gen)
    for c in ("atmosphere", "ocean"):
        getattr(sides[1], c).load_state_dict(
            getattr(sides[0], c).module.state_dict())
    ic, af, of, _, ocean = coupled_inputs(sides[0], C_REFERENCE_OUTER, 2, gen)
    results = []
    for coupled in sides:
        dev = coupled.device

        def run():
            moved = type(ic)(
                atmosphere_data=type(ic.atmosphere_data)(data={
                    k: v.to(dev) for k, v in ic.atmosphere_data.data.items()}),
                ocean_data=type(ic.ocean_data)(data={
                    k: v.to(dev) for k, v in ic.ocean_data.data.items()}))
            a_f = {k: v.to(dev) for k, v in af.items()}
            o_f = {k: v.to(dev) for k, v in of.items()}
            a_out, o_out, _ = coupled.predict(moved, a_f, o_f)
            for p in coupled.atmosphere.module.parameters():
                p.requires_grad_(False)
            params = dict(coupled.ocean.module.named_parameters())
            for p in params.values():
                p.grad = None
            _, o_grad, _ = coupled.predict_with_grad(moved, a_f, o_f)
            loss = StepLossConfig(type="MSE").build(
                o_info.gridded_operations, out_names=coupled.ocean.out_names,
                normalizer=coupled.ocean.step.config.normalization
                .build_loss_normalizer(
                    coupled.ocean.step.config._normalize_names))(
                o_grad, {k: ocean[k][:, 1:].to(dev)
                         for k in coupled.ocean.out_names}, 0).total
            loss.backward()
            grads = {k: p.grad.detach().cpu() for k, p in params.items()}
            return {**a_out, **o_out}, loss.detach().cpu(), grads

        results.append(counted(counters, run))
    (ref, ref_loss, ref_grads), _ = results[0]
    (got, loss, grads), launches = results[1]
    ratios = {}
    for k, r in ref.items():
        g = got[k].cpu()
        if not torch.equal(torch.isnan(r), torch.isnan(g)):
            ratios[k] = math.inf
            continue
        anomaly = (r - r.nanmean((-2, -1), keepdim=True)).abs().nan_to_num(
            0.0).amax((-2, -1))
        err = (g - r).abs().nan_to_num(0.0).amax((-2, -1))
        largest = r.abs().nan_to_num(0.0).amax((-2, -1))
        allowed = (S_F32_TOL * anomaly
                   + (C_BUDGET_TOL if k in C_BUDGET_NAMES else 1e-5)
                   * largest)
        ratios[k] = float((err / allowed).max())
    worst_out = max(ratios, key=ratios.get)
    loss_err = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    largest = max(float(r.double().norm()) for r in ref_grads.values())
    zero = _samudra_zero_gradients(ref_grads)
    gerrs = {k: float((grads[k].double() - r.double()).norm())
             / (S_F32_GRAD_TOL * float(r.double().norm()) + 1e-6 * largest)
             for k, r in ref_grads.items() if k not in zero}
    for k in zero:
        gerrs[k] = max(float(g[k].double().norm())
                       for g in (grads, ref_grads)) / (S_F32_GRAD_TOL * largest)
    worst = max(gerrs, key=gerrs.get)
    print(f"{label}: {device} vs CPU: outputs {ratios[worst_out]:.3g} of the "
          f"allowed ({worst_out}); loss {float(loss):.6g} / "
          f"{float(ref_loss):.6g}, relative error {loss_err:.3g} (tol "
          f"{S_F32_LOSS_TOL}); ocean gradients {gerrs[worst]:.3g} of the "
          f"allowed ({worst}) over {len(gerrs)} parameters; launches "
          f"{launches}")
    if not (ratios[worst_out] <= 1 and loss_err <= S_F32_LOSS_TOL
            and gerrs[worst] <= 1):
        raise AssertionError(f"{label}: the card disagrees with the CPU")
    if launches != {c.__name__: 0 for c in counters}:
        raise AssertionError(f"reference C: launches {launches}")
    return launches


def coupled_paths(counters, smi, sizes=None, device="cuda"):
    """Reference phase C, then paths C-R, C-F, C-E and C-bf16: the
    launches of each path. ``sizes`` makes the small copies the CPU
    runs."""
    t0 = time.perf_counter()
    reference_coupled_phase(counters, device)
    out = {}
    print(smi)

    def then(paths, base, ckpt_dir):
        print(smi)
        out["C-F"], _, _ = coupled_finetune_path(counters, paths, ckpt_dir,
                                                 device=device, sizes=sizes)
        gc.collect()
        out["C-E"], _ = coupled_evaluator_path(counters, paths, ckpt_dir,
                                               device=device, sizes=sizes)
        gc.collect()
        out["C-bf16"], _ = coupled_bf16_path(counters, paths, base,
                                             device=device, sizes=sizes)

    out["C-R"], _, _ = coupled_train_path(counters, device=device,
                                          sizes=sizes, then=then)
    print(f"path C (reference C, C-R, C-F, C-E, C-bf16): "
          f"{time.perf_counter() - t0:.1f} s")
    return {k: out[k] for k in ("C-R", "C-F", "C-E", "C-bf16")}


FCN3_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "fcn3-train.yaml")
# path N-R: the YAML's batch of 4 for both loaders, 2 training batches (8
# windows of its one forward step: 9 six-hourly times) and 1 validation
# batch (5 times); N-I reads a file of its own, N_STEPS steps from each of
# its first two times
N_BATCH = 4
N_SPLITS = (("train", 9, "2000-01-01T00:00"),
            ("valid", 5, "2001-01-01T00:00"),
            ("inference", N_STEPS + 2, "2002-01-01T00:00"))
N_WINDOW = 5
N_PREDICT_TOL = 1e-5
# reference N: a small FCN3 of the recipe's shape, float32, card against
# CPU within reference S's float32 limits (its 4 layers: two global, two
# local), with one atmosphere diagnostic (the recipe has none) so that
# each level's group carries a diagnostic channel
N_REFERENCE_SIZES = {"nlat": 32, "nlon": 64, "levels": 2, "embed": 8,
                     "layers": 4, "scale_factor": 2}
N_DIAGNOSTIC = "relative_humidity"
# DISCO alone at ragged shapes (odd nlat, a downsampling), card against
# CPU: within 1e-5 of the largest output
N_RAGGED = (((45, 90), (45, 90), "piecewise linear"),
            ((33, 66), (11, 22), "zernike"))
N_DISCO_TOL = 1e-5


def fcn3_step_dict(levels=8, diagnostic=False, stats=None, **builder):
    """The step config of ``configs/fcn3-train.yaml`` with ``levels``
    atmosphere levels, ``N_DIAGNOSTIC`` as an atmosphere diagnostic when
    ``diagnostic``, the network's statistics from ``stats`` (the means and
    stds files) or else ``_field_scale``'s draws, and ``builder``
    overriding the network's fields."""
    import copy

    step = copy.deepcopy(_yaml(FCN3_CONFIG)["stepper"]["step"]["config"])
    step["builder"]["config"].update(builder)
    step["atmosphere_levels"] = levels
    if diagnostic:
        step["atmosphere_diagnostic_names"] = [N_DIAGNOSTIC]
    if stats is not None:
        step["normalization"]["network"] = {
            "global_means_path": stats["centering"],
            "global_stds_path": stats["scaling-full-field"]}
    else:
        names = _fcn3_names(step)
        step["normalization"]["network"] = {
            "means": {k: _field_scale(k)[0] for k in names},
            "stds": {k: _field_scale(k)[1] for k in names}}
    return step


def _fcn3_names(step=None):
    """Every variable of the FCN3 step config ``step`` (the YAML's by
    default): 37 for the recipe."""
    if step is None:
        step = _yaml(FCN3_CONFIG)["stepper"]["step"]["config"]
    per_level = (step["atmosphere_prognostic_names"]
                 + step["atmosphere_diagnostic_names"])
    return sorted([f"{k}_{i}" for i in range(step["atmosphere_levels"])
                   for k in per_level]
                  + step["surface_prognostic_names"]
                  + step["surface_diagnostic_names"]
                  + step["forcing_names"])


def fcn3_stepper_config(nlat=32, nlon=64, levels=2, diagnostic=True,
                        **builder):
    """A stepper config of ``fcn3_step_dict`` and the dataset info of its
    Legendre-Gauss grid."""
    from datetime import timedelta

    import numpy as np

    from ace_tpu_torch.core.coordinates import (
        LatLonCoordinates,
        gaussian_latitudes,
    )
    from ace_tpu_torch.core.dataset_info import DatasetInfo
    from ace_tpu_torch.core.step import StepSelector
    from ace_tpu_torch.stepper.stepper import StepperConfig

    step = fcn3_step_dict(levels, diagnostic, **builder)
    info = DatasetInfo(
        horizontal_coordinates=LatLonCoordinates(
            lat=gaussian_latitudes(nlat),
            lon=np.linspace(0, 360, nlon, endpoint=False)),
        timestep=timedelta(hours=6))
    return StepperConfig(step=StepSelector(type="FCN3", config=step)), info


def fcn3_inputs(stepper, n_steps, batch, generator):
    """An initial condition, ``n_steps + 1`` forcing times and a training
    batch of as many times for an FCN3 stepper, ``_draw``n on the CPU from
    ``generator``."""
    from ace_tpu_torch.stepper.stepper import PrognosticState

    nlat, nlon = stepper.dataset_info.img_shape
    step = stepper.step
    data = {k: _draw(k, (batch, n_steps + 1, nlat, nlon), generator, "cpu")
            for k in sorted(set(step.input_names) | set(step.output_names))}
    ic = PrognosticState(data={k: data[k][:, :1]
                               for k in stepper.prognostic_names})
    return ic, {k: data[k] for k in stepper.forcing_window_names}, data


def _disco_ragged_phase(device):
    """``DiscoConvS2`` alone at ``N_RAGGED``'s shapes (3x3, Legendre-Gauss,
    3 samples of 5 channels), ``device`` against the CPU."""
    import torch

    from ace_tpu_torch.ops.disco import DiscoConvS2

    gen = torch.Generator().manual_seed(5)
    for in_shape, out_shape, basis in N_RAGGED:
        x = torch.randn(3, *in_shape, 5, generator=gen)
        conv = DiscoConvS2(in_shape, out_shape, (3, 3),
                           grid_in="legendre-gauss",
                           grid_out="legendre-gauss", basis_type=basis)
        ref = conv(x)
        got = conv.to(device)(x.to(device)).cpu()
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        print(f"reference N: DISCO {basis} {in_shape} -> {out_shape} "
              f"(K {conv.kernel_size}), {device} vs CPU: {err:.3g} of the "
              f"largest output (tol {N_DISCO_TOL})")
        if not (got.shape == ref.shape and err <= N_DISCO_TOL):
            raise AssertionError("reference N: DISCO disagrees with the CPU")


def reference_fcn3_phase(counters, device="cuda"):
    """Reference phase N: ``DiscoConvS2`` at ragged shapes, then a small
    FCN3 of the recipe's shape (``N_REFERENCE_SIZES``, float32) on
    ``device`` against the CPU from the same weights and inputs: one
    forward step and one train step under MSE, within reference S's
    float32 limits, with no kernel launch."""
    _disco_ragged_phase(device)
    sizes = dict(N_REFERENCE_SIZES)
    nlat, nlon, levels = sizes.pop("nlat"), sizes.pop("nlon"), sizes.pop(
        "levels")
    builder = {"atmo_embed_dim": sizes["embed"],
               "surf_embed_dim": sizes["embed"],
               "aux_embed_dim": sizes["embed"],
               "num_layers": sizes["layers"],
               "scale_factor": sizes["scale_factor"]}
    launches = _reference_case(
        "reference N (FCN3, f32)", counters, device,
        (S_F32_TOL, S_F32_LOSS_TOL, S_F32_GRAD_TOL),
        lambda dtype: fcn3_stepper_config(nlat, nlon, levels, **builder),
        "float32", lambda stepper, gen: fcn3_inputs(stepper, 1, 2, gen),
        n_steps=1, zero_gradients=lambda names: set())
    if launches != {c.__name__: 0 for c in counters}:
        raise AssertionError(f"reference N: launches {launches}")
    return launches


def _fcn3_config(paths, experiment_dir, sizes=None):
    """``configs/fcn3-train.yaml`` with path N-R's cuts: the synthetic
    files for the placeholder data and stats paths, one epoch, no output
    to the screen; ``sizes`` (``embed``, ``layers``, ``scale_factor``)
    makes the small copies the CPU runs."""
    config = _yaml(FCN3_CONFIG)
    config["experiment_dir"] = experiment_dir
    config["max_epochs"] = 1
    config["logging"]["log_to_screen"] = False
    for loader, split in (("train_loader", "train"),
                          ("validation_loader", "valid")):
        config[loader]["dataset"]["data_path"] = paths[split]
    step = config["stepper"]["step"]["config"]
    step["normalization"]["network"] = {
        "global_means_path": paths["centering"],
        "global_stds_path": paths["scaling-full-field"]}
    if sizes:
        step["builder"]["config"].update(
            atmo_embed_dim=sizes["embed"], surf_embed_dim=sizes["embed"],
            aux_embed_dim=sizes["embed"], num_layers=sizes["layers"],
            scale_factor=sizes["scale_factor"])
    return config


def _tf32_probe(flags):
    """A context that turns TF32 on for CUDA matmuls and cuDNN
    convolutions (the latter PyTorch's default) before an entry runs, and
    appends to ``flags`` what the entry left, ``(matmul, cudnn)``, as it
    closes; then turns both off again."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def context():
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            flags.append((torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32))
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    return context()


def _check_tf32_pinned(label, flags):
    print(f"{label}: TF32 (matmul, cudnn) after each entry run, set on "
          f"before it: {flags}")
    if not flags or any(any(f) for f in flags):
        raise AssertionError(f"{label}: an entry left TF32 on")


def fcn3_train_path(counters, device="cuda", sizes=None, then=None):
    """Path N-R: ``python -m ace_tpu_torch.train``'s ``main`` on
    ``configs/fcn3-train.yaml`` with the cuts of ``_fcn3_config`` (at the
    recipe's full width, 180x360 on the Legendre-Gauss grid, unless
    ``sizes`` gives ``nlat``, ``nlon``, ``embed``, ``layers`` and
    ``scale_factor``) over synthetic files of its 37 variables
    (``N_SPLITS``): one epoch, then ``--override max_epochs=2``, which
    must resume at epoch 1 with its state bit for bit. TF32 is turned on
    before each run, and each must leave it off. Checks finite metrics,
    one ``metrics.jsonl`` line per epoch, the checkpoint files, no kernel
    launch, no sync in the batch loop (on the card); prints the loop's
    rates, the phases, the checkpoints' bytes and seconds and the peak.
    ``then(paths, best)`` runs after the gates inside the context that
    holds the files. Returns the launches and the loop's rates."""
    import contextlib
    import tempfile

    import torch

    label = "path N-R"
    sizes = sizes or {}
    nlat, nlon = sizes.get("nlat", 180), sizes.get("nlon", 360)
    names = _fcn3_names()
    _, missing = inference_packages()
    files = h5py_in_memory() if "h5py" in missing else (
        contextlib.nullcontext())
    with tempfile.TemporaryDirectory() as tmp, files:
        paths = _training_files(tmp, names, nlat, nlon,
                                torch.Generator(device).manual_seed(11),
                                device, splits=N_SPLITS)
        out_dir = os.path.join(tmp, "experiment")
        config = _fcn3_config(paths, out_dir, sizes)
        path = _write_yaml(os.path.join(tmp, "fcn3.yaml"), config)
        builder = config["stepper"]["step"]["config"]["builder"]["config"]
        print(f"{label}: {FCN3_CONFIG} at {nlat}x{nlon}, {len(names)} "
              f"variables, {builder}, batch {N_BATCH}")
        flags = []
        runs, launches, rates, restored, _, n_params = _epoch_then_resume(
            label, path, counters, device, lambda: [_tf32_probe(flags)])
        ckpt_dir = os.path.join(out_dir, "training_checkpoints")
        files_found = sorted(os.listdir(ckpt_dir))
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        print(f"{label}: {n_params} parameters; batch loop "
              f"{rates[0]:.4f} (epoch 1) and {rates[1]:.4f} (epoch 2) train "
              f"steps/s at batch {N_BATCH} ({rates[1] * N_BATCH:.4f} "
              f"samples/s); losses by epoch: train "
              f"{[line['train/loss'] for line in lines]}, validation "
              f"{[line['val/loss'] for line in lines]}; {len(lines[-1])} "
              f"metrics; checkpoint files {files_found}")
        bad = [k for line in lines for k, v in line.items()
               if not math.isfinite(v)]
        if len(lines) != 2 or bad:
            raise AssertionError(f"{label}: {len(lines)} metrics.jsonl "
                                 f"lines, not finite: {bad[:5]}")
        want_files = {"ckpt.msgpack", "best_ckpt.msgpack", "ema_ckpt.msgpack"}
        if not want_files <= set(files_found):
            raise AssertionError(f"{label}: checkpoint files {files_found}")
        _check_tf32_pinned(label, flags)
        _check_resume(label, runs, restored)
        _check_no_launches(label, counters, launches)
        if then is not None:
            then(paths, os.path.join(ckpt_dir, "best_ckpt.msgpack"))
    total = {c.__name__: sum(n[c.__name__] for calls in launches.values()
                             for n in calls) for c in counters}
    return total, rates


def fcn3_inference_path(counters, paths, ckpt, device="cuda",
                        n_steps=N_STEPS, window=N_WINDOW):
    """Path N-I: ``python -m ace_tpu_torch.inference``'s ``main`` over path
    N-R's ``best_ckpt.msgpack`` on a YAML it writes: ``n_steps`` steps
    from the first two times of N-R's inference file (2 initial
    conditions, so batch 2) in windows of ``window``, writer off (then on,
    for the predictions), TF32 turned on before. Checks finite outputs,
    TF32 off after, no launch, no synchronizing call in ``run_inference``
    (on the card) and the written predictions within ``N_PREDICT_TOL`` of
    each channel's spatial std of one ``Stepper.predict``; prints steps/s
    and the peak. Returns the launches and the rate."""
    import tempfile

    import torch

    from ace_tpu_torch.stepper import checkpoint

    label = "path N-I"
    check_sync = torch.device(device).type == "cuda"
    flags = []
    with tempfile.TemporaryDirectory() as tmp, _tf32_probe(flags):
        runs, written = _entry_from_files(
            tmp, ckpt, None, None, None, counters, device, n_steps, window,
            check_sync, data_dir=paths["inference"], starts=(0, 1),
            label=label)
    _check_tf32_pinned(label, flags)
    stepper = checkpoint.load_stepper(ckpt, device=device)
    names = sorted(set(stepper.prognostic_names)
                   | set(stepper.forcing_window_names))
    series = _read_series(paths["inference"], names)
    errs, worst, _ = _check_written(label, stepper, series, written, [0, 1],
                                    n_steps)
    summary, launches, phases, peak = runs[False]
    rate = summary["total_steps_per_second"]
    print(f"{label}: {summary['total_steps']} steps at {rate:.4f} steps/s "
          f"(batch 2, windows of {window}, writer off; "
          f"{runs[True][0]['total_steps_per_second']:.4f} with it on); "
          f"phases { {k: round(v, 4) for k, v in sorted(phases.items())} }; "
          f"peak device memory {peak:.2f} GB; launches {launches}")
    print(f"{label}: written predictions vs one {n_steps}-step predict: "
          f"largest error {errs[worst]:.3g} of the channel's spatial std "
          f"({worst}; tol {N_PREDICT_TOL})")
    if launches != {c.__name__: 0 for c in counters}:
        raise AssertionError(f"{label}: launches {launches}")
    if not errs[worst] <= N_PREDICT_TOL:
        raise AssertionError(f"{label}: the written predictions disagree "
                             "with Stepper.predict")
    return launches, rate


def fcn3_paths(counters, smi, sizes=None, device="cuda"):
    """Reference phase N, then paths N-R and N-I: the launches of each
    path. ``sizes`` makes the small copies the CPU runs."""
    t0 = time.perf_counter()
    reference_fcn3_phase(counters, device)
    out = {}
    print(smi)

    def then(paths, best):
        print(smi)
        out["N-I"], _ = fcn3_inference_path(counters, paths, best,
                                            device=device)

    out["N-R"], _ = fcn3_train_path(counters, device=device, sizes=sizes,
                                    then=then)
    print(f"path N (reference N, N-R, N-I): {time.perf_counter() - t0:.1f} s")
    return {k: out[k] for k in ("N-R", "N-I")}


# path L: LocalNet and the conditional SFNO's options through the flagship
# recipe. The recipe's network with local DISCO blocks at the odd indices
# (spectral and local blocks in turn, as FourCastNet3's processor with its
# ``sfno_block_frequency: 2``), conditioned on the labels of two sources
# concatenated, each lacking one output-only variable of the recipe.
L_LOCAL_BLOCKS = [1, 3, 5, 7]
L_SOURCES = (("era5", "2000-01-01T00:00"), ("shield", "2010-01-01T00:00"))
# an output-only variable of the recipe (a flux the corrector does not
# read), absent from both sources: its targets are NaN placeholders and its
# presence is 0 in every row
L_MISSING = "USWRFsfc"
# per source: 3 training times (2 windows of 2, so the two sources give 2
# batches of 2) and 3 validation times (2 + 2
# windows: 2 batches); the first source also holds L-I's 22 times
L_TRAIN_TIMES, L_VALID_TIMES = 3, 3
L_WINDOW = 5
L_PREDICT_TOL = 1e-5
# K2 at the conditioning width of path L: 32 noise channels and 2 labels
L_NOISE = 34
# reference L at 16x32: the conditional SFNO at embed 64 (K1 at spectral
# width 32 with spectral_ratio 0.5), LocalNet and AnkurLocalNet at embed 16
L_REFERENCE = {"nlat": 16, "nlon": 32, "embed": 64, "layers": 4,
               "local_embed": 16}


def _local_blocks(layers):
    return [i for i in L_LOCAL_BLOCKS if i < layers]


def local_files(tmp, nlat, nlon, generator, device,
                train_times=L_TRAIN_TIMES):
    """The two sources' files (``L_SOURCES``: ``train_times`` training and
    ``L_VALID_TIMES`` validation times each, the first also L-I's
    inference times) of every variable of the recipe but ``L_MISSING``,
    and the stats files of the first (``L_MISSING`` included); returns the
    first source's paths with the second's directories under
    ``"sources"``."""
    names = _recipe_names()
    sources = []
    for i, (label, start) in enumerate(L_SOURCES):
        year = int(start[:4])
        splits = [("train", train_times, start),
                  ("valid", L_VALID_TIMES, f"{year + 1}{start[4:]}")]
        if i == 0:
            splits.append(("inference", N_STEPS + 2,
                           f"{year + 2}{start[4:]}"))
        sources.append(_training_files(
            os.path.join(tmp, label), names, nlat, nlon, generator, device,
            splits=tuple(splits), absent=(L_MISSING,)))
    paths = dict(sources[0])
    paths["sources"] = sources
    return paths


def _recipe_names():
    step = _yaml(TRAIN_CONFIG)["stepper"]["step"]["config"]
    return sorted(set(step["in_names"]) | set(step["out_names"]))


def _local_config(paths, experiment_dir, sizes=None, builder=None):
    """The flagship recipe with path R's cuts (``_train_config``) and path
    L's settings: ``local_blocks`` at ``L_LOCAL_BLOCKS`` (the builder's
    defaults otherwise: morlet, 3x3), ``conditional`` over the two
    sources' labels, ``allow_missing_variables``; both loaders read the
    sources concatenated. ``builder`` (a ``{type, config}``) replaces the
    network. Returns the config and the indices of the spectral blocks."""
    sizes = sizes or {}
    config, layers = _train_config(paths, experiment_dir,
                                   sizes.get("embed"), sizes.get("layers"))
    for loader, split in (("train_loader", "train"),
                          ("validation_loader", "valid")):
        config[loader]["dataset"] = {"concat": [
            {"data_path": source[split], "labels": [label]}
            for (label, _), source in zip(L_SOURCES, paths["sources"])]}
    # the inline inference reads the first source's inference times
    config["inference"]["loader"]["dataset"]["data_path"] = paths[
        "inference"]
    selector = config["stepper"]["step"]["config"]["builder"]
    local = _local_blocks(layers)
    selector["config"]["local_blocks"] = local
    if builder is not None:
        selector.update(builder)
    selector["conditional"] = True
    selector["allow_missing_variables"] = True
    spectral = [i for i in range(layers) if i not in local]
    return config, (spectral if builder is None else [])


def _masked_loss_probe(records):
    """A context in which the trainer's first validation of each run
    starts by holding the loss of a validation batch with its data mask
    against the same with ``L_MISSING``'s NaN targets replaced by finite
    values (equal: the term is masked) and without the mask (unequal);
    ``records`` gets (mask, masked, refilled, unmasked)."""
    import contextlib

    import torch

    from ace_tpu_torch.train.trainer import Trainer

    original = Trainer.validate

    def validate(self, *args, **kwargs):
        if len(records) < 2:
            batch = next(iter(self.valid_data))
            ts = self.train_stepper

            def loss(data, mask):
                return float(ts.valid_step(
                    data, torch.Generator(self.device).manual_seed(5),
                    labels=batch.labels, data_mask=mask)["loss"])

            refilled = dict(batch.data)
            refilled[L_MISSING] = torch.randn_like(batch.data[L_MISSING])
            mask = {k: v.tolist() for k, v in
                    (batch.data_mask or {}).items()}
            records.append((mask, loss(batch.data, batch.data_mask),
                            loss(refilled, batch.data_mask),
                            loss(batch.data, None)))
        return original(self, *args, **kwargs)

    @contextlib.contextmanager
    def context():
        Trainer.validate = validate
        try:
            yield
        finally:
            Trainer.validate = original

    return context()


def _metrics_lines(label, out_dir, n_epochs):
    """``metrics.jsonl``'s lines: one per epoch, every value finite but the
    one-step metrics of ``L_MISSING`` (NaN targets, as in ``ace_tpu``),
    which are printed."""
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    bad = sorted({k for line in lines for k, v in line.items()
                  if not math.isfinite(v)})
    missing = [k for k in bad if k.endswith(L_MISSING)]
    print(f"{label}: {len(lines)} metrics.jsonl lines of {len(lines[-1])} "
          f"metrics; not finite: {missing} (the missing variable's "
          f"one-step metrics)")
    if len(lines) != n_epochs or len(bad) != len(missing):
        raise AssertionError(f"{label}: {len(lines)} metrics.jsonl lines, "
                             f"not finite: {bad[:8]}")
    return lines


def local_train_path(counters, device="cuda", sizes=None, then=None):
    """Path L-R: the training entry's ``main`` on ``_local_config`` (the
    flagship recipe at full width unless ``sizes`` gives ``nlat``,
    ``nlon``, ``embed``, ``layers``) over ``local_files``: one epoch, then
    a resume that must be bit-equal. Checks finite metrics (but the
    missing variable's one-step metrics), the checkpoint files, the
    missing variable's loss term masked (``_masked_loss_probe``), the
    launches of each phase (per train step 2 K1 in each spectral block,
    forward and recompute, and one 1b and one 1c; per validation batch 2
    K1 in each; per inline step 1 K1 in each; no K2) and no sync in the
    batch loop. ``then(paths, best)`` runs after the gates inside the
    context that holds the files. Returns the launches, the rates and the
    first run's peak."""
    import contextlib
    import tempfile

    import torch

    label = "path L-R"
    sizes = sizes or {}
    nlat, nlon = sizes.get("nlat", 180), sizes.get("nlon", 360)
    cuda = torch.device(device).type == "cuda"
    _, missing = inference_packages()
    files = h5py_in_memory() if "h5py" in missing else (
        contextlib.nullcontext())
    with tempfile.TemporaryDirectory() as tmp, files:
        paths = local_files(tmp, nlat, nlon,
                            torch.Generator(device).manual_seed(13), device)
        out_dir = os.path.join(tmp, "experiment")
        config, spectral = _local_config(paths, out_dir, sizes)
        path = _write_yaml(os.path.join(tmp, "local.yaml"), config)
        selector = config["stepper"]["step"]["config"]["builder"]
        print(f"{label}: {TRAIN_CONFIG} at {nlat}x{nlon}, sources "
              f"{[s for s, _ in L_SOURCES]} concatenated, {L_MISSING} "
              f"absent from both; builder {selector}")
        probes = []
        runs, launches, rates, restored, _, n_params = _epoch_then_resume(
            label, path, counters, device,
            lambda: [_masked_loss_probe(probes)])
        ckpt_dir = os.path.join(out_dir, "training_checkpoints")
        files_found = sorted(os.listdir(ckpt_dir))
        lines = _metrics_lines(label, out_dir, 2)
        print(f"{label}: {n_params} parameters; batch loop {rates[0]:.4f} "
              f"(epoch 1) and {rates[1]:.4f} (epoch 2) train steps/s at "
              f"batch {R_BATCH} (x2 ensemble members); losses by epoch: "
              f"train {[line['train/loss'] for line in lines]}, validation "
              f"{[line['val/loss'] for line in lines]}; checkpoint files "
              f"{files_found}")
        want_files = {"ckpt.msgpack", "best_ckpt.msgpack", "ema_ckpt.msgpack",
                      "best_inference_ckpt.msgpack"}
        if not want_files <= set(files_found):
            raise AssertionError(f"{label}: checkpoint files {files_found}")
        _check_resume(label, runs, restored)
        for mask, masked, refilled, unmasked in probes:
            print(f"{label}: a validation batch's loss with its data mask "
                  f"{mask}: {masked!r}; {L_MISSING}'s targets refilled: "
                  f"{refilled!r}; without the mask: {unmasked!r}")
            if not (mask == {L_MISSING: [0.0] * R_BATCH}
                    and math.isfinite(masked) and masked == refilled
                    and masked != unmasked):
                raise AssertionError(f"{label}: the missing variable's loss "
                                     "term is not masked")
        if len(probes) != 2:
            raise AssertionError(f"{label}: {len(probes)} mask probes")
        _check_local_launches(label, launches, counters, len(spectral), cuda)
        if then is not None:
            then(paths, os.path.join(ckpt_dir, "best_ckpt.msgpack"))
    total = {c.__name__: sum(n[c.__name__] for calls in launches.values()
                             for n in calls) for c in counters}
    return total, rates, runs[0]["peak"]


def _check_local_launches(label, launches, counters, n_spectral, cuda):
    none = {c.__name__: 0 for c in counters}
    per_epoch = 2 * (L_TRAIN_TIMES - 1) // R_BATCH
    n_valid = 2 * (L_VALID_TIMES - 1) // R_BATCH
    if cuda:
        want = {
            "_train_batches": {**none,
                               "dhconv_filter": 2 * n_spectral * per_epoch,
                               "dhconv_filter_dx": n_spectral * per_epoch,
                               "dhconv_filter_dw": n_spectral * per_epoch},
            "validate": {**none, "dhconv_filter": 2 * n_spectral * n_valid},
            "inference_one_epoch": {
                **none, "dhconv_filter": n_spectral * R_INFERENCE_STEPS},
        }
    else:  # the plain versions
        want = dict.fromkeys(launches, none)
    for phase, counts in launches.items():
        print(f"{label}: launches per {phase} call {counts} (want "
              f"{want[phase]} each)")
        if any(c != want[phase] for c in counts):
            raise AssertionError(f"{label}: launches in {phase}")


def local_inference_path(counters, paths, ckpt, n_spectral, device="cuda",
                         n_steps=N_STEPS, window=L_WINDOW, label="path L-I"):
    """Path L-I (or, over L-N's checkpoint, the inference of L-N): the
    inference entry's ``main`` over ``ckpt`` from the first time of the
    first source's inference file (batch 1), ``n_steps`` steps in windows
    of ``window``, writer off (then on). Checks finite outputs, one K1 per
    spectral block and step (on the card) and no other launch, no sync in
    ``run_inference`` and the written predictions within ``L_PREDICT_TOL``
    of one ``Stepper.predict``. Returns the launches, the rate, the
    predict's initial condition, forcing and outputs."""
    import tempfile

    import numpy as np
    import torch

    from ace_tpu_torch.stepper import checkpoint
    from ace_tpu_torch.stepper.stepper import PrognosticState

    cuda = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        runs, written = _entry_from_files(
            tmp, ckpt, None, None, None, counters, device, n_steps, window,
            cuda, data_dir=paths["inference"], starts=(0,), label=label)
    stepper = checkpoint.load_stepper(ckpt, device=device)
    names = sorted(set(stepper.prognostic_names)
                   | set(stepper.forcing_window_names))
    series = _read_series(paths["inference"], names)
    errs, worst, drift = _check_written(label, stepper, series, written, [0],
                                        n_steps)
    summary, launches, phases, peak = runs[False]
    rate = summary["total_steps_per_second"]
    print(f"{label}: {summary['total_steps']} steps at {rate:.4f} steps/s "
          f"(batch 1, windows of {window}, writer off; "
          f"{runs[True][0]['total_steps_per_second']:.4f} with it on); "
          f"phases { {k: round(v, 4) for k, v in sorted(phases.items())} }; "
          f"peak device memory {peak:.2f} GB; launches {launches}")
    print(f"{label}: written predictions vs one {n_steps}-step predict: "
          f"largest error {errs[worst]:.3g} of the channel's spatial std "
          f"({worst}; tol {L_PREDICT_TOL}); dry-air drift {drift:.4f} Pa")
    none = {c.__name__: 0 for c in counters}
    want = ({**none, "dhconv_filter": n_spectral * n_steps} if cuda
            else none)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    if not (errs[worst] <= L_PREDICT_TOL and drift < 1.0):
        raise AssertionError(f"{label}: the written predictions disagree "
                             "with Stepper.predict")
    ic = PrognosticState(data={
        k: torch.as_tensor(np.stack([series[k][0:1]])).to(device)
        for k in stepper.prognostic_names})
    forcing = {k: torch.as_tensor(np.stack([series[k][:n_steps + 1]]))
               .to(device) for k in stepper.forcing_window_names}
    return launches, rate, stepper, ic, forcing


def local_fused_path(counters, stepper, ic, forcing, n_spectral,
                     device="cuda"):
    """Path L-A: L-I's model with the fused tail, as path A runs: the
    first step against the unfused model's from the same check weights
    (``flagship.draw_check_weights``) within ``flagship.CHECK_TOL`` of each
    output's spatial anomaly, then (the checkpoint's weights back) a
    20-step rollout with one K1 per spectral block and one K2 per block a
    step, no sync, and every step of its outputs within the same limit of
    the unfused rollout's. Returns the launches and the rate."""
    import torch

    from ace_tpu_torch import flagship

    label = "path L-A"
    cuda = torch.device(device).type == "cuda"
    weights = {k: v.clone() for k, v in stepper.module.state_dict().items()}
    ref_all, _ = stepper.predict(ic, forcing,
                                 generator=torch.Generator(
                                     device).manual_seed(0))
    flagship.draw_check_weights(stepper,
                                torch.Generator(device).manual_seed(5))
    window = {k: v[:, :2] for k, v in forcing.items()}
    ref, _ = stepper.predict(ic, window)
    stepper.module.use_fused_block_tail(True)
    out, _ = stepper.predict(ic, window)
    errs = {k: flagship.anomaly_error(out[k], ref[k], (-2, -1)) for k in ref}
    worst = max(errs, key=errs.get)
    print(f"{label}: first step, fused vs unfused (check weights): largest "
          f"error over the anomaly {errs[worst]:.4g} ({worst}; tol "
          f"{flagship.CHECK_TOL})")
    if not errs[worst] <= flagship.CHECK_TOL:
        raise AssertionError(f"{label}: the fused first step disagrees")
    stepper.load_state_dict(weights)
    layers = stepper.module.num_layers
    none = {c.__name__: 0 for c in counters}
    want = ({**none, "dhconv_filter": n_spectral * N_STEPS,
             "fused_block_tail": layers * N_STEPS} if cuda else none)
    if cuda:
        rate, launches = rollout("L-A", stepper, ic, forcing, counters, want)
    else:
        launches, rate = none, 0.0
    got, _ = stepper.predict(ic, forcing,
                             generator=torch.Generator(device).manual_seed(0))
    stepper.module.use_fused_block_tail(False)
    errs = {k: max(flagship.anomaly_error(got[k][:, t], ref_all[k][:, t],
                                          (-2, -1))
                   for t in range(N_STEPS)) for k in ref_all}
    worst = max(errs, key=errs.get)
    print(f"{label}: {N_STEPS} steps, fused vs L-I's unfused rollout from "
          f"the checkpoint's weights: largest error over the anomaly "
          f"{errs[worst]:.4g} ({worst}; tol {flagship.CHECK_TOL})")
    if not errs[worst] <= flagship.CHECK_TOL:
        raise AssertionError(f"{label}: the fused rollout disagrees with "
                             "the unfused one")
    return launches, rate


def local_net_path(counters, device="cuda", sizes=None):
    """Path L-N: ``LocalNet`` at its builder's defaults (fme's: embed 256,
    4 ``disco`` and 4 ``conv1x1`` blocks, noise 256, piecewise linear 3x3,
    float32) in place of the network of path L's config, through the
    training entry for one epoch (batch 2), then the inference entry for
    20 steps over its best checkpoint. No launch, no sync in the batch
    loop and in ``run_inference``, the predictions within
    ``L_PREDICT_TOL`` of ``Stepper.predict``. Returns the launches, the
    batch loop's rate and the rollout's."""
    import contextlib
    import tempfile

    import torch

    from ace_tpu_torch.core.timing import GlobalTimer
    from ace_tpu_torch.train.train import main as train_main

    label = "path L-N"
    sizes = sizes or {}
    nlat, nlon = sizes.get("nlat", 180), sizes.get("nlon", 360)
    cuda = torch.device(device).type == "cuda"
    _, missing = inference_packages()
    files = h5py_in_memory() if "h5py" in missing else (
        contextlib.nullcontext())
    with tempfile.TemporaryDirectory() as tmp, files:
        paths = local_files(tmp, nlat, nlon,
                            torch.Generator(device).manual_seed(17), device)
        out_dir = os.path.join(tmp, "experiment")
        builder = {"type": "LocalNet",
                   "config": {k: v for k, v in sizes.items()
                              if k in ("embed_dim", "noise_embed_dim")}}
        config, _ = _local_config(paths, out_dir, sizes, builder=builder)
        path = _write_yaml(os.path.join(tmp, "localnet.yaml"), config)
        print(f"{label}: builder {builder} in path L-R's config")
        launches, rates = {}, []
        GlobalTimer.reset()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with _phase_probes(counters, launches, rates, cuda, None):
            trainer = train_main([path], device=device)
        if cuda:
            torch.cuda.synchronize()
        n_params = sum(p.numel() for p in trainer.stepper.module.parameters())
        phases = GlobalTimer.get_instance().get_durations()
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
        del trainer
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        lines = _metrics_lines(label, out_dir, 1)
        print(f"{label}: {n_params} parameters; batch loop {rates[0]:.4f} "
              f"train steps/s at batch {R_BATCH}; train loss "
              f"{lines[0]['train/loss']}, validation {lines[0]['val/loss']};"
              f" phases { {k: round(v, 4) for k, v in sorted(phases.items())} }"
              f"; peak device memory {peak:.2f} GB")
        _check_no_launches(label, counters, launches)
        ckpt = os.path.join(out_dir, "training_checkpoints",
                            "best_ckpt.msgpack")
        inf_launches, rate, *_ = local_inference_path(
            counters, paths, ckpt, 0, device, label="path L-N (inference)")
    total = {c.__name__: sum(n[c.__name__] for calls in launches.values()
                             for n in calls) + inf_launches[c.__name__]
             for c in counters}
    return total, rates[0], rate


def local_stepper_config(kind, dtype="float32", sizes=None):
    """A small stepper config of path L's shape (``flagship.stepper_config``
    at 2 levels) with the network ``kind``: "sfno" (the conditional SFNO:
    local blocks, LoRA rank 2, ``spectral_ratio`` 0.5, conditioned on two
    labels), "global-norm" (the conditional SFNO with the global layer
    norm and affine norms), "localnet" (both block types, isotropic
    noise) or "ankur"; and its dataset info (with the labels)."""
    import dataclasses

    from ace_tpu_torch import flagship
    from ace_tpu_torch.core.step import StepSelector
    from ace_tpu_torch.stepper.stepper import StepperConfig

    sizes = dict(L_REFERENCE, **(sizes or {}))
    config, info = flagship.stepper_config(sizes["nlat"], sizes["nlon"],
                                           nz=2)
    step = config.step.config
    builder = dict(step["builder"]["config"], embed_dim=sizes["embed"],
                   num_layers=sizes["layers"], compute_dtype=dtype)
    selector = {"type": "NoiseConditionedSFNO", "config": builder}
    if kind == "sfno":
        builder.update(local_blocks=_local_blocks(sizes["layers"]),
                       lora_rank=2, spectral_ratio=0.5)
        selector["conditional"] = True
        info = dataclasses.replace(
            info, all_labels=tuple(s for s, _ in L_SOURCES))
    elif kind == "global-norm":
        builder.update(global_layer_norm=True)
    elif kind == "localnet":
        selector = {"type": "LocalNet", "config": {
            "embed_dim": sizes["local_embed"], "noise_embed_dim": 8,
            "noise_type": "isotropic", "lora_rank": 2,
            "block_types": ["disco", "conv1x1"]}}
    elif kind == "ankur":
        selector = {"type": "AnkurLocalNet", "config": {
            "embed_dim": sizes["local_embed"], "pos_embed": True}}
    step["builder"] = selector
    network = step["normalization"]["network"]
    network["means"]["PRESsfc"], network["stds"]["PRESsfc"] = 1.0e5, 100.0
    for name in network["stds"]:
        if name.startswith("specific_total_water"):
            network["stds"][name] = 1e-3
    return StepperConfig(step=StepSelector(type="single_module",
                                           config=step)), info


def _fixed_noise_prepare(kind, sizes):
    """``prepare`` for ``_reference_case``: both sides (and the float32
    copy) condition on one noise field drawn on the CPU (isotropic for
    LocalNet, through its own inverse SHT); None for AnkurLocalNet."""
    import torch

    from ace_tpu_torch import flagship
    from ace_tpu_torch.models.conditional_sfno import isotropic_noise
    from ace_tpu_torch.ops.sht import build_isht

    if kind == "ankur":
        return None
    sizes = dict(L_REFERENCE, **(sizes or {}))
    nlat, nlon = sizes["nlat"], sizes["nlon"]
    gen = torch.Generator().manual_seed(9)
    if kind == "localnet":
        noise = isotropic_noise(build_isht(nlat, nlon, grid="legendre-gauss"),
                                2, 8, gen)
    else:
        noise = torch.randn(2, nlat, nlon, 32, generator=gen)

    def prepare(ts):
        flagship.fixed_noise(ts.stepper, noise)

    return prepare


def reference_local_phase(counters, device="cuda", sizes=None):
    """Reference phase L: small models of path L's shape on ``device``
    against the CPU from the same weights, inputs and noise (a 2-step
    rollout and one MSE train step of 2 steps, ``_reference_case``; the
    second rollout step held against the CPU's step from the card's first,
    since one rounding of the state moves LocalNet's random network's next
    step by more than the allowed): the bf16 conditional SFNO with
    local blocks, LoRA, ``spectral_ratio`` 0.5 and labels (the train step
    with the labels [1, 1] the loader gives; the rollout with none, as
    ``Stepper.predict``) within the flagship's bf16 limits, with K1, 1b
    and 1c at spectral width 32; float32 with the global layer norm,
    LocalNet (both block types, isotropic noise) and AnkurLocalNet within
    reference S's float32 limits, no launch."""
    import torch

    from ace_tpu_torch import flagship

    none = {c.__name__: 0 for c in counters}
    cuda = torch.device(device).type == "cuda"
    f32 = (S_F32_TOL, S_F32_LOSS_TOL, S_F32_GRAD_TOL)
    bf16 = (flagship.CHECK_TOL, flagship.TRAIN_LOSS_TOL,
            flagship.TRAIN_GRAD_TOL)

    def inputs(stepper, gen):
        ic, forcing = flagship.synthetic_inputs(stepper, 2, batch=2,
                                                generator=gen)
        return ic, forcing, flagship.synthetic_batch(
            stepper, 2, n_forward_steps=2, generator=gen)

    labels = torch.ones(2, len(L_SOURCES))
    n_spectral = (L_REFERENCE["layers"]
                  - len(_local_blocks(L_REFERENCE["layers"])))
    out = {}
    for kind, dtype, tols in (("sfno", "bfloat16", bf16),
                              ("global-norm", "float32", f32),
                              ("localnet", "float32", f32),
                              ("ankur", "float32", f32)):
        launches = _reference_case(
            f"reference L ({kind}, {dtype})", counters, device, tols,
            lambda dt, kind=kind: local_stepper_config(kind, dt, sizes),
            dtype, inputs, prepare=_fixed_noise_prepare(kind, sizes),
            zero_gradients=lambda names: set(),
            labels=labels if kind == "sfno" else None,
            stepwise=True)
        # bf16: 2 rollout and 2 loss steps of the spectral blocks: K1 in
        # each forward, 1b and 1c in each backward
        want = ({**none, "dhconv_filter": 4 * n_spectral,
                 "dhconv_filter_dx": 2 * n_spectral,
                 "dhconv_filter_dw": 2 * n_spectral}
                if cuda and dtype == "bfloat16" else none)
        if launches != want:
            raise AssertionError(f"reference L ({kind}): launches "
                                 f"{launches}, want {want}")
        out[kind] = launches
    return out


def local_kernel_phase(gen):
    """Path L's kernel shapes against the plain versions, with their times
    and bounds: K2 at the conditioning width ``L_NOISE`` (a ragged shape,
    then L-A's: a flagship block's rows), and K1, 1b and 1c at
    ``[1, 180, 181, 256]`` (the spectral width of ``spectral_ratio`` 0.5
    at embed 512). Returns each kernel's row for the ``kernels`` line."""
    import torch

    from ace_tpu_torch import flagship
    from ace_tpu_torch.ops.fused_block_tail import (
        fused_block_tail,
        fused_block_tail_plain,
    )

    rows = {}

    def tail_check(args, label):
        err, scale = max_err((fused_block_tail(*args),),
                             (fused_block_tail_plain(*args),))
        tol = TAIL_TOL * scale
        print(f"fused_block_tail {label}: max_abs_err {err:.3e} "
              f"(tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"fused_block_tail disagrees with its plain "
                                 f"version at {label}")
        return err, tol

    tail_check(tail_inputs(1000, 128, 256, L_NOISE, gen),
               f"ragged N=1000 C=128 H=256 nc={L_NOISE}")
    n = flagship.NLAT * flagship.NLON
    c = flagship.EMBED
    hidden = 2 * c
    args = tail_inputs(n, c, hidden, L_NOISE, gen)
    err, tol = tail_check(args, f"path L-A N={n} C={c} H={hidden} "
                          f"nc={L_NOISE}")
    ms = cuda_ms(lambda: fused_block_tail(*args), 20)
    plain_ms = cuda_ms(lambda: fused_block_tail_plain(*args), 5)
    weights = args[3]
    n_bytes = (3 * n * c * 2 + n * L_NOISE * 4
               + sum(w.numel() for w in weights) * 2)
    flops = 2 * n * (c * c + 2 * L_NOISE * c + 2 * c * hidden)
    bound_ms, bound_by, bytes_ms, flops_ms = bound(n_bytes, flops,
                                                   PEAK_BF16_FLOPS)
    print(f"fused_block_tail path L-A (nc={L_NOISE}): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms; bound: {n_bytes / 1e6:.1f} MB -> "
          f"{bytes_ms:.4f} ms, {flops / 1e9:.1f} GFLOP -> {flops_ms:.4f} ms")
    rows["fused_block_tail"] = {
        "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    del args, weights

    from ace_tpu_torch.ops.dhconv_filter import (
        dhconv_filter,
        dhconv_filter_dw,
        dhconv_filter_dw_plain,
        dhconv_filter_dx,
        dhconv_filter_dx_plain,
        dhconv_filter_plain,
    )

    b, l, m, w = 1, flagship.NLAT, flagship.NLON // 2 + 1, flagship.EMBED // 2
    kw = dict(generator=gen, device="cuda")
    xr, xi = (torch.randn(b, l, m, w, **kw) for _ in range(2))
    wr, wi = ((torch.randn(l, w, w, **kw) / (w * w)).to(torch.bfloat16)
              for _ in range(2))
    gr, gi = (torch.randn(b, l, m, w, **kw).to(torch.bfloat16)
              for _ in range(2))
    label = f"path L [1,{l},{m},{w}]"
    err, scale = max_err(dhconv_filter(xr, xi, wr, wi),
                         dhconv_filter_plain(xr, xi, wr, wi))
    print(f"dhconv_filter {label}: max_abs_err {err:.3e} (tol "
          f"{BF16_TOL * scale:.3e})")
    if not err <= BF16_TOL * scale:
        raise AssertionError(f"dhconv_filter disagrees at {label}")
    rows["dhconv_filter"] = {"max_abs_err": err, "tol": BF16_TOL * scale,
                             **_dhconv_times(label, (xr, xi, wr, wi))}
    checks = {}
    for name, out, ref in (
            ("dhconv_filter_dx", dhconv_filter_dx(gr, gi, wr, wi),
             dhconv_filter_dx_plain(gr, gi, wr, wi)),
            ("dhconv_filter_dw", (dhconv_filter_dw(xr, xi, gr, gi),),
             (torch.stack(dhconv_filter_dw_plain(xr, xi, gr, gi)),))):
        e, s = max_err(out, ref)
        print(f"{name} {label}: max_abs_err {e:.3e} (tol {BWD_TOL * s:.3e})")
        if not e <= BWD_TOL * s:
            raise AssertionError(f"{name} disagrees at {label}")
        checks[name] = (e, BWD_TOL * s)
    for name, row in _dhconv_bwd_times(
            label, (xr, xi, gr, gi, wr, wi), checks["dhconv_filter_dx"],
            checks["dhconv_filter_dw"]).items():
        rows[name] = {k: row[k] for k in (
            "max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
    return rows


def local_paths(counters, smi, sizes=None, device="cuda", gen=None):
    """Path L's kernel shapes (on the card, with ``gen``), reference phase
    L, then paths L-R, L-I, L-A and L-N: the launches of each path and the
    kernel rows. ``sizes`` makes the small copies the CPU runs."""
    t0 = time.perf_counter()
    rows = local_kernel_phase(gen) if gen is not None else {}
    reference_local_phase(counters, device)
    out = {}
    print(smi)

    def then(paths, best):
        print(smi)
        n_spectral = len(spectral)
        out["L-I"], _, stepper, ic, forcing = local_inference_path(
            counters, paths, best, n_spectral, device)
        print(smi)
        out["L-A"], _ = local_fused_path(counters, stepper, ic, forcing,
                                         n_spectral, device)

    layers = (sizes or {}).get("layers", 8)
    spectral = [i for i in range(layers) if i not in _local_blocks(layers)]
    out["L-R"], _, _ = local_train_path(counters, device, sizes, then=then)
    print(smi)
    net_sizes = None
    if sizes:
        net_sizes = dict(sizes, embed_dim=sizes["embed"], noise_embed_dim=8)
    out["L-N"], _, _ = local_net_path(counters, device, net_sizes)
    print(f"path L (kernel shapes, reference L, L-R, L-I, L-A, L-N): "
          f"{time.perf_counter() - t0:.1f} s")
    return {k: out[k] for k in ("L-R", "L-I", "L-A", "L-N")}, rows


# path H: the HEALPix grid through DLWP-HPX's recipe
# (``configs/dlwp-hpx64-train.yaml``: HEALPixUNet at its builder's
# defaults on HPX64, nside 64, 8 prognostic fields and 3 forcings, float32,
# MSE)
HPX_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs", "dlwp-hpx64-train.yaml")
H_NSIDE = 64
H_BATCH = 4
# 4 training batches of 4, 1 validation batch (and 4 inline steps from its
# first time), 20 inference steps
H_SPLITS = (("train", 17, "2000-01-01T00:00"),
            ("valid", 5, "2001-01-01T00:00"),
            ("inference", N_STEPS + 2, "2002-01-01T00:00"))
H_INFERENCE_STEPS = 4
H_WINDOW = 5
H_PREDICT_TOL = 1e-5
# the recipe's static forcings, written without a time axis
H_STATIC = ("lsm", "topography")
# (mean, std, positive) of each synthetic field, of ERA5's size on HPX64
# (geopotentials in m2/s2, temperatures in K, water in kg/m2, wind in m/s,
# insolation in J/m2); the land-sea mask is a fraction
H_DRAWS = {"z500": (5.5e4, 3.0e3, False), "tau300-700": (3.7e4, 1.5e3, False),
           "z1000": (1.0e3, 1.0e3, False), "t2m0": (288.0, 15.0, False),
           "tcwv0": (0.0, 20.0, True), "t850": (275.0, 12.0, False),
           "z250": (1.0e5, 4.0e3, False), "ws10m": (0.0, 6.0, True),
           "tisr": (0.0, 1.0e6, True), "topography": (0.0, 5.0e3, True)}
# reference phase H: HEALPixUNet at nside 8 over every block type, in
# three networks; the round trip's degrees; the winds' grid
H_REFERENCE_NSIDE = 8
H_ROUND_TRIP_LMAX = 32
H_ROUND_TRIP_TOL = 1e-3
H_WINDS = (180, 360)


def _healpix_names():
    """The recipe's variables: its inputs and outputs (11)."""
    step = _yaml(HPX_CONFIG)["stepper"]["step"]["config"]
    return sorted(set(step["in_names"]) | set(step["out_names"]))


def _healpix_draw(name, shape, generator, device):
    """A synthetic field of ``H_DRAWS``' size; the land-sea mask in
    [0, 1]."""
    import torch

    v = torch.randn(shape, generator=generator, device=device)
    if name == "lsm":
        return v.abs().clamp(0, 1)
    mean, std, positive = H_DRAWS[name]
    return (v.abs() if positive else v) * std + mean


def healpix_files(tmp, nside, generator, device, splits=H_SPLITS):
    """The recipe's netCDF files on (face, height, width) dims, one
    directory per split of ``splits`` (the static forcings without a time
    axis), and the means and stds files of the first split's fields,
    drawn from ``generator`` on ``device``. Returns the paths and each
    split's fields ``[time, 12, nside, nside]`` (the static ones
    broadcast along time)."""
    import numpy as np

    from ace_tpu_torch.data.store import write_h5
    from ace_tpu_torch.data.time import TimeCoord

    coords = {"face": np.arange(12.0), "height": np.arange(float(nside)),
              "width": np.arange(float(nside))}
    static = {k: _healpix_draw(k, (12, nside, nside), generator,
                               device).cpu().numpy() for k in H_STATIC}
    paths, series = {}, {}
    for split, n, start in splits:
        data = {k: _healpix_draw(k, (n, 12, nside, nside), generator,
                                 device).cpu().numpy()
                for k in _healpix_names() if k not in H_STATIC}
        dims = {k: ("time", "face", "height", "width") for k in data}
        dims.update({k: ("face", "height", "width") for k in static})
        paths[split] = os.path.join(tmp, split)
        os.makedirs(paths[split])
        write_h5(os.path.join(paths[split], "data.nc"), {**data, **static},
                 dims, coords=coords,
                 time=TimeCoord.from_range(start, n, 21600))
        series[split] = {**data, **{k: np.broadcast_to(v, (n, *v.shape))
                                    for k, v in static.items()}}
    train = series[splits[0][0]]
    for label, stat in (("centering", np.mean), ("scaling", np.std)):
        paths[label] = os.path.join(tmp, f"{label}.nc")
        write_h5(paths[label],
                 {k: np.asarray(stat(v), np.float32) for k, v in train.items()},
                 {k: () for k in train})
    return paths, series


def _healpix_config(paths, experiment_dir, builder=None):
    """``configs/dlwp-hpx64-train.yaml`` with path H-R's cuts: the
    synthetic files for the placeholder data and stats paths, batch 4, one
    epoch, one inline-inference entry of 4 steps from the first
    validation time, no output to the screen; ``builder`` replaces the
    network's config (the small copies the CPU runs)."""
    config = _yaml(HPX_CONFIG)
    config["experiment_dir"] = experiment_dir
    config["max_epochs"] = 1
    config["logging"]["log_to_screen"] = False
    for loader, split in (("train_loader", "train"),
                          ("validation_loader", "valid")):
        config[loader]["dataset"]["data_path"] = paths[split]
        config[loader]["batch_size"] = H_BATCH
    step = config["stepper"]["step"]["config"]
    step["normalization"]["network"] = {
        "global_means_path": paths["centering"],
        "global_stds_path": paths["scaling"]}
    if builder is not None:
        step["builder"]["config"] = builder
    config["inference"] = {
        "loader": {"dataset": {"data_path": paths["valid"]},
                   "start_indices": {"list": [0]}},
        "n_forward_steps": H_INFERENCE_STEPS,
    }
    return config


def healpix_unet_configs():
    """Three small HEALPixUNet builder configs that together hold every
    block type: the defaults' structure (ConvNeXt, average pooling,
    transposed-conv upsampling, a 1x1 output) at widths up to 16; the
    symmetric blocks with the dealiased downsample, dilations and the
    smoothed interpolation; basic blocks with max pooling and a bilinear
    interpolation."""
    capped = {"cap_value": 10}
    return {
        "defaults-structure": {
            "encoder": {"conv_block": {"block_type": "ConvNeXtBlock",
                                       "activation": capped},
                        "down_sampling_block": {"block_type": "AvgPool"},
                        "n_channels": [16, 8, 4], "n_layers": [2, 2, 1]},
            "decoder": {"conv_block": {"block_type": "ConvNeXtBlock",
                                       "activation": capped},
                        "up_sampling_block": {
                            "block_type": "TransposedConvUpsample",
                            "activation": capped},
                        "output_layer": {"block_type": "BasicConvBlock",
                                         "kernel_size": 1, "n_layers": 1},
                        "n_channels": [4, 8, 16], "n_layers": [1, 2, 2]}},
        "every-block": {
            "encoder": {"conv_block": {
                "block_type": "SymmetricConvNeXtBlock", "activation": capped},
                "down_sampling_block": {"block_type": "DealiasedDownsample"},
                "n_channels": [8, 12], "n_layers": [1, 1],
                "dilations": [1, 2]},
            "decoder": {"conv_block": {
                "block_type": "Multi_SymmetricConvNeXtBlock", "n_layers": 2},
                "up_sampling_block": {
                    "block_type": "SmoothedInterpolateConv",
                    "activation": capped},
                "output_layer": {"block_type": "ConvNeXtBlock"},
                "n_channels": [12, 12], "n_layers": [1, 1]}},
        "maxpool-interpolate": {
            "encoder": {"conv_block": {"block_type": "BasicConvBlock",
                                       "n_layers": 2, "activation": capped},
                        "down_sampling_block": {"block_type": "MaxPool"},
                        "n_channels": [6, 10], "n_layers": [2, 1]},
            "decoder": {"conv_block": {"block_type": "ConvNeXtBlock"},
                        "up_sampling_block": {"block_type": "Interpolate",
                                              "upsample_mode": "bilinear"},
                        "output_layer": {"block_type": "BasicConvBlock",
                                         "kernel_size": 3},
                        "n_channels": [10, 6], "n_layers": [1, 1]}},
    }


def healpix_stepper_config(nside=H_REFERENCE_NSIDE, builder=None):
    """A stepper config of the recipe's step (its variables, statistics
    of ``H_DRAWS``' size) with ``builder`` as the network's config, and
    the dataset info of its grid."""
    from datetime import timedelta

    from ace_tpu_torch.core.coordinates import HEALPixCoordinates
    from ace_tpu_torch.core.dataset_info import DatasetInfo
    from ace_tpu_torch.core.step import StepSelector
    from ace_tpu_torch.stepper.stepper import StepperConfig

    step = _yaml(HPX_CONFIG)["stepper"]["step"]["config"]
    if builder is not None:
        step["builder"]["config"] = builder
    scale = {**H_DRAWS, "lsm": (0.5, 0.3, False)}
    step["normalization"]["network"] = {
        "means": {k: scale[k][0] for k in _healpix_names()},
        "stds": {k: scale[k][1] for k in _healpix_names()}}
    info = DatasetInfo(
        horizontal_coordinates=HEALPixCoordinates.from_nside(nside),
        timestep=timedelta(hours=6))
    return StepperConfig(step=StepSelector(type="single_module",
                                           config=step)), info


def healpix_inputs(stepper, n_steps, batch, generator):
    """An initial condition, ``n_steps + 1`` forcing times and a training
    batch of as many times for a HEALPix stepper, drawn on the CPU from
    ``generator``."""
    from ace_tpu_torch.stepper.stepper import PrognosticState

    shape = (batch, n_steps + 1, *stepper.dataset_info.img_shape)
    step = stepper.step
    data = {k: _healpix_draw(k, shape, generator, "cpu")
            for k in sorted(set(step.input_names) | set(step.output_names))}
    ic = PrognosticState(data={k: data[k][:, :1]
                               for k in stepper.prognostic_names})
    return ic, {k: data[k] for k in stepper.forcing_window_names}, data


def _healpix_grid_phase(device):
    """Reference H's grid parts, ``device`` against the CPU: the pad at p
    = 1, 2, 3 (equal), ``get_real_sht`` and ``get_real_isht`` at nside 64
    (lmax = mmax = 127) against a float64 evaluation of the same
    transforms (within ``SHT_TOL`` of the largest value), a band-limited
    round trip (the lowest degrees within ``H_ROUND_TRIP_TOL``, the card's
    within ``SHT_TOL`` of the float64 one's), and the vorticity and
    divergence of a wind at 180x360 and the wind back, against float64
    (1e-4 of the anomaly + 1e-5 of the value)."""
    import numpy as np
    import torch

    from ace_tpu_torch.core.gridded_ops import HEALPixOperations
    from ace_tpu_torch.models.healpix import healpix_pad
    from ace_tpu_torch.ops import hpx, vector_sht

    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 12, H_NSIDE, H_NSIDE, 8, generator=gen)
    equal = {p: torch.equal(healpix_pad(x.to(device), p).cpu(),
                            healpix_pad(x, p)) for p in (1, 2, 3)}
    print(f"reference H: healpix_pad of [2, 12, {H_NSIDE}, {H_NSIDE}, 8], "
          f"{device} equal to the CPU at p = 1, 2, 3: {equal}")
    if not all(equal.values()):
        raise AssertionError("reference H: the pad differs from the CPU")

    def rel(got, ref):
        return float((got.cpu().to(ref.dtype) - ref).abs().max()
                     / ref.abs().max())

    ops = HEALPixOperations(H_NSIDE)
    sht, isht = ops.get_real_sht(device), ops.get_real_isht(device)
    coeffs = sht(x[..., :4].to(device))
    ref = ops.get_real_sht().double()(x[..., :4].double())
    back = isht(ref.to(torch.complex64).to(device))
    ref_back = ops.get_real_isht().double()(ref)
    errs = {"sht": rel(coeffs, ref), "isht": rel(back, ref_back)}
    lmax = H_ROUND_TRIP_LMAX
    rng = np.random.RandomState(0)
    imag = np.tril(rng.randn(lmax, lmax), -1)
    imag[:, 0] = 0.0
    low = torch.from_numpy(np.tril(rng.randn(lmax, lmax)) + 1j * imag)[
        ..., None]

    def round_trip(dev, dtype):
        pair = [cls(H_NSIDE, lmax=lmax, mmax=lmax).to(dev, dtype)
                for cls in (hpx.HealpixISHT, hpx.HealpixSHT)]
        return pair[1](pair[0](low.to(dev)))

    trip64 = round_trip("cpu", torch.float64)
    errs["round trip"] = rel(round_trip(device, torch.float32), trip64)
    quadrature = float((trip64 - low).abs()[:4, :4].max()
                       / low.abs()[:4, :4].max())
    nlat, nlon = H_WINDS
    u, v = (torch.randn(2, nlat, nlon, generator=gen) for _ in range(2))
    ref_vd = vector_sht.u_v_to_vort_div(u.double(), v.double())
    got_vd = vector_sht.u_v_to_vort_div(u.to(device), v.to(device))
    ref_uv = vector_sht.vort_div_to_u_v(*ref_vd)
    got_uv = vector_sht.vort_div_to_u_v(*got_vd)
    winds = {}
    for name, got, r in zip(("vort", "div", "u", "v"), got_vd + got_uv,
                            ref_vd + ref_uv):
        anomaly = (r - r.mean((-2, -1), keepdim=True)).abs().amax((-2, -1))
        allowed = S_F32_TOL * anomaly + 1e-5 * r.abs().amax((-2, -1))
        winds[name] = float(((got.cpu().double() - r).abs().amax((-2, -1))
                             / allowed).max())
    print(f"reference H: nside {H_NSIDE} transforms (lmax = mmax = "
          f"{2 * H_NSIDE - 1}) on {device} against float64: "
          + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
          + f" of the largest value (tol {SHT_TOL}); the float64 round trip "
          f"at lmax {lmax} recovers the degrees below 4 within "
          f"{quadrature:.3g} (tol {H_ROUND_TRIP_TOL}); winds at "
          f"{nlat}x{nlon} against float64: "
          + ", ".join(f"{k} {e:.3g}" for k, e in winds.items())
          + " of the allowed")
    if not (max(errs.values()) <= SHT_TOL and quadrature <= H_ROUND_TRIP_TOL
            and max(winds.values()) <= 1):
        raise AssertionError("reference H: a transform disagrees")


def reference_healpix_phase(counters, device="cuda"):
    """Reference phase H: ``_healpix_grid_phase``, then small HEALPixUNets
    of the recipe's step at nside 8 (``healpix_unet_configs``: every block
    type), each a forward step and one MSE train step on ``device``
    against the CPU from the same weights and inputs, and one ensemble-loss
    train step (CRPS and the energy score over ``get_real_sht``, 2
    members) of the first, within reference S's float32 limits, with no
    kernel launch."""
    _healpix_grid_phase(device)
    tols = (S_F32_TOL, S_F32_LOSS_TOL, S_F32_GRAD_TOL)
    cases = [(name, builder, None, 1)
             for name, builder in healpix_unet_configs().items()]
    cases.append(("defaults-structure, ensemble loss",
                  healpix_unet_configs()["defaults-structure"],
                  {"type": "EnsembleLoss",
                   "kwargs": {"crps_weight": 0.9,
                              "energy_score_weight": 0.1}}, 2))
    for name, builder, loss, n_ensemble in cases:
        launches = _reference_case(
            f"reference H ({name})", counters, device, tols,
            lambda dtype, b=builder: healpix_stepper_config(builder=b),
            "float32",
            lambda stepper, gen: healpix_inputs(stepper, 1, 2, gen),
            n_steps=1, zero_gradients=lambda names: set(),
            loss_config=loss, n_ensemble=n_ensemble)
        if launches != {c.__name__: 0 for c in counters}:
            raise AssertionError(f"reference H: launches {launches}")


def healpix_train_path(counters, device="cuda", nside=H_NSIDE, builder=None,
                       then=None):
    """Path H-R: ``python -m ace_tpu_torch.train``'s ``main`` on
    ``configs/dlwp-hpx64-train.yaml`` with the cuts of ``_healpix_config``
    (HEALPixUNet at its builder's defaults on HPX64, unless ``nside`` and
    ``builder`` say otherwise) over ``healpix_files``: one epoch, then
    ``--override max_epochs=2``, which must resume at epoch 1 with its
    state bit for bit. TF32 is turned on before each run, and each must
    leave it off. Checks finite metrics, one ``metrics.jsonl`` line per
    epoch, the checkpoint files, no kernel launch, no sync in the batch
    loop (on the card); prints the loop's rates, the phases, the
    checkpoints' bytes and seconds and the peak. ``then(paths, series,
    best)`` runs after the gates inside the context that holds the files.
    Returns the launches and the loop's rates."""
    import contextlib

    import torch

    label = "path H-R"
    _, missing = inference_packages()
    files = h5py_in_memory() if "h5py" in missing else (
        contextlib.nullcontext())
    with tempfile.TemporaryDirectory() as tmp, files:
        paths, series = healpix_files(
            tmp, nside, torch.Generator(device).manual_seed(13), device)
        out_dir = os.path.join(tmp, "experiment")
        config = _healpix_config(paths, out_dir, builder)
        path = _write_yaml(os.path.join(tmp, "hpx.yaml"), config)
        print(f"{label}: {HPX_CONFIG} at nside {nside} (12 x {nside} x "
              f"{nside}), {len(_healpix_names())} variables, builder "
              f"{config['stepper']['step']['config']['builder']['config']}, "
              f"batch {H_BATCH}")
        flags = []
        runs, launches, rates, restored, _, n_params = _epoch_then_resume(
            label, path, counters, device, lambda: [_tf32_probe(flags)])
        ckpt_dir = os.path.join(out_dir, "training_checkpoints")
        files_found = sorted(os.listdir(ckpt_dir))
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        bad = [k for line in lines for k, v in line.items()
               if not math.isfinite(v)]
        if len(lines) != 2 or bad:
            raise AssertionError(f"{label}: {len(lines)} metrics.jsonl "
                                 f"lines, not finite: {bad[:5]}")
        print(f"{label}: {n_params} parameters; batch loop "
              f"{rates[0]:.4f} (epoch 1) and {rates[1]:.4f} (epoch 2) train "
              f"steps/s at batch {H_BATCH} ({rates[1] * H_BATCH:.4f} "
              f"samples/s); losses by epoch: train "
              f"{[line['train/loss'] for line in lines]}, validation "
              f"{[line['val/loss'] for line in lines]}; {len(lines[-1])} "
              f"metrics; checkpoint files {files_found}")
        want_files = {"ckpt.msgpack", "best_ckpt.msgpack", "ema_ckpt.msgpack"}
        if not want_files <= set(files_found):
            raise AssertionError(f"{label}: checkpoint files {files_found}")
        _check_tf32_pinned(label, flags)
        _check_resume(label, runs, restored)
        _check_no_launches(label, counters, launches)
        if then is not None:
            then(paths, series, os.path.join(ckpt_dir, "best_ckpt.msgpack"))
    total = {c.__name__: sum(n[c.__name__] for calls in launches.values()
                             for n in calls) for c in counters}
    return total, rates


def healpix_inference_path(counters, paths, series, ckpt, device="cuda",
                           n_steps=N_STEPS, window=H_WINDOW):
    """Path H-I: ``python -m ace_tpu_torch.inference``'s ``main`` over path
    H-R's ``best_ckpt.msgpack``: ``n_steps`` steps at batch 1 in windows
    of ``window`` from the first time of H-R's inference file, given as a
    ``file://`` URL (``initial_condition``), the spectrum aggregator on
    (the HEALPix SHT in the window loop), writer off (then on, for the
    predictions), TF32 turned on before. Checks finite outputs, TF32 off
    after it, no launch, no synchronizing call in ``run_inference`` (on
    the card) and the written predictions within ``H_PREDICT_TOL`` of
    each channel's spatial std of one ``Stepper.predict``; prints steps/s
    and the peak. Returns the launches and the rate."""
    import torch

    from ace_tpu_torch.stepper import checkpoint

    label = "path H-I"
    check_sync = torch.device(device).type == "cuda"
    ic = {"path": "file://" + os.path.join(paths["inference"], "data.nc"),
          "start_indices": {"list": [0]}}
    flags = []
    with tempfile.TemporaryDirectory() as tmp, _tf32_probe(flags):
        runs, written = _entry_from_files(
            tmp, ckpt, None, None, None, counters, device, n_steps, window,
            check_sync, data_dir=paths["inference"], label=label,
            initial_condition=ic)
    _check_tf32_pinned(label, flags)
    stepper = checkpoint.load_stepper(ckpt, device=device)
    errs, worst, _ = _check_written(label, stepper, series["inference"],
                                    written, [0], n_steps)
    summary, launches, phases, peak = runs[False]
    rate = summary["total_steps_per_second"]
    print(f"{label}: {summary['total_steps']} steps at {rate:.4f} steps/s "
          f"(batch 1, windows of {window}, writer off; "
          f"{runs[True][0]['total_steps_per_second']:.4f} with it on); "
          f"phases { {k: round(v, 4) for k, v in sorted(phases.items())} }; "
          f"peak device memory {peak:.2f} GB; launches {launches}")
    print(f"{label}: written predictions vs one {n_steps}-step predict: "
          f"largest error {errs[worst]:.3g} of the channel's spatial std "
          f"({worst}; tol {H_PREDICT_TOL})")
    if launches != {c.__name__: 0 for c in counters}:
        raise AssertionError(f"{label}: launches {launches}")
    if not errs[worst] <= H_PREDICT_TOL:
        raise AssertionError(f"{label}: the written predictions disagree "
                             "with Stepper.predict")
    return launches, rate


def healpix_paths(counters, smi, device="cuda", nside=H_NSIDE, builder=None):
    """Reference phase H, then paths H-R and H-I: the launches of each
    path. ``nside`` and ``builder`` make the small copies the CPU runs."""
    t0 = time.perf_counter()
    reference_healpix_phase(counters, device)
    out = {}
    print(smi)

    def then(paths, series, best):
        print(smi)
        out["H-I"], _ = healpix_inference_path(counters, paths, series, best,
                                               device=device)

    out["H-R"], _ = healpix_train_path(counters, device=device, nside=nside,
                                       builder=builder, then=then)
    print(f"path H (reference H, H-R, H-I): {time.perf_counter() - t0:.1f} s")
    return {k: out[k] for k in ("H-R", "H-I")}


# path W: the Swin U-Nets through the flagship recipe
# (``configs/ace2-era5-train.yaml`` with NoiseConditionedSwinTransformer at
# its builder's defaults in place of the SFNO: embed 96, heads 3-6-6-3,
# windows 4x8, noise 256, drop path 0.2, the cos-lat position bias, f32)
W_BUILDER = {"type": "NoiseConditionedSwinTransformer", "config": {}}
# W-A: the AdaLN Swin over path L's two labelled sources, earth-padded
# with fme's pads
W_A_PADDING = {"activate": True, "mode": "earth", "pad_lat": [40, 40],
               "pad_lon": [40, 40]}
W_WINDOW = 5
W_PREDICT_TOL = 1e-5
# reference W: small Swin nets at 16x32 (windows 2x4, widths 8), drop path
# off (the card's and the CPU's generators differ)
W_SMALL = {"embed_dim": 8, "num_heads": [2, 2, 2, 2], "window_size": [2, 4],
           "cpb_hidden_dim": 16, "drop_path_rate": 0.0}
W_NOISE = 8
W_REFERENCE = {
    # the recipe's options: noise, the cos-lat bias, earth padding, skip
    "cln-cosl-earth": ({"type": "NoiseConditionedSwinTransformer",
                        "config": dict(W_SMALL, noise_embed_dim=W_NOISE,
                                       padding_conf={
                                           "activate": True, "mode": "earth",
                                           "pad_lat": [2, 2],
                                           "pad_lon": [4, 4]})}, False),
    # labels through the CLN, SwiGLU, no skip, mirror padding, no cos-lat
    "cln-labels-swiglu-noskip-mirror": (
        {"type": "NoiseConditionedSwinTransformer", "conditional": True,
         "config": dict(W_SMALL, noise_embed_dim=W_NOISE, label_embed_dim=3,
                        mlp_layer="swiglu", use_skip=False,
                        use_cpb_scaling=False,
                        padding_conf={"activate": True, "mode": "mirror",
                                      "pad_lat": [3, 1],
                                      "pad_lon": [4, 4]})}, True),
    # AdaLN over the labels, earth padding
    "adaln-labels-earth": ({"type": "SwinTransformer", "conditional": True,
                            "config": dict(W_SMALL, padding_conf={
                                "activate": True, "pad_lat": [2, 2],
                                "pad_lon": [4, 4]})}, True),
}
# (no case pads with zeros after the boundary pad: the label terms fill
# those cells with a constant across channels, whose layer norm in the next
# block divides rounding by sqrt(1e-5), and the shifted windows carry that
# into the grid; card and CPU then differ by 2.2 of the allowed. The zero
# padding is held against ace_tpu on the CPU, tests/test_torch_swin.py,
# and runs on the card in W-R and W-A.)


def swin_stepper_config(builder, labelled, nlat=16, nlon=32):
    """A small stepper config of path W's shape (``flagship.stepper_config``
    at 2 levels) with ``builder`` (a ``{type, config}``) as its network,
    and its dataset info (with path L's two labels when ``labelled``)."""
    import dataclasses

    from ace_tpu_torch import flagship
    from ace_tpu_torch.core.step import StepSelector
    from ace_tpu_torch.stepper.stepper import StepperConfig

    config, info = flagship.stepper_config(nlat, nlon, nz=2)
    step = config.step.config
    step["builder"] = builder
    if labelled:
        info = dataclasses.replace(
            info, all_labels=tuple(s for s, _ in L_SOURCES))
    network = step["normalization"]["network"]
    network["means"]["PRESsfc"], network["stds"]["PRESsfc"] = 1.0e5, 100.0
    for name in network["stds"]:
        if name.startswith("specific_total_water"):
            network["stds"][name] = 1e-3
    return StepperConfig(step=StepSelector(type="single_module",
                                           config=step)), info


def _small_inputs(stepper, gen):
    from ace_tpu_torch import flagship

    ic, forcing = flagship.synthetic_inputs(stepper, 2, batch=2,
                                            generator=gen)
    return ic, forcing, flagship.synthetic_batch(
        stepper, 2, n_forward_steps=2, generator=gen)


def reference_swin_phase(counters, device="cuda"):
    """Reference phase W: the small Swin nets of ``W_REFERENCE`` (every
    option: CLN with the noise passed in, labels through the CLN and
    through AdaLN, SwiGLU, no skip, earth and mirror padding, the cos-lat
    bias off and on), each a 2-step rollout and one MSE train step of 2
    steps on ``device`` against the CPU from the same weights, inputs and
    noise (``_reference_case``; the second rollout step against the CPU's
    step from the card's first, as reference L: a random net carries one
    rounding of its state onward), within reference S's float32 limits,
    no launch."""
    import torch

    from ace_tpu_torch import flagship

    none = {c.__name__: 0 for c in counters}
    tols = (S_F32_TOL, S_F32_LOSS_TOL, S_F32_GRAD_TOL)
    labels = torch.ones(2, len(L_SOURCES))
    noise = torch.randn(2, 16, 32, W_NOISE,
                        generator=torch.Generator().manual_seed(9))
    for name, (builder, labelled) in W_REFERENCE.items():
        cln = builder["type"].startswith("Noise")
        launches = _reference_case(
            f"reference W ({name})", counters, device, tols,
            lambda dt, b=builder, lab=labelled: swin_stepper_config(b, lab),
            "float32", _small_inputs,
            prepare=(lambda ts: flagship.fixed_noise(ts.stepper, noise))
            if cln else None,
            zero_gradients=lambda names: set(),
            labels=labels if labelled else None, stepwise=True)
        if launches != none:
            raise AssertionError(f"reference W ({name}): launches {launches}")


def _swin_config(paths, experiment_dir, builder=None):
    """The flagship recipe with path R's cuts (``_train_config``) and the
    network replaced by ``builder`` (``W_BUILDER``: the
    NoiseConditionedSwinTransformer at its builder's defaults)."""
    config, _ = _train_config(paths, experiment_dir)
    config["stepper"]["step"]["config"]["builder"] = builder or W_BUILDER
    return config


def swin_train_path(counters, device="cuda", sizes=None, builder=None,
                    then=None):
    """Path W-R: the training entry's ``main`` on ``_swin_config`` over
    path R's synthetic files (at 180x360 unless ``sizes`` gives ``nlat``,
    ``nlon``): one epoch, then ``--override max_epochs=2``, which must
    resume at epoch 1 bit for bit; TF32 turned on before each run and off
    after it. Checks finite metrics, one line per epoch, the checkpoint
    files, no launch and no sync in the batch loop; prints the parameters,
    the loop's rates, the phases and the peak. ``then(paths, best)`` runs
    inside the context that holds the files. Returns the launches, the
    rates and the first run's peak."""
    import contextlib

    import torch

    label = "path W-R"
    sizes = sizes or {}
    nlat, nlon = sizes.get("nlat", 180), sizes.get("nlon", 360)
    _, missing = inference_packages()
    files = h5py_in_memory() if "h5py" in missing else (
        contextlib.nullcontext())
    with tempfile.TemporaryDirectory() as tmp, files:
        paths = _training_files(tmp, _recipe_names(), nlat, nlon,
                                torch.Generator(device).manual_seed(13),
                                device, splits=R_SPLITS + (
                                    ("inference", N_STEPS + 2,
                                     "2002-01-01T00:00"),))
        out_dir = os.path.join(tmp, "experiment")
        config = _swin_config(paths, out_dir, builder)
        path = _write_yaml(os.path.join(tmp, "swin.yaml"), config)
        print(f"{label}: {TRAIN_CONFIG} at {nlat}x{nlon}, builder "
              f"{config['stepper']['step']['config']['builder']}, batch "
              f"{R_BATCH} x {config['stepper_training']['n_ensemble']} "
              f"members")
        flags = []
        runs, launches, rates, restored, _, n_params = _epoch_then_resume(
            label, path, counters, device, lambda: [_tf32_probe(flags)])
        ckpt_dir = os.path.join(out_dir, "training_checkpoints")
        files_found = sorted(os.listdir(ckpt_dir))
        lines = _finite_metrics(os.path.join(out_dir, "metrics.jsonl"), 2,
                                label)
        print(f"{label}: {n_params} parameters; batch loop {rates[0]:.4f} "
              f"(epoch 1) and {rates[1]:.4f} (epoch 2) train steps/s at "
              f"batch {R_BATCH} ({rates[1] * R_BATCH:.4f} samples/s); "
              f"losses by epoch: train "
              f"{[line['train/loss'] for line in lines]}, validation "
              f"{[line['val/loss'] for line in lines]}; checkpoint files "
              f"{files_found}")
        want_files = {"ckpt.msgpack", "best_ckpt.msgpack", "ema_ckpt.msgpack",
                      "best_inference_ckpt.msgpack"}
        if not want_files <= set(files_found):
            raise AssertionError(f"{label}: checkpoint files {files_found}")
        _check_tf32_pinned(label, flags)
        _check_resume(label, runs, restored)
        _check_no_launches(label, counters, launches)
        if then is not None:
            then(paths, os.path.join(ckpt_dir, "best_ckpt.msgpack"))
    total = {c.__name__: sum(n[c.__name__] for calls in launches.values()
                             for n in calls) for c in counters}
    return total, rates, runs[0]["peak"]


def swin_inference_path(counters, paths, ckpt, device="cuda",
                        n_steps=N_STEPS, window=W_WINDOW):
    """Path W-I: the inference entry's ``main`` over W-R's best checkpoint
    from the first time of the inference file, ``n_steps`` steps at batch 1
    in windows of ``window``, TF32 turned on before: TF32 off after it, no
    launch, no sync in ``run_inference`` (on the card), the written
    predictions within ``W_PREDICT_TOL`` of one ``Stepper.predict`` from
    the same seed, the dry air within 1 Pa. Returns the launches and the
    rate."""
    import torch

    from ace_tpu_torch.stepper import checkpoint

    label = "path W-I"
    cuda = torch.device(device).type == "cuda"
    flags = []
    with tempfile.TemporaryDirectory() as tmp, _tf32_probe(flags):
        runs, written = _entry_from_files(
            tmp, ckpt, None, None, None, counters, device, n_steps, window,
            cuda, data_dir=paths["inference"], starts=(0,), label=label)
    _check_tf32_pinned(label, flags)
    stepper = checkpoint.load_stepper(ckpt, device=device)
    names = sorted(set(stepper.prognostic_names)
                   | set(stepper.forcing_window_names))
    series = _read_series(paths["inference"], names)
    errs, worst, drift = _check_written(label, stepper, series, written, [0],
                                        n_steps)
    summary, launches, phases, peak = runs[False]
    rate = summary["total_steps_per_second"]
    print(f"{label}: {summary['total_steps']} steps at {rate:.4f} steps/s "
          f"(batch 1, windows of {window}, writer off; "
          f"{runs[True][0]['total_steps_per_second']:.4f} with it on); "
          f"phases { {k: round(v, 4) for k, v in sorted(phases.items())} }; "
          f"peak device memory {peak:.2f} GB; launches {launches}")
    print(f"{label}: written predictions vs one {n_steps}-step predict: "
          f"largest error {errs[worst]:.3g} of the channel's spatial std "
          f"({worst}; tol {W_PREDICT_TOL}); dry-air drift {drift:.4f} Pa")
    if launches != {c.__name__: 0 for c in counters}:
        raise AssertionError(f"{label}: launches {launches}")
    if not (errs[worst] <= W_PREDICT_TOL and drift < 1.0):
        raise AssertionError(f"{label}: the written predictions disagree "
                             "with Stepper.predict")
    return launches, rate


def swin_adaln_path(counters, device="cuda", sizes=None, builder=None):
    """Path W-A: ``SwinTransformer`` (AdaLN) at its builder's defaults with
    ``W_A_PADDING`` (or ``builder``), ``conditional`` over path L's two
    labelled sources (``_local_config``, the missing variable included),
    through the training entry for one epoch of 2 batches. Checks finite
    metrics but the missing variable's one-step ones, no launch, no sync in
    the batch loop. Returns the launches and the rate."""
    import contextlib

    import torch

    from ace_tpu_torch.core.timing import GlobalTimer
    from ace_tpu_torch.train.train import main as train_main

    label = "path W-A"
    sizes = sizes or {}
    nlat, nlon = sizes.get("nlat", 180), sizes.get("nlon", 360)
    cuda = torch.device(device).type == "cuda"
    _, missing = inference_packages()
    files = h5py_in_memory() if "h5py" in missing else (
        contextlib.nullcontext())
    with tempfile.TemporaryDirectory() as tmp, files:
        # 3 training times a source (2 windows of 2): 2 batches of 2
        paths = local_files(tmp, nlat, nlon,
                            torch.Generator(device).manual_seed(19), device,
                            train_times=3)
        out_dir = os.path.join(tmp, "experiment")
        builder = builder or {"type": "SwinTransformer",
                              "config": {"padding_conf": W_A_PADDING}}
        config, _ = _local_config(paths, out_dir, builder=builder)
        config.pop("inference")
        path = _write_yaml(os.path.join(tmp, "swin_adaln.yaml"), config)
        print(f"{label}: builder {builder} conditional over "
              f"{[s for s, _ in L_SOURCES]} in path L-R's config")
        launches, rates = {}, []
        GlobalTimer.reset()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with _phase_probes(counters, launches, rates, cuda, None):
            trainer = train_main([path], device=device)
        if cuda:
            torch.cuda.synchronize()
        n_params = sum(p.numel() for p in trainer.stepper.module.parameters())
        n_batches = trainer.num_batches_seen
        phases = GlobalTimer.get_instance().get_durations()
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
        del trainer
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        lines = _metrics_lines(label, out_dir, 1)
        print(f"{label}: {n_params} parameters; {n_batches} batches at "
              f"{rates[0]:.4f} train steps/s (batch {R_BATCH}); train loss "
              f"{lines[0]['train/loss']}, validation {lines[0]['val/loss']}; "
              f"phases { {k: round(v, 4) for k, v in sorted(phases.items())} }"
              f"; peak device memory {peak:.2f} GB")
        if n_batches != 2:
            raise AssertionError(f"{label}: {n_batches} batches, not 2")
        _check_no_launches(label, counters, launches)
    total = {c.__name__: sum(n[c.__name__] for calls in launches.values()
                             for n in calls) for c in counters}
    return total, rates[0]


def swin_paths(counters, smi, device="cuda", sizes=None, builders=None):
    """Reference phase W, then paths W-R, W-I and W-A: the launches of
    each. ``sizes`` and ``builders`` (``{"W-R": ..., "W-A": ...}``) make
    the small copies the CPU runs."""
    t0 = time.perf_counter()
    builders = builders or {}
    reference_swin_phase(counters, device)
    out = {}
    print(smi)

    def then(paths, best):
        print(smi)
        out["W-I"], _ = swin_inference_path(counters, paths, best, device)

    out["W-R"], _, _ = swin_train_path(counters, device, sizes,
                                       builders.get("W-R"), then=then)
    print(smi)
    out["W-A"], _ = swin_adaln_path(counters, device, sizes,
                                    builders.get("W-A"))
    print(f"path W (reference W, W-R, W-I, W-A): "
          f"{time.perf_counter() - t0:.1f} s")
    return {k: out[k] for k in ("W-R", "W-I", "W-A")}


# path G: FloeNet through the sea-ice recipe of fme's test_ice_train.py
# (``tests/test_ice_train.py:68-130``: siconc and its three budget terms
# at daily steps, input masking, the ice corrector's budget correction,
# MSE, AdamW) on the 1° grid with path O's seeded land mask; FloeNet at
# its builder's defaults (latent 256, SiLU, meshes 6 from M0 4, 4
# processor steps, layer norms, residuals)
G_NAMES = ("siconc", "LSRCc", "LSNKc", "XPRTc")
G_BUILDER = {"type": "FloeNet", "config": {}}
G_L_BUILDER = {"type": "LandNet", "config": {
    "use_positional_embedding": True}}
# the recipe's batch (its YAML's 2; ~13 GB a sample of saved activations
# predicted at latent 256, PERF.md §6)
G_BATCH = 2
# 9 training days (8 windows: 4 batches of 2), 3 validation days (1
# batch), 22 days for G-E
G_SPLITS = (("train", 9, "2000-01-01T00:00"),
            ("valid", 3, "2001-01-01T00:00"),
            ("inference", N_STEPS + 2, "2002-01-01T00:00"))
G_MEANS = {"siconc": 0.5, "LSRCc": 0.0, "LSNKc": 0.0, "XPRTc": 0.0}
G_STDS = {"siconc": 0.3, "LSRCc": 1e-6, "LSNKc": 1e-6, "XPRTc": 1e-7}
G_E_STEPS = N_STEPS
# reference G: the fast graph queries on a seeded sample of the 1° grid at
# meshes 6, and small GraphCasts at 16x32 (meshes 3, latent 8)
G_QUERY_SAMPLE = 8192
G_REFERENCE = {"latent_dimension": 8, "meshes": 3, "M0": 1,
               "processor_steps": 2}


def _ice_draw(name, shape, generator, device):
    """The ice test's draws: the fraction uniform in [0, 1], its budget
    terms of 1e-6 (melt negative) and 1e-7."""
    import torch

    kw = dict(generator=generator, device=device)
    if name == "siconc":
        return torch.rand(shape, **kw)
    if name == "LSRCc":
        return 1e-6 * torch.rand(shape, **kw)
    if name == "LSNKc":
        return -1e-6 * torch.rand(shape, **kw)
    return 1e-7 * torch.randn(shape, **kw)


def ice_files(tmp, nlat, nlon, generator, device, splits=G_SPLITS):
    """The recipe's netCDF files (its four variables NaN over land, and
    ``mask_2d``), one directory per split, over path O's grid and seeded
    land mask (``ocean_grid_and_masks``), and its stats files. Returns the
    paths, each split's fields and the mask."""
    import numpy as np

    from ace_tpu_torch.data.store import write_h5
    from ace_tpu_torch.data.time import TimeCoord

    coords, _, _, masks = ocean_grid_and_masks(nlat, nlon)
    mask = masks["mask_2d"]
    paths, series = {}, {}
    for split, n, start in splits:
        data = {k: np.where(mask > 0, _ice_draw(
            k, (n, nlat, nlon), generator, device).cpu().numpy(),
            np.nan).astype(np.float32) for k in G_NAMES}
        series[split] = dict(data)
        data["mask_2d"] = mask
        dims = {k: ("time", "lat", "lon") for k in G_NAMES}
        dims["mask_2d"] = ("lat", "lon")
        paths[split] = os.path.join(tmp, split)
        os.makedirs(paths[split])
        write_h5(os.path.join(paths[split], "data.nc"), data, dims,
                 coords=coords, time=TimeCoord.from_range(start, n, 86400))
    for label, stats in (("centering", G_MEANS), ("scaling", G_STDS)):
        paths[label] = os.path.join(tmp, f"{label}.nc")
        write_h5(paths[label],
                 {k: np.asarray(np.float32(v)) for k, v in stats.items()},
                 {k: () for k in stats})
    return paths, series, mask


def _ice_config(paths, experiment_dir, builder=None, batch=G_BATCH):
    """``tests/test_ice_train.py``'s recipe (fme's ``test_ice_train.py``)
    over ``ice_files``: one epoch at ``batch``, lr 1e-3, AdamW, MSE over
    one forward step, input masking refilling land with 0, the ice
    corrector's budget correction of siconc by its three terms; the
    network ``builder`` (``G_BUILDER``: FloeNet at its defaults)."""
    loader = {"num_data_workers": 1, "batch_size": batch}
    return {
        "experiment_dir": experiment_dir, "max_epochs": 1,
        "save_checkpoint": True, "seed": 0,
        "logging": {"log_to_screen": False, "log_to_file": False},
        "train_loader": dict(loader, dataset={"data_path": paths["train"]}),
        "validation_loader": dict(loader,
                                  dataset={"data_path": paths["valid"]}),
        "optimization": {"lr": 1e-3, "optimizer_type": "AdamW"},
        "stepper_training": {"n_forward_steps": 1, "loss": {"type": "MSE"}},
        "stepper": {
            "input_masking": {"mask_value": 0, "fill_value": 0.0},
            "step": {"type": "single_module", "config": {
                "builder": builder or G_BUILDER,
                "in_names": list(G_NAMES), "out_names": list(G_NAMES),
                "normalization": {"network": {
                    "global_means_path": paths["centering"],
                    "global_stds_path": paths["scaling"]}},
                "corrector": {"type": "ice_corrector", "config": {
                    "budget_correction": {"corrected_variables": {
                        "siconc": ["LSRCc", "LSNKc", "XPRTc"]}}}}}},
        },
    }


def _timed_graph_builds(records):
    """A context in which each ``build_graphs`` of the port's GraphCast
    appends its seconds to ``records``."""
    import contextlib

    from ace_tpu_torch.models import graphcast

    build = graphcast.build_graphs

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = build(*args, **kwargs)
        records.append(time.perf_counter() - t0)
        return out

    @contextlib.contextmanager
    def context():
        graphcast.build_graphs = timed
        try:
            yield
        finally:
            graphcast.build_graphs = build

    return context()


def _graph_query_phase(device, sample=G_QUERY_SAMPLE, meshes=6):
    """Reference G's graphs: at ``meshes`` (M0 4's finest level) on a seeded
    sample of ``sample`` points of the 1° grid, the fast ``radius_query``
    equal to ``radius_query_brute`` (the same pairs in the same order)
    and the fast ``containing_triangle`` equal to
    ``containing_triangle_brute`` on ``device`` (float64, every face),
    index for index; then ``build_graphs`` of the whole grid, timed."""
    import numpy as np

    from ace_tpu_torch.models import graphcast

    coords, _, _, _ = ocean_grid_and_masks(180, 360)
    lat2d, lon2d = np.meshgrid(coords["lat"], coords["lon"], indexing="ij")
    idx = np.sort(np.random.default_rng(11).choice(lat2d.size, sample,
                                                   replace=False))
    xyz = graphcast.latlon_to_xyz(lat2d.ravel()[idx], lon2d.ravel()[idx])
    fine = graphcast.get_mesh_hierarchy(meshes)[-1]
    radius = graphcast.max_edge_distance(fine)
    seconds = {}
    t0 = time.perf_counter()
    fast = graphcast.radius_query(xyz, fine.vertices, radius)
    seconds["radius_query"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    brute = graphcast.radius_query_brute(xyz, fine.vertices, radius)
    seconds["radius_query_brute"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tri = graphcast.containing_triangle(xyz, fine)
    seconds["containing_triangle"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tri_brute = graphcast.containing_triangle_brute(xyz, fine, device=device)
    seconds[f"containing_triangle_brute ({device})"] = (
        time.perf_counter() - t0)
    pairs_equal = all(np.array_equal(a, b) for a, b in zip(fast, brute))
    t0 = time.perf_counter()
    graphs = graphcast.build_graphs(lat2d, lon2d, meshes=meshes, M0=4)
    build = time.perf_counter() - t0
    print(f"reference G: {sample} points of the 1° grid against meshes "
          f"{meshes} ({len(fine.vertices)} nodes, {len(fine.faces)} faces): "
          f"radius_query {len(fast[0])} pairs, equal to the brute force in "
          f"order: {pairs_equal}; containing_triangle equal to the brute "
          f"force on {device}: {int((tri == tri_brute).sum())} of {sample}; "
          f"seconds {({k: round(v, 2) for k, v in seconds.items()})}; "
          f"build_graphs of the 1° grid {build:.2f} s ({graphs.n_grid} grid "
          f"and {graphs.n_mesh} mesh nodes; {len(graphs.g2m_senders)} "
          f"grid-to-mesh, {len(graphs.m2m_senders)} mesh, "
          f"{len(graphs.m2g_senders)} mesh-to-grid edges)")
    if not (pairs_equal and np.array_equal(tri, tri_brute)):
        raise AssertionError("reference G: a fast graph query differs from "
                             "the brute force")
    return build


def _graphcast_module_case(device, masked):
    """Reference G's network: a small GraphCast at 16x32 (``G_REFERENCE``,
    with a seeded mask of 70% of the grid or none) on ``device`` against
    the CPU from the same weights and input: the output (zeros off the
    mask) within reference S's float32 limit of its anomaly plus 1e-5 of
    its largest value, an MSE loss within its loss limit and every
    gradient within its gradient limit of the gradient's norm; then two
    forwards and two backwards on ``device`` give the same bits (the
    segment sum and the gathers' gradients add in a fixed order)."""
    import numpy as np
    import torch

    from ace_tpu_torch.models.graphcast import GraphCast
    from ace_tpu_torch.models.layers import init_weights

    nlat, nlon = 16, 32
    lat = np.linspace(-90 + 90 / nlat, 90 - 90 / nlat, nlat)
    lon = (np.arange(nlon) + 0.5) * 360 / nlon
    lat2d, lon2d = np.meshgrid(lat, lon, indexing="ij")
    mask = (np.random.default_rng(5).random((nlat, nlon)) > 0.3
            if masked else None)
    kw = dict(img_shape=(nlat, nlon), in_chans=4, out_chans=4, lat2d=lat2d,
              lon2d=lon2d, mask=mask, **G_REFERENCE)
    gen = torch.Generator().manual_seed(3)
    cpu = GraphCast(**kw)
    init_weights(cpu, gen)
    card = GraphCast(**kw, device=device)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, nlat, nlon, 4, generator=gen)
    target = torch.randn(2, nlat, nlon, 4, generator=gen)

    def run(module):
        dev = next(module.parameters()).device
        module.zero_grad()
        out = module(x.to(dev))
        loss = ((out - target.to(dev)) ** 2).mean()
        loss.backward()
        return out.detach(), loss.detach(), {
            k: p.grad.detach().clone() for k, p in module.named_parameters()}

    ref, ref_loss, ref_grads = run(cpu)
    got, loss, grads = run(card)
    again, _, grads_again = run(card)
    anomaly = (ref - ref.mean((1, 2), keepdim=True)).abs().amax((1, 2))
    allowed = S_F32_TOL * anomaly + 1e-5 * ref.abs().amax((1, 2))
    out_err = float(((got.cpu() - ref).abs().amax((1, 2)) / allowed).max())
    loss_err = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    gerrs = {k: float((grads[k].cpu().double() - r.double()).norm()
                      / (S_F32_GRAD_TOL * float(r.double().norm()) + 1e-30))
             for k, r in ref_grads.items()}
    worst = max(gerrs, key=gerrs.get)
    same_bits = torch.equal(got, again) and all(
        torch.equal(grads[k], grads_again[k]) for k in grads)
    off_mask = (not masked) or not got.cpu()[:, ~torch.from_numpy(mask)].any()
    label = f"reference G (GraphCast, {'masked' if masked else 'no mask'})"
    print(f"{label}: {device} vs CPU: output error {out_err:.3g} of the "
          f"allowed ({S_F32_TOL} of the anomaly + 1e-5 of the largest); loss "
          f"{float(loss):.6g} / {float(ref_loss):.6g}, relative error "
          f"{loss_err:.3g} (tol {S_F32_LOSS_TOL}); worst gradient {worst} "
          f"{gerrs[worst]:.3g} of the allowed ({S_F32_GRAD_TOL} of its "
          f"norm); two forwards and backwards on {device} equal bit for "
          f"bit: {same_bits}; zeros off the mask: {off_mask}")
    if not (out_err <= 1 and loss_err <= S_F32_LOSS_TOL
            and gerrs[worst] <= 1 and same_bits and off_mask):
        raise AssertionError(f"{label}: the card disagrees with the CPU, or "
                             "repeats do not give the same bits")


def reference_graphcast_phase(counters, device="cuda",
                              sample=G_QUERY_SAMPLE, meshes=6):
    """Reference phase G: the graph queries (``_graph_query_phase`` at
    ``sample`` points and ``meshes``), a
    small GraphCast with and without a mask card against CPU and run
    twice (``_graphcast_module_case``), and FloeNet through a small
    stepper of path W's shape (``swin_stepper_config``'s atmosphere: a
    2-step rollout, its second step against the CPU's step from the
    card's first, and one MSE train step, ``_reference_case``), no
    launch. Returns ``build_graphs``' seconds at the 1° grid."""
    none = {c.__name__: 0 for c in counters}
    build = _graph_query_phase(device, sample, meshes)
    for masked in (False, True):
        _graphcast_module_case(device, masked)
    launches = _reference_case(
        "reference G (FloeNet step)", counters, device,
        (S_F32_TOL, S_F32_LOSS_TOL, S_F32_GRAD_TOL),
        lambda dt: swin_stepper_config(
            {"type": "FloeNet", "config": G_REFERENCE}, False),
        "float32", _small_inputs, zero_gradients=lambda names: set(),
        stepwise=True)
    if launches != none:
        raise AssertionError(f"reference G: launches {launches}")
    return build


def graphcast_train_path(counters, device="cuda", nlat=180, nlon=360,
                         builder=None, then=None):
    """Path G-R: the training entry's ``main`` on ``_ice_config`` over
    ``ice_files`` (FloeNet at its defaults unless ``builder``): one epoch,
    then a resume that must be bit-equal. Checks finite metrics, one line
    per epoch, the checkpoint files, no launch, no sync in the batch loop;
    prints ``build_graphs``' seconds, the parameters, the loop's rates,
    the phases and the peak. ``then(paths, series, mask, best)`` runs
    inside the context that holds the files. Returns the launches, the
    rates and the first run's peak."""
    import contextlib

    import torch

    label = "path G-R"
    _, missing = inference_packages()
    files = h5py_in_memory() if "h5py" in missing else (
        contextlib.nullcontext())
    with tempfile.TemporaryDirectory() as tmp, files:
        paths, series, mask = ice_files(
            tmp, nlat, nlon, torch.Generator(device).manual_seed(23), device)
        out_dir = os.path.join(tmp, "experiment")
        config = _ice_config(paths, out_dir, builder)
        path = _write_yaml(os.path.join(tmp, "ice.yaml"), config)
        print(f"{label}: the sea-ice recipe at {nlat}x{nlon} "
              f"({int(mask.sum())} of {mask.size} cells wet), builder "
              f"{config['stepper']['step']['config']['builder']}, batch "
              f"{G_BATCH}")
        builds = []
        runs, launches, rates, restored, _, n_params = _epoch_then_resume(
            label, path, counters, device,
            lambda: [_timed_graph_builds(builds)])
        ckpt_dir = os.path.join(out_dir, "training_checkpoints")
        files_found = sorted(os.listdir(ckpt_dir))
        lines = _finite_metrics(os.path.join(out_dir, "metrics.jsonl"), 2,
                                label, ("train/loss", "val/loss"))
        print(f"{label}: build_graphs {[round(s, 2) for s in builds]} s; "
              f"{n_params} parameters; batch loop {rates[0]:.4f} (epoch 1) "
              f"and {rates[1]:.4f} (epoch 2) train steps/s at batch "
              f"{G_BATCH} ({rates[1] * G_BATCH:.4f} samples/s); losses by "
              f"epoch: train {[line['train/loss'] for line in lines]}, "
              f"validation {[line['val/loss'] for line in lines]}; "
              f"checkpoint files {files_found}")
        want_files = {"ckpt.msgpack", "best_ckpt.msgpack", "ema_ckpt.msgpack"}
        if not want_files <= set(files_found):
            raise AssertionError(f"{label}: checkpoint files {files_found}")
        _check_resume(label, runs, restored)
        _check_no_launches(label, counters, launches)
        if then is not None:
            then(paths, series, mask,
                 os.path.join(ckpt_dir, "best_ckpt.msgpack"))
    total = {c.__name__: sum(n[c.__name__] for calls in launches.values()
                             for n in calls) for c in counters}
    return total, rates, runs[0]["peak"]


def graphcast_evaluator_path(counters, paths, mask, ckpt, device="cuda",
                             n_steps=G_E_STEPS):
    """Path G-E: the evaluator entry's ``main`` over G-R's best checkpoint
    for ``n_steps`` steps at batch 1 in windows of 5 from the first time of
    the inference file, with the ice test's settings (``fill_nans: 0.0``,
    no step means or spectra). Checks no launch, no sync in
    ``run_inference`` (on the card), every logged metric finite, and the
    written predictions NaN exactly on the land cells. Returns the
    launches and the rate."""
    import contextlib

    import numpy as np
    import torch

    from ace_tpu_torch.data.store import open_file_dataset
    from ace_tpu_torch.inference import evaluator

    label = "path G-E"
    cuda = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "evaluator")
        path = _write_yaml(os.path.join(tmp, "evaluator.yaml"), {
            "experiment_dir": out_dir, "checkpoint_path": ckpt,
            "n_forward_steps": n_steps, "forward_steps_in_memory": 5,
            "logging": {"log_to_screen": False, "log_to_file": False},
            "loader": {"dataset": {"data_path": paths["inference"],
                                   "fill_nans": 0.0},
                       "start_indices": {"list": [0]}},
            # the ice test's aggregator settings; the zonal means' images
            # need matplotlib, which the card's image lacks
            "aggregator": {"log_step_means": [], "log_spectra": False,
                           "log_zonal_mean_images": False},
        })
        t0 = time.perf_counter()
        guard = (no_sync_in_run_inference(evaluator) if cuda
                 else contextlib.nullcontext())
        with guard:
            summary, launches = counted(
                counters, lambda: evaluator.main([path], device=device))
        seconds = time.perf_counter() - t0
        ds = open_file_dataset(os.path.join(out_dir,
                                            "autoregressive_predictions.nc"))
        pred = {k: np.asarray(ds[k].read(())) for k in G_NAMES}
    logs = summary["logs"]
    bad = [k for k, v in logs.items() if not np.isfinite(v)]
    land = mask == 0
    nan_on_land = {k: bool(np.isnan(v[..., land]).all()
                           and np.isfinite(v[..., ~land]).all())
                   for k, v in pred.items()}
    print(f"{label}: {n_steps} steps in {seconds:.2f} s (the entry, "
          f"checkpoint and graphs included); {len(logs)} metrics, not "
          f"finite: {bad[:5]}; time-mean RMSE of siconc "
          f"{logs['time_mean/rmse/siconc']:.6g}; predictions NaN exactly on "
          f"the {int(land.sum())} land cells: {nan_on_land}; launches "
          f"{launches}")
    if bad or not all(nan_on_land.values()):
        raise AssertionError(f"{label}: metrics not finite, or NaN off the "
                             "land cells")
    if launches != {c.__name__: 0 for c in counters}:
        raise AssertionError(f"{label}: launches {launches}")
    return launches, n_steps / seconds


def landnet_path(counters, paths, device="cuda", builder=None):
    """Path G-L: ``LandNet`` at its builder's defaults with its positional
    embedding (or ``builder``) through the training entry on G-R's files:
    one epoch of 2 batches. Checks finite metrics, no launch, no sync in
    the batch loop. Returns the launches and the rate."""
    import torch

    from ace_tpu_torch.core.timing import GlobalTimer
    from ace_tpu_torch.train.train import main as train_main

    label = "path G-L"
    cuda = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "experiment")
        config = _ice_config(paths, out_dir, builder or G_L_BUILDER)
        # 4 samples: 2 batches of 2
        config["train_loader"]["dataset"]["subset"] = {"stop": 4}
        path = _write_yaml(os.path.join(tmp, "landnet.yaml"), config)
        launches, rates = {}, []
        GlobalTimer.reset()
        with _phase_probes(counters, launches, rates, cuda, None):
            trainer = train_main([path], device=device)
        n_params = sum(p.numel() for p in trainer.stepper.module.parameters())
        n_batches = trainer.num_batches_seen
        del trainer
        lines = _finite_metrics(os.path.join(out_dir, "metrics.jsonl"), 1,
                                label, ("train/loss", "val/loss"))
    print(f"{label}: builder {builder or G_L_BUILDER}; {n_params} "
          f"parameters; {n_batches} batches at {rates[0]:.4f} train steps/s; "
          f"train loss {lines[0]['train/loss']}, validation "
          f"{lines[0]['val/loss']}")
    if n_batches != 2:
        raise AssertionError(f"{label}: {n_batches} batches, not 2")
    _check_no_launches(label, counters, launches)
    return ({c.__name__: sum(n[c.__name__] for calls in launches.values()
                             for n in calls) for c in counters}, rates[0])


def graphcast_paths(counters, smi, device="cuda", nlat=180, nlon=360,
                    builders=None, query=(G_QUERY_SAMPLE, 6)):
    """Reference phase G (its graph queries at ``query``: a sample size
    and a mesh level), then paths G-R, G-E and G-L: the launches of each.
    ``nlat``, ``nlon``, ``builders`` (``{"G-R": ..., "G-L": ...}``) and
    ``query`` make the small copies the CPU runs."""
    t0 = time.perf_counter()
    builders = builders or {}
    reference_graphcast_phase(counters, device, *query)
    out = {}
    print(smi)

    def then(paths, series, mask, best):
        print(smi)
        out["G-E"], _ = graphcast_evaluator_path(counters, paths, mask, best,
                                                 device)
        out["G-L"], _ = landnet_path(counters, paths, device,
                                     builders.get("G-L"))

    out["G-R"], _, _ = graphcast_train_path(counters, device, nlat, nlon,
                                            builders.get("G-R"), then=then)
    print(f"path G (reference G, G-R, G-E, G-L): "
          f"{time.perf_counter() - t0:.1f} s")
    return {k: out[k] for k in ("G-R", "G-E", "G-L")}


# path D: the HiRO-ACE global recipe
# (``configs/baselines/downscaling-hiro-global/train.yaml``: SongUNet at
# model_channels 128, channel_mult [1, 2, 2, 2, 2, 2, 2], one block a
# level, the bottleneck's attention only, residual prediction, fine
# topography, Adam 1e-4, EMA 0.999, 16x16 coarse patches, 18 Heun steps)
# at 100 km -> 3.125 km over synthetic files: the coarse grid 32x64 inside
# the recipe's lat_extent [-66, 70] (one row outside it on each side), the
# fine grid 32 times finer
D_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "baselines", "downscaling-hiro-global",
                        "train.yaml")
D_SIZES = {"nlat": 32, "nlon": 64, "factor": 32, "patch": 16, "batch": 6,
           "batches": 4, "train_times": 6, "valid_times": 2, "samples": 2}
D_COARSE = ("PRATEsfc", "eastward_wind_at_ten_meters",
            "northward_wind_at_ten_meters")
D_FINE = ("PRATEsfc",)
# the draws of the synthetic fields: (mean, std, positive)
D_DRAWS = {"PRATEsfc": (0.0, 3e-5, True),
           "eastward_wind_at_ten_meters": (0.0, 6.0, False),
           "northward_wind_at_ten_meters": (0.0, 4.0, False),
           "HGTsfc": (400.0, 800.0, True)}
D_PREDICT_TOL = 1e-5
# reference D: small nets of each backbone, card against CPU
D_SMALL_SONG = {"model_channels": 16, "channel_mult": [1, 2, 2],
                "num_blocks": 1, "attn_resolutions": [8], "dropout": 0.0,
                "channel_mult_emb": 4}
D_REFERENCE = {
    "song-standard": {"type": "unet_diffusion_song",
                      "config": dict(D_SMALL_SONG)},
    "song-residual": {"type": "unet_diffusion_song_v2", "config": dict(
        D_SMALL_SONG, encoder_type="residual")},
    "song-skip-fourier": {"type": "unet_diffusion_song_v2", "config": dict(
        D_SMALL_SONG, encoder_type="skip", decoder_type="skip",
        embedding_type="fourier")},
    "unet": {"type": "unet", "config": {"base_channels": 8,
                                        "channel_mults": [1, 2],
                                        "num_res_blocks": 1,
                                        "attn_levels": [1]}},
}


def _downscaling_draw(name, shape, generator, device):
    import torch

    mean, std, positive = D_DRAWS[name]
    v = torch.randn(shape, generator=generator, device=device)
    return ((v.abs() if positive else v) * std + mean).cpu().numpy()


def downscaling_files(tmp, generator, device, sizes=None):
    """Path D's netCDF files: coarse (the three inputs) and fine
    (PRATEsfc) training and validation directories, the four stats files
    the recipe names, and the fine ``HGTsfc`` static file over the region
    the recipe's lat_extent keeps; drawn from ``generator`` on
    ``device``. Returns their paths."""
    import numpy as np

    from ace_tpu_torch.data.store import write_h5
    from ace_tpu_torch.data.time import TimeCoord

    s = dict(D_SIZES, **(sizes or {}))
    nlat, nlon, f = s["nlat"], s["nlon"], s["factor"]
    # coarse rows: nlat inside [-66, 70] and one outside on each side
    step = 136.0 / nlat
    lat = -66.0 + step / 2 + step * np.arange(-1, nlat + 1)
    lon = np.linspace(0.0, 360.0, nlon, endpoint=False)
    fine_lat = -66.0 - step + step / f * (np.arange((nlat + 2) * f) + 0.5)
    fine_lon = np.linspace(0.0, 360.0, nlon * f, endpoint=False)
    paths, train = {}, {}
    for split, n, start in (("train", s["train_times"], "2014-01-01T00:00"),
                            ("valid", s["valid_times"], "2023-01-01T00:00")):
        time = TimeCoord.from_range(start, n, 21600)
        for res, names, la, lo in (("coarse", D_COARSE, lat, lon),
                                   ("fine", D_FINE, fine_lat, fine_lon)):
            data = {k: _downscaling_draw(k, (n, len(la), len(lo)),
                                         generator, device) for k in names}
            if split == "train":
                train[res] = data
            key = f"{res}_{split}"
            paths[key] = os.path.join(tmp, key)
            os.makedirs(paths[key])
            write_h5(os.path.join(paths[key], "data.nc"), data,
                     {k: ("time", "lat", "lon") for k in data},
                     coords={"lat": la, "lon": lo}, time=time)
    for res, data in train.items():
        for label, fn in (("centering", np.mean), ("scaling", np.std)):
            paths[f"{res}_{label}"] = os.path.join(tmp, f"{res}_{label}.nc")
            write_h5(paths[f"{res}_{label}"],
                     {k: np.asarray(fn(v), np.float32)
                      for k, v in data.items()}, {k: () for k in data})
    paths["static"] = os.path.join(tmp, "topography.nc")
    write_h5(paths["static"], {"HGTsfc": _downscaling_draw(
        "HGTsfc", (nlat * f, nlon * f), generator, device)},
        {"HGTsfc": ("lat", "lon")})
    paths["lat"], paths["lon"] = lat, lon
    return paths


def _downscaling_config(paths, experiment_dir, sizes=None, module=None):
    """The recipe with path D's cuts: the synthetic files, the downscale
    factor, the static field, batch ``D_SIZES['batch']``, that many
    batches an epoch (``sample_with_replacement``), validation every
    epoch over the validation times, one epoch, no Weights & Biases;
    ``sizes`` and ``module`` (a ``{type, config}``) make the small copies
    the CPU runs."""
    import yaml

    s = dict(D_SIZES, **(sizes or {}))
    with open(D_CONFIG) as fh:
        config = yaml.safe_load(fh)
    model = config["model"]
    model["downscale_factor"] = s["factor"]
    if module is not None:
        model["module"] = module
    if "steps" in s:
        model["num_diffusion_generation_steps"] = s["steps"]
    for res in ("coarse", "fine"):
        model["normalization"][res] = {
            "global_means_path": paths[f"{res}_centering"],
            "global_stds_path": paths[f"{res}_scaling"]}
    for key, split in (("train_data", "train"),
                       ("validation_data", "valid")):
        block = config[key]
        for res in ("coarse", "fine"):
            block[res] = [{"data_path": paths[f"{res}_{split}"],
                           "file_pattern": "data.nc"}]
        block["batch_size"] = s["batch"]
    config["train_data"]["sample_with_replacement"] = (s["batch"]
                                                       * s["batches"])
    config["coarse_patch_extent_lat"] = s["patch"]
    config["coarse_patch_extent_lon"] = s["patch"]
    config.update(experiment_dir=experiment_dir, max_epochs=1,
                  validate_interval=1,
                  static_inputs={"HGTsfc": paths["static"]})
    config["logging"] = {"log_to_wandb": False, "log_to_screen": False,
                         "log_to_file": True}
    return config


def _downscaling_state_checksums(trainer):
    """``_tensor_checksums`` of the downscaling trainer's weights, Adam
    moments, EMA, generator and batch sampler states, with its counters."""
    import numpy as np
    import torch

    opt = trainer.optimization
    _, keys, pos, _, _ = trainer.np_rng.get_state()
    tensors = {"generator": trainer.generator.get_state().to(trainer.device),
               "np_rng": torch.as_tensor(keys.view(np.int32),
                                         device=trainer.device)}
    for label, group in (("param", trainer.params), ("mu", opt.mu),
                         ("nu", opt.nu), ("ema", trainer.ema.ema_params)):
        for i, t in enumerate(group):
            tensors[f"{label}/{i}"] = t
    out = _tensor_checksums(tensors)
    out["counts"] = (int(pos), opt.adam_count, opt.schedule_count,
                     trainer.ema.num_updates, trainer.num_batches_seen)
    return out


def _count_calls(owner, name, calls):
    """A context that appends one to ``calls`` at each call of
    ``owner.<name>``."""
    import contextlib

    fn = getattr(owner, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    @contextlib.contextmanager
    def context():
        setattr(owner, name, counted)
        try:
            yield calls
        finally:
            setattr(owner, name, fn)

    return context()


def downscaling_train_path(counters, device="cuda", sizes=None, module=None,
                           then=None):
    """Path D-R: the downscaling training entry (``python -m
    ace_tpu_torch.downscaling``'s ``main``) on ``_downscaling_config``: one
    epoch, then ``--override max_epochs=2``, which must resume at epoch 1
    from ``ckpt.msgpack`` bit for bit; TF32 turned on before each run and
    off after it. Checks finite losses, one metrics line per epoch, the
    checkpoint files, no launch, no sync in the batch loop; prints the
    parameters, the loop's train steps/s, the peak and each checkpoint's
    bytes and seconds. ``then(paths, ckpt, config)`` runs inside the
    context that holds the files. Returns the launches, the rates and the
    first run's peak."""
    import contextlib

    import torch

    from ace_tpu_torch.downscaling import train as ds_train

    label = "path D-R"
    s = dict(D_SIZES, **(sizes or {}))
    cuda = torch.device(device).type == "cuda"
    _, missing = inference_packages()
    files = h5py_in_memory() if "h5py" in missing else (
        contextlib.nullcontext())
    trainer_cls = ds_train.DownscalingTrainer
    with tempfile.TemporaryDirectory() as tmp, files:
        t0 = time.perf_counter()
        paths = downscaling_files(tmp, torch.Generator(device).manual_seed(23),
                                  device, sizes)
        out_dir = os.path.join(tmp, "experiment")
        config = _downscaling_config(paths, out_dir, sizes, module)
        path = _write_yaml(os.path.join(tmp, "downscaling.yaml"), config)
        print(f"{label}: {D_CONFIG} at {s['nlat']}x{s['nlon']} coarse, "
              f"x{s['factor']}, patches {s['patch']}x{s['patch']}, batch "
              f"{s['batch']} x {s['batches']} batches; files in "
              f"{time.perf_counter() - t0:.1f} s")
        runs, launches, rates, restored, saves = [], [], [], {}, []
        restore = trainer_cls.restore

        def restore_and_read(self, ckpt):
            restore(self, ckpt)
            restored.update(_downscaling_state_checksums(self))

        save = trainer_cls._save

        def timed_save(self, epoch):
            t = time.perf_counter()
            save(self, epoch)
            if cuda:
                torch.cuda.synchronize()
            saves.append(time.perf_counter() - t)

        flags = []
        for argv in ([path], [path, "--override", "max_epochs=2"]):
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            with contextlib.ExitStack() as stack:
                seconds = stack.enter_context(
                    _no_sync_in(trainer_cls, "_train_batches") if cuda
                    else contextlib.nullcontext([]))
                stack.enter_context(_tf32_probe(flags))
                trainer_cls.restore = restore_and_read
                trainer_cls._save = timed_save
                stack.callback(setattr, trainer_cls, "restore", restore)
                stack.callback(setattr, trainer_cls, "_save", save)
                trainer, counts = counted(
                    counters, lambda: ds_train.main(argv, device=device))
            launches.append(counts)
            rates.extend(s["batches"] / t for t in seconds)
            runs.append({"start_epoch": trainer.start_epoch,
                         "state": _downscaling_state_checksums(trainer),
                         "peak": (torch.cuda.max_memory_allocated() / 1e9
                                  if cuda else 0.0)})
            n_params = sum(p.numel() for p in trainer.params)
            del trainer
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        ckpt_dir = os.path.join(out_dir, "checkpoints")
        found = sorted(os.listdir(ckpt_dir))
        sizes_b = {f: os.path.getsize(os.path.join(ckpt_dir, f))
                   for f in found}
        with open(os.path.join(out_dir, "metrics.jsonl")) as fh:
            lines = [json.loads(line) for line in fh]
        print(f"{label}: {n_params} parameters; batch loop "
              f"{[round(r, 4) for r in rates]} train steps/s at batch "
              f"{s['batch']} (patches {s['patch'] * s['factor']}^2); losses "
              f"by epoch: train {[x['train_loss'] for x in lines]}, "
              f"validation {[x['val_loss'] for x in lines]}; peak device "
              f"memory {[round(r['peak'], 2) for r in runs]} GB; checkpoint "
              f"saves {[round(t, 3) for t in saves]} s; files {sizes_b} "
              f"bytes (ckpt.msgpack holds the training state; on {device} "
              "the netCDF files are in host memory where h5py is missing, "
              "the checkpoints on the disk)")
        _check_tf32_pinned(label, flags)
        if not (len(lines) == 2 and all(
                math.isfinite(x[k]) for x in lines
                for k in ("train_loss", "val_loss"))):
            raise AssertionError(f"{label}: metrics {lines}")
        if set(found) != {"ckpt.msgpack", "ema_ckpt.msgpack"}:
            raise AssertionError(f"{label}: checkpoint files {found}")
        _check_resume(label, runs, restored)
        none = {c.__name__: 0 for c in counters}
        print(f"{label}: launches per run {launches} (want none)")
        if any(n != none for n in launches):
            raise AssertionError(f"{label}: launches {launches}")
        if then is not None:
            then(paths, os.path.join(ckpt_dir, "ckpt.msgpack"), config)
    total = {c.__name__: sum(n[c.__name__] for n in launches)
             for c in counters}
    return total, rates, runs[0]["peak"]


def _event_region(paths, s, patches):
    """Lat/lon extents around the first ``patches`` x ``patches`` coarse
    patches (overlap 1) from the grid's second row and column, and the
    number of coarse cells each way."""
    n = patches * s["patch"] - (patches - 1)
    lat, lon = paths["lat"], paths["lon"]
    return ([float(lat[1]), float(lat[n])], [float(lon[1]), float(lon[n])],
            n)


def downscaling_predict_path(counters, paths, ckpt, device="cuda",
                             sizes=None):
    """Path D-G: the downscaler entry (``downscaling.predict.main``) over
    D-R's checkpoint: one event of 2x2 coarse patches (overlap 1) at a
    validation time with ``D_SIZES['samples']`` samples kept, TF32 turned
    on before. Checks TF32 off after it, no launch, exactly ``2 steps -
    1`` network evaluations per patch-sample, no sync inside the sampler,
    finite output, and the written samples within ``D_PREDICT_TOL`` of
    ``PatchPredictor.generate`` of the first patch on the same draws (the
    event's generator, seeded as the entry seeds it; the first patch
    draws first) where no other patch overlaps it. Returns the launches
    and the seconds per patch-sample."""
    import contextlib

    import numpy as np
    import torch

    from ace_tpu_torch.data.dataset import XarrayDataConfig
    from ace_tpu_torch.data.store import open_file_dataset
    from ace_tpu_torch.downscaling import models, predict
    from ace_tpu_torch.downscaling.train import load_downscaling_model

    label = "path D-G"
    s = dict(D_SIZES, **(sizes or {}))
    cuda = torch.device(device).type == "cuda"
    lat_ext, lon_ext, n = _event_region(paths, s, 2)
    with tempfile.TemporaryDirectory() as tmp:
        event = {"name": "d_g", "date": "2023-01-01T06:00",
                 "lat_extent": lat_ext, "lon_extent": lon_ext,
                 "n_samples": s["samples"], "save_generated_samples": True}
        config = {"experiment_dir": os.path.join(tmp, "out"),
                  "checkpoint_path": ckpt,
                  "coarse_data": {"data_path": paths["coarse_valid"],
                                  "file_pattern": "data.nc"},
                  "n_timesteps": 0, "events": [event],
                  "coarse_patch_extent_lat": s["patch"],
                  "coarse_patch_extent_lon": s["patch"],
                  "logging": {"log_to_screen": False, "log_to_file": False}}
        path = _write_yaml(os.path.join(tmp, "predict.yaml"), config)
        net_calls, flags = [], []
        from ace_tpu_torch.downscaling.song_unet import SongUNetV2
        from ace_tpu_torch.downscaling.unet import DiffusionUNet

        with contextlib.ExitStack() as stack:
            seconds = stack.enter_context(
                _no_sync_in(models, "stochastic_sampler") if cuda
                else contextlib.nullcontext([]))
            for cls in (SongUNetV2, DiffusionUNet):
                stack.enter_context(_count_calls(cls, "forward", net_calls))
            stack.enter_context(_tf32_probe(flags))
            _, launches = counted(counters,
                                  lambda: predict.main([path], device=device))
        _check_tf32_pinned(label, flags)
        written = open_file_dataset(os.path.join(tmp, "out",
                                                 "d_g_event.nc"))
        samples = np.asarray(written["PRATEsfc"].read(()))
        model = load_downscaling_model(ckpt, device=device)
        steps = model.config.num_diffusion_generation_steps
        n_calls = s["samples"] * 4
        per_sample = len(net_calls) / n_calls
        data = XarrayDataConfig(data_path=paths["coarse_valid"],
                                file_pattern="data.nc").build()
        window, _ = data.get_window(1, 1, model.config.in_names)
        y0, y1, xs, contiguous = predict._region_indices(
            data.dataset_info.horizontal_coordinates.lat,
            data.dataset_info.horizontal_coordinates.lon, lat_ext, lon_ext)
        coarse = predict._crop_window(window, y0, y1, xs, contiguous,
                                      torch.device(device))
        static = predict._crop_static(model, y0, y1, xs, contiguous)
        # the first patch's draws come first: its prediction, where no
        # other patch overlaps it, is the composite's
        generator = torch.Generator(device).manual_seed(
            predict._named_seed(0, "d_g"))
        p = s["patch"]
        first = models.PatchPredictor(model, (p, p)).generate(
            {k: v[..., :p, :p] for k, v in coarse.items()}, generator,
            n_samples=s["samples"],
            static=static[:p * s["factor"], :p * s["factor"]])
        alone = (p - 1) * s["factor"]
        again = first["PRATEsfc"][0, :, :alone, :alone].cpu().numpy()
    err = float(np.abs(samples[:, :alone, :alone] - again).max())
    scale = float(np.abs(again).max())
    per_patch_sample = (sum(seconds) / len(seconds)) if seconds else 0.0
    print(f"{label}: event of {n}x{n} coarse cells (2x2 patches of "
          f"{s['patch']}, overlap 1) -> {samples.shape}, "
          f"{s['samples']} samples: {len(seconds)} sampler calls, "
          f"{per_patch_sample:.4f} s per patch-sample (host clock, ending in "
          f"a synchronize); {per_sample} network evaluations per "
          f"patch-sample (want {2 * steps - 1}); the first patch's cells "
          f"against PatchPredictor.generate of that patch on the same draws: "
          f"largest error {err:.3g} (tol "
          f"{D_PREDICT_TOL} of {scale:.3g}); launches {launches}")
    if launches != {c.__name__: 0 for c in counters}:
        raise AssertionError(f"{label}: launches {launches}")
    if per_sample != 2 * steps - 1:
        raise AssertionError(f"{label}: {per_sample} evaluations a sample")
    if not (np.isfinite(samples).all() and err <= D_PREDICT_TOL * scale):
        raise AssertionError(f"{label}: the written samples disagree with "
                             "PatchPredictor.generate")
    return launches, per_patch_sample


def downscaling_evaluator_path(counters, paths, ckpt, device="cuda",
                               sizes=None):
    """Path D-E: the evaluator entry (``downscaling.evaluator.main``) over
    D-R's checkpoint on the validation pair cropped (the ``data`` block's
    extents) to one coarse patch: one time, and one event over the same
    region, ``D_SIZES['samples']`` samples each, TF32 turned on before.
    Checks TF32 off after it, no launch, the generation and ensemble
    metrics finite and present, the diagnostics file. Returns the
    launches."""
    import torch

    from ace_tpu_torch.downscaling import evaluator

    label = "path D-E"
    s = dict(D_SIZES, **(sizes or {}))
    lat_ext, lon_ext, _ = _event_region(paths, s, 1)
    extent = {"lat_extent": {"start": lat_ext[0], "stop": lat_ext[1]},
              "lon_extent": {"start": lon_ext[0], "stop": lon_ext[1]}}
    with tempfile.TemporaryDirectory() as tmp:
        config = {
            "experiment_dir": os.path.join(tmp, "out"),
            "checkpoint_path": ckpt,
            "data": {"coarse": [{"data_path": paths["coarse_valid"],
                                 "file_pattern": "data.nc"}],
                     "fine": [{"data_path": paths["fine_valid"],
                               "file_pattern": "data.nc"}], **extent},
            "events": [{"name": "d_e", "date": "2023-01-01T06:00",
                        "n_samples": s["samples"]}],
            "n_samples": s["samples"], "n_timesteps": 1,
            "coarse_patch_extent_lat": s["patch"],
            "coarse_patch_extent_lon": s["patch"],
            "logging": {"log_to_screen": False, "log_to_file": False}}
        path = _write_yaml(os.path.join(tmp, "evaluator.yaml"), config)
        flags = []
        t0 = time.perf_counter()
        with _tf32_probe(flags):
            logs, launches = counted(
                counters, lambda: evaluator.main([path], device=device))
        seconds = time.perf_counter() - t0
        _check_tf32_pinned(label, flags)
        diagnostics = os.path.exists(os.path.join(
            tmp, "out", "generation_diagnostics.nc"))
    want = [f"downscaling/{m}/PRATEsfc" for m in (
        "crps", "rmse_of_ensemble_mean", "spread_skill_ratio_bias",
        "metrics/crps", "metrics/rmse", "metrics/psnr", "metrics/ssim",
        "metrics/relative_crps_bicubic", "metrics/relative_mse_bicubic")]
    want += [f"event/d_e/{m}/PRATEsfc" for m in (
        "crps", "rmse_of_ensemble_mean", "spread_skill_ratio_bias")]
    print(f"{label}: {seconds:.2f} s; logs "
          f"{ {k: round(v, 6) for k, v in sorted(logs.items())} }; "
          f"diagnostics file {diagnostics}; launches {launches}")
    if launches != {c.__name__: 0 for c in counters}:
        raise AssertionError(f"{label}: launches {launches}")
    missing = [k for k in want if k not in logs]
    # the SSIM's window needs 11 cells: a small patch has none
    if s["patch"] * s["factor"] < 11:
        missing = [k for k in missing if "ssim" not in k]
    if missing or not all(math.isfinite(v) for v in logs.values()):
        raise AssertionError(f"{label}: logs {logs} (missing {missing})")
    if not diagnostics:
        raise AssertionError(f"{label}: no generation_diagnostics.nc")
    return launches


def reference_downscaling_phase(counters, device="cuda", fine=16):
    """Reference phase D: small diffusion models of each backbone of
    ``D_REFERENCE`` (SongUNetV2 standard, residual, skip with the Fourier
    embedding; the compact UNet) and a small SwinIR, each on ``device``
    against the CPU from the same weights and inputs: the network's output
    within ``S_F32_TOL`` of each channel's anomaly plus 1e-5 of its largest
    value, the EDM loss (fixed sigma and noise; SwinIR's MSE) within
    ``S_F32_LOSS_TOL``, every gradient within ``S_F32_GRAD_TOL`` of its norm
    plus 1e-6 of the largest; one sampler call (3 Heun steps with churn,
    the same latents and noise) within the outputs' limit; and the keep
    rate of the port's dropout on the card by its statistics. No launch."""
    import numpy as np
    import torch

    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.core.coordinates import LatLonCoordinates
    from ace_tpu_torch.core.dataset_info import DatasetInfo
    from ace_tpu_torch.downscaling import models
    from ace_tpu_torch.downscaling.song_unet import dropout
    from ace_tpu_torch.models.layers import init_weights

    label = "reference D"
    coarse_hw = (fine // 2, fine // 2)
    info = DatasetInfo(horizontal_coordinates=LatLonCoordinates(
        lat=np.linspace(-40.0, 40.0, coarse_hw[0]),
        lon=np.linspace(0.0, 350.0, coarse_hw[1])))
    norm = {"coarse": {"means": {"a": 0.0, "b": 1.0},
                       "stds": {"a": 1.0, "b": 2.0}},
            "fine": {"means": {"a": 0.5}, "stds": {"a": 1.5}}}
    gen = torch.Generator().manual_seed(31)

    def draw(*shape):
        return torch.randn(shape, generator=gen)

    coarse = {"a": draw(2, *coarse_hw), "b": draw(2, *coarse_hw)}
    target = {"a": draw(2, fine, fine)}
    cases = {name: ("diffusion", module) for name, module in
             D_REFERENCE.items()}
    cases["swinir"] = ("deterministic", None)
    none = {c.__name__: 0 for c in counters}
    for name, (kind, module) in cases.items():
        results, start = [], gen.get_state()
        for dev in ("cpu", device):
            gen.set_state(start)
            if kind == "diffusion":
                cfg = from_dict(models.DiffusionModelConfig, {
                    "in_names": ["a", "b"], "out_names": ["a"],
                    "normalization": norm, "module": module,
                    "downscale_factor": 2, "predict_residual": True,
                    "churn": 0.5, "num_diffusion_generation_steps": 3})
                model = cfg.build(info, device=dev)
            else:
                cfg = from_dict(models.DeterministicModelConfig, {
                    "in_names": ["a", "b"], "out_names": ["a"],
                    "normalization": norm, "downscale_factor": 2,
                    "embed_dim": 16, "depths": [2], "num_heads": 2,
                    "window_size": [2, 4]})
                model = cfg.build(info, device=dev)
            if dev == "cpu":
                # the initial weights, each tensor moved by a draw of its
                # scale (the zero-initialized output layers count too)
                wgen = torch.Generator().manual_seed(3)
                init_weights(model.net, wgen)
                with torch.no_grad():
                    for p in model.net.parameters():
                        fan = p[0].numel() if p.dim() > 1 else 1
                        p.add_(0.3 * torch.randn(p.shape, generator=wgen)
                               / fan ** 0.5)
                weights = model.net.state_dict()
            else:
                model.net.load_state_dict(weights)

            def run(model=model, dev=dev):
                c = {k: v.to(dev) for k, v in coarse.items()}
                t = {k: v.to(dev) for k, v in target.items()}
                if kind == "diffusion":
                    cond, _ = model._pack(c, None)
                    x = draw(2, fine, fine, 1).to(dev)
                    out = model.net(x, cond, torch.full((2,), 0.3,
                                                        device=dev))
                    loss = model.loss_fn(c, t, sigma=torch.tensor(
                        [0.2, 3.0], device=dev), noise=draw(
                        2, fine, fine, 1).to(dev))
                else:
                    out = model.net(model._cond(c))
                    loss = model.loss_fn(c, t)
                params = list(model.net.parameters())
                grads = torch.autograd.grad(loss, params)
                sample = None
                if kind == "diffusion":
                    latents = [draw(2, fine, fine, 1).to(dev)]
                    eps = [[draw(2, fine, fine, 1).to(dev) for _ in range(3)]]
                    sample = model.generate(c, latents=latents,
                                            eps=eps)["a"]
                names = [k for k, _ in model.net.named_parameters()]
                return (out.detach().cpu(), float(loss.detach()),
                        {k: g.cpu() for k, g in zip(names, grads)},
                        None if sample is None else sample.cpu())

            res, counts = counted(counters, run)
            results.append(res)
            if counts != none:
                raise AssertionError(f"{label} ({name}): launches {counts}")
        (ref, ref_loss, ref_grads, ref_sample), (got, loss, grads, sample) = (
            results)

        def ratio(g, r):
            anomaly = (r - r.mean((1, 2), keepdim=True)).abs().amax((1, 2))
            allowed = S_F32_TOL * anomaly + 1e-5 * r.abs().amax((1, 2))
            return float(((g - r).abs().amax((1, 2)) / allowed).max())

        out_ratio = ratio(got, ref)
        sample_ratio = (ratio(sample, ref_sample) if sample is not None
                        else 0.0)
        loss_err = abs(loss - ref_loss) / abs(ref_loss)
        largest = max(float(r.double().norm()) for r in ref_grads.values())
        gerrs = {k: float((grads[k].double() - r.double()).norm())
                 / (S_F32_GRAD_TOL * float(r.double().norm())
                    + 1e-6 * largest) for k, r in ref_grads.items()}
        worst = max(gerrs, key=gerrs.get)
        print(f"{label} ({name}): {device} vs CPU: output "
              f"{out_ratio:.3g} of the allowed, loss {loss:.6g} / "
              f"{ref_loss:.6g} (relative {loss_err:.3g}, tol "
              f"{S_F32_LOSS_TOL}), gradients {gerrs[worst]:.3g} of the "
              f"allowed ({worst}) over {len(gerrs)} parameters, sampler "
              f"{sample_ratio:.3g} of the allowed")
        if not (out_ratio <= 1 and sample_ratio <= 1
                and loss_err <= S_F32_LOSS_TOL and gerrs[worst] <= 1):
            raise AssertionError(f"{label} ({name}): the card disagrees "
                                 "with the CPU")
    ones = torch.ones(8, 128, 64, 64, device=device)
    kept = dropout(ones, 0.1, False,
                   torch.Generator(device).manual_seed(5))
    rate = float((kept != 0).float().mean())
    sd = (0.9 * 0.1 / ones.numel()) ** 0.5
    print(f"{label}: the port's dropout at 0.10 on {device} keeps {rate:.6f} "
          f"of {ones.numel()} (want 0.9 within {5 * sd:.2g}); kept values "
          f"{float(kept.max()):.7g}")
    if not (abs(rate - 0.9) <= 5 * sd
            and torch.allclose(kept[kept != 0], torch.tensor(
                1 / 0.9, device=device))):
        raise AssertionError(f"{label}: the dropout's keep rate")


def downscaling_paths(counters, smi, device="cuda", sizes=None, module=None):
    """Reference phase D, then paths D-R, D-G and D-E: the launches of
    each. ``sizes`` and ``module`` make the small copies the CPU runs."""
    t0 = time.perf_counter()
    reference_downscaling_phase(counters, device)
    out = {}
    print(smi)

    def then(paths, ckpt, config):
        print(smi)
        out["D-G"], _ = downscaling_predict_path(counters, paths, ckpt,
                                                 device, sizes)
        print(smi)
        out["D-E"] = downscaling_evaluator_path(counters, paths, ckpt,
                                                device, sizes)

    out["D-R"], _, _ = downscaling_train_path(counters, device, sizes,
                                              module, then=then)
    print(f"path D (reference D, D-R, D-G, D-E): "
          f"{time.perf_counter() - t0:.1f} s")
    return {k: out[k] for k in ("D-R", "D-G", "D-E")}


def _entry_paths(counters, keep, none, smi, rate_t):
    """Paths I, E (with phase E-agg), R and F (with reference phases R
    and F): the launches of each."""
    from ace_tpu_torch import flagship

    # path I: the inference entry, K1 in each block of each step
    print(smi)
    ckpt = os.path.join(keep, "flagship.msgpack")
    launches_i, _, _, _ = inference_path(counters, keep_checkpoint=ckpt)
    per_step = flagship.LAYERS * N_STEPS
    if launches_i != {**none, "dhconv_filter": per_step}:
        raise AssertionError(f"path I: launches {launches_i}, want "
                             f"{per_step} of dhconv_filter only")

    # path E: the evaluator entry over path I's checkpoint, K1 in each
    # block of each step; then every aggregator, card against CPU
    print(smi)
    launches_e, _, _, _ = evaluator_path(counters, ckpt)
    want_e = {**none, "dhconv_filter": flagship.LAYERS * E_STEPS}
    if launches_e != want_e:
        raise AssertionError(f"path E: launches {launches_e}, want {want_e}")
    aggregator_phase(ckpt)
    gc.collect()

    # reference phases R and F, path R and, from its best checkpoint,
    # path F: the training entries, K1 in each block's forward (and
    # recompute), 1b and 1c in each block's backward
    reference_train_entry_phase()
    reference_finetune_phase()
    print(smi)
    launches_f = {}

    def then(paths, best):
        print(smi)
        launches_f.update(finetune_entry_path(counters, paths, best)[0])

    launches_r, _, _, _ = train_entry_path(counters, path_t_rate=rate_t,
                                           then=then)
    return {"I": launches_i, "E": launches_e, "R": launches_r,
            "F": launches_f}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from ace_tpu_torch import flagship
    from ace_tpu_torch.ops import dhconv_filter as k1
    from ace_tpu_torch.ops import fused_block_tail as k2
    from ace_tpu_torch.ops import fused_sht as k3
    from ace_tpu_torch.ops import kernel_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; allow_tf32: matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}")

    # seconds by section, printed at the end: where the run's time goes
    sections, clock = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        sections[name] = round(now - clock[0], 1)
        clock[0] = now

    sources = [k1.SOURCE, k1.BWD_SOURCE, k1.DW_SOURCE, k2.SOURCE, k3.SOURCE]
    t0 = time.perf_counter()
    seconds = kernel_build.build(sources)
    print(f"build: {seconds} in {time.perf_counter() - t0:.1f} s")
    for source in sources:
        print(kernel_build.build_log(source).strip())
    lap("build")

    gen = torch.Generator("cuda").manual_seed(2)
    kernels = {"dhconv_filter": dhconv_phase(gen)}
    kernels.update(dhconv_bwd_phase(gen))
    reference_phase(fused=False)
    reference_phase(fused=True)
    counters = [k1.dhconv_filter, k1.dhconv_filter_dx, k1.dhconv_filter_dw,
                k2.fused_block_tail, k3.fused_sht]
    for fused in (False, True):
        reference_train_phase(fused, counters)
    lap("K1 and 1b/1c phases, the flagship references")

    path0 = build_flagship(fused=False)
    kernels["fused_block_tail"] = block_tail_phase(gen, path0.module.block_1)
    kernels["fused_sht"] = sht_phase(gen, path0.module.trans)

    per_step = flagship.LAYERS * N_STEPS
    none = {c.__name__: 0 for c in counters}
    ic, forcing = flagship.synthetic_inputs(
        path0, N_STEPS, generator=torch.Generator("cuda").manual_seed(1)
    )
    rate0, launches0 = rollout(
        "0", path0, ic, forcing, counters,
        {**none, "dhconv_filter": per_step},
    )

    path_a = build_flagship(fused=True)
    for p, q in zip(path0.module.state_dict().values(),
                    path_a.module.state_dict().values()):
        if not torch.equal(p, q):
            raise AssertionError("paths 0 and A drew different weights")
    # path B's input: what block 1's forward SHT sees in path A's first step
    block_input = []
    hook = path_a.module.block_1.filter.register_forward_pre_hook(
        lambda module, args: block_input.append(args[0].clone())
    )
    first_steps_agree(path0, path_a, ic, forcing)
    hook.remove()
    # path A's peak memory is read with path 0's stepper gone
    del path0
    gc.collect()
    # back to the seed-0 weights of path 0's rollout
    path_a.init_params(torch.Generator("cuda").manual_seed(0))
    rate_a, launches_a = rollout(
        "A", path_a, ic, forcing, counters,
        {**none, "dhconv_filter": per_step, "fused_block_tail": per_step},
    )
    print(f"paths 0 and A, same call: {rate0:.3f} and {rate_a:.3f} steps/s")

    trans = path_a.module.trans
    (x,) = block_input
    with torch.inference_mode():
        (coeffs, launches_b) = counted(
            counters, lambda: trans.forward_fused(x)
        )
        err, scale = max_err(coeffs, trans.forward_pair(x))
    print(f"path B: forward_fused on block 1's input {tuple(x.shape)} "
          f"{x.dtype} vs forward_pair: max_abs_err {err:.3e} (tol "
          f"{SHT_TOL * scale:.3e}); launches {launches_b}")
    if not (all(torch.isfinite(c).all() for c in coeffs)
            and err <= SHT_TOL * scale):
        raise AssertionError("path B disagrees with forward_pair")
    if launches_b != {**none, "fused_sht": 1}:
        raise AssertionError(f"path B: kernel launches {launches_b}")
    del path_a, trans, x, block_input, coeffs
    gc.collect()
    torch.cuda.empty_cache()
    lap("K2 and K3 phases, paths 0, A, B")

    # path T: per train step, K1 in each block's forward and again in its
    # recompute (checkpointing 1), 1b and 1c once per block
    layers = flagship.LAYERS
    per_train_step = {**none, "dhconv_filter": 2 * layers,
                      "dhconv_filter_dx": layers, "dhconv_filter_dw": layers}
    path_t = build_train_flagship(fused=False)
    batch = flagship.synthetic_batch(
        path_t.stepper, TRAIN_BATCH,
        generator=torch.Generator("cuda").manual_seed(1))
    weights0 = {k: v.clone() for k, v in path_t.module.state_dict().items()}
    first_t, rate_t, launches_t = train_path(path_t, batch, counters,
                                             per_train_step)
    del path_t
    gc.collect()
    torch.cuda.empty_cache()

    # path T-A: the first step again, with the fused tail (K2 in each
    # block's forward and recompute)
    path_ta = build_train_flagship(fused=True)
    for k, v in path_ta.module.state_dict().items():
        if not torch.equal(v, weights0[k]):
            raise AssertionError("paths T and T-A drew different weights")
    del weights0
    torch.cuda.reset_peak_memory_stats()
    metrics_ta, launches_ta = counted(
        counters, lambda: path_ta.train_step(batch, noise_generator()))
    peak_ta = torch.cuda.max_memory_allocated() / 1e9
    errs = {k: abs(float(metrics_ta[k]) - float(first_t[k]))
            / abs(float(first_t[k])) for k in ("loss", "grad_norm")}
    print(f"path T-A: first step loss {float(metrics_ta['loss']):.6g}, "
          f"grad_norm {float(metrics_ta['grad_norm']):.6g}; against path "
          f"T's first: relative errors {errs} (tol {TRAIN_PATH_TOL}); peak "
          f"device memory {peak_ta:.2f} GB; launches {launches_ta}")
    if not max(errs.values()) <= TRAIN_PATH_TOL:
        raise AssertionError("path T-A's first step disagrees with path T's")
    if launches_ta != {**per_train_step, "fused_block_tail": 2 * layers}:
        raise AssertionError(f"path T-A: launches {launches_ta}")
    print(f"path T, same call: {rate_t:.4f} train steps/s, "
          f"{rate_t * TRAIN_BATCH:.4f} samples/s")
    del path_ta, batch
    gc.collect()
    torch.cuda.empty_cache()
    lap("paths T, T-A")

    # the flagship checkpoint of path I, for path E
    keep = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        by_path = {"0": launches0, "A": launches_a, "B": launches_b,
                   "T": launches_t, "T-A": launches_ta}
        by_path.update(_entry_paths(counters, keep, none, smi, rate_t))
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    gc.collect()
    lap("paths I, E, R, F")
    torch.cuda.empty_cache()

    # reference phase S and paths S-R, S-I, S-bf16: the ACE2-SHiELD AMIP
    # recipe's SphericalFourierNeuralOperatorNet (K1, 1b and 1c only in
    # S-bf16)
    by_path.update(shield_paths(counters, smi))
    gc.collect()
    torch.cuda.empty_cache()
    lap("path S")

    # reference phase M and paths M-R, M-I, M-bf16: the ACE2-SOM slab-ocean
    # recipe (the multi-call step over the slab-ocean step; K1, 1b and 1c
    # only in M-bf16, 2 calls of the wrapped step a step)
    by_path.update(som_paths(counters, smi))
    gc.collect()
    torch.cuda.empty_cache()
    lap("path M")

    # reference phase O and paths O-R, O-E: the uncoupled-ocean CM4
    # recipe (Samudra, masks, the ocean corrector; no kernel of the port)
    by_path.update(ocean_paths(counters, smi))
    gc.collect()
    torch.cuda.empty_cache()
    lap("path O")

    # reference phase C and paths C-R, C-F, C-E, C-bf16: the SamudrACE
    # CM4 recipes (the SFNO coupled to Samudra; K1 and 1b only in C-bf16)
    by_path.update(coupled_paths(counters, smi))
    gc.collect()
    torch.cuda.empty_cache()
    lap("path C")

    # reference phase N and paths N-R, N-I: FourCastNet3's recipe (DISCO
    # encoders and decoders, float32: no kernel of the port)
    by_path.update(fcn3_paths(counters, smi))
    gc.collect()
    torch.cuda.empty_cache()
    lap("path N")

    # path L's kernel shapes, reference phase L and paths L-R, L-I, L-A,
    # L-N: the flagship recipe with local blocks, labels and a missing
    # variable (K1, 1b, 1c in the spectral blocks; K2 in L-A), and LocalNet
    by_local, rows_l = local_paths(counters, smi, gen=gen)
    by_path.update(by_local)
    gc.collect()
    torch.cuda.empty_cache()
    lap("path L")

    # reference phase H and paths H-R, H-I: DLWP-HPX's recipe on the HEALPix
    # grid (HEALPixUNet, float32: no kernel of the port)
    by_path.update(healpix_paths(counters, smi))
    gc.collect()
    torch.cuda.empty_cache()
    lap("path H")

    # reference phase W and paths W-R, W-I, W-A: the Swin U-Nets through the
    # flagship recipe (float32: no kernel of the port)
    by_path.update(swin_paths(counters, smi))
    gc.collect()
    torch.cuda.empty_cache()
    lap("path W")

    # reference phase G and paths G-R, G-E, G-L: FloeNet and LandNet
    # through the sea-ice recipe (float32: no kernel of the port)
    by_path.update(graphcast_paths(counters, smi))
    gc.collect()
    torch.cuda.empty_cache()
    lap("path G")

    # reference phase D and paths D-R, D-G, D-E: the HiRO-ACE global
    # downscaling recipe (SongUNet at full width, float32: no kernel of the
    # port)
    by_path.update(downscaling_paths(counters, smi))
    lap("path D")
    print(f"seconds by section: {sections}; in all "
          f"{sum(sections.values()):.1f} s")

    own_path = {"dhconv_filter": "0", "fused_block_tail": "A",
                "fused_sht": "B", "dhconv_filter_dx": "T",
                "dhconv_filter_dw": "T"}
    for name, row in kernels.items():
        row["launches"] = by_path[own_path[name]][name]
        row["launches_by_path"] = {p: n[name] for p, n in by_path.items()}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        if name in rows_l:
            row["at_path_l"] = rows_l[name]
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
