"""Smoke run of the PyTorch/CUDA port (ace_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Checks that CUDA is present, prints the card's name and power limit,
   and turns TF32 off for matmuls and convolutions.
2. Builds the port's CUDA kernels from ``ace_tpu_torch/csrc/`` with nvcc
   (one process per source, in parallel) and prints the build time and
   the compiler's resource report.
3. Kernel phase: holds each kernel against its plain PyTorch version on
   the card, at the main path's shapes and at a ragged shape, and times
   the kernel, the plain version and one PyTorch library call computing
   the same function, beside the least time the card could take.
4. Reference phase: runs a small bf16 model on the card (kernels) and on
   the CPU (plain versions) with the same weights and noise, and compares.
5. Main path: builds the ACE2-ERA5 flagship stepper (NoiseConditionedSFNO,
   embed 512, 8 layers, 180x360 Gauss grid, bf16, 32 isotropic noise
   channels, prescribed SST, dry-air corrector; 38 inputs, 44 outputs)
   through the port's config and registry, draws its weights from a seed
   on the card, and rolls it out with ``Stepper.predict`` for 20 steps at
   batch 1. Checks that the outputs are finite, that the dry-air mass and
   the prescribed SST hold, and that the kernels ran the expected number
   of times; prints steps/s and peak device memory.

Prints a ``{"kernels": [...]}`` JSON line, then as its last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero without that
line. Needs no network and imports nothing of JAX.
"""

import json
import subprocess
import sys
import time

N_STEPS = 20
# published H100 SXM peaks (dense bf16 tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
BF16_TOL = 8e-3  # of the largest output: the final bf16 rounding


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

    def max_err(args):
        out = dhconv_filter(*args)
        ref = dhconv_filter_plain(*args)
        torch.cuda.synchronize()
        err = max(float((a.float() - r.float()).abs().max())
                  for a, r in zip(out, ref))
        scale = max(float(r.float().abs().max()) for r in ref)
        return err, scale

    # ragged M and O edges (M=181 over 64-row tiles, O=200 over 64 columns)
    err, scale = max_err(inputs(2, 3, 181, 96, 200))
    print(f"dhconv_filter ragged [2,3,181,96]x[3,96,200]: max_abs_err "
          f"{err:.3e} (tol {BF16_TOL * scale:.3e})")
    if not err <= BF16_TOL * scale:
        raise AssertionError("dhconv_filter disagrees with its plain version "
                             "at the ragged shape")

    # the flagship shape: B=1, L=180, M=181, I=O=512
    from ace_tpu_torch import flagship

    b, l, m = 1, flagship.NLAT, flagship.NLON // 2 + 1
    i = o = flagship.EMBED
    args = inputs(b, l, m, i, o)
    err, scale = max_err(args)
    tol = BF16_TOL * scale
    print(f"dhconv_filter flagship [1,180,181,512]x[180,512,512]: max_abs_err "
          f"{err:.3e} (tol {tol:.3e})")
    if not err <= tol:
        raise AssertionError("dhconv_filter disagrees with its plain version "
                             "at the flagship shape")
    xr, xi, wr, wi = args
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
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_BF16_FLOPS * 1e3
    print(f"dhconv_filter flagship: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, library (bf16 matmul) {library_ms:.4f} ms; bound: "
          f"{n_bytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms, {flops / 1e9:.1f} "
          f"GFLOP -> {flops_ms:.4f} ms")
    return {
        "name": "dhconv_filter", "route": "cuda",
        "source": "ace_tpu_torch/csrc/dhconv_filter.cu",
        "replaces": "ace_tpu/ops/pallas_filter.py:69",
        "launches": None, "max_abs_err": err, "tol": tol,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": library_ms,
    }


def reference_phase():
    """A small bf16 flagship-shaped model on the card (through the
    kernels) against the same model on the CPU (plain versions), on the
    same weights and noise."""
    import torch

    from ace_tpu_torch.flagship import (
        CHECK_TOL,
        anomaly_error,
        build_stepper,
        draw_check_weights,
    )

    cpu = build_stepper(16, 32, 2, 128, 2, device="cpu")
    gpu = build_stepper(16, 32, 2, 128, 2, device="cuda")
    gen = torch.Generator().manual_seed(3)
    # filters and conditioning drawn large enough to show in the outputs
    draw_check_weights(cpu, gen)
    gpu.load_state_dict(cpu.module.state_dict())
    n_in = cpu.module.in_chans
    x = torch.randn(2, 16, 32, n_in, generator=gen)
    noise = cpu.module.make_noise(2, gen)
    with torch.inference_mode():
        ref = cpu.module(x, noise=noise)
        out = gpu.module(x.cuda(), noise=noise.cuda()).cpu()
    # per output channel, over the scale of its spatial anomaly
    err = anomaly_error(out, ref, (1, 2))
    print(f"reference: bf16 model on the card vs the CPU, largest error "
          f"over the anomaly {err:.4g} (tol {CHECK_TOL})")
    if not (torch.isfinite(out).all() and err <= CHECK_TOL):
        raise AssertionError("the model on the card disagrees with the CPU")


def main_path(counters):
    """The flagship rollout; returns the launches counted in it."""
    import torch

    from ace_tpu_torch import flagship

    t0 = time.perf_counter()
    stepper = flagship.build_stepper(device="cuda")
    stepper.init_params(torch.Generator("cuda").manual_seed(0))
    ic, forcing = flagship.synthetic_inputs(
        stepper, N_STEPS, generator=torch.Generator("cuda").manual_seed(1)
    )
    torch.cuda.synchronize()
    print(f"main path: flagship stepper built and initialized in "
          f"{time.perf_counter() - t0:.2f} s")
    n_params = sum(p.numel() for p in stepper.module.parameters())
    print(f"main path: {n_params} parameters, "
          f"{len(stepper.step.config.in_names)} inputs, "
          f"{len(stepper.out_names)} outputs")

    # first call (one step) timed apart: it prepares the kernel-layout
    # weights and warms the library handles
    t0 = time.perf_counter()
    stepper.predict(ic, {k: v[:, :2] for k, v in forcing.items()})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    for counted in counters:
        counted.launches = 0
    t0 = time.perf_counter()
    # the rollout must never wait for the device: any synchronizing
    # operation inside it raises
    torch.cuda.set_sync_debug_mode("error")
    outputs, _ = stepper.predict(ic, forcing)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"main path: first call (1 step) {first_s:.3f} s; {N_STEPS}-step "
          f"rollout {rollout_s:.3f} s = {N_STEPS / rollout_s:.3f} steps/s at "
          f"batch 1; peak device memory {peak_gb:.2f} GB; launches {launches}")

    for name in stepper.out_names:
        v = outputs[name]
        if (v.shape != (1, N_STEPS, *stepper.dataset_info.img_shape)
                or not torch.isfinite(v).all()):
            raise AssertionError(f"output {name}: shape {tuple(v.shape)} "
                                 "or non-finite values")
    # the prescribed SST holds where the next step's ocean fraction is 1
    ocean = torch.round(forcing["ocean_fraction"][:, 1:]) == 1
    sst = outputs["surface_temperature"]
    if not torch.equal(sst[ocean], forcing["surface_temperature"][:, 1:][ocean]):
        raise AssertionError("the prescribed SST does not hold")
    # the corrector pins the global dry-air mass to the initial condition's
    corrector = stepper.step.corrector
    target = corrector.init_state({k: v[:, 0] for k, v in ic.data.items()})
    drift = max(
        float((corrector.init_state({k: v[:, t] for k, v in outputs.items()})
               ["global_dry_air_mass"] - target["global_dry_air_mass"])
              .abs().max())
        for t in range(N_STEPS)
    )
    print(f"main path: dry-air mass drift over the rollout {drift:.4f} Pa")
    if not drift < 1.0:
        raise AssertionError("the dry-air mass is not conserved")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from ace_tpu_torch import flagship
    from ace_tpu_torch.ops import dhconv_filter as dhconv_module
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

    sources = [dhconv_module.SOURCE]
    t0 = time.perf_counter()
    seconds = kernel_build.build(sources)
    print(f"build: {seconds} in {time.perf_counter() - t0:.1f} s")
    for source in sources:
        print(kernel_build.build_log(source).strip())

    gen = torch.Generator("cuda").manual_seed(2)
    kernels = [dhconv_phase(gen)]
    reference_phase()
    counters = [dhconv_module.dhconv_filter]
    launches = main_path(counters)
    expected = {"dhconv_filter": flagship.LAYERS * N_STEPS}
    for row in kernels:
        row["launches"] = launches[row["name"]]
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, want {expected}")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
