"""Smoke run of the PyTorch/CUDA port (ace_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Checks that CUDA is present, prints the card's name and power limit,
   and turns TF32 off for matmuls and convolutions.
2. Builds the port's CUDA kernels from ``ace_tpu_torch/csrc/`` with nvcc
   (one process per source, all at once) and prints the build times and
   the compiler's resource reports (registers, shared memory, spills).
3. Kernel phases: holds each kernel (K1 dhconv_filter, K2
   fused_block_tail, K3 fused_sht) against its plain PyTorch version on
   the card, at the main path's shapes and at a ragged shape, and times
   the kernel, the plain version and what the port runs in its place
   (one PyTorch library call for K1, the unfused tail for K2,
   ``RealSHT.forward_pair`` and one three-operand einsum for K3), beside
   the least time the card could take (``bound_share`` = bound / kernel
   time). K3 and ``forward_pair`` are also held against a float64
   evaluation of the same transform.
4. Reference phase: runs a small bf16 model on the card (kernels) and on
   the CPU (plain versions) with the same weights and noise, unfused
   (K1) and with the fused tail (K1 and K2), and compares.
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
   The rollouts check finite outputs, the dry-air mass, the prescribed SST
   and the launch counts, and print steps/s and peak device memory.

Prints a ``{"kernels": [...]}`` JSON line, then as its last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero without that
line. Needs no network and imports nothing of JAX.
"""

import gc
import json
import subprocess
import sys
import time

N_STEPS = 20
# published H100 SXM peaks (dense bf16 and TF32 tensor cores, f32 outside
# the tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
BF16_TOL = 8e-3  # of the largest output: the final bf16 rounding
# K2: four bf16 rounding points between the products, the JAX package's
# fused-versus-module limit (tests/test_pallas_block.py)
TAIL_TOL = 2e-2
# K3: split-TF32 products (about 22 mantissa bits) summed over 360 and 180
# terms in another order
SHT_TOL = 1e-4


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
    i = o = flagship.EMBED
    args = inputs(b, l, m, i, o)
    err, scale = check(args)
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
    bound_ms, bound_by, bytes_ms, flops_ms = bound(n_bytes, flops,
                                                   PEAK_BF16_FLOPS)
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
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


def tail_inputs(n, c, hidden, nc, gen):
    """Rows and weights for K2, the weights drawn at std 1/sqrt(fan-in)
    so that every product shows in the output."""
    import torch

    def r(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    bf = torch.bfloat16
    xf, resid = r(n, c).to(bf), r(n, c).to(bf)
    noise = r(n, nc)
    weights = (
        r(c, c, std=c ** -0.5), r(c, std=0.1), 1.0 + r(c, std=0.1),
        r(c, std=0.1), r(nc, c, std=0.1), r(nc, c, std=0.1),
        r(c, hidden, std=c ** -0.5), r(hidden, std=0.1),
        r(hidden, c, std=hidden ** -0.5), r(c, std=0.1),
    )
    return xf, resid, noise, tuple(w.to(bf).contiguous() for w in weights)


def block_tail_phase(gen, block):
    """Kernel K2 against its plain version at a ragged and the flagship
    shape; times beside the unfused tail of ``block`` (a flagship block,
    as path 0 runs it) on the same rows."""
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

    sources = [k1.SOURCE, k2.SOURCE, k3.SOURCE]
    t0 = time.perf_counter()
    seconds = kernel_build.build(sources)
    print(f"build: {seconds} in {time.perf_counter() - t0:.1f} s")
    for source in sources:
        print(kernel_build.build_log(source).strip())

    gen = torch.Generator("cuda").manual_seed(2)
    kernels = {"dhconv_filter": dhconv_phase(gen)}
    reference_phase(fused=False)
    reference_phase(fused=True)

    path0 = build_flagship(fused=False)
    kernels["fused_block_tail"] = block_tail_phase(gen, path0.module.block_1)
    kernels["fused_sht"] = sht_phase(gen, path0.module.trans)

    counters = [k1.dhconv_filter, k2.fused_block_tail, k3.fused_sht]
    per_step = flagship.LAYERS * N_STEPS
    ic, forcing = flagship.synthetic_inputs(
        path0, N_STEPS, generator=torch.Generator("cuda").manual_seed(1)
    )
    rate0, launches0 = rollout(
        "0", path0, ic, forcing, counters,
        {"dhconv_filter": per_step, "fused_block_tail": 0, "fused_sht": 0},
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
        {"dhconv_filter": per_step, "fused_block_tail": per_step,
         "fused_sht": 0},
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
    if launches_b != {"dhconv_filter": 0, "fused_block_tail": 0,
                      "fused_sht": 1}:
        raise AssertionError(f"path B: kernel launches {launches_b}")

    by_path = {"0": launches0, "A": launches_a, "B": launches_b}
    own_path = {"dhconv_filter": "0", "fused_block_tail": "A",
                "fused_sht": "B"}
    for name, row in kernels.items():
        row["launches"] = by_path[own_path[name]][name]
        row["launches_by_path"] = {p: n[name] for p, n in by_path.items()}
        row["bound_share"] = row["bound_ms"] / row["ms"]
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
