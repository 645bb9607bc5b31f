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
   Functions) and at a ragged shape, and times the kernel,
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
   the step's metrics.
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
     from the same weights, batch and noise, against path T's first.
   The rollouts check finite outputs, the dry-air mass, the prescribed SST
   and the launch counts, and print steps/s and peak device memory; the
   train steps check finite losses and gradient norms, a loss after the
   6 updates below the warm-up step's (taken before any update), the
   launch counts and that no step waits for the device, and print steps/s,
   samples/s and peak device memory.

Prints a ``{"kernels": [...]}`` JSON line, then as its last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero without that
line. Needs no network and imports nothing of JAX.
"""

import gc
import json
import math
import subprocess
import sys
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
    train_err, train_tol = dhconv_train_check(gen)
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
        "train_max_abs_err": train_err, "train_tol": train_tol,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


def dhconv_train_check(gen):
    """K1 as path T calls it: 2 * TRAIN_BATCH samples through
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

    b, l, m = 2 * TRAIN_BATCH, flagship.NLAT, flagship.NLON // 2 + 1
    i = o = flagship.EMBED
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
    print(f"dhconv_filter flagship-train [{b},{l},{m},{i}] through "
          f"dhconv_filter_param (f32 [2, L, I, O] weight): max_abs_err "
          f"{err:.3e} (tol {tol:.3e})")
    if not err <= tol:
        raise AssertionError("dhconv_filter disagrees with its plain version "
                             "at the flagship training shape")
    return err, tol


def dhconv_bwd_phase(gen):
    """Kernels 1b (dx) and 1c (dW) against their plain versions at a
    ragged shape and the flagship training shape (B = 4: 2 samples x 2
    members), with their times beside their bounds, their plain versions
    and one bf16 library matmul each."""
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

    rows = {}
    for label, shape in (("ragged", (2, 3, 181, 96, 200)),
                         ("flagship-train", (2 * TRAIN_BATCH, flagship.NLAT,
                                             flagship.NLON // 2 + 1,
                                             flagship.EMBED, flagship.EMBED))):
        xr, xi, gr, gi, wr, wi = inputs(*shape)
        dx = check(label, shape, "dhconv_filter_dx",
                   dhconv_filter_dx(gr, gi, wr, wi),
                   dhconv_filter_dx_plain(gr, gi, wr, wi))
        dw_ref = dhconv_filter_dw_plain(xr, xi, gr, gi)
        dw = check(label, shape, "dhconv_filter_dw",
                   (dhconv_filter_dw(xr, xi, gr, gi),),
                   (torch.stack(dw_ref),))
        del dw_ref
    b, l, m, i, o = shape
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
    for name, n_bytes, key, source, replaces in (
            ("dhconv_filter_dx", dx_bytes, "dx", "dhconv_filter_bwd.cu", 129),
            ("dhconv_filter_dw", dw_bytes, "dw", "dhconv_filter_dw.cu", 137)):
        bound_ms, bound_by, bytes_ms, flops_ms = bound(n_bytes, flops,
                                                       PEAK_BF16_FLOPS)
        err, tol = dx if key == "dx" else dw
        print(f"{name} flagship-train: kernel {times[key]:.4f} ms, plain "
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

    sources = [k1.SOURCE, k1.BWD_SOURCE, k1.DW_SOURCE, k2.SOURCE, k3.SOURCE]
    t0 = time.perf_counter()
    seconds = kernel_build.build(sources)
    print(f"build: {seconds} in {time.perf_counter() - t0:.1f} s")
    for source in sources:
        print(kernel_build.build_log(source).strip())

    gen = torch.Generator("cuda").manual_seed(2)
    kernels = {"dhconv_filter": dhconv_phase(gen)}
    kernels.update(dhconv_bwd_phase(gen))
    reference_phase(fused=False)
    reference_phase(fused=True)
    counters = [k1.dhconv_filter, k1.dhconv_filter_dx, k1.dhconv_filter_dw,
                k2.fused_block_tail, k3.fused_sht]
    for fused in (False, True):
        reference_train_phase(fused, counters)

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

    by_path = {"0": launches0, "A": launches_a, "B": launches_b,
               "T": launches_t, "T-A": launches_ta}
    own_path = {"dhconv_filter": "0", "fused_block_tail": "A",
                "fused_sht": "B", "dhconv_filter_dx": "T",
                "dhconv_filter_dw": "T"}
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
