"""The fused SFNO block tail: CUDA kernel and plain version (port of
ace_tpu/ops/pallas_block.py:fused_block_tail).

After the spectral filter, a block of the noise-conditioned SFNO computes,
per grid point (a row of C channels)::

    t   = gelu(x_f + (r @ W_skip + b_skip))        # inner skip, GELU
    y   = layer_norm(t) * ln_w + ln_b              # over C, f32 statistics
    y   = y * (1 + n @ W_s) + n @ W_b              # noise conditioning
    out = gelu(y @ W1 + b1) @ W2 + b2 + r          # MLP, outer skip

with bf16 activations and the JAX package's rounding points
(``pallas_block.py:_tail_math``): each product's f32 sum is rounded to bf16
before its bias is added, every elementwise step rounds to bf16, GELU is
the tanh form. ``fused_block_tail`` launches the hand-written kernel
``csrc/fused_block_tail.cu`` for CUDA tensors and uses
``fused_block_tail_plain`` only for tensors on the CPU. With tensors that
require grad it is differentiable: the forward is the kernel, the backward
the VJP of the plain version recomputed, as JAX's ``_tail_bwd``
(pallas_block.py:179-190) does.
"""

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

SOURCE = "fused_block_tail.cu"
EPS = 1e-5
# the kernel's row tile, hidden chunk, ring of weight stages, and the
# shared memory a block may use on Hopper
ROWS = 64
HIDDEN_CHUNK = 256
STAGES, STAGE_BYTES = 3, 32768
MAX_SMEM = 232448


def tail_smem_bytes(c: int, hidden: int, noise: int) -> int:
    """Dynamic shared memory of one kernel block, as
    ``csrc/fused_block_tail.cu`` lays it out: 1 KB to align the base to
    the 128-byte swizzle's 1024-byte period, the ring of weight stages, the
    t/y tile (64 rows x C bf16), the tile that holds the residual, then
    the staged skip product, then the noise (padded to a multiple of 64
    channels), then each hidden chunk, and ten 8-byte barriers (the ring's
    full and empty ones, and those of the residual and x_f tiles).
    ``hidden`` does not enter: the hidden activations exist one 256-column
    chunk at a time."""
    del hidden
    noise_pad = -(-max(noise, 1) // 64) * 64
    second = max(c, noise_pad, HIDDEN_CHUNK)
    return (1024 + STAGES * STAGE_BYTES + ROWS * c * 2 + ROWS * second * 2
            + 10 * 8)


def tail_shapes_supported(c: int, hidden: int, noise: int) -> bool:
    """Widths the kernel takes: C and hidden in whole 64-column tiles, at
    least one noise channel, and a block that fits one SM's shared memory
    (C up to 512). The TPU's 128-lane rule does not apply."""
    return (c % 64 == 0 and hidden % 64 == 0 and c > 0 and hidden > 0
            and noise >= 1 and tail_smem_bytes(c, hidden, noise) <= MAX_SMEM)


def fused_block_tail_plain(xf, resid, noise, weights, bf16_products=False):
    """Plain PyTorch version on ``[..., C]`` rows, with the kernel's
    rounding points.

    Args:
      xf: the spectral filter's output ``[..., C]``.
      resid: the block residual ``[..., C]``.
      noise: the conditioning channels ``[..., Nc]``.
      weights: ``(skip_k, skip_b, ln_w, ln_b, w_s, w_b, fc1_k, fc1_b,
        fc2_k, fc2_b)``, dense kernels ``[in, out]``; all rounded to bf16.
      bf16_products: take each product as one bf16 ``torch.matmul`` (f32
        accumulation, a bf16 result) instead of an f32 product of the
        rounded operands rounded after: the same values up to the order of
        the sum, and the tensor cores on a card. The backward's recompute
        on CUDA uses it; JAX leaves these products to XLA's bf16 dots.
    """
    bf = torch.bfloat16
    (skip_k, skip_b, ln_w, ln_b, ws, wb,
     fc1_k, fc1_b, fc2_k, fc2_b) = (w.to(bf) for w in weights)

    def mm(x, w):
        if bf16_products:
            return x.to(bf) @ w
        return (x.to(bf).float() @ w.float()).to(bf)

    r = resid.to(bf)
    t = F.gelu(xf.to(bf) + (mm(r, skip_k) + skip_b), approximate="tanh")
    mean = t.mean(-1, keepdim=True, dtype=torch.float32)
    xc = t - mean.to(bf)
    var = xc.square().mean(-1, keepdim=True, dtype=torch.float32)
    y = xc * torch.rsqrt(var + EPS).to(bf)
    y = y * ln_w + ln_b
    y = y * (1.0 + mm(noise, ws)) + mm(noise, wb)
    h = F.gelu(mm(y, fc1_k) + fc1_b, approximate="tanh")
    return mm(h, fc2_k) + fc2_b + r


def _check(xf, resid, noise, weights):
    named = [("xf", xf), ("resid", resid), ("noise", noise)] + [
        (f"weights[{i}]", w) for i, w in enumerate(weights)
    ]
    if len(weights) != 10:
        raise ValueError(f"fused_block_tail: want 10 weights, got {len(weights)}")
    c = xf.shape[-1]
    if resid.shape != xf.shape or noise.shape[:-1] != xf.shape[:-1]:
        raise ValueError(
            f"fused_block_tail: shapes xf {tuple(xf.shape)}, resid "
            f"{tuple(resid.shape)}, noise {tuple(noise.shape)}"
        )
    nc = noise.shape[-1]
    hidden = weights[6].shape[-1]
    want = [(c, c), (c,), (c,), (c,), (nc, c), (nc, c), (c, hidden),
            (hidden,), (hidden, c), (c,)]
    for i, (w, shape) in enumerate(zip(weights, want)):
        if tuple(w.shape) != shape:
            raise ValueError(
                f"fused_block_tail: weights[{i}] shape {tuple(w.shape)}, "
                f"want {shape}"
            )
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError(f"fused_block_tail: tensors on several devices {devices}")


def fused_block_tail(xf, resid, noise, weights):
    """Fused inner skip, GELU, conditional layer norm, MLP and outer skip.

    Args:
      xf: bfloat16 filter output ``[..., C]``.
      resid: bfloat16 block residual ``[..., C]``.
      noise: float32 conditioning channels ``[..., Nc]`` (the kernel
        rounds them to bf16 as it loads them).
      weights: see :func:`fused_block_tail_plain`; on CUDA all bfloat16
        and contiguous, dense kernels ``[in, out]``.

    Returns:
      bfloat16 ``[..., C]``. CUDA tensors go through the kernel
      (``fused_block_tail.launches`` counts its launches); CPU tensors
      through :func:`fused_block_tail_plain`. Other devices raise. With
      tensors that require grad (and grad mode on) the call is
      differentiable; the weights may then be float32 (rounded to bf16
      inside, their gradients float32) and need not be contiguous.
    """
    _check(xf, resid, noise, weights)
    tensors = (xf, resid, noise, *weights)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _FusedBlockTail.apply(xf, resid, noise, *weights)
    return _forward(xf, resid, noise, weights)


class _FusedBlockTail(torch.autograd.Function):
    """K2 forward; backward as the VJP of the plain tail, recomputed
    (JAX's ``_tail_bwd``), with bf16 products on CUDA."""

    @staticmethod
    def forward(ctx, xf, resid, noise, *weights):
        ctx.save_for_backward(xf, resid, noise, *weights)
        bf = torch.bfloat16
        return _forward(xf, resid, noise,
                        tuple(w.detach().to(bf).contiguous() for w in weights))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        saved = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = fused_block_tail_plain(
                inputs[0], inputs[1], inputs[2], tuple(inputs[3:]),
                bf16_products=inputs[0].device.type == "cuda",
            )
        grads = iter(torch.autograd.grad(out, wanted, g.to(torch.bfloat16)))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def _forward(xf, resid, noise, weights):
    device = xf.device
    if device.type == "cpu":
        return fused_block_tail_plain(xf, resid, noise, weights)
    if device.type != "cuda":
        raise NotImplementedError(f"fused_block_tail: no kernel for {device}")
    c, nc = xf.shape[-1], noise.shape[-1]
    hidden = weights[6].shape[-1]
    smem = tail_smem_bytes(c, hidden, nc)
    if not tail_shapes_supported(c, hidden, nc):
        raise ValueError(
            f"fused_block_tail: the kernel needs C % 64 == 0, hidden % 64 "
            f"== 0, noise > 0 and at most {MAX_SMEM} bytes of shared "
            f"memory; got C={c}, hidden={hidden}, noise={nc} ({smem} bytes)"
        )
    if xf.dtype != torch.bfloat16 or resid.dtype != torch.bfloat16:
        raise TypeError(
            f"fused_block_tail: xf and resid must be bfloat16, got "
            f"{xf.dtype}/{resid.dtype}"
        )
    if noise.dtype != torch.float32:
        raise TypeError(f"fused_block_tail: noise must be float32, got {noise.dtype}")
    if any(w.dtype != torch.bfloat16 for w in weights):
        raise TypeError("fused_block_tail: the kernel takes bfloat16 weights")
    tensors = (xf, resid, noise, *weights)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_block_tail: the kernel needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("fused_block_tail: the kernel needs 16-byte alignment")
    n = xf.numel() // c if c else 0
    out = torch.empty_like(xf)
    if n == 0:
        return out
    err = _library().fused_block_tail_forward(
        xf.data_ptr(), resid.data_ptr(), noise.data_ptr(),
        *(w.data_ptr() for w in weights), out.data_ptr(),
        n, c, hidden, nc, smem,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"fused_block_tail: kernel launch failed, cudaError {err}"
        )
    fused_block_tail.launches += 1
    return out


fused_block_tail.launches = 0


def _library():
    from ace_tpu_torch.ops import kernel_build

    lib = kernel_build.load(SOURCE)
    fn = lib.fused_block_tail_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return lib
