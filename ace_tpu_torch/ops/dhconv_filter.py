"""The complex dhconv spectral filter: CUDA kernel and plain version
(port of ace_tpu/ops/pallas_filter.py:dhconv_filter).

Per spherical-harmonic degree l the filter is the complex matmul
``out[..., l] = x[..., l] @ w[l]``, written as four real products with
bf16 operands, f32 accumulation and bf16 outputs (the AMP contract of the
JAX package). ``dhconv_filter`` launches the hand-written kernel
``csrc/dhconv_filter.cu`` for CUDA tensors and uses
``dhconv_filter_plain`` only for tensors on the CPU. The kernel is
inference-only for now: tensors that require grad are refused.
"""

import ctypes

import torch

SOURCE = "dhconv_filter.cu"


def dhconv_filter_plain(xr, xi, wr, wi, out_dtype=torch.bfloat16):
    """Plain PyTorch version: round the operands to bf16, take four f32
    einsums, combine, cast to ``out_dtype``.

    Args:
      xr, xi: real/imag spectral activations ``[..., L, M, I]``.
      wr, wi: real/imag weights ``[L, I, O]``.
    """
    def ein(a, b):
        return torch.einsum(
            "...lmi,lio->...lmo",
            a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float(),
        )

    outr = ein(xr, wr) - ein(xi, wi)
    outi = ein(xr, wi) + ein(xi, wr)
    return outr.to(out_dtype), outi.to(out_dtype)


# the kernel's tile: all M rows of one l up to ROWS, and BN output columns
ROWS, BN = 192, 128


def filter_tiles(m: int, o: int) -> int:
    """Tiles of the kernel for one (b, l): ``ceil(M / 192) * ceil(O /
    128)``. A persistent grid of one block per SM walks ``B * L`` times
    as many."""
    return -(-m // ROWS) * -(-o // BN)


def _check(xr, xi, wr, wi):
    for name, t in (("xr", xr), ("xi", xi), ("wr", wr), ("wi", wi)):
        if t.requires_grad:
            raise NotImplementedError(
                f"dhconv_filter: {name} requires grad; the filter has no "
                "backward yet (call it under torch.inference_mode())"
            )
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(
            f"dhconv_filter: x must be float32, got {xr.dtype}/{xi.dtype}"
        )
    if wr.dtype != torch.bfloat16 or wi.dtype != torch.bfloat16:
        raise TypeError(
            f"dhconv_filter: w must be bfloat16, got {wr.dtype}/{wi.dtype}"
        )
    if xr.shape != xi.shape or xr.dim() < 3:
        raise ValueError(
            f"dhconv_filter: x shapes {tuple(xr.shape)}/{tuple(xi.shape)}; "
            "want two equal [..., L, M, I]"
        )
    l, _, i = xr.shape[-3:]
    if wr.shape != wi.shape or wr.dim() != 3 or tuple(wr.shape[:2]) != (l, i):
        raise ValueError(
            f"dhconv_filter: w shape {tuple(wr.shape)}; want [{l}, {i}, O]"
        )
    devices = {t.device for t in (xr, xi, wr, wi)}
    if len(devices) != 1:
        raise ValueError(f"dhconv_filter: tensors on several devices {devices}")


def dhconv_filter(xr, xi, wr, wi, out_dtype=torch.bfloat16):
    """Complex dhconv filter ``[..., L, M, I] x [L, I, O] -> [..., L, M, O]``.

    Args:
      xr, xi: float32 real/imag spectral activations ``[..., L, M, I]``.
      wr, wi: bfloat16 real/imag weights ``[L, I, O]`` (kernel layout).
      out_dtype: output dtype; the CUDA kernel writes bfloat16 only.

    Returns:
      (outr, outi), each ``[..., L, M, O]``. CUDA tensors go through the
      kernel (``dhconv_filter.launches`` counts its launches); CPU tensors
      through :func:`dhconv_filter_plain`. Other devices raise.
    """
    _check(xr, xi, wr, wi)
    device = xr.device
    if device.type == "cpu":
        return dhconv_filter_plain(xr, xi, wr, wi, out_dtype)
    if device.type != "cuda":
        raise NotImplementedError(f"dhconv_filter: no kernel for {device}")
    if out_dtype != torch.bfloat16:
        raise NotImplementedError("dhconv_filter: the kernel writes bf16 only")
    lead = tuple(xr.shape[:-3])
    l, m, i = xr.shape[-3:]
    o = wr.shape[-1]
    batch_l = xr.numel() // (m * i) if xr.numel() else 0
    if i % 32 or o % 8:
        raise ValueError(
            f"dhconv_filter: the kernel needs I % 32 == 0 and O % 8 == 0, "
            f"got I={i}, O={o}"
        )
    if batch_l * filter_tiles(m, o) >= 2 ** 31:
        raise ValueError(f"dhconv_filter: too many tiles for B*L={batch_l}")
    tensors = (xr, xi, wr, wi)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dhconv_filter: the kernel needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("dhconv_filter: the kernel needs 16-byte alignment")
    outr = torch.empty(lead + (l, m, o), dtype=torch.bfloat16, device=device)
    outi = torch.empty_like(outr)
    if batch_l == 0 or m == 0 or o == 0:
        return outr, outi
    err = _library().dhconv_filter_forward(
        xr.data_ptr(), xi.data_ptr(), wr.data_ptr(), wi.data_ptr(),
        outr.data_ptr(), outi.data_ptr(), batch_l, l, m, i, o,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"dhconv_filter: kernel launch failed, cudaError {err} (9: the "
            "compiled kernel holds too few registers for its warpgroups)"
        )
    dhconv_filter.launches += 1
    return outr, outi


dhconv_filter.launches = 0


def _library():
    from ace_tpu_torch.ops import kernel_build

    lib = kernel_build.load(SOURCE)
    fn = lib.dhconv_filter_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return lib

