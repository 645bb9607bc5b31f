"""The fused forward real SHT: CUDA kernel and plain version (port of
ace_tpu/ops/pallas_sht.py:fused_sht).

The forward transform of channels-last data ``x [B, K, J, C]`` (K
latitudes, J longitudes) is a longitudinal DFT against the cos/sin
matrices ``[J, M]`` followed by a Legendre contraction over latitude
against the quadrature-weighted table, which the kernel takes as
``leg [K, L, M]``::

    xm[b, k, m, c]  = sum_j x[b, k, j, c] * dft[j, m]       (real and imag)
    out[b, l, m, c] = sum_k leg[k, l, m] * xm[b, k, m, c]

all in float32. ``fused_sht`` launches the hand-written kernel
``csrc/fused_sht.cu``, which keeps the DFT intermediate on chip, for CUDA
tensors and uses ``fused_sht_plain`` (two einsums each for the real and
imaginary parts) only for tensors on the CPU. Inference only: tensors that
require grad are refused.
"""

import ctypes

import torch

SOURCE = "fused_sht.cu"
# the shared memory a block may use on Hopper
MAX_SMEM = 232448


def fused_sht_plain(x, dft_r, dft_i, leg):
    """Plain PyTorch version: the DFT einsums, then the Legendre einsums,
    in float32.

    Args:
      x: ``[B, K, J, C]`` float32.
      dft_r, dft_i: ``[J, M]`` float32 cos/sin matrices (scale folded in).
      leg: ``[K, L, M]`` float32 weighted Legendre table.

    Returns:
      (real, imag), each ``[B, L, M, C]`` float32.
    """
    xr = torch.einsum("bkjc,jm->bkmc", x, dft_r)
    xi = torch.einsum("bkjc,jm->bkmc", x, dft_i)
    return (torch.einsum("bkmc,klm->blmc", xr, leg),
            torch.einsum("bkmc,klm->blmc", xi, leg))


def _check(x, dft_r, dft_i, leg):
    named = (("x", x), ("dft_r", dft_r), ("dft_i", dft_i), ("leg", leg))
    for name, t in named:
        if t.requires_grad:
            raise NotImplementedError(
                f"fused_sht: {name} requires grad; the fused transform has "
                "no backward (call it under torch.inference_mode())"
            )
        if t.dtype != torch.float32:
            raise TypeError(f"fused_sht: {name} must be float32, got {t.dtype}")
    if x.dim() != 4:
        raise ValueError(f"fused_sht: x shape {tuple(x.shape)}; want [B, K, J, C]")
    _, k, j, _ = x.shape
    if dft_r.dim() != 2 or dft_r.shape != dft_i.shape or dft_r.shape[0] != j:
        raise ValueError(
            f"fused_sht: dft shapes {tuple(dft_r.shape)}/{tuple(dft_i.shape)}; "
            f"want two equal [{j}, M]"
        )
    m = dft_r.shape[1]
    if leg.dim() != 3 or leg.shape[0] != k or leg.shape[2] != m:
        raise ValueError(
            f"fused_sht: leg shape {tuple(leg.shape)}; want [{k}, L, {m}]"
        )
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError(f"fused_sht: tensors on several devices {devices}")


def fused_sht(x, dft_r, dft_i, leg):
    """Fused forward real SHT ``[B, K, J, C] -> 2 x [B, L, M, C]``.

    Arguments as for :func:`fused_sht_plain`. CUDA tensors go through the
    kernel (``fused_sht.launches`` counts its launches); CPU tensors
    through the plain version. Other devices raise.
    """
    _check(x, dft_r, dft_i, leg)
    device = x.device
    if device.type == "cpu":
        return fused_sht_plain(x, dft_r, dft_i, leg)
    if device.type != "cuda":
        raise NotImplementedError(f"fused_sht: no kernel for {device}")
    tensors = (x, dft_r, dft_i, leg)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_sht: the kernel needs contiguous tensors")
    b, k, j, c = x.shape
    m, l_dim = dft_r.shape[1], leg.shape[1]
    if -(-c // 8) > 65535 or b * -(-l_dim // 192) > 65535:
        raise ValueError(f"fused_sht: grid too large for B={b}, C={c}, L={l_dim}")
    lib = _library()
    smem = lib.fused_sht_smem_bytes(j)
    if smem > MAX_SMEM:
        raise ValueError(
            f"fused_sht: J={j} needs {smem} bytes of shared memory, more "
            f"than {MAX_SMEM}"
        )
    out_r = torch.empty(b, l_dim, m, c, device=device)
    out_i = torch.empty_like(out_r)
    if out_r.numel() == 0:
        return out_r, out_i
    if k == 0 or j == 0:  # empty sums
        return out_r.zero_(), out_i.zero_()
    err = lib.fused_sht_forward(
        x.data_ptr(), dft_r.data_ptr(), dft_i.data_ptr(), leg.data_ptr(),
        out_r.data_ptr(), out_i.data_ptr(), b, k, j, c, m, l_dim,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_sht: kernel launch failed, cudaError {err}")
    fused_sht.launches += 1
    return out_r, out_i


fused_sht.launches = 0


def _library():
    from ace_tpu_torch.ops import kernel_build

    lib = kernel_build.load(SOURCE)
    fn = lib.fused_sht_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        lib.fused_sht_smem_bytes.argtypes = [ctypes.c_int]
        lib.fused_sht_smem_bytes.restype = ctypes.c_int
    return lib
