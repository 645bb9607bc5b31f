"""The complex dhconv spectral filter and its backward: CUDA kernels and
plain versions (port of ace_tpu/ops/pallas_filter.py:dhconv_filter and its
custom VJP).

Per spherical-harmonic degree l the filter is the complex matmul
``out[..., l] = x[..., l] @ w[l]``, written as four real products with
bf16 operands, f32 accumulation and bf16 outputs (the AMP contract of the
JAX package). Its backward (JAX's ``_bwd``, pallas_filter.py:129-141) is
the same contract with f32 results:

    dx_r = g_r w_r^T + g_i w_i^T       dx_i = g_i w_r^T - g_r w_i^T
    dw_r = x_r^T g_r + x_i^T g_i       dw_i = x_r^T g_i - x_i^T g_r

Three kernels: K1 ``csrc/dhconv_filter.cu`` (the forward), 1b
``csrc/dhconv_filter_bwd.cu`` (``dhconv_filter_dx``) and 1c
``csrc/dhconv_filter_dw.cu`` (``dhconv_filter_dw``).
Each wrapper launches its kernel for CUDA tensors and uses its plain
version only for tensors on the CPU. Tensors that require grad go through
an autograd Function whose backward calls 1b and 1c.
"""

import ctypes

import torch
from torch.autograd.function import once_differentiable

SOURCE = "dhconv_filter.cu"
BWD_SOURCE = "dhconv_filter_bwd.cu"
DW_SOURCE = "dhconv_filter_dw.cu"
_BF16 = torch.bfloat16


def _ein(eq, a, b):
    """bf16-rounded operands, f32 products and sums (``_ein`` of
    pallas_filter.py:102)."""
    return torch.einsum(eq, a.to(_BF16).float(), b.to(_BF16).float())


def dhconv_filter_plain(xr, xi, wr, wi, out_dtype=_BF16):
    """Plain PyTorch version: round the operands to bf16, take four f32
    einsums, combine, cast to ``out_dtype``.

    Args:
      xr, xi: real/imag spectral activations ``[..., L, M, I]``.
      wr, wi: real/imag weights ``[L, I, O]``.
    """
    eq = "...lmi,lio->...lmo"
    outr = _ein(eq, xr, wr) - _ein(eq, xi, wi)
    outi = _ein(eq, xr, wi) + _ein(eq, xi, wr)
    return outr.to(out_dtype), outi.to(out_dtype)


def dhconv_filter_dx_plain(gr, gi, wr, wi):
    """Plain version of 1b: ``(dx_r, dx_i)`` f32 ``[..., L, M, I]`` from
    the cotangents ``[..., L, M, O]`` and the weights ``[L, I, O]``."""
    eq = "...lmo,lio->...lmi"
    return (_ein(eq, gr, wr) + _ein(eq, gi, wi),
            _ein(eq, gi, wr) - _ein(eq, gr, wi))


def dhconv_filter_dw_plain(xr, xi, gr, gi):
    """Plain version of 1c: ``(dw_r, dw_i)`` f32 ``[L, I, O]``, summed over
    the leading axes of x ``[..., L, M, I]`` and g ``[..., L, M, O]``."""
    eq = "...lmi,...lmo->lio"
    return (_ein(eq, xr, gr) + _ein(eq, xi, gi),
            _ein(eq, xr, gi) - _ein(eq, xi, gr))


def dhconv_filter_bwd_plain(xr, xi, wr, wi, gr, gi):
    """JAX's ``_bwd`` (pallas_filter.py:129-141) as f32 einsums on
    bf16-rounded operands: ``(dx_r, dx_i, dw_r, dw_i)``, all f32."""
    return (*dhconv_filter_dx_plain(gr, gi, wr, wi),
            *dhconv_filter_dw_plain(xr, xi, gr, gi))


# the forward kernel's tile: all M rows of one l up to ROWS, and BN output
# columns
ROWS, BN = 192, 128


def filter_tiles(m: int, o: int) -> int:
    """Tiles of the kernel for one (b, l): ``ceil(M / 192) * ceil(O /
    128)``. A persistent grid of one block per SM walks ``B * L`` times
    as many."""
    return -(-m // ROWS) * -(-o // BN)


def _check(xr, xi, wr, wi):
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(
            f"dhconv_filter: x must be float32, got {xr.dtype}/{xi.dtype}"
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


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def dhconv_filter(xr, xi, wr, wi, out_dtype=_BF16):
    """Complex dhconv filter ``[..., L, M, I] x [L, I, O] -> [..., L, M, O]``.

    Args:
      xr, xi: float32 real/imag spectral activations ``[..., L, M, I]``.
      wr, wi: real/imag weights ``[L, I, O]`` (kernel layout): bfloat16,
        or, when they require grad, any float dtype (rounded to bf16
        inside; their gradients come back in their dtype).
      out_dtype: output dtype; the CUDA kernel writes bfloat16 only, and
        the backward exists for bfloat16 outputs only.

    Returns:
      (outr, outi), each ``[..., L, M, O]``. CUDA tensors go through the
      kernel (``dhconv_filter.launches`` counts its launches); CPU tensors
      through :func:`dhconv_filter_plain`. Other devices raise. With
      tensors that require grad (and grad mode on) the call is
      differentiable, through 1b and 1c on CUDA.
    """
    _check(xr, xi, wr, wi)
    if _needs_grad(xr, xi, wr, wi):
        if out_dtype != _BF16:
            raise NotImplementedError(
                "dhconv_filter: the backward exists for bfloat16 outputs only"
            )
        return _DhconvFilter.apply(xr, xi, torch.stack((wr, wi)))
    if wr.dtype != _BF16 or wi.dtype != _BF16:
        raise TypeError(
            f"dhconv_filter: w must be bfloat16, got {wr.dtype}/{wi.dtype}"
        )
    return _forward(xr, xi, wr, wi, out_dtype)


def dhconv_filter_param(xr, xi, weight):
    """The filter on the spectral weight in its parameter layout ``[2, L,
    I, O]`` float32 (``SpectralConvS2.weight``: re and im stacked):
    differentiable with respect to x and ``weight``, whose gradient 1c
    writes in that layout. The bf16 kernel weights are made inside, so the
    gradient reaches the float32 parameter, as JAX's ``_bwd`` casts ``dw``
    to the dtype of the weights it was handed."""
    if weight.dim() != 4 or weight.shape[0] != 2:
        raise ValueError(f"dhconv_filter: weight shape {tuple(weight.shape)}; "
                         "want [2, L, I, O]")
    _check(xr, xi, weight[0], weight[1])
    return _DhconvFilter.apply(xr, xi, weight)


class _DhconvFilter(torch.autograd.Function):
    """K1 forward; backward through 1b (dx) and 1c (dW, in the weight's
    ``[2, L, I, O]`` layout) on CUDA, their plain versions on the CPU."""

    @staticmethod
    def forward(ctx, xr, xi, weight):
        wr, wi = weight.detach().to(_BF16).contiguous()
        xr, xi = xr.detach().contiguous(), xi.detach().contiguous()
        ctx.save_for_backward(xr, xi, wr, wi)
        ctx.weight_dtype = weight.dtype
        return _forward(xr, xi, wr, wi, _BF16)

    @staticmethod
    @once_differentiable
    def backward(ctx, gr, gi):
        xr, xi, wr, wi = ctx.saved_tensors
        zero = None
        if gr is None or gi is None:
            zero = torch.zeros(xr.shape[:-1] + wr.shape[-1:], dtype=_BF16,
                               device=xr.device)
        gr = (zero if gr is None else gr).to(_BF16).contiguous()
        gi = (zero if gi is None else gi).to(_BF16).contiguous()
        dxr = dxi = dw = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            dxr, dxi = dhconv_filter_dx(gr, gi, wr, wi)
        if ctx.needs_input_grad[2]:
            dw = dhconv_filter_dw(xr, xi, gr, gi).to(ctx.weight_dtype)
        return dxr, dxi, dw


def _forward(xr, xi, wr, wi, out_dtype):
    device = xr.device
    if device.type == "cpu":
        return dhconv_filter_plain(xr, xi, wr, wi, out_dtype)
    if device.type != "cuda":
        raise NotImplementedError(f"dhconv_filter: no kernel for {device}")
    if out_dtype != _BF16:
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
    _check_kernel_operands("dhconv_filter", tensors)
    outr = torch.empty(lead + (l, m, o), dtype=_BF16, device=device)
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


def _check_kernel_operands(name, tensors):
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the kernel needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the kernel needs 16-byte alignment")


def _bwd_shapes(name, g, i):
    """(B, L, M, I, O) of a backward call, with the kernels' checks."""
    if g.dtype != _BF16:
        raise TypeError(f"{name}: g must be bfloat16, got {g.dtype}")
    l, m, o = g.shape[-3:]
    batch = g.numel() // (l * m * o) if g.numel() else 0
    if i % 8 or o % 8:
        raise ValueError(f"{name}: the kernel needs I % 8 == 0 and O % 8 == 0, "
                         f"got I={i}, O={o}")
    return batch, l, m, i, o


def dhconv_filter_dx(gr, gi, wr, wi):
    """Kernel 1b: ``(dx_r, dx_i)`` float32 ``[..., L, M, I]`` from bf16
    cotangents ``[..., L, M, O]`` and bf16 weights ``[L, I, O]`` (as they
    lie, the kernel's K-major B operand: no transposed copy is made). CUDA
    tensors go through the kernel (``dhconv_filter_dx.launches``), CPU
    tensors through :func:`dhconv_filter_dx_plain`."""
    if gr.shape != gi.shape or wr.shape != wi.shape or (
            tuple(wr.shape[::2]) != (gr.shape[-3], gr.shape[-1])):
        raise ValueError(f"dhconv_filter_dx: g {tuple(gr.shape)}, w "
                         f"{tuple(wr.shape)}; want [..., L, M, O], [L, I, O]")
    device = gr.device
    if device.type == "cpu":
        return dhconv_filter_dx_plain(gr, gi, wr, wi)
    if device.type != "cuda":
        raise NotImplementedError(f"dhconv_filter_dx: no kernel for {device}")
    if wr.dtype != _BF16 or wi.dtype != _BF16:
        raise TypeError("dhconv_filter_dx: w must be bfloat16")
    batch, l, m, i, o = _bwd_shapes("dhconv_filter_dx", gr, wr.shape[1])
    # 1b's tile is K1's, over the columns (I) of dx
    if batch * l * filter_tiles(m, i) >= 2 ** 31:
        raise ValueError(f"dhconv_filter_dx: too many tiles for B*L={batch * l}")
    _check_kernel_operands("dhconv_filter_dx", (gr, gi, wr, wi))
    dxr = torch.empty(gr.shape[:-1] + (i,), dtype=torch.float32, device=device)
    dxi = torch.empty_like(dxr)
    if dxr.numel() == 0:
        return dxr, dxi
    if o == 0:
        return dxr.zero_(), dxi.zero_()
    err = _bwd_library().dhconv_filter_dx(
        gr.data_ptr(), gi.data_ptr(), wr.data_ptr(), wi.data_ptr(),
        dxr.data_ptr(), dxi.data_ptr(), batch, l, m, i, o,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"dhconv_filter_dx: kernel launch failed, "
                           f"cudaError {err}")
    dhconv_filter_dx.launches += 1
    return dxr, dxi


dhconv_filter_dx.launches = 0


def dhconv_filter_dw(xr, xi, gr, gi):
    """Kernel 1c: the weight gradient float32 ``[2, L, I, O]`` (``dw_r``
    and ``dw_i`` stacked: the spectral weight's layout) from float32 x
    ``[..., L, M, I]`` and bf16 cotangents ``[..., L, M, O]``, summed over
    the leading axes. CUDA tensors go through the kernel
    (``dhconv_filter_dw.launches``), CPU tensors through
    :func:`dhconv_filter_dw_plain`."""
    if xr.shape != xi.shape or gr.shape != gi.shape or (
            xr.shape[:-1] != gr.shape[:-1]) or xr.dim() < 3:
        raise ValueError(f"dhconv_filter_dw: x {tuple(xr.shape)}, g "
                         f"{tuple(gr.shape)}; want [..., L, M, I], "
                         "[..., L, M, O]")
    device = xr.device
    if device.type == "cpu":
        return torch.stack(dhconv_filter_dw_plain(xr, xi, gr, gi))
    if device.type != "cuda":
        raise NotImplementedError(f"dhconv_filter_dw: no kernel for {device}")
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError("dhconv_filter_dw: x must be float32")
    batch, l, m, i, o = _bwd_shapes("dhconv_filter_dw", gr, xr.shape[-1])
    _check_kernel_operands("dhconv_filter_dw", (xr, xi, gr, gi))
    dw = torch.empty(2, l, i, o, dtype=torch.float32, device=device)
    if batch == 0 or m == 0:
        dw.zero_()
    elif dw.numel():
        err = _dw_library().dhconv_filter_dw(
            xr.data_ptr(), xi.data_ptr(), gr.data_ptr(), gi.data_ptr(),
            dw.data_ptr(), batch, l, m, i, o,
            torch.cuda.current_stream(device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"dhconv_filter_dw: kernel launch failed, "
                               f"cudaError {err}")
        dhconv_filter_dw.launches += 1
    return dw


dhconv_filter_dw.launches = 0


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


def _bwd_library():
    from ace_tpu_torch.ops import kernel_build

    lib = kernel_build.load(BWD_SOURCE)
    if lib.dhconv_filter_dx.argtypes is None:
        lib.dhconv_filter_dx.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.dhconv_filter_dx.restype = ctypes.c_int
    return lib


def _dw_library():
    from ace_tpu_torch.ops import kernel_build

    lib = kernel_build.load(DW_SOURCE)
    if lib.dhconv_filter_dw.argtypes is None:
        lib.dhconv_filter_dw.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.dhconv_filter_dw.restype = ctypes.c_int
    return lib
