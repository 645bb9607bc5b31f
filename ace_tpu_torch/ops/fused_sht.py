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
``csrc/fused_sht.cu`` for CUDA tensors and uses ``fused_sht_plain`` (two
einsums each for the real and imaginary parts) only for tensors on the
CPU. Inference only: tensors that require grad are refused.

The kernel runs both contractions on the TF32 tensor cores in split form:
each f32 operand ``v`` is taken as ``hi + lo`` with ``hi = tf32(v)`` and
``lo = tf32(v - hi)``, and each product as ``lo*hi + hi*lo + hi*hi`` in
f32, which keeps about 22 of f32's 24 mantissa bits. The tables are split
once on the host (:func:`kernel_tables`, with :func:`split_tf32`); x and
the DFT intermediate are split by the kernel as it loads them. The DFT
intermediate goes through a scratch tensor the wrapper allocates
(``[B, M, K, 2, C]``, channels padded to a multiple of 32; 133 MB at the
flagship shape).
"""

import ctypes

import torch
import torch.nn.functional as F

SOURCE = "fused_sht.cu"
# the low mantissa bits of an f32 word that TF32 drops
_TF32_DROPPED = 13


def split_tf32(t):
    """Split float32 ``t`` into ``(hi, lo)``, both exact TF32 values (the
    low 13 bits of each word zero), with ``hi`` = ``t`` rounded to 10
    mantissa bits and ``lo`` = ``t - hi`` rounded the same way; ``hi + lo``
    keeps about 22 mantissa bits of ``t``. Rounding is to nearest, ties
    away from zero, as the kernel's ``cvt.rna.tf32.f32``, done on the f32
    bits: add half of the dropped part's weight to the magnitude, then
    clear the dropped bits."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        half = 1 << (_TF32_DROPPED - 1)
        mask = -(1 << _TF32_DROPPED)
        return ((bits + half) & mask).view(torch.float32)

    if t.dtype != torch.float32:
        raise TypeError(f"split_tf32: want float32, got {t.dtype}")
    hi = rna(t)
    return hi, rna(t - hi)


def kernel_tables(dft_r, dft_i, leg):
    """The kernel's split tables ``(d_hi, d_lo, leg_hi, leg_lo)``.

    ``d`` is ``[2M, Jp]``: row ``2m`` is the cos column ``dft_r[:, m]``,
    row ``2m + 1`` the sin column, over the depth ``j`` padded with zeros
    to a multiple of 4 (16-byte rows for TMA). ``leg`` ``[K, L, M]``
    becomes ``[M, L, Kp]``, K-major for each m, padded the same way.
    """
    j, m = dft_r.shape
    d = torch.stack((dft_r, dft_i), dim=2).reshape(j, 2 * m).t()
    d = F.pad(d, (0, -j % 4))
    legt = leg.permute(2, 1, 0)
    legt = F.pad(legt, (0, -leg.shape[0] % 4))
    return split_tf32(d.contiguous()) + split_tf32(legt.contiguous())


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


# the kernel's tiles: 128 rows by 192 columns
ROWS, COLS = 128, 192


def fused_sht(x, dft_r, dft_i, leg, tables=None):
    """Fused forward real SHT ``[B, K, J, C] -> 2 x [B, L, M, C]``.

    Arguments as for :func:`fused_sht_plain`; ``tables`` are the split
    tables of :func:`kernel_tables` for these ``dft_r, dft_i, leg``
    (``RealSHT`` keeps them per device), made here when not given. CUDA
    tensors go through the kernel; ``fused_sht.launches`` counts one per
    call, though the kernel runs as two CUDA launches (the DFT, then the
    Legendre contraction). CPU tensors go through the plain version. Other
    devices raise.
    """
    _check(x, dft_r, dft_i, leg)
    device = x.device
    if device.type == "cpu":
        return fused_sht_plain(x, dft_r, dft_i, leg)
    if device.type != "cuda":
        raise NotImplementedError(f"fused_sht: no kernel for {device}")
    if not x.is_contiguous():
        raise ValueError("fused_sht: the kernel needs contiguous tensors")
    b, k, j, c = x.shape
    m, l_dim = dft_r.shape[1], leg.shape[1]
    if c % 4:
        raise ValueError(
            f"fused_sht: the kernel needs C % 4 == 0 (16-byte TMA strides), "
            f"got C={c}"
        )
    cp = -(-c // 32) * 32  # the intermediate's channels, padded
    items = max(b * k * -(-c // ROWS) * -(-2 * m // COLS),
                b * m * -(-2 * cp // ROWS) * -(-l_dim // COLS))
    if items >= 2 ** 31:
        raise ValueError(f"fused_sht: too many tiles for x {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("fused_sht: the kernel needs 16-byte alignment")
    out_r = torch.empty(b, l_dim, m, c, device=device)
    out_i = torch.empty_like(out_r)
    if out_r.numel() == 0:
        return out_r, out_i
    if k == 0 or j == 0:  # empty sums
        return out_r.zero_(), out_i.zero_()
    if tables is None:
        tables = kernel_tables(dft_r, dft_i, leg)
    d_hi, d_lo, leg_hi, leg_lo = tables
    jp, kp = d_hi.shape[1], leg_hi.shape[2]
    if (d_hi.shape != (2 * m, jp) or leg_hi.shape != (m, l_dim, kp)
            or jp != j + -j % 4 or kp != k + -k % 4
            or d_lo.shape != d_hi.shape or leg_lo.shape != leg_hi.shape):
        raise ValueError("fused_sht: tables do not match dft and leg")
    if not all(t.device == device and t.dtype == torch.float32
               and t.is_contiguous() for t in tables):
        raise ValueError("fused_sht: tables must be contiguous float32 on "
                         f"{device}")
    xm = torch.empty(b, m, k, 2, cp, device=device)
    err = _library().fused_sht_forward(
        x.data_ptr(), d_hi.data_ptr(), d_lo.data_ptr(), leg_hi.data_ptr(),
        leg_lo.data_ptr(), xm.data_ptr(), out_r.data_ptr(), out_i.data_ptr(),
        b, k, j, c, m, l_dim, jp, kp,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"fused_sht: kernel launch failed, cudaError {err} (9: the "
            "compiled kernel holds too few registers for its warpgroups)"
        )
    fused_sht.launches += 1
    return out_r, out_i


fused_sht.launches = 0


def _library():
    from ace_tpu_torch.ops import kernel_build

    lib = kernel_build.load(SOURCE)
    fn = lib.fused_sht_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return lib
