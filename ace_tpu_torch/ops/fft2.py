"""2D real Fourier transforms with mode truncation and padding, the
``spectral_transform: fft`` alternative to the SHT pair (port of
ace_tpu/ops/fft2.py).

Channels-last like ``ops/sht.py``: ``[..., H, W, C]`` to complex
``[..., lmax, mmax, C]`` and back. The latitude axis is a full FFT of
which the first ``lmax`` rows are kept, the longitude axis a real FFT of
which the first ``mmax`` modes are kept; both use the "ortho" norm. The
pair has no ``forward_pair``/``inverse_pair``, so the spectral
convolution takes its complex route.
"""

import torch
import torch.nn.functional as F


class RealFFT2:
    def __init__(self, nlat: int, nlon: int, lmax: int | None = None,
                 mmax: int | None = None):
        self.nlat, self.nlon = nlat, nlon
        self.lmax = lmax or nlat
        self.mmax = mmax or (nlon // 2 + 1)
        self.grid = "fft"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        xm = torch.fft.rfft(x, dim=-2, norm="ortho")
        xl = torch.fft.fft(xm, dim=-3, norm="ortho")
        out = xl[..., : self.lmax, : self.mmax, :]
        # zero-pad to (lmax, mmax) where the grid has fewer modes
        return F.pad(out, (0, 0, 0, max(0, self.mmax - out.shape[-2]),
                           0, max(0, self.lmax - out.shape[-3])))


class InverseRealFFT2:
    def __init__(self, nlat: int, nlon: int, lmax: int | None = None,
                 mmax: int | None = None):
        self.nlat, self.nlon = nlat, nlon
        self.lmax = lmax or nlat
        self.mmax = mmax or (nlon // 2 + 1)
        self.grid = "fft"

    def __call__(self, coeffs: torch.Tensor) -> torch.Tensor:
        # pad the modes back to the full grid
        x = F.pad(coeffs, (
            0, 0, 0, max(0, self.nlon // 2 + 1 - coeffs.shape[-2]),
            0, max(0, self.nlat - coeffs.shape[-3])))
        x = torch.fft.ifft(x, dim=-3, norm="ortho")
        # Hermitian symmetry on the real FFT's m = 0 and Nyquist columns:
        # their imaginary parts are dropped (ace_tpu/ops/fft2.py:62-70)
        keep_imag = torch.ones(x.shape[-2], 1, device=x.device)
        keep_imag[0] = 0.0
        if self.nlon % 2 == 0 and x.shape[-2] > self.nlon // 2:
            keep_imag[self.nlon // 2] = 0.0
        x = torch.complex(x.real, x.imag * keep_imag)
        return torch.fft.irfft(x, n=self.nlon, dim=-2, norm="ortho").float()
