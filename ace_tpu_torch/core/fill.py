"""Smooth flood fill of NaN regions (port of ace_tpu/core/fill.py:109
SmoothFloodFill).

The spectrum aggregator fills masked (e.g. land) regions of a field before
its SHT, so that the mask's edge does not alias into the power spectrum.
Three phases, as in the JAX package: interior NaNs take the field's mean,
the rest are filled by ``num_steps`` neighbour-average expansions, and the
result is blended with its Gaussian blur near the mask.

The masks come from the NaN pattern of a variable's first sample and are
kept per variable name (the pattern must not change between calls). The
JAX package derives them on the host with numpy and skips the fill of a
variable with no NaN; here they are derived on the data's device, so a
fill never waits for the device. "This variable has no NaN" is a device
flag that selects the unfilled field, and a copy of it that reaches the
host without waiting: once every variable of a call is known there to
have no NaN, the call skips the fill, as the JAX package does.
"""

import numpy as np
import torch


def _pad_lon_circular(x: torch.Tensor, p: int = 1) -> torch.Tensor:
    return torch.cat([x[..., -p:], x, x[..., :p]], dim=-1)


def _sum3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box sum with circular longitude and zero latitude padding."""
    x = _pad_lon_circular(x)
    x = torch.nn.functional.pad(x, (0, 0, 1, 1))
    h, w = x.shape[-2] - 2, x.shape[-1] - 2
    return sum(x[..., i:i + h, j:j + w] for i in range(3) for j in range(3))


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    # (-size) // 2 as in the JAX package: symmetric for odd sizes
    coords = np.arange(-size // 2 + 1.0, size // 2 + 1.0)
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _separable_blur(x: torch.Tensor, kernel: list[float]) -> torch.Tensor:
    """Separable Gaussian blur: replicate-padded latitude, circular
    longitude."""
    k = len(kernel)
    h = k // 2
    n_lat, n_lon = x.shape[-2], x.shape[-1]
    xp = torch.cat([x[..., :1, :].expand(*x.shape[:-2], h, n_lon), x,
                    x[..., -1:, :].expand(*x.shape[:-2], h, n_lon)], dim=-2)
    x = sum(kernel[i] * xp[..., i:i + n_lat, :] for i in range(k))
    xp = _pad_lon_circular(x, h)
    return sum(kernel[j] * xp[..., :, j:j + n_lon] for j in range(k))


def _interior_mask(nan_mask: torch.Tensor, num_steps: int) -> torch.Tensor:
    """NaN points that ``num_steps`` 3x3 expansions cannot reach."""
    isnan = nan_mask
    valid = (~isnan).float()
    for _ in range(num_steps):
        can_update = isnan & (_sum3x3(valid) > 0)
        valid = torch.where(can_update, 1.0, valid)
        isnan = isnan & ~can_update
    return isnan


def _flood_fill(x, interior, valid0, blurred_valid, kernel, num_steps):
    """The fill of ``x`` ``[..., H, W]`` from its masks (each
    broadcastable to ``x``)."""
    isnan0 = ~valid0
    x = torch.nan_to_num(x, nan=0.0)
    valid0f = valid0.to(x.dtype)
    mean_vals = (x * valid0f).sum(dim=(-2, -1), keepdim=True) / torch.clamp(
        valid0f.sum(dim=(-2, -1), keepdim=True), min=1.0)
    x = torch.where(interior, mean_vals, x)
    valid = torch.where(interior, 1.0, valid0f).expand_as(x)
    isnan = (isnan0 & ~interior).expand_as(x)
    for _ in range(num_steps):
        neighbor_count = _sum3x3(valid)
        neighbor_sum = _sum3x3(x)
        can_update = isnan & (neighbor_count > 0)
        local_avg = torch.where(
            neighbor_count > 0,
            neighbor_sum / torch.clamp(neighbor_count, min=1e-30), 0.0)
        x = torch.where(can_update, local_avg, x)
        valid = torch.where(can_update, 1.0, valid)
        isnan = isnan & ~can_update
    blurred = _separable_blur(x, kernel)
    return x * blurred_valid + blurred * (1.0 - blurred_valid)


class SmoothFloodFill:
    """Fill NaN regions with smooth transitions at their edges (port of
    ace_tpu/core/fill.py:109)."""

    def __init__(self, num_steps: int = 4, blur_kernel_size: int = 5,
                 blur_sigma: float = 1.0):
        self._num_steps = num_steps
        self._kernel = [float(v) for v in
                        _gaussian_kernel(blur_kernel_size, blur_sigma)]
        self._masks: dict[str, tuple[torch.Tensor, ...]] = {}
        # the has-NaN flags that have reached the host, and the copies of
        # others still on their way (names, host flags, event or None)
        self._host_has_nan: dict[str, bool] = {}
        self._flags_in_flight: list[tuple[list[str], torch.Tensor, object]] = []

    def masks(self, arr: torch.Tensor, name: str) -> tuple[torch.Tensor, ...]:
        """(interior, valid, blurred_valid, has_nan) for ``name``, derived
        from the NaN pattern of ``arr``'s first sample ``[H, W]`` on its
        device the first time the name is seen."""
        if name not in self._masks:
            nan_mask = torch.isnan(arr[(0,) * (arr.dim() - 2)].float())
            valid = ~nan_mask
            self._masks[name] = (
                _interior_mask(nan_mask, self._num_steps),
                valid,
                _separable_blur(valid.float(), self._kernel),
                nan_mask.any(),
            )
        return self._masks[name]

    def _send_flags(self, names: list[str]):
        """Start the copy of ``names``' has-NaN flags to the host."""
        flags = torch.stack([self._masks[n][3] for n in names])
        event = None
        if flags.device.type == "cuda":
            host = torch.empty(flags.shape, dtype=flags.dtype,
                               pin_memory=True)
            host.copy_(flags, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            flags = host
        self._flags_in_flight.append((names, flags, event))

    def _nan_free(self, names: list[str]) -> bool:
        """Whether the host knows that none of ``names`` has a NaN; reads
        the flags whose copies have ended, without waiting for the rest."""
        waiting = []
        for sent, flags, event in self._flags_in_flight:
            if event is None or event.query():
                self._host_has_nan.update(zip(sent, flags.tolist()))
            else:
                waiting.append((sent, flags, event))
        self._flags_in_flight = waiting
        return all(self._host_has_nan.get(n) is False for n in names)

    def __call__(self, arr: torch.Tensor, name: str) -> torch.Tensor:
        """Fill the NaNs of ``arr`` ``[..., H, W]`` (variable ``name``)."""
        return self.fill_stacked(arr[None], [name])[0]

    def fill_stacked(self, x: torch.Tensor, names: list[str]
                     ) -> torch.Tensor:
        """Fill ``x`` ``[V, ..., H, W]``, whose leading axis holds the
        variables ``names``, in one pass over all of them."""
        new = [n for n in names if n not in self._masks]
        masks = [self.masks(x[i], n) for i, n in enumerate(names)]
        if new:
            self._send_flags(new)
        if self._nan_free(names):
            return x.float()
        lead = (len(names),) + (1,) * (x.dim() - 3)
        interior, valid, blurred_valid = (
            torch.stack([m[j] for m in masks]).reshape(*lead, *x.shape[-2:])
            for j in range(3)
        )
        has_nan = torch.stack([m[3] for m in masks]).reshape(
            *lead, 1, 1)
        x = x.float()
        filled = _flood_fill(x, interior, valid, blurred_valid,
                             self._kernel, self._num_steps)
        return torch.where(has_nan, filled, x)
