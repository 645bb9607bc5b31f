"""``jax.image.resize``'s bilinear and bicubic resizing, as separable
weight matrices built the way JAX builds them (``compute_weight_mat``):
half-pixel centres, Keys' cubic with a = -0.5, each output's weights
normalized over the input samples in range. ``F.interpolate``'s bicubic
uses a = -0.75 and clamps indices at the edges, so it differs there.
"""

import functools

import numpy as np
import torch


def _triangle(x):
    return np.maximum(0, 1 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


@functools.lru_cache(maxsize=64)
def weight_matrix(n_in: int, n_out: int, method: str) -> np.ndarray:
    """``[n_in, n_out]`` float32 weights of one axis's resize."""
    f32 = np.float32
    scale = f32(n_out) / f32(n_in)
    inv_scale = f32(1.0) / scale
    # antialiasing widens the kernel only when downsampling
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
         / kernel_scale).astype(f32)
    weights = KERNELS[method](x).astype(f32)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


_CACHE: dict = {}


def _weights(n_in, n_out, method, device):
    key = (n_in, n_out, method, str(device))
    if key not in _CACHE:
        # made outside inference mode: autograd may save it later
        with torch.inference_mode(False):
            _CACHE[key] = torch.as_tensor(
                weight_matrix(n_in, n_out, method)).to(device,
                                                       non_blocking=True)
    return _CACHE[key]


def resize(x: torch.Tensor, out_hw: tuple[int, int], method: str,
           channels_last: bool = False) -> torch.Tensor:
    """Resize the two spatial axes of ``x`` (``[..., H, W]``, or ``[...,
    H, W, C]`` with ``channels_last``) to ``out_hw``, in float32."""
    if channels_last:
        return resize(x.movedim(-1, -3), out_hw, method).movedim(-3, -1)
    h, w = x.shape[-2:]
    wh = _weights(h, out_hw[0], method, x.device)
    ww = _weights(w, out_hw[1], method, x.device)
    return torch.matmul(wh.t(), torch.matmul(x.float(), ww))
