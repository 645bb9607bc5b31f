"""Device selection for the port.

The port runs on the CUDA device by default. There is no silent CPU
fallback: without CUDA, :func:`get_device` raises unless the caller asks
for the CPU explicitly (the CPU tests do).
"""

import numpy as np
import torch


def get_device(device: str | torch.device | None = None) -> torch.device:
    """The device entry points run on.

    Args:
        device: ``None`` for the default CUDA device, or an explicit
            device such as ``"cpu"`` or ``"cuda:1"``.

    Raises:
        RuntimeError: a CUDA device is wanted (the default) but CUDA is
            not available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def cached_on_device(cache: dict, name: str, array: np.ndarray,
                     device: torch.device) -> torch.Tensor:
    """``array`` as a tensor on ``device``, made once per device and kept
    in ``cache`` (host-side constants that device math reads each step)."""
    key = (name, str(device))
    if key not in cache:
        cache[key] = torch.as_tensor(array, device=device)
    return cache[key]
