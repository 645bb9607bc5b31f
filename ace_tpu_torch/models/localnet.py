"""LocalNet's helpers (port of ace_tpu/models/localnet.py). Only
``compute_cutoff_radius``, which FourCastNet3's DISCO convolutions use, is
ported so far; the networks (``LocalNet``, ``AnkurLocalNet``) are not."""

import math


def compute_cutoff_radius(nlat: int, kernel_shape, basis_type: str) -> float:
    """The DISCO filter's cutoff radius for a grid of ``nlat`` latitudes
    (port of ace_tpu/models/localnet.py:25)."""
    factor = {
        "piecewise linear": 0.5,
        "morlet": 0.5,
        "isotropic morlet": 0.5,
        "zernike": math.sqrt(2.0),
    }[basis_type]
    return (kernel_shape[0] + 1) * factor * math.pi / float(nlat - 1)
