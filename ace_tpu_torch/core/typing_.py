"""Core typing aliases (port of ace_tpu/core/typing_.py).

A ``TensorDict`` maps variable names (e.g. ``"air_temperature_0"``) to
tensors of shape ``[batch, ...(time)..., lat, lon]``. Packing into one
channel-stacked tensor happens only at the network boundary.
"""

from collections.abc import Mapping

import torch

TensorDict = dict[str, torch.Tensor]
TensorMapping = Mapping[str, torch.Tensor]
