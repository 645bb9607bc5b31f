"""Core typing aliases (port of ace_tpu/core/typing_.py).

A ``TensorDict`` maps variable names (e.g. ``"air_temperature_0"``) to
tensors of shape ``[batch, ...(time)..., lat, lon]``. Packing into one
channel-stacked tensor happens only at the network boundary.
"""

import dataclasses
from collections.abc import Mapping

import torch

TensorDict = dict[str, torch.Tensor]
TensorMapping = Mapping[str, torch.Tensor]


@dataclasses.dataclass
class Slice:
    """A python slice from start, stop and step (port of
    ace_tpu/core/typing_.py:22)."""

    start: int | None = None
    stop: int | None = None
    step: int | None = None

    @property
    def slice(self) -> slice:
        return slice(self.start, self.stop, self.step)

    def contains(self, value: int) -> bool:
        start = self.start if self.start is not None else 0
        step = self.step if self.step is not None else 1
        if value < start:
            return False
        if self.stop is not None and value >= self.stop:
            return False
        return (value - start) % step == 0
