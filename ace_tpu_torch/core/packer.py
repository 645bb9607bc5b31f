"""Pack/unpack named variables to/from a channels-last tensor
(port of ace_tpu/core/packer.py)."""

import torch

from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping


class DataShapesNotUniform(ValueError):
    """A set of tensors do not all have the same shape."""


class Packer:
    """Stacks named tensors along a new trailing channel axis in a fixed
    order."""

    def __init__(self, names: list[str]):
        self.names = list(names)

    def pack(self, tensors: TensorMapping) -> torch.Tensor:
        shape = tensors[self.names[0]].shape
        for name in self.names:
            if tensors[name].shape != shape:
                raise DataShapesNotUniform(
                    f"Cannot pack tensors of different shapes. "
                    f"Expected {shape} got {tensors[name].shape} for {name!r}"
                )
        return torch.stack([tensors[n] for n in self.names], dim=-1)

    def unpack(self, tensor: torch.Tensor) -> TensorDict:
        return dict(zip(self.names, tensor.unbind(-1)))
