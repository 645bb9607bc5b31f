"""Secondary decoder: extra diagnostics decoded from the main module's
outputs (port of ace_tpu/core/step/secondary_decoder.py).

The decoder reads a detached copy of the main module's packed
(normalized) output channels, so its loss trains the decoder only and
never the main module (``jax.lax.stop_gradient`` in the JAX package).
"""

import dataclasses

import torch

from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.packer import Packer
from ace_tpu_torch.core.typing_ import TensorDict
from ace_tpu_torch.models.registry import ModuleSelector


@dataclasses.dataclass
class SecondaryDecoderConfig:
    """secondary_diagnostic_names: the variables decoded, column by column,
    from the main module's outputs; network: the decoder's builder."""

    secondary_diagnostic_names: list[str]
    network: ModuleSelector

    def build(self, n_in_channels: int, dataset_info: DatasetInfo,
              device=None) -> "SecondaryDecoder":
        return SecondaryDecoder(n_in_channels, self.secondary_diagnostic_names,
                                self.network, dataset_info, device=device)


class SecondaryDecoder:
    """Decode -> unpack to named diagnostics. ``module`` is the decoder's
    network (its weights sit under ``secondary_decoder`` in the step's
    module)."""

    def __init__(self, in_dim: int, out_names: list[str],
                 network: ModuleSelector, dataset_info: DatasetInfo,
                 device=None):
        self.module = network.build(
            n_in_channels=in_dim,
            n_out_channels=len(out_names),
            dataset_info=dataset_info,
            device=device,
        )
        self._packer = Packer(out_names)

    def __call__(self, main_output_packed: torch.Tensor, *, deterministic,
                 generator) -> TensorDict:
        decoded = self.module(main_output_packed.detach(),
                              generator=generator,
                              deterministic=deterministic)
        return self._packer.unpack(decoded)
