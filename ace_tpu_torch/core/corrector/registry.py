"""Corrector selection by ``{type, config}`` (port of
ace_tpu/core/corrector/registry.py): the ``atmosphere_corrector``,
``ocean_corrector`` and ``ice_corrector`` registrations."""

import dataclasses
from typing import ClassVar

from ace_tpu_torch.core.corrector.atmosphere import AtmosphereCorrectorConfig
from ace_tpu_torch.core.corrector.ice import IceCorrectorConfig
from ace_tpu_torch.core.corrector.ocean import OceanCorrectorConfig
from ace_tpu_torch.core.registry import Registry, Selector


@dataclasses.dataclass
class CorrectorSelector(Selector):
    _registry: ClassVar[Registry] = Registry()

    @classmethod
    def get_registry(cls) -> Registry:
        return cls._registry

    @classmethod
    def register(cls, name: str):
        return cls._registry.register(name)

    @property
    def is_noop(self) -> bool:
        return self.instance.is_noop

    @property
    def corrector_disabled_epochs(self) -> int:
        return self.instance.corrector_disabled_epochs

    def build_from_dataset_info(self, dataset_info):
        """Build with what each family needs: the atmosphere corrector the
        hybrid sigma-pressure coordinate, the ocean corrector the depth
        coordinate, the ice corrector neither."""
        instance = self.instance
        if isinstance(instance, OceanCorrectorConfig):
            vertical = dataset_info.vertical_coordinate
        elif isinstance(instance, IceCorrectorConfig):
            vertical = None
        else:
            vertical = dataset_info.atmosphere_vertical_coordinate
        return instance.build(dataset_info.gridded_operations, vertical,
                              dataset_info.timestep)


CorrectorSelector.register("atmosphere_corrector")(AtmosphereCorrectorConfig)
CorrectorSelector.register("ice_corrector")(IceCorrectorConfig)
CorrectorSelector.register("ocean_corrector")(OceanCorrectorConfig)
