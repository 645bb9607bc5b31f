"""Dataset metadata bundle (port of ace_tpu/core/dataset_info.py).

Carries the grid, the vertical coordinate (hybrid sigma-pressure or
depth), the timestep and the dataset's static masks; serialized into
checkpoints in the JAX package's layout (``get_state``/``from_state``
round-trip with ``ace_tpu``'s). The grid is lat-lon or HEALPix.
"""

import dataclasses
from datetime import timedelta

import numpy as np

from ace_tpu_torch.core.coordinates import (
    DepthCoordinate,
    HEALPixCoordinates,
    HybridSigmaPressureCoordinate,
    LatLonCoordinates,
    deserialize_vertical_coordinate,
    serialize_vertical_coordinate,
)
from ace_tpu_torch.core.gridded_ops import (
    GriddedOperations,
    LatLonOperations,
)
from ace_tpu_torch.core.masking import MaskProvider


@dataclasses.dataclass(frozen=True)
class VariableMetadata:
    units: str
    long_name: str


class IncompatibleDatasetInfo(ValueError):
    """Raised when two DatasetInfos cannot be used together."""


@dataclasses.dataclass
class DatasetInfo:
    horizontal_coordinates: (
        LatLonCoordinates | HEALPixCoordinates | None) = None
    vertical_coordinate: (
        HybridSigmaPressureCoordinate | DepthCoordinate | None) = None
    timestep: timedelta | None = None
    variable_metadata: dict[str, VariableMetadata] = dataclasses.field(
        default_factory=dict
    )
    # the dataset's static "mask_*" fields; None: no masks
    mask_provider: MaskProvider | None = None
    all_labels: tuple = ()

    @property
    def img_shape(self) -> tuple[int, ...]:
        if self.horizontal_coordinates is None:
            raise ValueError("DatasetInfo has no horizontal coordinates")
        return self.horizontal_coordinates.shape

    @property
    def gridded_operations(self) -> GriddedOperations:
        if self.horizontal_coordinates is None:
            raise ValueError("DatasetInfo has no horizontal coordinates")
        ops = self.horizontal_coordinates.get_gridded_operations()
        if (self.mask_provider is not None and self.mask_provider.masks
                and isinstance(ops, LatLonOperations)):
            # masked cells get zero area weight in every scalar metric
            # (HEALPix means stay plain, as in the JAX package)
            ops = LatLonOperations(ops.area_weights_host,
                                   mask_provider=self.mask_provider)
        return ops

    @property
    def atmosphere_vertical_coordinate(
        self,
    ) -> HybridSigmaPressureCoordinate | None:
        if isinstance(self.vertical_coordinate, HybridSigmaPressureCoordinate):
            return self.vertical_coordinate
        return None

    @property
    def depth_coordinate(self) -> DepthCoordinate | None:
        if isinstance(self.vertical_coordinate, DepthCoordinate):
            return self.vertical_coordinate
        return None

    def assert_compatible_with(self, other: "DatasetInfo"):
        """Check that a model trained on this dataset can be used with
        ``other`` (port of ace_tpu/core/dataset_info.py:88): the grids,
        the timesteps and the vertical coordinates, where both have one,
        must agree."""
        if (
            self.horizontal_coordinates is not None
            and other.horizontal_coordinates is not None
            and self.horizontal_coordinates != other.horizontal_coordinates
        ):
            raise IncompatibleDatasetInfo(
                "horizontal coordinates differ between datasets"
            )
        if (
            self.timestep is not None
            and other.timestep is not None
            and self.timestep != other.timestep
        ):
            raise IncompatibleDatasetInfo(
                f"timesteps differ: {self.timestep} vs {other.timestep}"
            )
        if (
            isinstance(self.vertical_coordinate, HybridSigmaPressureCoordinate)
            and isinstance(other.vertical_coordinate,
                           HybridSigmaPressureCoordinate)
            and self.vertical_coordinate != other.vertical_coordinate
        ):
            raise IncompatibleDatasetInfo("vertical coordinates differ")

    def get_state(self) -> dict:
        state: dict = {"variable_metadata": {
            k: {"units": v.units, "long_name": v.long_name}
            for k, v in self.variable_metadata.items()
        }}
        if self.horizontal_coordinates is not None:
            state["horizontal_coordinates"] = self.horizontal_coordinates.as_dict()
        if self.vertical_coordinate is not None:
            state["vertical_coordinate"] = serialize_vertical_coordinate(
                self.vertical_coordinate
            )
        if self.timestep is not None:
            state["timestep_seconds"] = self.timestep.total_seconds()
        if self.mask_provider is not None and self.mask_provider.masks:
            state["mask_provider"] = self.mask_provider.get_state()
        if self.all_labels:
            state["all_labels"] = list(self.all_labels)
        return state

    @classmethod
    def from_state(cls, state: dict) -> "DatasetInfo":
        horizontal = None
        if "horizontal_coordinates" in state:
            hc = state["horizontal_coordinates"]
            if "nside" in hc:
                horizontal = HEALPixCoordinates.from_dict(hc)
            else:
                horizontal = LatLonCoordinates(
                    lat=np.asarray(hc["lat"]), lon=np.asarray(hc["lon"])
                )
        vertical = None
        if "vertical_coordinate" in state:
            vertical = deserialize_vertical_coordinate(
                state["vertical_coordinate"]
            )
        timestep = None
        if state.get("timestep_seconds") is not None:
            timestep = timedelta(seconds=state["timestep_seconds"])
        metadata = {
            k: VariableMetadata(units=v["units"], long_name=v["long_name"])
            for k, v in state.get("variable_metadata", {}).items()
        }
        mask_provider = None
        if "mask_provider" in state:
            mask_provider = MaskProvider.from_state(state["mask_provider"])
        return cls(
            horizontal_coordinates=horizontal,
            vertical_coordinate=vertical,
            timestep=timestep,
            variable_metadata=metadata,
            mask_provider=mask_provider,
            all_labels=tuple(state.get("all_labels", ())),
        )
