"""Dataset metadata bundle (port of ace_tpu/core/dataset_info.py).

Carries the grid, the vertical coordinate and the timestep; serialized
into checkpoints in the JAX package's layout (``get_state``/``from_state``
round-trip with ``ace_tpu``'s). HEALPix grids, depth coordinates and
dataset masks are not ported yet and raise.
"""

import dataclasses
from datetime import timedelta

import numpy as np

from ace_tpu_torch.core.coordinates import (
    HybridSigmaPressureCoordinate,
    LatLonCoordinates,
    deserialize_vertical_coordinate,
    serialize_vertical_coordinate,
)
from ace_tpu_torch.core.gridded_ops import LatLonOperations


@dataclasses.dataclass(frozen=True)
class VariableMetadata:
    units: str
    long_name: str


@dataclasses.dataclass
class DatasetInfo:
    horizontal_coordinates: LatLonCoordinates | None = None
    vertical_coordinate: HybridSigmaPressureCoordinate | None = None
    timestep: timedelta | None = None
    variable_metadata: dict[str, VariableMetadata] = dataclasses.field(
        default_factory=dict
    )
    all_labels: tuple = ()

    @property
    def img_shape(self) -> tuple[int, int]:
        if self.horizontal_coordinates is None:
            raise ValueError("DatasetInfo has no horizontal coordinates")
        return self.horizontal_coordinates.shape

    @property
    def gridded_operations(self) -> LatLonOperations:
        if self.horizontal_coordinates is None:
            raise ValueError("DatasetInfo has no horizontal coordinates")
        return self.horizontal_coordinates.get_gridded_operations()

    @property
    def atmosphere_vertical_coordinate(
        self,
    ) -> HybridSigmaPressureCoordinate | None:
        if isinstance(self.vertical_coordinate, HybridSigmaPressureCoordinate):
            return self.vertical_coordinate
        return None

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
        if self.all_labels:
            state["all_labels"] = list(self.all_labels)
        return state

    @classmethod
    def from_state(cls, state: dict) -> "DatasetInfo":
        if "mask_provider" in state:
            raise NotImplementedError("dataset masks are not ported yet")
        horizontal = None
        if "horizontal_coordinates" in state:
            hc = state["horizontal_coordinates"]
            if "nside" in hc:
                raise NotImplementedError("HEALPix grids are not ported yet")
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
        return cls(
            horizontal_coordinates=horizontal,
            vertical_coordinate=vertical,
            timestep=timestep,
            variable_metadata=metadata,
            all_labels=tuple(state.get("all_labels", ())),
        )
