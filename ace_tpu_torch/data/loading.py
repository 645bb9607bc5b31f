"""Batch carrier (port of ace_tpu/data/loading.py:36 BatchData).

``WindowDataset``, the ``DataLoader`` with its prefetch thread and
``GriddedData`` wait for the trainer's slice.
"""

import dataclasses
from typing import Any

import numpy as np
import torch

from ace_tpu_torch.data.time import TimeCoord


@dataclasses.dataclass
class BatchData:
    """A batch: ``[batch, time, lat, lon]`` fields (numpy on the host, or
    tensors once ``to_device`` has placed them) and their times."""

    data: dict[str, Any]
    time: TimeCoord  # values shaped [batch, time]
    # one-hot dataset labels [batch, n_labels]; None when no labels
    labels: Any = None
    # per-variable [batch] presence masks; None = all present
    data_mask: dict[str, Any] | None = None

    @property
    def n_timesteps(self) -> int:
        return self.time.values.shape[1]

    def to_device(self, device, sharding=None) -> "BatchData":
        """The batch on ``device``: each field goes through pinned host
        memory with a non-blocking copy when the device is a GPU, so the
        copies overlap work already queued there. A mesh ``sharding`` is
        refused: the port has no mesh yet."""
        if sharding is not None:
            raise NotImplementedError(
                "mesh placement is not ported yet (ROADMAP Queue 1 item 12)"
            )
        device = torch.device(device)

        def put(v):
            t = torch.as_tensor(np.asarray(v))
            if device.type == "cuda":
                t = t.pin_memory()
            return t.to(device, non_blocking=True)

        data = {k: put(v) for k, v in self.data.items()}
        mask = self.data_mask
        if mask is not None:
            mask = {k: put(v) for k, v in mask.items()}
        return BatchData(data=data, time=self.time, labels=self.labels,
                         data_mask=mask)

    def get_start(self, prognostic_names, n_ic_timesteps: int):
        from ace_tpu_torch.stepper.stepper import PrognosticState

        return PrognosticState(data={
            k: self.data[k][:, :n_ic_timesteps] for k in prognostic_names
        })

    def get_end(self, prognostic_names, n_ic_timesteps: int):
        from ace_tpu_torch.stepper.stepper import PrognosticState

        return PrognosticState(data={
            k: self.data[k][:, -n_ic_timesteps:] for k in prognostic_names
        })
