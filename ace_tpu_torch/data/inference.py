"""Inference data loading: initial conditions + streaming forcing windows
(port of ace_tpu/data/inference.py; reference: fme/ace/data_loading/inference.py — InferenceDataLoaderConfig
:104, ForcingDataLoaderConfig :164, InferenceDataset :203).

Forcing is delivered in windows of ``forward_steps_in_memory`` forward
steps (+1 overlap step), so arbitrarily long rollouts stream with bounded
host/device memory (reference: fme/ace/inference/inference.py:258).
Windows are numpy on the host; the inference loop moves them to the
device.
"""

import dataclasses

import numpy as np

from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.data.dataset import (
    MergeDatasetConfig,
    XarrayDataConfig,
    XarrayDataset,
)
from ace_tpu_torch.data.loading import BatchData
from ace_tpu_torch.data.time import TimeCoord, parse_datetime_string


@dataclasses.dataclass
class ExplicitIndices:
    """IC selection by dataset indices (reference: inference.py ExplicitIndices)."""

    list: list[int]

    def resolve(self, time: TimeCoord) -> list[int]:
        return [int(i) for i in self.list]


@dataclasses.dataclass
class TimestampList:
    """IC selection by timestamps (reference: inference.py:28 TimestampList)."""

    times: list[str]

    def resolve(self, time: TimeCoord) -> list[int]:
        out = []
        for t in self.times:
            micros = parse_datetime_string(t, time.calendar)
            idx = np.searchsorted(time.values, micros)
            if idx >= len(time) or time.values[idx] != micros:
                raise ValueError(f"timestamp {t} not found in dataset")
            out.append(int(idx))
        return out


@dataclasses.dataclass
class InferenceInitialConditionIndices:
    """Evenly-spaced IC selection (reference: inference.py
    InferenceInitialConditionIndices).
    """

    n_initial_conditions: int
    first: int = 0
    interval: int = 1

    def resolve(self, time: TimeCoord) -> list[int]:
        return [
            self.first + i * self.interval
            for i in range(self.n_initial_conditions)
        ]


StartIndices = (
    ExplicitIndices | TimestampList | InferenceInitialConditionIndices
)


@dataclasses.dataclass
class InferenceDataLoaderConfig:
    """(reference: fme/ace/data_loading/inference.py:104; merged
    forcing sources via MergeNoConcatDatasetConfig :179)."""

    dataset: "XarrayDataConfig | MergeDatasetConfig"
    start_indices: StartIndices = dataclasses.field(
        default_factory=lambda: ExplicitIndices(list=[0])
    )
    num_data_workers: int = 2

    def build(
        self,
        forcing_names: list[str],
        prognostic_names: list[str],
        n_forward_steps: int,
        forward_steps_in_memory: int,
    ) -> "InferenceGriddedData":
        return InferenceGriddedData(
            dataset=self.dataset.build(),
            start_indices=self.start_indices,
            forcing_names=forcing_names,
            prognostic_names=prognostic_names,
            n_forward_steps=n_forward_steps,
            forward_steps_in_memory=forward_steps_in_memory,
        )


@dataclasses.dataclass
class ForcingDataLoaderConfig:
    """(reference: fme/ace/data_loading/inference.py:164)."""

    dataset: XarrayDataConfig
    num_data_workers: int = 2


class InferenceGriddedData:
    """Provides the initial condition and an iterator of forcing windows
    (reference: fme/ace/data_loading/gridded_data.py:152
    InferenceGriddedData).
    """

    def __init__(self, dataset: XarrayDataset, start_indices,
                 forcing_names, prognostic_names,
                 n_forward_steps: int, forward_steps_in_memory: int):
        self.dataset = dataset
        self._starts = start_indices.resolve(dataset.all_time)
        self.forcing_names = list(forcing_names)
        self.prognostic_names = list(prognostic_names)
        self.n_forward_steps = n_forward_steps
        self.forward_steps_in_memory = forward_steps_in_memory
        max_start = max(self._starts)
        if max_start + n_forward_steps >= dataset.n_times:
            raise ValueError(
                f"IC at index {max_start} + {n_forward_steps} forward steps "
                f"exceeds dataset length {dataset.n_times}"
            )

    @property
    def dataset_info(self) -> DatasetInfo:
        return self.dataset.dataset_info

    @property
    def n_initial_conditions(self) -> int:
        return len(self._starts)

    def initial_condition(self, names: list[str] | None = None) -> BatchData:
        """IC batch [n_ic, 1, H, W] for the prognostic (or given) names."""
        names = names if names is not None else self.prognostic_names
        samples = [
            self.dataset.get_window(s, 1, names) for s in self._starts
        ]
        data = {
            k: np.stack([s[0][k] for s in samples]) for k in names
        }
        time = TimeCoord(
            np.stack([s[1].values for s in samples]),
            samples[0][1].calendar,
        )
        return BatchData(data=data, time=time)

    def windows(self, names: list[str] | None = None):
        """Yield (BatchData [n_ic, fsm+1, H, W], window index).

        Window k covers forward steps [k*fsm, min((k+1)*fsm, n)) with one
        step of overlap at the start. ``names`` defaults to the forcing
        variables; the evaluator passes target names instead.
        """
        names = self.forcing_names if names is None else names
        fsm = self.forward_steps_in_memory
        n = self.n_forward_steps
        k = 0
        while k * fsm < n:
            n_fwd = min(fsm, n - k * fsm)
            samples = [
                self.dataset.get_window(s + k * fsm, n_fwd + 1, names)
                for s in self._starts
            ]
            data = {
                name: np.stack([s[0][name] for s in samples])
                for name in names
            }
            time = TimeCoord(
                np.stack([s[1].values for s in samples]),
                samples[0][1].calendar,
            )
            yield BatchData(data=data, time=time), k
            k += 1

    def target_windows(self, names: list[str]):
        """windows() over arbitrary (target) names — evaluator use."""
        return self.windows(names)
