"""Batches and the training data loader (port of
ace_tpu/data/loading.py).

Samples are windows of consecutive times read on the host as numpy by a
thread pool and collated into batches by a prefetch thread, which also
copies each batch into page-locked (pinned) host memory of its own when
the batches go to a GPU. The consumer's copies to the device are then
``non_blocking``: they are queued behind the work already on the device
and nothing waits for them. PyTorch's pinned-memory allocator does not hand
a batch's buffer out again before its copy has run, and no buffer is
reused by the loader itself. Shuffling is the JAX package's numpy order
(``RandomState(seed + epoch)``), so both packages train on the same
batches in the same order. Mesh placement (``sharding``) is refused: the
port runs on one device.
"""

import concurrent.futures
import dataclasses
import itertools
import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.data.augmentation import AugmentationConfig
from ace_tpu_torch.data.dataset import (
    ConcatDatasetConfig,
    MergeDatasetConfig,
    XarrayDataConfig,
    XarrayDataset,
)
from ace_tpu_torch.data.requirements import DataRequirements
from ace_tpu_torch.data.time import TimeCoord

_NO_MESH = ('mesh placement is not ported yet (ROADMAP Queue 1, '
            '"Multi-GPU")')


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

    def pinned(self) -> "BatchData":
        """The batch as CPU tensors in pinned host memory of their own."""

        def pin(v):
            return torch.as_tensor(np.asarray(v)).pin_memory()

        mask = self.data_mask
        if mask is not None:
            mask = {k: pin(v) for k, v in mask.items()}
        return BatchData(data={k: pin(v) for k, v in self.data.items()},
                         time=self.time, labels=self.labels, data_mask=mask)

    def to_device(self, device, sharding=None) -> "BatchData":
        """The batch on ``device``: each field goes through pinned host
        memory (its own, unless :meth:`pinned` already placed it there)
        with a non-blocking copy when the device is a GPU, so the copies
        overlap work already queued there. A mesh ``sharding`` is
        refused: the port has no mesh yet."""
        if sharding is not None:
            raise NotImplementedError(_NO_MESH)
        device = torch.device(device)

        def put(v):
            t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
                np.asarray(v))
            if device.type == "cuda" and not t.is_pinned():
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


class WindowDataset:
    """Sample index -> contiguous window of ``requirements.n_timesteps``
    times (port of ace_tpu/data/loading.py:103).

    Samples are ``(data, time, missing)``, ``missing`` the requested
    variables absent from the dataset: with
    ``requirements.allow_missing_variables`` they arrive NaN-filled,
    otherwise a missing variable raises at read time.
    """

    def __init__(self, dataset: XarrayDataset,
                 requirements: DataRequirements):
        self.dataset = dataset
        self.names = requirements.names
        self.n_timesteps = requirements.n_timesteps
        self.allow_missing = requirements.allow_missing_variables
        if self.allow_missing:
            available = set(dataset.names)
            self._present = [n for n in self.names if n in available]
            self._missing = frozenset(
                n for n in self.names if n not in available
            )
        else:
            self._present = list(self.names)
            self._missing = frozenset()

    def __len__(self) -> int:
        if hasattr(self.dataset, "n_windows"):
            return self.dataset.n_windows(self.n_timesteps)
        return max(0, self.dataset.n_times - self.n_timesteps + 1)

    def _fill_missing(self, data: dict) -> dict:
        if self._missing:
            if data:
                shape = next(iter(data.values())).shape
            else:
                shape = (
                    self.n_timesteps,
                    *self.dataset.dataset_info.img_shape,
                )
            for name in self._missing:
                data[name] = np.full(shape, np.nan, np.float32)
        return data

    def __getitem__(self, idx: int) -> tuple[dict, TimeCoord, frozenset]:
        if hasattr(self.dataset, "window_start"):
            # concatenated datasets enumerate the windows that do not span
            # a boundary, per segment
            idx = self.dataset.window_start(idx, self.n_timesteps)
        data, time = self.dataset.get_window(
            idx, self.n_timesteps, self._present
        )
        return self._fill_missing(dict(data)), time, self._missing

    @property
    def dataset_info(self) -> DatasetInfo:
        return self.dataset.dataset_info


class StridedWindowDataset(WindowDataset):
    """Windows whose starts advance by ``stride`` (``time_buffer + 1``), so
    that the sub-windows of consecutive windows skip no time; a trailing
    partial window is dropped (port of ace_tpu/data/loading.py:162)."""

    def __init__(self, dataset: XarrayDataset,
                 requirements: DataRequirements, stride: int):
        super().__init__(dataset, requirements)
        self.stride = stride

    def __len__(self) -> int:
        n = self.dataset.n_times - self.n_timesteps + 1
        return max(0, (n + self.stride - 1) // self.stride)

    def __getitem__(self, idx: int) -> tuple[dict, TimeCoord, frozenset]:
        data, time = self.dataset.get_window(
            idx * self.stride, self.n_timesteps, self._present
        )
        return self._fill_missing(dict(data)), time, self._missing


def _collate(samples: list[tuple]) -> BatchData:
    names = samples[0][0].keys()
    data = {
        k: np.stack([s[0][k] for s in samples], axis=0) for k in names
    }
    time = TimeCoord(
        np.stack([s[1].values for s in samples], axis=0),
        samples[0][1].calendar,
    )
    # per-variable [batch] presence masks, only for variables missing in
    # at least one sample
    data_mask = None
    missing_sets = [s[2] if len(s) > 2 else frozenset() for s in samples]
    if any(missing_sets):
        ever_missing = frozenset().union(*missing_sets)
        data_mask = {
            name: np.asarray(
                [name not in m for m in missing_sets], np.float32
            )
            for name in ever_missing
        }
    return BatchData(data=data, time=time, data_mask=data_mask)


def _dataset_labels(dataset) -> list:
    """The union of configured dataset labels, through concatenated and
    merged datasets."""
    cfg = getattr(dataset, "config", None)
    if cfg is not None:
        return list(getattr(cfg, "labels", None) or [])
    children = getattr(dataset, "_datasets", None)
    if children:
        out: list = []
        for child in children:
            for name in _dataset_labels(child):
                if name not in out:
                    out.append(name)
        return out
    return []


class DataLoader:
    """Threaded, prefetching batch loader with epoch-seeded shuffling
    (port of ace_tpu/data/loading.py:227): batches of ``dataset`` on
    ``device``."""

    def __init__(
        self,
        dataset: WindowDataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        drop_last: bool = True,
        sharding=None,
        sample_with_replacement: int | None = None,
        modifier=None,
        device="cpu",
    ):
        if sharding is not None:
            raise NotImplementedError(_NO_MESH)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.drop_last = drop_last
        self.sample_with_replacement = sample_with_replacement
        self.modifier = modifier
        self.device = torch.device(device)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        n = (
            self.sample_with_replacement
            if self.sample_with_replacement is not None
            else len(self.dataset)
        )
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self, start_batch: int = 0) -> list[np.ndarray]:
        rng = np.random.RandomState(self.seed + self.epoch)
        if self.sample_with_replacement is not None:
            indices = rng.randint(
                0, len(self.dataset), self.sample_with_replacement
            )
        else:
            indices = np.arange(len(self.dataset))
            if self.shuffle:
                rng.shuffle(indices)
        n_batches = len(self)
        batches = [
            indices[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(n_batches)
        ]
        return batches[start_batch:]

    def __iter__(self) -> Iterator[BatchData]:
        return self.iter_batches()

    def _attach_labels(self, batch: BatchData) -> BatchData:
        label_names = _dataset_labels(self.dataset.dataset)
        if not label_names:
            return batch
        encoding = sorted(label_names)
        n = next(iter(batch.data.values())).shape[0]
        onehot = np.zeros((n, len(encoding)), np.float32)
        for name in label_names:
            onehot[:, encoding.index(name)] = 1.0
        labels = BatchData({"labels": onehot}, batch.time).to_device(
            self.device).data["labels"]
        return BatchData(data=batch.data, time=batch.time, labels=labels,
                         data_mask=batch.data_mask)

    def iter_batches(self, start_batch: int = 0) -> Iterator[BatchData]:
        batches = self._index_batches(start_batch)
        if not batches:
            return
        pin = self.device.type == "cuda"
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that gives up once the consumer has gone, so
            # that an early exit of the consumer never wedges the producer
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with concurrent.futures.ThreadPoolExecutor(
                    self.num_workers
                ) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        samples = list(
                            pool.map(self.dataset.__getitem__, batch_idx)
                        )
                        batch = _collate(samples)
                        if self.modifier is not None:
                            batch = BatchData(
                                data=self.modifier(dict(batch.data)),
                                time=batch.time,
                                labels=batch.labels,
                                data_mask=batch.data_mask,
                            )
                        if pin:
                            batch = batch.pinned()
                        if not put(batch):
                            return
            except BaseException as e:  # surface read errors, don't hang
                put(e)
                return
            put(None)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield self._attach_labels(item.to_device(self.device))
        finally:
            stop.set()


class SlidingWindowLoader:
    """Wraps a loader of long windows and emits ``time_buffer + 1``
    sub-window batches per input batch, interleaved across a pool of
    ``pool_size`` windows in memory to decorrelate consecutive batches
    (port of ace_tpu/data/loading.py:393)."""

    def __init__(self, loader: DataLoader, output_n_timesteps: int,
                 time_buffer: int, shuffle: bool, pool_size: int = 1,
                 seed: int = 0):
        if pool_size < 1:
            raise ValueError("pool_size must be >= 1")
        self._loader = loader
        self._n_out = output_n_timesteps
        self._time_buffer = time_buffer
        self._shuffle = shuffle
        self._pool_size = pool_size
        self._seed = seed
        self._epoch = 0

    @property
    def batch_size(self) -> int:
        return self._loader.batch_size

    @property
    def dataset(self):
        return self._loader.dataset

    def set_epoch(self, epoch: int):
        self._epoch = epoch
        self._loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self._loader) * (self._time_buffer + 1)

    def _subselect(self, batch: BatchData, offset: int) -> BatchData:
        sl = slice(offset, offset + self._n_out)
        return BatchData(
            data={k: v[:, sl] for k, v in batch.data.items()},
            time=TimeCoord(batch.time.values[:, sl], batch.time.calendar),
            labels=batch.labels,
            data_mask=batch.data_mask,
        )

    def __iter__(self) -> Iterator[BatchData]:
        rng = np.random.RandomState(self._seed + self._epoch + 17)
        source = iter(self._loader)
        # each pool slot: (window batch, remaining offsets)
        pool: list[tuple[BatchData, list[int]]] = []

        def refill():
            while len(pool) < self._pool_size:
                try:
                    batch = next(source)
                except StopIteration:
                    return
                offsets = list(range(self._time_buffer + 1))
                if self._shuffle:
                    rng.shuffle(offsets)
                pool.append((batch, offsets))

        refill()
        while pool:
            slot = int(rng.randint(len(pool))) if self._shuffle else 0
            batch, offsets = pool[slot]
            yield self._subselect(batch, offsets.pop(0))
            if not offsets:
                pool.pop(slot)
                refill()


@dataclasses.dataclass
class DataLoaderConfig:
    """Training data loader config (port of ace_tpu/data/loading.py:466).

    ``time_buffer`` reads windows that many times longer and emits their
    sub-windows; ``sample_with_replacement`` draws that many samples per
    epoch with replacement instead of each sample once.
    """

    dataset: ConcatDatasetConfig | MergeDatasetConfig | XarrayDataConfig
    batch_size: int = 1
    num_data_workers: int = 4
    prefetch_factor: int = 2
    time_buffer: int = 0
    time_buffer_pool_size: int = 1
    augmentation: AugmentationConfig = dataclasses.field(
        default_factory=AugmentationConfig
    )
    sample_with_replacement: int | None = None

    def __post_init__(self):
        if self.time_buffer_pool_size > 1 and self.time_buffer == 0:
            raise ValueError(
                "time_buffer_pool_size requires time_buffer > 0"
            )

    def build(self, requirements: DataRequirements, train: bool = True,
              sharding=None, seed: int = 0, device="cpu") -> "GriddedData":
        """The loader of batches on ``device`` (the trainer passes its
        own; a mesh ``sharding`` is refused)."""
        if sharding is not None:
            raise NotImplementedError(_NO_MESH)
        xr_dataset = self.dataset.build()
        if self.time_buffer > 0:
            buffered = DataRequirements(
                names=requirements.names,
                n_timesteps=requirements.n_timesteps + self.time_buffer,
            )
            window: WindowDataset = StridedWindowDataset(
                xr_dataset, buffered, stride=self.time_buffer + 1
            )
        else:
            window = WindowDataset(xr_dataset, requirements)
        modifier = (
            self.augmentation.build_modifier(seed=seed) if train else None
        )
        loader = DataLoader(
            window,
            batch_size=self.batch_size,
            shuffle=train,
            num_workers=self.num_data_workers,
            prefetch=self.prefetch_factor,
            seed=seed,
            sample_with_replacement=self.sample_with_replacement,
            modifier=modifier,
            device=device,
        )
        if len(loader) == 0:
            raise ValueError(
                f"no batches in dataloader: {len(window)} samples of "
                f"{requirements.n_timesteps} timesteps with batch size "
                f"{self.batch_size}"
            )
        if self.time_buffer > 0:
            loader = SlidingWindowLoader(
                loader,
                output_n_timesteps=requirements.n_timesteps,
                time_buffer=self.time_buffer,
                shuffle=train,
                pool_size=self.time_buffer_pool_size,
                seed=seed,
            )
        return GriddedData(loader=loader, dataset=xr_dataset)


class GriddedData:
    """A loader and its dataset's metadata (port of
    ace_tpu/data/loading.py:538)."""

    def __init__(self, loader: DataLoader, dataset: XarrayDataset):
        self.loader = loader
        self.dataset = dataset

    @property
    def dataset_info(self) -> DatasetInfo:
        return self.dataset.dataset_info

    @property
    def n_batches(self) -> int:
        return len(self.loader)

    @property
    def n_samples(self) -> int:
        return len(self.loader.dataset)

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        return iter(self.loader)

    def iter_batches(self, start_batch: int = 0) -> Iterator[BatchData]:
        """The epoch's batches from ``start_batch`` on (a mid-epoch
        resume). A plain loader reads none of the batches before it; a
        sliding-window loader, whose order interleaves its windows, reads
        and drops them."""
        if isinstance(self.loader, DataLoader):
            return self.loader.iter_batches(start_batch)
        return itertools.islice(iter(self.loader), start_batch, None)
