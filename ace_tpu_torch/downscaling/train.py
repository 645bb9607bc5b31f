"""Downscaling training entry (port of ace_tpu/downscaling/train.py).

    python -m ace_tpu_torch.downscaling <config.yaml> [--override a.b=1 ...]
        [--device cpu]

It reads the YAML of ``python -m ace_tpu.downscaling`` and trains the EDM
diffusion model (or a deterministic one) on paired coarse and fine
snapshots, on the CUDA device unless ``--device`` (or ``device=``) asks
for another. Batches, their times and patch origins are drawn as
``ace_tpu`` draws them (``np.random.RandomState(seed)``); the noise comes
from a ``torch.Generator`` seeded with ``seed + 1``. Nothing in the batch
loop waits for the device: losses stay there and are read once an epoch.

Checkpoints are ``ace_tpu``'s files (``checkpoints/ckpt.msgpack`` and
``ema_ckpt.msgpack``: config, model type, dataset info, the flax
parameter tree, the static fields), which either package loads.
``ckpt.msgpack`` also holds the port's training state (epoch, Adam's
moments and counts, the EMA, both random states), and a run on a
directory that holds one resumes from it bit for bit: ``ace_tpu`` starts
afresh instead. ``segment_epochs`` then counts from the resumed epoch.
``generate_n_samples`` is read and unused, as in ``ace_tpu``: validation
computes the loss.
"""

import contextlib
import dataclasses
import json
import logging
import os

import numpy as np
import torch

from ace_tpu_torch.core.cli import get_parser, prepare_config, prepare_directory
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.coordinates import LatLonCoordinates
from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
from ace_tpu_torch.core.wandb import DiskMetricLogger
from ace_tpu_torch.data.dataset import XarrayDataConfig
from ace_tpu_torch.device import entry_device
from ace_tpu_torch.downscaling.models import (
    DeterministicModelConfig,
    DiffusionModelConfig,
    load_params_tree,
    model_state,
)
from ace_tpu_torch.stepper.checkpoint import load_msgpack, save_msgpack
from ace_tpu_torch.train.trainer import LoggingConfig


@dataclasses.dataclass
class ClosedInterval:
    """A ``[start, stop]`` coordinate interval."""

    start: float | None = None
    stop: float | None = None

    def index_range(self, coords: np.ndarray) -> tuple[int, int]:
        sel = np.ones(len(coords), bool)
        if self.start is not None:
            sel &= coords >= self.start
        if self.stop is not None:
            sel &= coords <= self.stop
        idx = np.nonzero(sel)[0]
        if len(idx) == 0:
            raise ValueError(
                f"extent [{self.start}, {self.stop}] selects no points")
        return int(idx[0]), int(idx[-1]) + 1


class _CroppedDataset:
    """A dataset's view cropped to lat/lon index ranges: its windows and
    its horizontal coordinates."""

    def __init__(self, ds, lat_range, lon_range):
        self._ds = ds
        self._lat = slice(*lat_range)
        self._lon = slice(*lon_range)

    def __getattr__(self, name):
        return getattr(self._ds, name)

    @property
    def dataset_info(self):
        info = self._ds.dataset_info
        hc = info.horizontal_coordinates
        cropped = LatLonCoordinates(lat=np.asarray(hc.lat)[self._lat],
                                    lon=np.asarray(hc.lon)[self._lon])
        return dataclasses.replace(info, horizontal_coordinates=cropped)

    def get_window(self, start, n, names):
        data, time = self._ds.get_window(start, n, names)
        return ({k: v[..., self._lat, self._lon] for k, v in data.items()},
                time)


@dataclasses.dataclass
class PairedDataConfig:
    """Time-aligned coarse and fine datasets, one source or a list each,
    with region extents on the coarse grid (the fine crop is the same
    index range times the downscale factor)."""

    coarse: XarrayDataConfig | list[XarrayDataConfig]
    fine: XarrayDataConfig | list[XarrayDataConfig]
    batch_size: int = 1
    num_data_workers: int = 2
    lat_extent: ClosedInterval | None = None
    lon_extent: ClosedInterval | None = None
    strict_ensemble: bool = True
    # this many snapshots an epoch, drawn with replacement
    sample_with_replacement: int | None = None

    def _build_one(self, cfg_or_list):
        from ace_tpu_torch.data.dataset import ConcatXarrayDataset

        if isinstance(cfg_or_list, list):
            members = [c.build() for c in cfg_or_list]
            if len(members) == 1:
                return members[0]
            return ConcatXarrayDataset(members, strict=True)
        return cfg_or_list.build()

    def build_pair(self, downscale_factor: int):
        """``(coarse_ds, fine_ds)`` with the extents applied."""
        if (self.strict_ensemble and isinstance(self.coarse, list)
                and isinstance(self.fine, list)
                and len(self.coarse) != len(self.fine)):
            raise ValueError(
                "strict_ensemble: coarse and fine source lists must "
                f"pair up ({len(self.coarse)} vs {len(self.fine)})")
        coarse_ds = self._build_one(self.coarse)
        fine_ds = self._build_one(self.fine)
        if self.lat_extent is None and self.lon_extent is None:
            return coarse_ds, fine_ds
        hc = coarse_ds.dataset_info.horizontal_coordinates
        lat, lon = np.asarray(hc.lat), np.asarray(hc.lon)
        lat_r = (self.lat_extent.index_range(lat)
                 if self.lat_extent is not None else (0, len(lat)))
        lon_r = (self.lon_extent.index_range(lon)
                 if self.lon_extent is not None else (0, len(lon)))
        f = downscale_factor
        return (_CroppedDataset(coarse_ds, lat_r, lon_r),
                _CroppedDataset(fine_ds, (lat_r[0] * f, lat_r[1] * f),
                                (lon_r[0] * f, lon_r[1] * f)))


@dataclasses.dataclass
class RegionSamplingConfig:
    """Training patches whose centre falls in a lat/lon region drawn with
    relative weight ``weight`` (others 1)."""

    lat_interval: list[float] | None = None
    lon_interval: list[float] | None = None
    weight: float = 1.0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError("region sampling weight must be > 0")

    def origin_weights(self, lat: np.ndarray, lon: np.ndarray,
                       patch_shape: tuple[int, int]) -> np.ndarray:
        """The probability of each patch origin ``(y0, x0)``."""
        ph, pw = patch_shape
        n_y, n_x = len(lat) - ph + 1, len(lon) - pw + 1
        center_lat = lat[np.arange(n_y) + ph // 2]
        center_lon = lon[np.arange(n_x) + pw // 2]
        in_lat, in_lon = np.ones(n_y, bool), np.ones(n_x, bool)
        if self.lat_interval is not None:
            lo, hi = self.lat_interval
            in_lat = (center_lat >= lo) & (center_lat <= hi)
        if self.lon_interval is not None:
            lo, hi = self.lon_interval
            in_lon = (center_lon >= lo) & (center_lon <= hi)
        weights = np.where(in_lat[:, None] & in_lon[None, :], self.weight,
                           1.0)
        return weights / weights.sum()


@dataclasses.dataclass
class DownscalingTrainConfig:
    """The downscaling trainer's config (``ace_tpu``'s fields)."""

    experiment_dir: str
    max_epochs: int
    model: DeterministicModelConfig | DiffusionModelConfig
    train_data: PairedDataConfig
    validation_data: PairedDataConfig | None = None
    optimization: OptimizationConfig = dataclasses.field(
        default_factory=OptimizationConfig)
    ema: EMAConfig = dataclasses.field(default_factory=EMAConfig)
    validate_using_ema: bool = False
    validate_interval: int = 1
    generate_n_samples: int = 1
    save_checkpoints: bool = True
    segment_epochs: int | None = None
    coarse_patch_extent_lat: int | None = None
    coarse_patch_extent_lon: int | None = None
    region_sampling: RegionSamplingConfig | None = None
    # fine-grid static conditioning fields: {field_name: file_path}
    static_inputs: dict[str, str] = dataclasses.field(default_factory=dict)
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)
    seed: int = 0

    def __post_init__(self):
        if (self.coarse_patch_extent_lat is None) != (
                self.coarse_patch_extent_lon is None):
            raise ValueError(
                "set both or neither of coarse_patch_extent_lat/lon")
        if (self.region_sampling is not None
                and self.coarse_patch_extent_lat is None):
            raise ValueError(
                "region_sampling requires coarse_patch_extent_lat/lon")

    @property
    def checkpoint_dir(self) -> str:
        return os.path.join(self.experiment_dir, "checkpoints")


def load_static_inputs(static_inputs_config: dict[str, str]) -> np.ndarray:
    """Fine-grid static fields, each standard-score normalized, as one
    ``[H, W, n_fields]`` float32 array."""
    from ace_tpu_torch.data.store import open_file_dataset

    if not static_inputs_config:
        raise ValueError("load_static_inputs requires at least one field.")
    fields, shape = [], None
    for field_name, path in static_inputs_config.items():
        ds = open_file_dataset(path)
        arr = np.asarray(ds[field_name].read(()), dtype=np.float64)
        if arr.ndim == 3:  # a time axis: its first step
            arr = arr[0]
        if arr.ndim != 2:
            raise ValueError(
                f"unexpected shape {arr.shape} for static input "
                f"{field_name!r}; only 2-D lat/lon fields are supported")
        if shape is None:
            shape = arr.shape
        elif arr.shape != shape:
            raise ValueError(f"static input {field_name!r} shape "
                             f"{arr.shape} does not match {shape}")
        fields.append(((arr - arr.mean()) / arr.std()).astype(np.float32))
    return np.stack(fields, axis=-1)


def save_downscaling_checkpoint(path: str, model, training_state=None):
    """``ace_tpu``'s checkpoint of ``model`` (its network's current
    weights), with the port's ``training_state`` when given."""
    payload = model_state(model)
    static = getattr(model, "static_inputs", None)
    if static is not None:
        payload["static_inputs"] = static.detach().cpu().numpy()
    if training_state is not None:
        payload["training_state"] = training_state
    save_msgpack(path, payload)


def _build_model(payload: dict, device):
    from ace_tpu_torch.core.dataset_info import DatasetInfo

    cls = (DeterministicModelConfig
           if payload.get("model_type") == "DeterministicModelConfig"
           else DiffusionModelConfig)
    config = from_dict(cls, json.loads(payload["config"]))
    info = DatasetInfo.from_state(json.loads(payload["dataset_info"]))
    static = payload.get("static_inputs")
    if static is not None and cls is DiffusionModelConfig:
        model = config.build(info, static_inputs=np.asarray(static),
                             device=device)
    else:
        model = config.build(info, device=device)
    load_params_tree(model, payload["params"])
    return model


def load_downscaling_model(path: str, device=None):
    """The model of a downscaling checkpoint (either package's) on
    ``device`` (the CUDA device by default)."""
    return _build_model(load_msgpack(path), device)


def _np_rng_state(rng: np.random.RandomState) -> dict:
    _, keys, pos, has_gauss, cached = rng.get_state()
    return {"keys": keys, "pos": int(pos), "has_gauss": int(has_gauss),
            "cached": float(cached)}


def _set_np_rng_state(rng: np.random.RandomState, state: dict):
    rng.set_state(("MT19937", np.asarray(state["keys"], np.uint32),
                   int(state["pos"]), int(state["has_gauss"]),
                   float(state["cached"])))


class DownscalingTrainer:
    def __init__(self, config: DownscalingTrainConfig, device=None):
        self.config = config
        self.device = entry_device(device)
        self._val_datasets = None
        factor = config.model.downscale_factor
        self.coarse_ds, self.fine_ds = config.train_data.build_pair(factor)
        coarse_shape = self.coarse_ds.dataset_info.img_shape
        fine_shape = self.fine_ds.dataset_info.img_shape
        if (coarse_shape[0] * factor, coarse_shape[1] * factor) != tuple(
                fine_shape):
            raise ValueError(
                f"fine shape {fine_shape} is not coarse {coarse_shape} x "
                f"downscale_factor {factor}")
        if config.coarse_patch_extent_lat is not None:
            self.patch_shape: tuple[int, int] | None = (
                config.coarse_patch_extent_lat,
                config.coarse_patch_extent_lon)
        else:
            self.patch_shape = None
        self._static_full = (load_static_inputs(config.static_inputs)
                             if config.static_inputs else None)
        if self._static_full is not None and (
                tuple(self._static_full.shape[:2]) != tuple(fine_shape)):
            raise ValueError(
                f"static input shape {self._static_full.shape[:2]} does "
                f"not match the fine grid {tuple(fine_shape)}")
        if isinstance(config.model, DiffusionModelConfig):
            self.model = config.model.build(
                self.coarse_ds.dataset_info, static_inputs=self._static_full,
                device=self.device)
        else:
            self.model = config.model.build(self.coarse_ds.dataset_info,
                                            device=self.device)
        self.static = self.model.static_inputs
        self.model.init_params(
            torch.Generator(self.device).manual_seed(config.seed))
        net = self.model.net
        self.params = [] if net is None else list(net.parameters())
        self.optimization = config.optimization.build(
            max_epochs=config.max_epochs,
            steps_per_epoch=max(1, self.coarse_ds.n_times
                                // config.train_data.batch_size))
        self.optimization.init(self.params)
        self.ema = config.ema.build()
        self.ema.init(self.params)
        self.generator = torch.Generator(self.device).manual_seed(
            config.seed + 1)
        self.np_rng = np.random.RandomState(config.seed)
        self.start_epoch = 0
        self.num_batches_seen = 0
        self._disk_logger = DiskMetricLogger(
            os.path.join(config.experiment_dir, "metrics.jsonl"))
        self._ckpt = os.path.join(config.checkpoint_dir, "ckpt.msgpack")
        if os.path.exists(self._ckpt):
            self.restore(self._ckpt)

    # checkpoints ------------------------------------------------------

    def _training_state(self, epoch: int) -> dict:
        opt = self.optimization
        return {
            "epoch": epoch,
            "num_batches_seen": self.num_batches_seen,
            "optimization": {
                **opt.get_state(), "adam_count": opt.adam_count,
                "schedule_count": opt.schedule_count,
                "mu": {str(i): m for i, m in enumerate(opt.mu or [])},
                "nu": {str(i): n for i, n in enumerate(opt.nu or [])},
            },
            "ema": {**self.ema.get_state(), "params": {
                str(i): e for i, e in enumerate(self.ema.ema_params or [])}},
            "generator_state": self.generator.get_state(),
            "np_rng": _np_rng_state(self.np_rng),
        }

    @torch.no_grad()
    def restore(self, path: str):
        """Resume from the training state of ``path`` (a checkpoint that
        ``ace_tpu`` wrote, without one, is refused)."""
        payload = load_msgpack(path)
        state = payload.get("training_state")
        if state is None:
            raise ValueError(
                f"{path} holds no training state to resume from; the "
                "port resumes only its own checkpoints")
        load_params_tree(self.model, payload["params"])
        opt, n = self.optimization, len(self.params)

        def tensors(tree):
            return [torch.as_tensor(np.array(tree[str(i)]))
                    for i in range(n)]

        opt.load_state(state["optimization"])
        opt.load_moments(int(state["optimization"]["adam_count"]),
                         tensors(state["optimization"]["mu"]),
                         tensors(state["optimization"]["nu"]),
                         int(state["optimization"]["schedule_count"]))
        self.ema.load_state(state["ema"])
        for e, v in zip(self.ema.ema_params, tensors(state["ema"]["params"])):
            e.copy_(v)
        self.generator.set_state(torch.as_tensor(
            np.array(state["generator_state"]), dtype=torch.uint8))
        _set_np_rng_state(self.np_rng, state["np_rng"])
        self.start_epoch = int(state["epoch"]) + 1
        self.num_batches_seen = int(state["num_batches_seen"])
        logging.info(f"resumed from {path} at epoch {self.start_epoch}")

    def _save(self, epoch: int):
        os.makedirs(self.config.checkpoint_dir, exist_ok=True)
        save_downscaling_checkpoint(self._ckpt, self.model,
                                    self._training_state(epoch))
        if self.ema.ema_params is not None and self.params:
            with self._ema_weights():
                save_downscaling_checkpoint(
                    os.path.join(self.config.checkpoint_dir,
                                 "ema_ckpt.msgpack"), self.model)

    # batches ----------------------------------------------------------

    def _to_device(self, arrays: dict) -> dict:
        cuda = self.device.type == "cuda"
        out = {}
        for k, v in arrays.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.pin_memory().to(self.device, non_blocking=True)
                      if cuda else t)
        return out

    def _patch_origin(self, rng):
        ph, pw = self.patch_shape
        h, w = self.coarse_ds.dataset_info.img_shape
        if self.config.region_sampling is not None:
            hc = self.coarse_ds.dataset_info.horizontal_coordinates
            weights = self.config.region_sampling.origin_weights(
                np.asarray(hc.lat), np.asarray(hc.lon), self.patch_shape)
            flat = rng.choice(weights.size, p=weights.ravel())
            y0, x0 = np.unravel_index(flat, weights.shape)
            return int(y0), int(x0)
        return int(rng.randint(0, h - ph + 1)), int(rng.randint(0, w - pw + 1))

    def batch_indices(self, rng: np.random.RandomState, shuffle: bool):
        """The epoch's batches: each its times and its patch origin
        (``None`` without patches), drawn as ``ace_tpu`` draws them."""
        n = min(self.coarse_ds.n_times, self.fine_ds.n_times)
        bs = self.config.train_data.batch_size
        swr = self.config.train_data.sample_with_replacement
        if swr:
            order, n = rng.randint(0, n, size=swr), swr
        else:
            order = np.arange(n)
            if shuffle:
                rng.shuffle(order)
        for i in range(0, n - bs + 1, bs):
            idx = order[i:i + bs]
            origin = (self._patch_origin(rng)
                      if self.patch_shape is not None else None)
            yield idx, origin

    def _batch(self, idx, origin):
        names_c = self.model.config.in_names
        names_f = self.model.config.out_names
        coarse = {k: np.stack([self.coarse_ds.get_window(int(j), 1, names_c)
                               [0][k][0] for j in idx]) for k in names_c}
        fine = {k: np.stack([self.fine_ds.get_window(int(j), 1, names_f)
                             [0][k][0] for j in idx]) for k in names_f}
        static = self.static
        if origin is not None:
            (y0, x0), (ph, pw) = origin, self.patch_shape
            f = self.model.config.downscale_factor
            coarse = {k: v[..., y0:y0 + ph, x0:x0 + pw]
                      for k, v in coarse.items()}
            fine = {k: v[..., y0 * f:(y0 + ph) * f, x0 * f:(x0 + pw) * f]
                    for k, v in fine.items()}
            if static is not None:
                static = static[y0 * f:(y0 + ph) * f, x0 * f:(x0 + pw) * f]
        return self._to_device(coarse), self._to_device(fine), static

    # training ---------------------------------------------------------

    def train_step(self, coarse, fine, static):
        """One update; returns the loss (a device tensor)."""
        loss = self.model.loss_fn(coarse, fine, self.generator,
                                  static=static)
        if self.params:  # the interpolation baseline has none
            grads = torch.autograd.grad(loss, self.params)
            self.optimization.step(self.params, list(grads))
            self.ema(self.params)
        self.num_batches_seen += 1
        return loss.detach()

    def _train_batches(self, epoch: int):
        """The epoch's batch loop: its losses (on the device) and its
        batch count."""
        losses = []
        for idx, origin in self.batch_indices(self.np_rng, shuffle=True):
            losses.append(self.train_step(*self._batch(idx, origin)))
        return torch.stack(losses), len(losses)

    @contextlib.contextmanager
    def _ema_weights(self):
        """The EMA's weights in the network's place, then its own back."""
        saved = [p.detach().clone() for p in self.params]
        with torch.no_grad():
            for p, e in zip(self.params, self.ema.ema_params):
                p.copy_(e)
        try:
            yield
        finally:
            with torch.no_grad():
                for p, s in zip(self.params, saved):
                    p.copy_(s)

    def train(self):
        config = self.config
        end_epoch = config.max_epochs
        if config.segment_epochs is not None:
            end_epoch = min(self.start_epoch + config.segment_epochs,
                            config.max_epochs)
        for epoch in range(self.start_epoch, end_epoch):
            losses, _ = self._train_batches(epoch)
            last = {"epoch": epoch, "train_loss": float(losses.mean())}
            if (config.validation_data is not None
                    and epoch % max(config.validate_interval, 1) == 0):
                last["val_loss"] = self.validate()
            logging.info(f"downscaling epoch {epoch}: {last}")
            self._disk_logger.log(last)
            if config.save_checkpoints:
                self._save(epoch)
        return self

    def validate(self) -> float:
        """The mean loss over the validation times (batch 1, the first
        patch), with the EMA weights where ``validate_using_ema``."""
        if self._val_datasets is None:
            self._val_datasets = self.config.validation_data.build_pair(
                self.config.model.downscale_factor)
        val_coarse, val_fine = self._val_datasets
        names_c = self.model.config.in_names
        names_f = self.model.config.out_names
        use_ema = (self.config.validate_using_ema
                   and self.ema.ema_params is not None and self.params)
        losses = []
        with (self._ema_weights() if use_ema else contextlib.nullcontext()), \
                torch.no_grad():
            for j in range(min(val_coarse.n_times, val_fine.n_times)):
                coarse = val_coarse.get_window(j, 1, names_c)[0]
                fine = val_fine.get_window(j, 1, names_f)[0]
                static = self.static
                if self.patch_shape is not None:
                    ph, pw = self.patch_shape
                    f = self.model.config.downscale_factor
                    coarse = {k: v[..., :ph, :pw] for k, v in coarse.items()}
                    fine = {k: v[..., :ph * f, :pw * f]
                            for k, v in fine.items()}
                    if static is not None:
                        static = static[:ph * f, :pw * f]
                losses.append(self.model.loss_fn(
                    self._to_device(coarse), self._to_device(fine),
                    self.generator, static=static))
        return float(torch.stack(losses).mean())


def main(argv=None, device=None) -> DownscalingTrainer:
    """The command line; ``device`` (when given) takes the place of
    ``--device``. Returns the trainer."""
    args = get_parser().parse_args(argv)
    device = entry_device(device if device is not None else args.device)
    data = prepare_config(args.yaml_config, args.override)
    config = from_dict(DownscalingTrainConfig, data)
    prepare_directory(config.experiment_dir, data)
    config.logging.configure(config.experiment_dir)
    logging.info("Starting downscaling training")
    return DownscalingTrainer(config, device=device).train()
