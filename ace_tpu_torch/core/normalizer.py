"""Per-variable standard normalization of TensorDicts
(port of ace_tpu/core/normalizer.py).

Statistics are given explicitly (as the JAX package's checkpoints carry
them) or as paths to stats files (netCDF/HDF5 read with h5py, or .npz).
"""

import dataclasses
import pathlib
from collections.abc import Mapping

import numpy as np
import torch

from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping


def load_scalar_dict_from_file(path, names=None) -> dict[str, float]:
    """``{variable: scalar}`` from an .npz / .npy-dict / netCDF-HDF5 stats
    file (port of ace_tpu/core/normalizer.py:23)."""
    path = str(path)
    if path.endswith(".npz") or path.endswith(".npy"):
        data = np.load(path, allow_pickle=True)
        if hasattr(data, "files"):
            out = {k: float(np.asarray(data[k]).item()) for k in data.files}
        else:
            out = {k: float(v) for k, v in data.item().items()}
    else:
        import h5py

        out = {}
        with h5py.File(path, "r") as f:
            for k in f.keys():
                v = f[k]
                if hasattr(v, "shape") and int(np.prod(v.shape)) == 1:
                    out[k] = float(np.asarray(v[()]).reshape(()))
    if names is not None:
        missing = set(names) - set(out)
        if missing:
            raise KeyError(
                f"stats file {path} missing variables {sorted(missing)}"
            )
        out = {k: out[k] for k in names}
    return out


class StandardNormalizer:
    """Normalizes/denormalizes TensorDicts with per-variable scalar stats
    (float32, as in the JAX package)."""

    def __init__(self, means: Mapping[str, float], stds: Mapping[str, float],
                 fill_nans_on_normalize: bool = False,
                 fill_nans_on_denormalize: bool = False):
        self.means = {k: float(np.float32(v)) for k, v in means.items()}
        self.stds = {k: float(np.float32(v)) for k, v in stds.items()}
        self._names = set(means) & set(stds)
        self._fill_nans_on_normalize = fill_nans_on_normalize
        self._fill_nans_on_denormalize = fill_nans_on_denormalize

    @property
    def names(self) -> set[str]:
        return self._names

    def normalize(self, tensors: TensorMapping) -> TensorDict:
        out = {}
        for k, v in tensors.items():
            if k not in self._names:
                out[k] = v
                continue
            normed = (v - self.means[k]) / self.stds[k]
            if self._fill_nans_on_normalize:
                normed = torch.nan_to_num(normed, nan=0.0)
            out[k] = normed
        return out

    def denormalize(self, tensors: TensorMapping) -> TensorDict:
        out = {}
        for k, v in tensors.items():
            if k not in self._names:
                out[k] = v
                continue
            if self._fill_nans_on_denormalize:
                v = torch.nan_to_num(v, nan=0.0)
            out[k] = v * self.stds[k] + self.means[k]
        return out


@dataclasses.dataclass
class NormalizationConfig:
    """Normalization statistics from files or explicit values (port of
    ace_tpu/core/normalizer.py:134)."""

    global_means_path: str | pathlib.Path | None = None
    global_stds_path: str | pathlib.Path | None = None
    means: dict[str, float] = dataclasses.field(default_factory=dict)
    stds: dict[str, float] = dataclasses.field(default_factory=dict)
    fill_nans_on_normalize: bool = False
    fill_nans_on_denormalize: bool = False

    def __post_init__(self):
        using_path = (
            self.global_means_path is not None
            and self.global_stds_path is not None
        )
        using_explicit = len(self.means) > 0 and len(self.stds) > 0
        if using_path and using_explicit:
            raise ValueError(
                "Cannot use both stats paths and explicit means/stds."
            )
        if not (using_path or using_explicit):
            raise ValueError(
                "Must provide either stats paths or explicit means/stds."
            )

    def load(self):
        """Resolve file-based stats to explicit values (for serialization)."""
        if self.global_means_path is not None:
            self.means = load_scalar_dict_from_file(self.global_means_path)
            self.stds = load_scalar_dict_from_file(self.global_stds_path)
            self.global_means_path = None
            self.global_stds_path = None

    def build(self, names: list[str]) -> StandardNormalizer:
        if self.global_means_path is not None:
            return StandardNormalizer(
                load_scalar_dict_from_file(self.global_means_path, names),
                load_scalar_dict_from_file(self.global_stds_path, names),
                self.fill_nans_on_normalize,
                self.fill_nans_on_denormalize,
            )
        missing = set(names) - set(self.means)
        if missing:
            raise KeyError(f"means/stds missing for variables {sorted(missing)}")
        return StandardNormalizer(
            {k: self.means[k] for k in names},
            {k: self.stds[k] for k in names},
            self.fill_nans_on_normalize,
            self.fill_nans_on_denormalize,
        )


@dataclasses.dataclass
class NetworkAndLossNormalizationConfig:
    """Separate network-input and loss (residual) normalization (port of
    ace_tpu/core/normalizer.py:175)."""

    network: NormalizationConfig
    loss: NormalizationConfig | None = None
    residual: NormalizationConfig | None = None

    def __post_init__(self):
        if self.loss is not None and self.residual is not None:
            raise ValueError("Cannot specify both loss and residual normalization.")

    def build_network_normalizer(self, names: list[str]) -> StandardNormalizer:
        return self.network.build(names)

    def build_loss_normalizer(
        self, names: list[str], residual_scaled_names: list[str] | None = None
    ) -> StandardNormalizer:
        """The loss normalizer: either explicit loss stats, or network stats
        with both moments replaced by the residual stats for the
        ``residual_scaled_names`` (the prognostic variables)."""
        if self.loss is not None:
            return self.loss.build(names)
        if self.residual is None:
            return self.network.build(names)
        network = self.network.build(names)
        residual_names = (
            [n for n in residual_scaled_names if n in names]
            if residual_scaled_names is not None
            else names
        )
        residual = self.residual.build(residual_names)
        means = dict(network.means)
        stds = dict(network.stds)
        for k in residual_names:
            means[k] = residual.means[k]
            stds[k] = residual.stds[k]
        return StandardNormalizer(means, stds)
