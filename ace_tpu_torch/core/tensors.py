"""Tensor-dict utilities on torch tensors (port of ace_tpu/core/tensors.py):
the ensemble-dim helpers, nested config dicts, ``TensorDictAccumulator``
and the wind conversions."""

import numpy as np
import torch

from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def assert_dict_allclose(actual: TensorMapping, expected: TensorMapping,
                         rtol=1e-5, atol=1e-8):
    """Both dicts have the same keys and each pair of values is close."""
    missing = set(expected) - set(actual)
    extra = set(actual) - set(expected)
    if missing or extra:
        raise AssertionError(
            f"dict keys differ; missing: {sorted(missing)}, "
            f"extra: {sorted(extra)}"
        )
    for k in expected:
        np.testing.assert_allclose(
            _numpy(actual[k]), _numpy(expected[k]),
            rtol=rtol, atol=atol, err_msg=f"variable {k}",
        )


def add_ensemble_dim(data: TensorMapping, repeats: int = 1) -> TensorDict:
    """``[B, ...] -> [B, E, ...]``."""
    return {k: v[:, None].repeat_interleave(repeats, dim=1)
            for k, v in data.items()}


def fold_ensemble_dim(data: TensorMapping) -> tuple[TensorDict, int]:
    """``[B, E, ...] -> [B * E, ...]``, and E."""
    n_ensemble = next(iter(data.values())).shape[1]
    return {k: v.reshape(-1, *v.shape[2:]) for k, v in data.items()}, (
        n_ensemble)


def unfold_ensemble_dim(data: TensorMapping, n_ensemble: int) -> TensorDict:
    """``[B * E, ...] -> [B, E, ...]``."""
    return {k: v.reshape(-1, n_ensemble, *v.shape[1:])
            for k, v in data.items()}


def flatten_dict(nested: dict, separator: str = ".") -> dict:
    """Nested -> flat config dict."""
    out = {}
    for k, v in nested.items():
        if isinstance(v, dict):
            for kk, vv in flatten_dict(v, separator).items():
                out[f"{k}{separator}{kk}"] = vv
        else:
            out[k] = v
    return out


def unflatten_dict(flat: dict, separator: str = ".") -> dict:
    """Flat -> nested config dict."""
    out: dict = {}
    for k, v in flat.items():
        parts = k.split(separator)
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return out


def add_names(source: TensorMapping, target: TensorMapping,
              names: list[str]) -> TensorDict:
    """``target[name] + source[name]`` for each name of ``names``, the
    other entries of ``target`` as they are."""
    out = dict(target)
    for name in names:
        out[name] = out[name] + source[name]
    return out


class TensorDictAccumulator:
    """Running sum of TensorDicts with the same keys, and their mean."""

    def __init__(self):
        self._sum: TensorDict | None = None
        self._count = 0

    def record(self, data: TensorMapping):
        if self._sum is None:
            self._sum = dict(data)
        else:
            if set(data) != set(self._sum):
                raise ValueError("inconsistent keys in accumulation")
            self._sum = {k: self._sum[k] + data[k] for k in data}
        self._count += 1

    def get_mean(self) -> TensorDict:
        if self._sum is None:
            raise ValueError("no data recorded")
        return {k: v / self._count for k, v in self._sum.items()}


def u_v_to_x_y_z_wind(u, v, lat, lon):
    """Horizontal wind (eastward ``u``, northward ``v``) at ``lat``,
    ``lon`` in degrees to Cartesian components."""
    lat, lon = torch.deg2rad(lat), torch.deg2rad(lon)
    wx = -u * torch.sin(lon) - v * torch.sin(lat) * torch.cos(lon)
    wy = u * torch.cos(lon) - v * torch.sin(lat) * torch.sin(lon)
    wz = v * torch.cos(lat)
    return wx, wy, wz


def x_y_z_to_u_v_wind(wx, wy, wz, lat, lon):
    """Cartesian wind back to horizontal components."""
    lat, lon = torch.deg2rad(lat), torch.deg2rad(lon)
    u = -wx * torch.sin(lon) + wy * torch.cos(lon)
    v = (
        -wx * torch.sin(lat) * torch.cos(lon)
        - wy * torch.sin(lat) * torch.sin(lon)
        + wz * torch.cos(lat)
    )
    return u, v
