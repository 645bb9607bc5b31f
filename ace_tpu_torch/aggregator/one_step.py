"""One-step validation aggregator: per-variable RMSE, bias and
gradient-magnitude difference of one-step predictions, with snapshot and
mean maps (port of ace_tpu/aggregator/one_step.py:20 OneStepAggregator).

``record_batch`` only queues reductions on the device and adds them to
running sums there; the sums reach the host in one copy, at the first
``get_logs``, ``get_snapshots`` or ``flush_diagnostics`` (the JAX package
drains its device-resident list at the same points), so a validation loop
never waits for the device per batch.
"""

import os

import numpy as np
import torch

from ace_tpu_torch.core.typing_ import TensorMapping


def _add(sums: dict, key: str, value: torch.Tensor):
    sums[key] = sums[key] + value if key in sums else value


class OneStepAggregator:
    def __init__(self, ops, record_snapshots: bool = True,
                 record_mean_maps: bool = False):
        self._ops = ops
        self._record_snapshots = record_snapshots
        self._record_mean_maps = record_mean_maps
        # device sums and host counts, until the drain
        self._device_sums: dict[str, torch.Tensor] = {}
        self._device_maps: dict[str, torch.Tensor] = {}
        self._device_snapshots: dict[str, torch.Tensor] = {}
        self._counts: dict[str, int] = {}
        self._map_counts: dict[str, int] = {}
        # host values after the drain
        self._sums: dict[str, float] = {}
        self._map_sums: dict[str, np.ndarray] = {}
        self._snapshots: dict[str, np.ndarray] = {}

    @torch.no_grad()
    def record_batch(self, gen: TensorMapping, target: TensorMapping):
        """``gen`` and ``target``: ``[batch, (time,) lat, lon]`` tensors
        on one device, by variable."""
        for name in gen:
            if name not in target:
                continue
            g, t = gen[name].float(), target[name].float()
            ops = self._ops
            for key, value in (
                (f"rmse/{name}", ops.area_weighted_rmse(t, g, name=name)),
                (f"bias/{name}", ops.area_weighted_mean_bias(t, g,
                                                             name=name)),
                (f"gradient_magnitude_percent_diff/{name}",
                 ops.area_weighted_gradient_magnitude_percent_diff(
                     t, g, name=name)),
            ):
                _add(self._device_sums, key, value.mean())
                self._counts[key] = self._counts.get(key, 0) + 1
            if self._record_snapshots:
                # the last batch's first sample wins
                g0, t0 = g, t
                while g0.dim() > 2:
                    g0, t0 = g0[0], t0[0]
                self._device_snapshots[f"snapshot/gen/{name}"] = g0
                self._device_snapshots[f"snapshot/error/{name}"] = g0 - t0
            if self._record_mean_maps:
                g_map = g.reshape(-1, *g.shape[-2:]).mean(dim=0)
                t_map = t.reshape(-1, *t.shape[-2:]).mean(dim=0)
                _add(self._device_maps, f"gen_map-{name}", g_map)
                _add(self._device_maps, f"bias_map-{name}", g_map - t_map)
                self._map_counts[name] = self._map_counts.get(name, 0) + 1

    def _drain(self):
        """Bring the device sums to the host in one copy each kind."""
        if self._device_sums:
            keys = list(self._device_sums)
            values = torch.stack([self._device_sums[k] for k in keys])
            for k, v in zip(keys, values.cpu().double().numpy()):
                self._sums[k] = self._sums.get(k, 0.0) + float(v)
            self._device_sums = {}
        for k, v in self._device_maps.items():
            self._map_sums[k] = self._map_sums.get(k, 0.0) + v.cpu().numpy()
        self._device_maps = {}
        for k, v in self._device_snapshots.items():
            self._snapshots[k] = v.cpu().numpy()
        self._device_snapshots = {}

    def get_logs(self, label: str = "one_step") -> dict[str, float]:
        self._drain()
        return {
            f"{label}/{k}": self._sums[k] / self._counts[k]
            for k in self._sums
        }

    def get_snapshots(self) -> dict[str, np.ndarray]:
        self._drain()
        return dict(self._snapshots)

    def flush_diagnostics(self, output_dir: str):
        """Write the epoch's validation diagnostics: scalar means
        (mean_diagnostics.nc), the last batch's snapshots
        (snapshot_diagnostics.nc) and the batch-mean maps
        (mean_map_diagnostics.nc)."""
        from ace_tpu_torch.data.store import write_h5

        self._drain()
        os.makedirs(output_dir, exist_ok=True)
        groups: dict[str, dict[str, np.ndarray]] = {
            "mean": {
                k.replace("/", "-"): np.asarray(
                    self._sums[k] / self._counts[k]
                )
                for k in self._sums
            },
        }
        if self._snapshots:
            groups["snapshot"] = {
                k.replace("/", "-"): v for k, v in self._snapshots.items()
            }
        if self._map_sums:
            groups["mean_map"] = {
                k: v / self._map_counts[k.split("-", 1)[1]]
                for k, v in self._map_sums.items()
            }
        for label, diags in groups.items():
            if not diags:
                continue
            write_h5(
                os.path.join(output_dir, f"{label}_diagnostics.nc"),
                {k: np.asarray(v) for k, v in diags.items()},
                {k: tuple(f"dim{i}" for i in range(np.ndim(v)))
                 for k, v in diags.items()},
            )


class EnsembleOneStepAggregator:
    """One-step ensemble metrics (port of ace_tpu/aggregator/one_step.py:148
    EnsembleOneStepAggregator): almost-fair CRPS, the ensemble mean's RMSE
    and the spread-skill ratio's bias (stdev / unbiased RMSE - 1, per grid
    cell, then averaged; 0 is calibrated).

    ``record_batch(gen [B, E, ...spatial], target [B, ...spatial])`` keeps
    its sums on the device; they reach the host at ``get_logs``.
    """

    # zero-spread cells whose unbiased MSE is below this fraction of the
    # field's largest MSE are prescribed
    _PRESCRIBED_MSE_RTOL = 1e-6

    def __init__(self, ops):
        self._ops = ops
        self._device: dict[str, torch.Tensor] = {}
        self._n_ens: int | None = None
        self._count = 0
        self._crps: dict[str, float] = {}
        self._mse: dict[str, float] = {}
        self._mse_map: dict[str, np.ndarray] = {}
        self._var_map: dict[str, np.ndarray] = {}

    def record_batch(self, gen: TensorMapping, target: TensorMapping):
        from ace_tpu_torch.core.loss import get_crps

        self._count += 1
        for name in gen:
            if name not in target:
                continue
            g, t = gen[name].float(), target[name].float()
            self._n_ens = g.shape[1]
            # the members' deviations from the first: equal members give
            # a mean equal to them and a variance of exactly 0 (a
            # prescribed cell), not rounding
            d = g - g[:, :1]
            mean = g[:, 0] + d.mean(dim=1)
            _add(self._device, f"crps/{name}",
                 get_crps(g, t[:, None], alpha=0.95).mean())
            _add(self._device, f"mse_map/{name}",
                 ((mean - t) ** 2).mean(dim=0))
            _add(self._device, f"var_map/{name}",
                 d.var(dim=1, correction=1).mean(dim=0))
            _add(self._device, f"scalar_mse/{name}", self._ops.area_weighted_mean(
                (mean - t) ** 2, name=name).mean())

    def _drain(self):
        if not self._device:
            return
        host = {k: v.cpu().double().numpy() for k, v in self._device.items()}
        self._device = {}
        for key, value in host.items():
            kind, name = key.split("/", 1)
            store = {"crps": self._crps, "scalar_mse": self._mse,
                     "mse_map": self._mse_map, "var_map": self._var_map}[kind]
            store[name] = store.get(name, 0.0) + (
                float(value) if value.ndim == 0 else value)

    def _ssr_bias_map(self, name: str) -> np.ndarray:
        n_ens = max(self._n_ens or 1, 1)
        total_var = self._var_map[name]
        total_umse = self._mse_map[name] - total_var / n_ens
        spread = np.sqrt(total_var)
        skill = np.sqrt(np.clip(total_umse, 0.0, None))
        ssr = np.where(skill > 0, spread / np.maximum(skill, 1e-300) - 1.0,
                       -1.0)
        mse_floor = self._PRESCRIBED_MSE_RTOL * float(
            np.max(np.square(skill), initial=0.0))
        prescribed = (total_var == 0) & (total_umse <= mse_floor)
        return np.where(prescribed, 0.0, ssr)

    def get_logs(self, label: str = "ensemble") -> dict[str, float]:
        self._drain()
        logs = {}
        n = max(self._count, 1)
        for name in self._crps:
            mse = self._mse[name] / n
            logs[f"{label}/crps/{name}"] = self._crps[name] / n
            logs[f"{label}/rmse_of_ensemble_mean/{name}"] = mse ** 0.5
            logs[f"{label}/spread_skill_ratio_bias/{name}"] = float(
                np.mean(self._ssr_bias_map(name)))
        return logs
