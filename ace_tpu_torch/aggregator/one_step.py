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
