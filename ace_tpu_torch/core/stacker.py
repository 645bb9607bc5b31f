"""Prefix-based stacking of per-level variables (port of
ace_tpu/core/stacker.py).

Variables named ``prefix_0, prefix_1, ...`` are stacked along a new
trailing vertical axis. A prefix map associates standard names with
candidate prefixes (e.g. "sea_water_salinity" -> ["so_"]).
"""

import re
from collections.abc import Mapping

import torch

from ace_tpu_torch.core.typing_ import TensorMapping

LEVEL_PATTERN = re.compile(r"_(\d+)$")


def natural_sort(names: list[str]) -> list[str]:
    """Sort names by trailing integer level index."""

    def key(name: str):
        match = LEVEL_PATTERN.search(name)
        return (int(match.group(1)) if match else -1, name)

    return sorted(names, key=key)


class Stacker:
    def __init__(self, prefix_map: Mapping[str, list[str]]):
        self._prefix_map = dict(prefix_map)

    @property
    def prefix_map(self) -> dict[str, list[str]]:
        return self._prefix_map

    def get_all_level_names(self, standard_name: str,
                            data: TensorMapping) -> list[str]:
        if standard_name not in self._prefix_map:
            raise ValueError(f"{standard_name} is not a standard name")
        for prefix in self._prefix_map[standard_name]:
            # exact match (2-D variable)
            if prefix in data:
                return [prefix]
            level_names = [
                name for name in data
                if name.startswith(prefix)
                and LEVEL_PATTERN.search(name[len(prefix) - 1:])
                and name[len(prefix):].isdigit()
            ]
            if level_names:
                level_names = natural_sort(level_names)
                # require contiguous 0..N-1 levels
                levels = [int(LEVEL_PATTERN.search(n).group(1))
                          for n in level_names]
                if levels != list(range(len(levels))):
                    raise ValueError(
                        f"missing vertical levels for {prefix}: got {levels}"
                    )
                return level_names
        raise KeyError(standard_name)

    def __call__(self, standard_name: str,
                 data: TensorMapping) -> torch.Tensor:
        names = self.get_all_level_names(standard_name, data)
        if len(names) == 1 and not names[0][-1].isdigit():
            return data[names[0]][..., None]
        return torch.stack([data[n] for n in names], dim=-1)
