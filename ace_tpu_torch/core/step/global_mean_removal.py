"""Global-mean removal around the network (port of
ace_tpu/core/step/global_mean_removal.py).

``forward_transform`` shifts each listed field by the offset that moves
its spatial mean to its climatological (normalizer) mean before
normalization, so the network sees fields of about that mean;
``inverse_transform`` takes the offsets off the outputs again. With
``append_as_input`` the removed means, normalized, are extra input
channels of uniform value, so the network still sees the global state.
"""

import dataclasses
from typing import Literal

import torch

from ace_tpu_torch.core.normalizer import StandardNormalizer
from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping

_EXTRA_SUFFIX = "_global_mean"


def extra_channel_name(name: str) -> str:
    return f"{name}{_EXTRA_SUFFIX}"


def extra_channel_source_field(name: str) -> str | None:
    """The field whose mean the extra channel ``name`` holds, or None if
    ``name`` is not an extra channel."""
    if name.endswith(_EXTRA_SUFFIX):
        return name[: -len(_EXTRA_SUFFIX)]
    return None


def _per_sample(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A ``[batch]`` value shaped to broadcast over ``like``'s other axes."""
    return value.reshape(-1, *(1,) * (like.dim() - 1))


@dataclasses.dataclass
class GlobalMeanRemovalState:
    shifts: TensorDict
    extras: TensorDict


@dataclasses.dataclass
class GlobalMeanRemovalConfig:
    """``per_channel``: each listed field gets its own offset. ``shared``:
    the offset of ``reference_field`` applies to every listed field."""

    names: list[str]
    mode: Literal["per_channel", "shared"] = "per_channel"
    reference_field: str | None = None
    append_as_input: bool = False

    def __post_init__(self):
        if self.mode == "shared" and self.reference_field is None:
            raise ValueError("shared mode requires reference_field")

    def validate_names(self, in_names, out_names):
        for name in self.names:
            if name not in in_names and name not in out_names:
                raise ValueError(
                    f"global_mean_removal name {name!r} not in in/out names"
                )
        if self.mode == "shared" and self.reference_field not in in_names:
            raise ValueError("reference_field must be an input variable")

    def build(self, normalizer: StandardNormalizer) -> "GlobalMeanRemoval":
        return GlobalMeanRemoval(self, normalizer)


class GlobalMeanRemoval:
    def __init__(self, config: GlobalMeanRemovalConfig,
                 normalizer: StandardNormalizer):
        self.config = config
        self._normalizer = normalizer

    @property
    def extra_channel_names(self) -> list[str]:
        if not self.config.append_as_input:
            return []
        if self.config.mode == "shared":
            return [extra_channel_name(self.config.reference_field)]
        return [extra_channel_name(n) for n in self.config.names]

    def _offset(self, name: str, field: torch.Tensor) -> torch.Tensor:
        """``[batch]``: the normalizer's mean less the field's spatial
        mean."""
        return self._normalizer.means[name] - field.mean(
            dim=tuple(range(1, field.dim())))

    def _extra(self, name: str, offset: torch.Tensor,
               like: torch.Tensor) -> torch.Tensor:
        """The normalized removed mean as a uniform field shaped as
        ``like``."""
        normalized_mean = -offset / self._normalizer.stds[name]
        return _per_sample(normalized_mean, like).expand(like.shape)

    def forward_transform(self, input: TensorMapping
                          ) -> tuple[TensorDict, GlobalMeanRemovalState]:
        cfg = self.config
        result = dict(input)
        shifts: TensorDict = {}
        extras: TensorDict = {}
        if cfg.mode == "shared":
            ref = input[cfg.reference_field]
            offset = self._offset(cfg.reference_field, ref)
            if cfg.append_as_input:
                extras[extra_channel_name(cfg.reference_field)] = (
                    self._extra(cfg.reference_field, offset, ref))
            for name in cfg.names:
                if name in result:
                    result[name] = result[name] + _per_sample(offset,
                                                              result[name])
                shifts[name] = offset
        else:
            for name in cfg.names:
                if name not in input:
                    continue
                field = input[name]
                offset = self._offset(name, field)
                result[name] = field + _per_sample(offset, field)
                shifts[name] = offset
                if cfg.append_as_input:
                    extras[extra_channel_name(name)] = self._extra(
                        name, offset, field)
        return result, GlobalMeanRemovalState(shifts=shifts, extras=extras)

    def inverse_transform(self, output: TensorDict,
                          state: GlobalMeanRemovalState) -> TensorDict:
        result = dict(output)
        for name, shift in state.shifts.items():
            if name in result:
                result[name] = result[name] - _per_sample(shift, result[name])
        return result
