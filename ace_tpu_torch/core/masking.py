"""Synthetic training-time input variable masking, i.e. input dropout (port
of the variable-masking half of ace_tpu/core/masking.py). The spatial half
(static masks, mask providers) waits for the dataset masks.

The JAX package draws from a fold of the step's key; the port draws from
the step's explicit ``torch.Generator``, on its device, so a draw never
waits for the device. The two streams are unrelated: tests hold the draw
to its statistics, and pass the presence in to compare steps.
"""

import dataclasses

import numpy as np
import torch

from ace_tpu_torch.device import cached_on_device


def _device(generator: torch.Generator | None):
    return generator.device if generator is not None else None


@dataclasses.dataclass
class BernoulliMaskingConfig:
    """All-or-nothing masking of a pool of channels: one draw a step drops
    the whole pool with probability ``rate``."""

    rate: float

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"masking rate must be in [0, 1]: {self.rate}")

    def sample_drops(self, generator: torch.Generator | None,
                     n: int) -> torch.Tensor:
        fired = torch.rand((), generator=generator,
                           device=_device(generator)) < self.rate
        return fired.expand(n)


@dataclasses.dataclass
class UniformMaskingConfig:
    """Drop k channels of the pool at random, k uniform in [0,
    min(max_masked_vars, n)]."""

    max_masked_vars: int

    def __post_init__(self):
        if (not isinstance(self.max_masked_vars, int)
                or isinstance(self.max_masked_vars, bool)
                or self.max_masked_vars < 0):
            raise ValueError(
                "max_masked_vars must be a non-negative int: "
                f"{self.max_masked_vars!r}"
            )

    def sample_drops(self, generator: torch.Generator | None,
                     n: int) -> torch.Tensor:
        device = _device(generator)
        if n == 0:
            return torch.zeros((0,), dtype=torch.bool, device=device)
        k = torch.randint(0, min(self.max_masked_vars, n) + 1, (),
                          generator=generator, device=device)
        ranks = torch.argsort(torch.randperm(n, generator=generator,
                                             device=device))
        return ranks < k


MaskingConfig = BernoulliMaskingConfig | UniformMaskingConfig


@dataclasses.dataclass
class MaskingGroupConfig:
    """A group of variables masked together by one scheme."""

    variables: list[str]
    masking: MaskingConfig

    def __post_init__(self):
        if len(self.variables) == 0:
            raise ValueError("masking group variables must be non-empty")


@dataclasses.dataclass
class VariableMaskingConfig:
    """Input dropout: the channels of an override group follow that group's
    scheme, the others ``default`` (which masks nothing unless set). The
    pools are disjoint, so each group's rate is exact; every sample of the
    batch drops the same channels."""

    default: MaskingConfig = dataclasses.field(
        default_factory=lambda: UniformMaskingConfig(0)
    )
    override_groups: list[MaskingGroupConfig] = dataclasses.field(
        default_factory=list
    )

    def __post_init__(self):
        seen: set[str] = set()
        for group in self.override_groups:
            for name in group.variables:
                if name in seen:
                    raise ValueError(
                        f"variable {name!r} in more than one masking group"
                    )
                seen.add(name)

    def build(self, names: list[str]) -> "VariableMasking":
        """Build for the packed channel ``names``; a grouped variable that
        is not among them raises."""
        valid = set(names)
        unknown = [name for group in self.override_groups
                   for name in group.variables if name not in valid]
        if unknown:
            raise ValueError(
                f"masking group variable(s) {unknown} not in packed "
                f"input channels {names}"
            )
        grouped = {name for group in self.override_groups
                   for name in group.variables}
        pools = [([n for n in names if n not in grouped], self.default)]
        pools += [(g.variables, g.masking) for g in self.override_groups]
        return VariableMasking(names, pools)


class VariableMasking:
    """The union of the masking pools over a fixed channel list."""

    def __init__(self, names, pools):
        self._names = list(names)
        self._pools = pools
        self._indices = [np.asarray([self._names.index(n) for n in pool])
                         for pool, _ in pools]
        self._cache: dict = {}

    @property
    def names(self) -> list[str]:
        return self._names

    def sample_presence(self, generator: torch.Generator | None
                        ) -> torch.Tensor:
        """Per-channel presence (True: kept), aligned with ``names``."""
        device = torch.device(_device(generator) or "cpu")
        presence = torch.ones(len(self._names), dtype=torch.bool,
                              device=device)
        for i, (pool_names, scheme) in enumerate(self._pools):
            if not pool_names:
                continue
            drops = scheme.sample_drops(generator, len(pool_names))
            index = cached_on_device(self._cache, f"pool_{i}",
                                     self._indices[i], device)
            presence[index] = ~drops
        return presence
