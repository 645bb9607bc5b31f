"""Static spatial masks and input-channel dropout (port of
ace_tpu/core/masking.py).

Spatial half: ocean datasets carry static ``mask_*`` fields (1 wet, 0
dry); ``MaskProvider`` resolves a variable's mask, the stepper's output
masker fills dry cells of the outputs with NaN, and
``StaticSpatialMaskingConfig`` (``StepperConfig.input_masking``) refills
them with a constant before the network. The masks live on the host as
numpy and reach each device once (``cached_on_device``), and each fill is
a ``torch.where`` with a Python scalar, so masking adds no host sync.

Variable half, input dropout: the JAX package draws from a fold of the
step's key; the port draws from the step's explicit ``torch.Generator``,
on its device, so a draw never waits for the device. The two streams are
unrelated: tests hold the draw to its statistics, and pass the presence
in to compare steps.
"""

import dataclasses

import numpy as np
import torch

from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping
from ace_tpu_torch.device import cached_on_device


class NameAndPrefixMatcher:
    """Exact and ``prefix_<level>`` matching: 'so' matches 'so' and
    'so_0'."""

    def __init__(self, names: list[str]):
        self._names = set(names)
        self._prefixes = [f"{n}_" for n in names]

    def matches(self, name: str) -> bool:
        return self.match(name) is not None

    def match(self, name: str) -> str | None:
        """The name or prefix (without its underscore) ``name`` matches."""
        if name in self._names:
            return name
        for prefix in self._prefixes:
            if name.startswith(prefix) and name[len(prefix):].isdigit():
                return prefix[:-1]
        return None


class MaskProvider:
    """Static dataset masks keyed ``mask_*``. Priority for variable
    ``name``: ``mask_{name}`` > ``mask_{level}`` for a name with a level
    suffix > ``mask_2d`` for one without."""

    def __init__(self, masks: dict[str, np.ndarray] | None = None):
        masks = masks or {}
        for key in masks:
            if not key.startswith("mask_"):
                raise ValueError(f"mask name {key!r} must start with mask_")
        self.masks = {k: np.asarray(v) for k, v in masks.items()}
        self._host: dict = {}
        self._device_cache: dict = {}

    def mask_key_for(self, name: str) -> str | None:
        """The key of ``name``'s mask, or None."""
        if f"mask_{name}" in self.masks:
            return f"mask_{name}"
        parts = name.rsplit("_", 1)
        if len(parts) == 2 and parts[1].isdigit():
            level_mask = f"mask_{parts[1]}"
            if level_mask in self.masks:
                return level_mask
        elif "mask_2d" in self.masks:
            return "mask_2d"
        return None

    def get_mask_for(self, name: str) -> np.ndarray | None:
        key = self.mask_key_for(name)
        return None if key is None else self.masks[key]

    def on_device(self, key: str, kind: str, device) -> torch.Tensor:
        """Mask ``key`` on ``device`` as a bool tensor: ``"wet"`` where
        the mask is not 0, ``"rounded=<v>"`` where the rounded mask
        equals ``v``; made once per device."""
        if (key, kind) not in self._host:
            mask = self.masks[key]
            self._host[key, kind] = (
                mask != 0 if kind == "wet"
                else np.round(mask).astype(np.int32) == int(kind[8:]))
        return cached_on_device(self._device_cache, f"{key}/{kind}",
                                self._host[key, kind], device)

    def build_output_masker(self, fill_value: float = float("nan")):
        """A callable that fills the dry cells of every output with a mask
        with ``fill_value`` (NaN); the identity when there are no
        masks."""
        if not self.masks:
            return lambda data: dict(data)

        def apply(data: TensorMapping) -> TensorDict:
            out = dict(data)
            for name, value in data.items():
                key = self.mask_key_for(name)
                if key is not None:
                    wet = self.on_device(key, "wet", value.device)
                    out[name] = torch.where(wet, value, fill_value)
            return out

        return apply

    def get_state(self) -> dict:
        return {"masks": {k: v.tolist() for k, v in self.masks.items()}}

    @classmethod
    def from_state(cls, state: dict) -> "MaskProvider":
        return cls({k: np.asarray(v)
                    for k, v in state.get("masks", {}).items()})

    def __eq__(self, other):
        if not isinstance(other, MaskProvider):
            return False
        if set(self.masks) != set(other.masks):
            return False
        return all(np.array_equal(self.masks[k], other.masks[k])
                   for k in self.masks)


@dataclasses.dataclass
class StaticSpatialMasking:
    """Fill the dry cells of the variables ``masks`` names (by name or
    level prefix; ``[lat, lon]`` masks, 1 wet) with ``fill_value``."""

    masks: dict[str, np.ndarray]
    fill_value: float = 0.0

    def __post_init__(self):
        self._matcher = NameAndPrefixMatcher(list(self.masks))
        self._device_cache: dict = {}

    def __call__(self, data: TensorMapping) -> TensorDict:
        out = dict(data)
        for name, value in data.items():
            key = self._matcher.match(name)
            if key is None:
                continue
            wet = cached_on_device(self._device_cache, key,
                                   np.asarray(self.masks[key]) != 0,
                                   value.device)
            out[name] = torch.where(wet, value, self.fill_value)
        return out


@dataclasses.dataclass
class SpatialMaskProvider:
    """Builds a ``StaticSpatialMasking`` from dataset fields:
    ``mask_names`` maps a variable name or prefix to its mask's name in
    ``mask_data``."""

    mask_names: dict[str, str] = dataclasses.field(default_factory=dict)
    fill_value: float = 0.0

    def build(self, mask_data) -> StaticSpatialMasking:
        masks = {key: np.asarray(mask_data[var])
                 for key, var in self.mask_names.items()}
        return StaticSpatialMasking(masks=masks, fill_value=self.fill_value)


@dataclasses.dataclass
class StaticSpatialMaskingConfig:
    """Refill the statically masked cells of a step's inputs
    (``StepperConfig.input_masking``; port of
    ace_tpu/core/masking.py:66).

    mask_value: the mask's value IN the masked cells (0 or 1).
    fill_value: a constant, or "mean" for each variable's normalizer
        mean.
    exclude_names_and_prefixes: variables left as they are.
    """

    mask_value: int = 0
    fill_value: float | str = 0.0
    exclude_names_and_prefixes: list[str] | None = None

    def __post_init__(self):
        if self.mask_value not in (0, 1):
            raise ValueError(
                f"mask_value must be 0 or 1, got {self.mask_value}"
            )
        if isinstance(self.fill_value, str) and self.fill_value != "mean":
            raise ValueError(
                'fill_value must be a float or "mean", got '
                f"{self.fill_value!r}"
            )

    def build(self, mask_provider: MaskProvider | None, means=None):
        """The input-masking callable over a ``TensorMapping``; the
        identity when the dataset has no masks."""
        if mask_provider is None or not mask_provider.masks:
            return lambda data: dict(data)
        exclude = NameAndPrefixMatcher(self.exclude_names_and_prefixes or [])
        use_mean = self.fill_value == "mean"
        if use_mean and means is None:
            raise ValueError('fill_value="mean" requires normalizer means')
        kind = f"rounded={self.mask_value}"

        def apply(data: TensorMapping) -> TensorDict:
            out = dict(data)
            for name, value in data.items():
                if exclude.matches(name):
                    continue
                key = mask_provider.mask_key_for(name)
                if key is None:
                    continue
                fill = (float(means.get(name, 0.0)) if use_mean
                        else float(self.fill_value))
                masked = mask_provider.on_device(key, kind, value.device)
                out[name] = torch.where(masked, fill, value)
            return out

        return apply


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
