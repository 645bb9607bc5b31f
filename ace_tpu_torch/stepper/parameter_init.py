"""Fine-tuning from a base checkpoint: weight transfer, frozen parameters,
L2-SP regularization toward the base weights, and copying a subset of
weights back after each optimizer step (port of
ace_tpu/stepper/parameter_init.py).

Rules select parameters by their flax names (``core/wildcard.py``), and a
shape-mismatched parameter gets its initial slice overwritten in flax's
layout (``utils/convert.py:flax_view``), so that a YAML selects and
transfers the same values in both packages. The JAX package zeroes a
frozen parameter's update after clipping and Adam
(``optax.masked(optax.set_to_zero(), mask)``); the port's optimizer does
the same with the mask of :meth:`FrozenParameterConfig.frozen_mask`.
"""

import dataclasses
import json

import torch

from ace_tpu_torch.core.wildcard import build_mask
from ace_tpu_torch.utils.convert import flax_view


def _overwrite(key: str, target: torch.Tensor, source: torch.Tensor):
    """Copy ``source`` into ``target`` in place; where their shapes differ
    (same rank), only the leading slice they share, taken in flax's
    layout."""
    if target.shape == source.shape:
        target.copy_(source)
        return
    if target.dim() != source.dim():
        raise ValueError(f"cannot transfer weight {key} with rank mismatch: "
                         f"{tuple(source.shape)} vs {tuple(target.shape)}")
    t, s = flax_view(key, target), flax_view(key, source)
    slices = tuple(slice(0, min(a, b)) for a, b in zip(t.shape, s.shape))
    t[slices] = s[slices].to(t.dtype)


@torch.no_grad()
def overwrite_weights(state: dict[str, torch.Tensor],
                      base: dict[str, torch.Tensor],
                      exclude: list[str] | None = None):
    """Overwrite the tensors of ``state`` (a module's ``state_dict``, whose
    tensors are written in place) with ``base``'s, but for those that an
    ``exclude`` rule selects and those ``base`` lacks; a shape-mismatched
    tensor gets its initial slice overwritten (fine-tuning to more
    channels or levels)."""
    keep = (build_mask(state, exclude=exclude) if exclude
            else dict.fromkeys(state, True))
    for key, value in state.items():
        if keep[key] and key in base:
            _overwrite(key, value, base[key].to(value.device))


def read_base_weights(path: str) -> tuple[dict[str, torch.Tensor], dict]:
    """A checkpoint's weights as a ``state_dict`` on the host, and its
    stepper entry."""
    from ace_tpu_torch.stepper.checkpoint import load_msgpack
    from ace_tpu_torch.utils.convert import flax_params_to_state_dict

    state = load_msgpack(path)["stepper"]
    return flax_params_to_state_dict(state["params"]), state


@dataclasses.dataclass
class FrozenParameterConfig:
    """Exactly one of include/exclude; frozen parameters get no optimizer
    updates."""

    include: list[str] | None = None
    exclude: list[str] | None = None

    def __post_init__(self):
        if (self.include is None) == (self.exclude is None):
            raise ValueError(
                "provide exactly one of include or exclude for frozen params"
            )

    def frozen_mask(self, state: dict[str, torch.Tensor]) -> dict[str, bool]:
        """True where the parameter is FROZEN."""
        return build_mask(state, include=self.include, exclude=self.exclude)


@dataclasses.dataclass
class ParameterClassification:
    exclude: list[str] = dataclasses.field(default_factory=list)
    frozen: FrozenParameterConfig | None = None


@dataclasses.dataclass
class ParameterInitializationConfig:
    """Fine-tuning options (the JAX package's fields).

    alpha: L2-SP coefficient toward the base weights (transferred params).
    beta: L2 coefficient toward zero for the params not transferred.
    ``parameters`` is the reference's rule-list spelling; its rules fold
    into exclude_parameters/frozen_parameters.
    """

    weights_path: str | None = None
    parameters: list[ParameterClassification] = dataclasses.field(
        default_factory=list
    )
    exclude_parameters: list[str] | None = None
    frozen_parameters: FrozenParameterConfig | None = None
    alpha: float = 0.0
    beta: float = 0.0

    def __post_init__(self):
        if not self.parameters:
            return
        if (self.exclude_parameters is not None
                or self.frozen_parameters is not None):
            raise ValueError(
                "provide either parameters rules or the deprecated "
                "exclude_parameters/frozen_parameters, not both"
            )
        excludes = [name for rule in self.parameters for name in rule.exclude]
        if excludes:
            self.exclude_parameters = excludes
        frozen = [rule.frozen for rule in self.parameters
                  if rule.frozen is not None]
        if len(frozen) > 1:
            # include-style rules merge; mixed include/exclude rules
            # cannot be merged into one mask
            includes = [f.include for f in frozen]
            if any(i is None for i in includes):
                raise ValueError("multiple frozen rules must all use include")
            self.frozen_parameters = FrozenParameterConfig(
                include=[n for inc in includes for n in inc])
        elif frozen:
            self.frozen_parameters = frozen[0]

    @property
    def regularized(self) -> bool:
        return self.alpha != 0.0 or self.beta != 0.0

    def apply_weights(self, stepper) -> dict[str, torch.Tensor] | None:
        """Load the base checkpoint's weights into ``stepper`` (but for the
        excluded ones) and append the base's training history to its own.
        Returns the base weights on the host (None without a base)."""
        if self.weights_path is None:
            return None
        from ace_tpu_torch.core.training_history import TrainingHistory

        base, state = read_base_weights(self.weights_path)
        overwrite_weights(stepper.module.state_dict(), base,
                          exclude=self.exclude_parameters)
        if "training_history" in state:
            stepper.training_history.extend(TrainingHistory.from_state(
                json.loads(state["training_history"])))
        return base

    def regularizer_loss(self, params: dict[str, torch.Tensor],
                         base: dict[str, torch.Tensor] | None
                         ) -> torch.Tensor:
        """The L2-SP penalty: alpha/2 ||w - w_base||^2 over the parameters
        the base has at the same shape, beta/2 ||w||^2 over the rest.
        ``base`` holds constants on the parameters' device."""
        base = base or {}
        total = None
        for name, p in params.items():
            b = base.get(name)
            if b is not None and b.shape == p.shape:
                term = 0.5 * self.alpha * ((p - b) ** 2).sum()
            else:
                term = 0.5 * self.beta * (p ** 2).sum()
            total = term if total is None else total + term
        return total


@dataclasses.dataclass
class CopyWeightsConfig:
    """Overwrite a wildcard-selected subset of weights with their stored
    values after each optimizer step. Exactly one of include/exclude
    selects the OVERWRITTEN set."""

    include: list[str] | None = None
    exclude: list[str] | None = None

    def __post_init__(self):
        if (self.include is None) == (self.exclude is None):
            raise ValueError("provide exactly one of include or exclude")

    def build(self, state: dict[str, torch.Tensor]) -> "CopyWeights":
        return CopyWeights(self, state)


class CopyWeights:
    """Copies, on their device, of the selected tensors of ``state`` (a
    module's ``state_dict``) as they were when built."""

    def __init__(self, config: CopyWeightsConfig,
                 state: dict[str, torch.Tensor]):
        mask = build_mask(state, include=config.include,
                          exclude=config.exclude)
        self._stored = {k: v.detach().clone() for k, v in state.items()
                        if mask[k]}

    @torch.no_grad()
    def apply(self, state: dict[str, torch.Tensor]):
        """Reset the selected tensors of ``state`` in place."""
        for key, value in self._stored.items():
            _overwrite(key, state[key], value)
