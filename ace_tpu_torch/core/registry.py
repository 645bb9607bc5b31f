"""Generic name -> config-class registry with ``{type, config}`` selection
(reference: fme/core/registry/registry.py and registry/module.py).

Every pluggable component (module architecture, step type, corrector, ...)
registers a dataclass config under a string name. YAML selects one via::

    builder:
      type: SphericalFourierNeuralOperatorNet
      config:
        embed_dim: 256

Selectors serialize back to ``{type, config}`` dicts so checkpoints are
self-describing (reference: fme/ace/stepper/single_module.py:1337).
"""

import dataclasses
from typing import Any, Callable, Generic, TypeVar

from ace_tpu_torch.core.config import from_dict, to_dict

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self):
        self._types: dict[str, type] = {}

    def register(self, name: str) -> Callable[[type], type]:
        def decorator(cls: type) -> type:
            if not dataclasses.is_dataclass(cls):
                raise TypeError(f"registered config {cls} must be a dataclass")
            self._types[name] = cls
            return cls

        return decorator

    def get(self, name: str, config: dict[str, Any]) -> Any:
        if name not in self._types:
            raise KeyError(
                f"unknown registry type {name!r}; known: {sorted(self._types)}"
            )
        return from_dict(self._types[name], config)


@dataclasses.dataclass
class Selector:
    """A ``{type, config}`` pair bound to a registry at class level.

    Subclasses set ``registry`` as a class attribute. After construction,
    ``instance`` holds the built config dataclass.
    """

    type: str
    config: dict[str, Any] = dataclasses.field(default_factory=dict)

    registry: Registry = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        self.instance = self.get_registry().get(self.type, self.config)

    @classmethod
    def get_registry(cls) -> Registry:
        raise NotImplementedError

    def get_state(self) -> dict[str, Any]:
        return {"type": self.type, "config": to_dict(self.instance)}

    @classmethod
    def from_state(cls, state: dict[str, Any]) -> "Selector":
        return cls(type=state["type"], config=state["config"])
