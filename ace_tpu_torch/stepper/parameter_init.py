"""Parameter initialization config for training (port of
ace_tpu/stepper/parameter_init.py:ParameterInitializationConfig).

Only the defaults are ported: a fresh start with no base checkpoint, no
frozen parameters and no L2-SP regularization. Fine-tuning (``weights_path``,
``parameters`` rules, ``exclude_parameters``, ``frozen_parameters``, nonzero
``alpha`` or ``beta``) raises ``NotImplementedError``.
"""

import dataclasses


@dataclasses.dataclass
class FrozenParameterConfig:
    """Exactly one of include/exclude (accepted for config compatibility;
    freezing is not ported yet)."""

    include: list[str] | None = None
    exclude: list[str] | None = None

    def __post_init__(self):
        if (self.include is None) == (self.exclude is None):
            raise ValueError(
                "provide exactly one of include or exclude for frozen params"
            )


@dataclasses.dataclass
class ParameterClassification:
    exclude: list[str] = dataclasses.field(default_factory=list)
    frozen: FrozenParameterConfig | None = None


@dataclasses.dataclass
class ParameterInitializationConfig:
    """The JAX package's fields; everything but the defaults raises."""

    weights_path: str | None = None
    parameters: list[ParameterClassification] = dataclasses.field(
        default_factory=list
    )
    exclude_parameters: list[str] | None = None
    frozen_parameters: FrozenParameterConfig | None = None
    alpha: float = 0.0
    beta: float = 0.0

    def __post_init__(self):
        unported = {
            "weights_path": self.weights_path is not None,
            "parameters": bool(self.parameters),
            "exclude_parameters": self.exclude_parameters is not None,
            "frozen_parameters": self.frozen_parameters is not None,
            "alpha": self.alpha != 0.0,
            "beta": self.beta != 0.0,
        }
        for option, requested in unported.items():
            if requested:
                raise NotImplementedError(
                    f"parameter_init option {option} (fine-tuning) is not "
                    "ported yet"
                )
