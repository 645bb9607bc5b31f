"""Step types. Importing this package registers them with StepSelector."""

from ace_tpu_torch.core.step import single_module  # noqa: F401
from ace_tpu_torch.core.step.base import (  # noqa: F401
    StepArgs,
    StepOutput,
    StepperState,
    StepSelector,
)
