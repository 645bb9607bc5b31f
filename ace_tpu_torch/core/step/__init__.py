"""Step types. Importing this package registers them with StepSelector."""

from ace_tpu_torch.core.step import (  # noqa: F401
    fcn3,
    multi_call,
    separate_radiation,
    single_module,
)
from ace_tpu_torch.core.step.base import (  # noqa: F401
    StepArgs,
    StepOutput,
    StepperState,
    StepSelector,
)
