"""Metric logging (port of the part of ace_tpu/core/wandb.py that the
trainer calls): the JSON-lines ``DiskMetricLogger`` and a ``WandB``
singleton that stays disabled.

Weights & Biases is not ported: the machines the port runs on have no
network, so ``configure(True)`` raises, as ``LoggingConfig.log_to_wandb``
does. While disabled, ``log`` only checks that steps never go back, and
``log_watched`` does nothing.
"""

import json
import os
from typing import Any, Mapping


class WandB:
    """The disabled wandb singleton, with the JAX package's step check."""

    _instance: "WandB | None" = None

    def __init__(self):
        self._last_step = -1

    @classmethod
    def get_instance(cls) -> "WandB":
        if cls._instance is None:
            cls._instance = WandB()
        return cls._instance

    @classmethod
    def reset(cls):
        cls._instance = None

    def configure(self, log_to_wandb: bool):
        if log_to_wandb:
            raise NotImplementedError(
                "logging to Weights & Biases is not ported"
            )

    def log(self, data: Mapping[str, Any], step: int | None = None):
        if step is not None:
            if step < self._last_step:
                raise ValueError(
                    f"step {step} < last logged step {self._last_step}"
                )
            self._last_step = step

    def log_watched(self, step: int, params, grads=None):
        """Parameter histograms of a watch: never, while disabled."""

    @property
    def enabled(self) -> bool:
        return False

    def get_id(self) -> str | None:
        return None


class DiskMetricLogger:
    """Append metrics as JSON lines (port of ace_tpu/core/wandb.py:243)."""

    def __init__(self, path: str):
        self._path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, data: Mapping[str, Any], step: int | None = None):
        record = {k: _to_scalar(v) for k, v in data.items()}
        if step is not None:
            record["step"] = step
        with open(self._path, "a") as f:
            f.write(json.dumps(record) + "\n")


def _to_scalar(value):
    try:
        return float(value)
    except (TypeError, ValueError):
        return str(value)
