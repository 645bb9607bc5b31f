"""The trainer (port of ace_tpu/train/trainer.py), so far only its
``LoggingConfig``, which the inference entry shares. The trainer loop
waits for its own slice."""

import dataclasses
import logging
import os


@dataclasses.dataclass
class LoggingConfig:
    """Where a run logs (port of ace_tpu/train/trainer.py:63). Weights &
    Biases is not ported: ``log_to_wandb`` must stay false, and its
    fields (``project``, ``entity``, ``watch_log_freq``) are read only so
    that ``ace_tpu``'s configs load."""

    log_to_screen: bool = True
    log_to_file: bool = True
    log_to_wandb: bool = False
    project: str = "ace_tpu"
    entity: str | None = None
    watch_log_freq: int | None = None

    def __post_init__(self):
        if self.log_to_wandb:
            raise NotImplementedError(
                "logging to Weights & Biases is not ported yet"
            )

    def configure(self, experiment_dir: str, resumable: bool = True):
        handlers: list[logging.Handler] = []
        if self.log_to_screen:
            handlers.append(logging.StreamHandler())
        if self.log_to_file:
            os.makedirs(experiment_dir, exist_ok=True)
            handlers.append(
                logging.FileHandler(os.path.join(experiment_dir, "out.log"))
            )
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(levelname)s %(message)s",
            handlers=handlers,
            force=True,
        )
