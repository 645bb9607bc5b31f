"""Training-job provenance of a stepper (a copy of
ace_tpu/core/training_history.py, host only; tests hold it
equal to the original).

Every training run appends a TrainingJob (git sha and wandb run id of the
job) to the stepper's history; the history rides along inside the
checkpoint, so any checkpoint can be traced back through its chain of
training and fine-tuning jobs.
"""

import dataclasses
import subprocess
from collections.abc import Sequence


@dataclasses.dataclass
class TrainingJob:
    """Metadata of one stepper training job (reference:
    training_history.py:10)."""

    git_sha: str | None = None
    job_id: str | None = None

    @classmethod
    def from_env(cls) -> "TrainingJob":
        return cls(git_sha=git_revision_short_hash(), job_id=get_job_id())


class TrainingHistory(Sequence):
    """Ordered list of TrainingJobs (reference: training_history.py:30)."""

    def __init__(self, training_jobs: list[TrainingJob] | None = None):
        self._training_jobs: list[TrainingJob] = list(training_jobs or [])

    def __getitem__(self, idx):
        return self._training_jobs[idx]

    def __len__(self) -> int:
        return len(self._training_jobs)

    def __eq__(self, other) -> bool:
        if not isinstance(other, TrainingHistory):
            return False
        return self._training_jobs == other._training_jobs

    def append(self, job: TrainingJob) -> None:
        self._training_jobs.append(job)

    def extend(self, other: "TrainingHistory") -> None:
        self._training_jobs.extend(other)

    def get_history_by_key(self) -> dict[str, list]:
        keys = [f.name for f in dataclasses.fields(TrainingJob)]
        return {
            k: [getattr(job, k) for job in self._training_jobs] for k in keys
        }

    def get_state(self) -> list[dict]:
        return [dataclasses.asdict(job) for job in self._training_jobs]

    @classmethod
    def from_state(cls, state: list[dict]) -> "TrainingHistory":
        return cls([TrainingJob(**job) for job in state])


def git_revision_short_hash() -> str | None:
    try:
        return (
            subprocess.check_output(
                ["git", "rev-parse", "--short", "HEAD"],
                stderr=subprocess.DEVNULL,
            )
            .decode("ascii")
            .strip()
        )
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None


def get_job_id() -> str | None:
    from ace_tpu_torch.core.wandb import WandB

    wandb = WandB.get_instance()
    return wandb.get_id() if wandb.enabled else None
