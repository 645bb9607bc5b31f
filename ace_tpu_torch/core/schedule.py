"""Epoch-milestone schedules and stochastic rollout-length sampling (a
copy of ace_tpu/core/schedule.py, which imports only numpy; the port
imports nothing of the JAX package).

Used for rollout-length curricula: the training rollout length can vary
by epoch (IntSchedule) or be sampled per batch (TimeLengthProbabilities).
"""

import dataclasses

import numpy as np


@dataclasses.dataclass
class IntMilestone:
    epoch: int
    value: int


@dataclasses.dataclass
class IntSchedule:
    """Epoch-milestone-varying integer (reference: schedule.py:54)."""

    start_value: int
    milestones: list[IntMilestone] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        epochs = [m.epoch for m in self.milestones]
        if epochs != sorted(epochs):
            raise ValueError("milestones must be sorted by epoch")
        if len(set(epochs)) != len(epochs):
            raise ValueError("milestone epochs must be unique")

    @classmethod
    def from_constant(cls, value: int) -> "IntSchedule":
        return cls(start_value=value)

    def get_value(self, epoch: int) -> int:
        value = self.start_value
        for m in self.milestones:
            if epoch >= m.epoch:
                value = m.value
        return value

    @property
    def max_value(self) -> int:
        if not self.milestones:
            return self.start_value
        return max(self.start_value, max(m.value for m in self.milestones))


@dataclasses.dataclass
class TimeLengthProbability:
    steps: int
    probability: float


@dataclasses.dataclass
class TimeLengthProbabilities:
    """Stochastic rollout-length sampling
    (reference: time_length_probabilities.py:16).
    """

    outcomes: list[TimeLengthProbability]

    def __post_init__(self):
        if not self.outcomes:
            raise ValueError("outcomes must be non-empty")
        self._n_times = np.asarray([o.steps for o in self.outcomes])
        probs = np.asarray(
            [o.probability for o in self.outcomes], dtype=np.float64
        )
        if np.any(probs < 0) or probs.sum() <= 0:
            raise ValueError("probabilities must be non-negative, sum > 0")
        self._probabilities = probs / probs.sum()
        self._rng = np.random.RandomState(684)

    @classmethod
    def from_constant(cls, n_steps: int) -> "TimeLengthProbabilities":
        return cls(outcomes=[TimeLengthProbability(n_steps, 1.0)])

    @property
    def max_n_forward_steps(self) -> int:
        return int(self._n_times.max())

    @property
    def is_constant(self) -> bool:
        return len(self.outcomes) == 1

    def seed_rng(self, seed: int):
        self._rng = np.random.RandomState(seed)

    def sample(self) -> int:
        return int(self._rng.choice(self._n_times, p=self._probabilities))


TimeLength = TimeLengthProbabilities | int


def probabilities_from_time_length(value) -> TimeLengthProbabilities:
    if isinstance(value, TimeLengthProbabilities):
        return value
    return TimeLengthProbabilities.from_constant(value)


@dataclasses.dataclass
class TimeLengthMilestone:
    """(reference: time_length_probabilities.py TimeLengthMilestone)."""

    epoch: int
    value: TimeLength


@dataclasses.dataclass
class TimeLengthSchedule:
    """Epoch-scheduled (possibly stochastic) rollout lengths
    (reference: time_length_probabilities.py:75 TimeLengthSchedule).
    """

    start_value: TimeLength
    milestones: list[TimeLengthMilestone] = dataclasses.field(
        default_factory=list
    )

    def __post_init__(self):
        epochs = [m.epoch for m in self.milestones]
        if epochs != sorted(epochs):
            raise ValueError("milestones must be sorted by epoch")

    @classmethod
    def from_constant(cls, value: TimeLength) -> "TimeLengthSchedule":
        return cls(start_value=value, milestones=[])

    @property
    def is_constant(self) -> bool:
        return len(self.milestones) == 0 and (
            isinstance(self.start_value, int)
            or len(self.start_value.outcomes) == 1
        )

    def get_value(self, epoch: int) -> TimeLength:
        value = self.start_value
        for m in self.milestones:
            if epoch >= m.epoch:
                value = m.value
        return value

    @property
    def max_n_forward_steps(self) -> int:
        def _max(v):
            return v if isinstance(v, int) else v.max_n_forward_steps

        return max(
            _max(self.start_value), *[_max(m.value) for m in self.milestones]
        ) if self.milestones else _max(self.start_value)
