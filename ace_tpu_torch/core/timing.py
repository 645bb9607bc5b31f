"""Two-level cumulative wall-clock timers
(reference: fme/core/timing.py:41 GlobalTimer).

A copy of ``ace_tpu/core/timing.py`` (numpy on the host; tests hold it equal to
the original).
"""

import contextlib
import time
from collections import defaultdict


class GlobalTimer:
    """Singleton two-level (outer category + inner name) timer."""

    _instance: "GlobalTimer | None" = None

    def __init__(self):
        self._times: dict[str, float] = defaultdict(float)
        self._starts: dict[str, float] = {}

    @classmethod
    def get_instance(cls) -> "GlobalTimer":
        if cls._instance is None:
            cls._instance = GlobalTimer()
        return cls._instance

    @classmethod
    def reset(cls):
        cls._instance = None

    def start(self, name: str):
        if name in self._starts:
            raise RuntimeError(f"timer {name!r} already started")
        self._starts[name] = time.perf_counter()

    def stop(self, name: str):
        start = self._starts.pop(name)
        self._times[name] += time.perf_counter() - start

    @contextlib.contextmanager
    def context(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def get_duration(self, name: str) -> float:
        return self._times[name]

    def get_durations(self) -> dict[str, float]:
        return dict(self._times)

    def log_durations(self, logger=None):
        import logging

        logger = logger or logging.getLogger(__name__)
        for name, duration in sorted(self._times.items()):
            logger.info(f"{name}: {duration:.2f}s")
