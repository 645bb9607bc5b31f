"""The port's collectives, counted (port of ace_tpu/parallel/comm_stats.py).

``ace_tpu`` reads its collectives from the HLO text of a compiled program,
where XLA's SPMD partitioner placed them. The port compiles no HLO: every
collective it runs is a call of ``parallel/distributed.py``, which records
it here by kind (``all-reduce``, ``all-gather``, ``barrier``) with its
bytes (the output's, as ``ace_tpu`` counts them).
``ace_tpu``'s ``collective_byte_counts`` and ``compiled_collective_stats``
have no input in the port and are not carried.

The counts are process-wide, as the process group is: ``reset`` before a
phase, ``snapshot`` after it.
"""

from typing import Mapping

_COUNTS: dict[str, dict[str, int]] = {}


def record(kind: str, nbytes: int) -> None:
    """One collective of ``kind`` that moved ``nbytes``."""
    entry = _COUNTS.setdefault(kind, {"count": 0, "bytes": 0})
    entry["count"] += 1
    entry["bytes"] += int(nbytes)


def reset() -> None:
    _COUNTS.clear()


def snapshot() -> dict[str, dict[str, int]]:
    """The counts since the last ``reset``, by kind (a copy)."""
    return {k: dict(v) for k, v in _COUNTS.items()}


def format_comm_stats(stats: Mapping[str, Mapping[str, int]]) -> str:
    parts = [
        f"{k}:n={v['count']},MB={v['bytes'] / 1e6:.2f}"
        for k, v in sorted(stats.items())
    ]
    return " ".join(parts) if parts else "none"
