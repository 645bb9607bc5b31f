"""Wildcard rules over parameter names (port of ace_tpu/core/wildcard.py).

Rules are written against ``ace_tpu``'s names: the "/"-joined flax paths
of the parameter tree, such as ``params/block_0/filter/weight`` or
``params/encoder_0/kernel``. The port matches each rule on the flax name
of each ``state_dict`` entry (``utils/convert.py:flax_name``), so that one
YAML selects the same tensors in both packages, and a rule that matches
nothing raises in both.
"""

import re

import torch

from ace_tpu_torch.utils.convert import flax_name


class UnusedRuleError(ValueError):
    pass


def wildcard_match(pattern: str, name: str) -> bool:
    regex = pattern.replace(".", r"\.").replace("*", ".*")
    return bool(re.match(f"^{regex}$", name))


def _first_match(patterns: list[str], name: str) -> str | None:
    for pattern in patterns:
        if wildcard_match(pattern, name):
            return pattern
    return None


def param_names(state: dict[str, torch.Tensor]) -> list[str]:
    """The flax names of the entries of ``state`` (a ``state_dict``)."""
    return [flax_name(k, v) for k, v in state.items()]


def build_mask(state: dict[str, torch.Tensor],
               include: list[str] | None = None,
               exclude: list[str] | None = None) -> dict[str, bool]:
    """``{state_dict key: selected}``. With ``include``, only the entries
    whose flax name matches a rule are selected; with ``exclude``, all but
    those. Raises UnusedRuleError for a rule that matches nothing (except
    the "*" catch-all)."""
    if (include is None) == (exclude is None):
        raise ValueError("provide exactly one of include or exclude")
    rules = list(include if include is not None else exclude)
    remaining = set(rules) - {"*"}
    mask = {}
    for key, value in state.items():
        match = _first_match(rules, flax_name(key, value))
        if match is not None:
            remaining.discard(match)
        mask[key] = (match is not None) == (include is not None)
    if remaining:
        raise UnusedRuleError(
            f"rules match no parameters: {sorted(remaining)}; parameters: "
            f"{param_names(state)}"
        )
    return mask
