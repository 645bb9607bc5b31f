"""Strict dict -> dataclass config construction.

The reference uses ``dacite.from_dict(..., strict=True)`` at every entry
point (reference: fme/ace/train/train.py:97, fme/core/cli.py:82). dacite is
not a dependency, so this module implements the same contract natively:

- every key in the input dict must correspond to a dataclass field
  (unknown keys are errors),
- nested dataclasses, Optional/Union, Literal, list/tuple/dict generics and
  enums are constructed recursively,
- missing keys fall back to field defaults; missing required keys are errors.
"""

import dataclasses
import enum
import types
import typing
from typing import Any, TypeVar, Union

T = TypeVar("T")


class ConfigError(ValueError):
    """Raised when a config dict cannot be converted to its dataclass."""


def _type_name(tp: Any) -> str:
    return getattr(tp, "__name__", str(tp))


def _is_union(tp: Any) -> bool:
    origin = typing.get_origin(tp)
    return origin is Union or origin is types.UnionType


def _build_value(tp: Any, value: Any, path: str) -> Any:
    if tp is Any or tp is dataclasses.MISSING:
        return value
    if tp is None or tp is type(None):
        if value is not None:
            raise ConfigError(f"{path}: expected None, got {value!r}")
        return None

    origin = typing.get_origin(tp)

    if _is_union(tp):
        args = typing.get_args(tp)
        if value is None:
            if type(None) in args:
                return None
            raise ConfigError(f"{path}: got None for non-optional {tp}")
        errors = []
        # Try dataclass members first when the value is a dict: strict
        # matching makes the first success unambiguous in practice.
        ordered = sorted(
            (a for a in args if a is not type(None)),
            key=lambda a: 0 if dataclasses.is_dataclass(a) else 1,
        )
        for arg in ordered:
            try:
                return _build_value(arg, value, path)
            except (ConfigError, TypeError, ValueError) as e:
                errors.append(f"{_type_name(arg)}: {e}")
        raise ConfigError(
            f"{path}: value {value!r} does not match any member of {tp} "
            f"({'; '.join(errors)})"
        )

    if origin is typing.Literal:
        if value not in typing.get_args(tp):
            raise ConfigError(
                f"{path}: {value!r} is not one of {typing.get_args(tp)}"
            )
        return value

    if dataclasses.is_dataclass(tp) and isinstance(tp, type):
        if isinstance(value, tp):
            return value
        if not isinstance(value, dict):
            raise ConfigError(
                f"{path}: expected mapping for {_type_name(tp)}, got {value!r}"
            )
        return from_dict(tp, value, _path=path)

    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        if isinstance(value, tp):
            return value
        return tp(value)

    if origin in (list, typing.Sequence, tuple) or tp in (list, tuple):
        args = typing.get_args(tp)
        if not isinstance(value, (list, tuple)):
            raise ConfigError(f"{path}: expected sequence, got {value!r}")
        if origin is tuple or tp is tuple:
            if args and args[-1] is not Ellipsis and len(args) == len(value):
                out = tuple(
                    _build_value(a, v, f"{path}[{i}]")
                    for i, (a, v) in enumerate(zip(args, value))
                )
            else:
                elem = args[0] if args else Any
                out = tuple(
                    _build_value(elem, v, f"{path}[{i}]")
                    for i, v in enumerate(value)
                )
            return out
        elem = args[0] if args else Any
        return [
            _build_value(elem, v, f"{path}[{i}]") for i, v in enumerate(value)
        ]

    if origin in (dict, typing.Mapping) or tp is dict:
        if not isinstance(value, dict):
            raise ConfigError(f"{path}: expected mapping, got {value!r}")
        args = typing.get_args(tp)
        if args:
            kt, vt = args
            return {
                _build_value(kt, k, f"{path}.key"): _build_value(
                    vt, v, f"{path}[{k!r}]"
                )
                for k, v in value.items()
            }
        return dict(value)

    # scalar leaf types
    if tp is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ConfigError(f"{path}: expected float, got {value!r}")
        return float(value)
    if tp is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ConfigError(f"{path}: expected int, got {value!r}")
        return value
    if tp is bool:
        if not isinstance(value, bool):
            raise ConfigError(f"{path}: expected bool, got {value!r}")
        return value
    if tp is str:
        if not isinstance(value, str):
            raise ConfigError(f"{path}: expected str, got {value!r}")
        return value

    if isinstance(tp, type):
        if isinstance(value, tp):
            return value
        raise ConfigError(
            f"{path}: expected {_type_name(tp)}, got {type(value).__name__}"
        )
    return value


def from_dict(cls: type[T], data: dict[str, Any], _path: str = "") -> T:
    """Build dataclass ``cls`` from ``data``, strictly.

    Unknown keys and type mismatches raise ``ConfigError`` with a dotted path
    to the offending entry.
    """
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls} is not a dataclass")
    if not isinstance(data, dict):
        raise ConfigError(f"{_path or cls.__name__}: expected mapping, got {data!r}")
    try:
        hints = typing.get_type_hints(cls)
    except Exception:
        hints = {f.name: f.type for f in dataclasses.fields(cls)}
    field_map = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(field_map)
    if unknown:
        raise ConfigError(
            f"{_path or cls.__name__}: unknown keys {sorted(unknown)}; "
            f"allowed: {sorted(field_map)}"
        )
    kwargs = {}
    for name, field in field_map.items():
        if not field.init:
            continue
        fpath = f"{_path}.{name}" if _path else f"{cls.__name__}.{name}"
        if name in data:
            kwargs[name] = _build_value(hints.get(name, field.type), data[name], fpath)
        elif (
            field.default is dataclasses.MISSING
            and field.default_factory is dataclasses.MISSING
        ):
            raise ConfigError(f"{fpath}: missing required key")
    return cls(**kwargs)


def to_dict(obj: Any) -> Any:
    """Recursively convert a dataclass tree to plain dicts/lists for YAML or
    checkpoint embedding (inverse of :func:`from_dict` for plain configs).
    """
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: to_dict(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if f.init
        }
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    return obj


def update_dict_with_dotlist(
    data: dict[str, Any], dotlist: list[str] | None
) -> dict[str, Any]:
    """Apply ``--override a.b.c=value`` dotlist entries onto a nested dict
    (reference: fme/core/config.py:7).

    Values are parsed as YAML scalars (so ``1`` is an int, ``true`` a bool).
    """
    import yaml

    if not dotlist:
        return data
    for item in dotlist:
        if "=" not in item:
            raise ConfigError(f"dotlist entry {item!r} must be KEY=VALUE")
        key, value_str = item.split("=", 1)
        value = yaml.safe_load(value_str)
        node = data
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ConfigError(f"dotlist key {key!r}: {part!r} is not a mapping")
        node[parts[-1]] = value
    return data
