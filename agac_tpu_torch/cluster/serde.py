"""Wire serialization for typed objects.

The generic replacement for the reference's ~1,571 LoC of
code-generator output (SURVEY.md §2 row 17): every kind here is a
dataclass whose fields are snake_case in Python and camelCase on the
wire; ``to_wire``/``from_wire`` convert recursively using the
dataclass type hints, so new kinds (including CRDs) need no generated
clients — registering the dataclass is enough.

Conventions:
- ``None`` fields and empty collections are omitted from wire dicts
  (matching ``json:",omitempty"`` in the reference's Go types).
- A field may override its wire name via
  ``field(metadata={"wire": "name"})``.
- Unknown wire keys are ignored on decode (forward compatibility).
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Type, TypeVar, get_args, get_origin, get_type_hints

T = TypeVar("T")

_hints_cache: dict[type, dict[str, Any]] = {}  # agac-lint: ignore[shared-state-census] -- idempotent get_type_hints memo; racing writers store identical values


def _snake_to_camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(part.title() for part in rest)


def _wire_name(f: dataclasses.Field) -> str:
    return f.metadata.get("wire", _snake_to_camel(f.name))


def _type_hints(cls: type) -> dict[str, Any]:
    if cls not in _hints_cache:
        _hints_cache[cls] = get_type_hints(cls)
    return _hints_cache[cls]


def to_wire(obj: Any) -> Any:
    """Recursively convert a dataclass instance to a wire-format dict."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            value = getattr(obj, f.name)
            if value is None:
                continue
            if isinstance(value, (list, dict)) and not value:
                continue
            out[_wire_name(f)] = to_wire(value)
        return out
    if isinstance(obj, list):
        return [to_wire(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_wire(v) for k, v in obj.items()}
    return obj


def _unwrap_optional(hint: Any) -> Any:
    if get_origin(hint) in (typing.Union, getattr(__import__("types"), "UnionType", ())):
        args = [a for a in get_args(hint) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return hint


def _decode(hint: Any, value: Any) -> Any:
    hint = _unwrap_optional(hint)
    origin = get_origin(hint)
    if value is None:
        return None
    if dataclasses.is_dataclass(hint):
        return from_wire(hint, value)
    if origin is list:
        (item_hint,) = get_args(hint) or (Any,)
        return [_decode(item_hint, v) for v in value]
    if origin is dict:
        args = get_args(hint)
        value_hint = args[1] if len(args) == 2 else Any
        return {k: _decode(value_hint, v) for k, v in value.items()}
    return value


def from_wire(cls: Type[T], data: dict | None) -> T:
    """Build a dataclass instance of ``cls`` from a wire-format dict.

    Missing keys fall back to the dataclass defaults; unknown keys are
    ignored.
    """
    data = data or {}
    hints = _type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        wire = _wire_name(f)
        if wire in data:
            kwargs[f.name] = _decode(hints[f.name], data[wire])
    return cls(**kwargs)
