"""Dataclass <-> plain-JSON codec.

The reference serializes its domain structs with codegen'd msgpack codecs
(nomad/structs/generate.sh) for the wire and BoltDB. Here one generic,
type-hint-driven codec covers both consumers: the client state DB
(client/state) and the HTTP API JSON bodies. Encoding is schema-less
(plain dicts); decoding walks the target dataclass's resolved type hints
so nested dataclasses, Optionals, Lists and Dicts round-trip.

The counterpart of `nomad_tpu.utils.codec`; in the port its consumer is
the raft log, whose entries carry wire payloads.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, Optional, Type, Union

_hints_cache: Dict[type, Dict[str, Any]] = {}


def to_wire(obj: Any) -> Any:
    """Encode dataclasses/containers into JSON-serializable plain data."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            out[f.name] = to_wire(getattr(obj, f.name))
        return out
    if isinstance(obj, dict):
        return {k: to_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_wire(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if isinstance(obj, bytes):
        import base64
        return {"__b64__": base64.b64encode(obj).decode("ascii")}
    if isinstance(obj, set):
        return sorted(to_wire(v) for v in obj)
    if hasattr(obj, "__dict__"):
        # plain-class structs (JobSummary, SchedulerConfiguration)
        return {k: to_wire(v) for k, v in vars(obj).items()
                if not k.startswith("_")}
    raise TypeError(f"cannot encode {type(obj).__name__}")


def _hints(cls: type) -> Dict[str, Any]:
    if cls not in _hints_cache:
        _hints_cache[cls] = typing.get_type_hints(cls)
    return _hints_cache[cls]


def from_wire(cls: Any, data: Any) -> Any:
    """Decode plain data into `cls` (a dataclass, container generic, or
    plain type). Unknown keys are ignored for forward compatibility."""
    if data is None:
        return None
    origin = typing.get_origin(cls)
    if origin is Union:                      # Optional[X] and unions
        args = [a for a in typing.get_args(cls) if a is not type(None)]
        if len(args) == 1:
            return from_wire(args[0], data)
        return data
    if origin in (list, tuple):
        (elem,) = typing.get_args(cls)[:1] or (Any,)
        return [from_wire(elem, v) for v in data]
    if origin is dict:
        args = typing.get_args(cls)
        val_t = args[1] if len(args) == 2 else Any
        return {k: from_wire(val_t, v) for k, v in data.items()}
    if origin is set:
        (elem,) = typing.get_args(cls)[:1] or (Any,)
        return {from_wire(elem, v) for v in data}
    if dataclasses.is_dataclass(cls):
        kwargs = {}
        hints = _hints(cls)
        field_names = {f.name for f in dataclasses.fields(cls)}
        for key, value in data.items():
            if key in field_names:
                kwargs[key] = from_wire(hints.get(key, Any), value)
        return cls(**kwargs)
    if cls is bytes:
        import base64
        if isinstance(data, dict) and "__b64__" in data:
            return base64.b64decode(data["__b64__"])
        return data.encode() if isinstance(data, str) else data
    if cls in (Any, object) or cls is None:
        return data
    if cls in (int, float, str, bool):
        # tolerate int-for-float and the like from JSON
        return cls(data) if data is not None else data
    return data
