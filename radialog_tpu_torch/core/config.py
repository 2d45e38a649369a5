"""Configuration (port of radialog_tpu/core/config.py, a copy): ``Config``,
a nested attribute dict built from defaults, YAML files (``yaml`` imported
when called) and ``key.path=value`` dotlist overrides (the reference's
``--options`` syntax); ``register`` / ``get_registered``, a name -> object
registry; ``freeze_dict``.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

_REGISTRY: Dict[str, Dict[str, Any]] = {}


def register(kind: str, name: str) -> Callable[[Any], Any]:
    """Decorator: register ``obj`` under (kind, name). Mirrors
    registry.register_model / register_task etc. in the reference."""

    def deco(obj: Any) -> Any:
        _REGISTRY.setdefault(kind, {})
        if name in _REGISTRY[kind] and _REGISTRY[kind][name] is not obj:
            raise KeyError(f"{kind}:{name} already registered")
        _REGISTRY[kind][name] = obj
        return obj

    return deco


def get_registered(kind: str, name: str) -> Any:
    try:
        return _REGISTRY[kind][name]
    except KeyError:
        known = sorted(_REGISTRY.get(kind, {}))
        raise KeyError(f"unknown {kind} '{name}'; registered: {known}") from None


def _parse_scalar(text: str) -> Any:
    t = text.strip()
    low = t.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none"):
        return None
    for caster in (int, float):
        try:
            return caster(t)
        except ValueError:
            pass
    if t.startswith(("[", "{")):
        try:
            return json.loads(t)
        except json.JSONDecodeError:
            pass
    return t


class Config:
    """Nested attribute-access config.

    >>> c = Config({"model": {"dim": 8}})
    >>> c.model.dim
    8
    >>> c.apply_overrides(["model.dim=16", "run.lr=1e-4"]).model.dim
    16
    """

    def __init__(self, data: Optional[Mapping[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = Config(v) if isinstance(v, Mapping) else v

    # -- attribute / item protocol -------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = Config(value) if isinstance(value, Mapping) else value

    __getitem__ = __getattr__
    __setitem__ = __setattr__

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        if isinstance(other, Mapping):
            return self.to_dict() == dict(other)
        return NotImplemented

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self._data.items():
            out[k] = v.to_dict() if isinstance(v, Config) else v
        return out

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))

    # -- construction helpers ------------------------------------------------------
    def merge(self, other: Mapping[str, Any] | "Config") -> "Config":
        """Deep-merge ``other`` into a copy of self (other wins)."""
        merged = self.copy()
        items = other.items() if hasattr(other, "items") else dict(other).items()
        for k, v in items:
            cur = merged.get(k)
            if isinstance(cur, Config) and isinstance(v, (Mapping, Config)):
                merged[k] = cur.merge(v)
            else:
                merged[k] = copy.deepcopy(v.to_dict() if isinstance(v, Config) else v)
        return merged

    def apply_overrides(self, dotlist: Iterable[str]) -> "Config":
        """Apply ``a.b.c=value`` overrides (reference --options syntax)."""
        out = self.copy()
        for item in dotlist or []:
            if "=" not in item:
                raise ValueError(f"override '{item}' is not key=value")
            path, _, raw = item.partition("=")
            keys = path.strip().split(".")
            node = out
            for k in keys[:-1]:
                nxt = node.get(k)
                if not isinstance(nxt, Config):
                    nxt = Config()
                    node[k] = nxt
                node = nxt
            node[keys[-1]] = _parse_scalar(raw)
        return out

    @classmethod
    def from_yaml(cls, path: str | os.PathLike) -> "Config":
        import yaml

        with open(path) as f:
            return cls(yaml.safe_load(f) or {})

    @classmethod
    def from_files(cls, *paths: str, overrides: Optional[Iterable[str]] = None) -> "Config":
        cfg = cls()
        for p in paths:
            cfg = cfg.merge(cls.from_yaml(p))
        if overrides:
            cfg = cfg.apply_overrides(overrides)
        return cfg


def freeze_dict(d: Mapping[str, Any]) -> tuple:
    """Recursively convert a mapping to a hashable tuple."""
    out = []
    for k in sorted(d.keys()):
        v = d[k]
        if isinstance(v, (Mapping, Config)):
            v = freeze_dict(v if isinstance(v, Mapping) else v.to_dict())
        elif isinstance(v, list):
            v = tuple(v)
        out.append((k, v))
    return tuple(out)
