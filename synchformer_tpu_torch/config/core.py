"""Minimal YAML config system with interpolation and CLI dotlist merge (the
port's copy of synchformer_tpu/config/core.py:19-136).

``load_config(path)`` + ``merge_cli_overrides(cfg, ['a.b=1'])`` with string
interpolation ``${path.to.key}`` and the arithmetic resolver ``${add: a, b}``.
PyYAML is imported only where a YAML text is parsed (``load_config`` and the
CLI values), so that a config given as a Python dict needs no PyYAML.
"""
from __future__ import annotations

import copy
import re
from typing import Any, Iterable, List, Mapping, Union

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class Config(dict):
    """A nested dict with attribute access. Values resolve interpolations lazily."""

    def __init__(self, data: Mapping[str, Any] | None = None, _root: "Config" = None):
        super().__init__()
        self._root = _root if _root is not None else self
        for k, v in (data or {}).items():
            self[k] = self._wrap(v)

    def _wrap(self, v):
        if isinstance(v, Config):
            v._root = self._root
            return v
        if isinstance(v, Mapping):
            return Config(v, _root=self._root)
        if isinstance(v, list):
            return [self._wrap(x) for x in v]
        return v

    # -- attribute access --------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self[name] = self._wrap(value)

    def __getitem__(self, key):
        value = super().__getitem__(key)
        return self._resolve(value)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    # -- interpolation -----------------------------------------------------
    def _lookup(self, dotted: str) -> Any:
        node: Any = self._root
        for part in dotted.strip().split("."):
            node = node[part] if isinstance(node, dict) else getattr(node, part)
        return node

    def _resolve(self, value: Any) -> Any:
        if isinstance(value, str) and "${" in value:
            return self._resolve_str(value)
        return value

    def _resolve_str(self, s: str) -> Any:
        # whole-string interpolation keeps the referenced value's type
        m = _INTERP_RE.fullmatch(s)
        if m:
            return self._resolve_expr(m.group(1))
        return _INTERP_RE.sub(lambda mm: str(self._resolve_expr(mm.group(1))), s)

    def _resolve_expr(self, expr: str) -> Any:
        expr = expr.strip()
        if expr.startswith("add:"):
            terms = [t.strip() for t in expr[len("add:"):].split(",")]
            total: Union[int, float] = 0
            for t in terms:
                num = _number(t)
                total += self._lookup(t) if num is None else num
            return total
        return self._lookup(expr)

    # -- utilities -----------------------------------------------------------
    def to_dict(self, resolve: bool = True) -> dict:
        out = {}
        for k in super().keys():
            v = self[k] if resolve else super().__getitem__(k)
            if isinstance(v, Config):
                v = v.to_dict(resolve)
            elif isinstance(v, list):
                v = [x.to_dict(resolve) if isinstance(x, Config) else x for x in v]
            out[k] = v
        return out

    def clone(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict(resolve=False)))


def _number(term: str):
    """An int or float literal of an ``add:`` term, else None (a key)."""
    for cast in (int, float):
        try:
            return cast(term)
        except ValueError:
            pass
    return None


def load_config(path: str) -> Config:
    import yaml

    with open(path) as f:
        return Config(yaml.safe_load(f))


def _parse_value(raw: str) -> Any:
    import yaml

    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def merge_cli_overrides(cfg: Config, overrides: Iterable[str]) -> Config:
    """Apply ``key.path=value`` overrides (CLI wins; ref: main.py:26-28)."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got {item!r}")
        key, raw = item.split("=", 1)
        parts: List[str] = key.strip().split(".")
        node = cfg
        for part in parts[:-1]:
            if part not in node or not isinstance(dict.__getitem__(node, part), Config):
                node[part] = Config({}, _root=cfg)
            node = dict.__getitem__(node, part)
        node[parts[-1]] = node._wrap(_parse_value(raw.strip()))
    return cfg
