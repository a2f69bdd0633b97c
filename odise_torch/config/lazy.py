"""Lazy, Python-native configuration (counterpart of
``odise_tpu/config/lazy.py``).

Configs are Python files that build trees of ``L(callable)(**kwargs)``
nodes, with ``${path}`` interpolation (absolute, relative with leading dots,
or embedded in a string), dotted overrides ``a.b.c=value`` and recursive
instantiation. Nodes are plain dict subclasses (``ConfigDict``), so a tree
is easy to walk and to dump; ``resolve()`` interpolates eagerly.
``get_config`` loads a file of the port's own config tree,
``odise_torch/configs/``.
"""

from __future__ import annotations

import ast
import builtins
import copy
import importlib
import os
import pydoc
import re
import uuid
from typing import Any, Callable

__all__ = [
    "L",
    "LazyObject",
    "ConfigDict",
    "load_config",
    "save_config",
    "apply_overrides",
    "resolve",
    "instantiate",
    "locate",
    "get_config",
]

_TARGET_KEY = "_target_"
_CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")


class ConfigDict(dict):
    """A dict with attribute access. The single node type for config trees."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name)

    def __deepcopy__(self, memo):
        out = type(self)()
        memo[id(self)] = out
        for k, v in self.items():
            # callables (classes/functions) are stored by reference, not copied
            if callable(v) and not isinstance(v, (dict, list)):
                out[k] = v
            else:
                out[k] = copy.deepcopy(v, memo)
        return out


class LazyObject(ConfigDict):
    """A ConfigDict carrying a ``_target_`` callable: instantiated lazily."""

    @property
    def target(self) -> Callable:
        return self[_TARGET_KEY]

    def __repr__(self):  # pragma: no cover - debugging aid
        t = self.get(_TARGET_KEY)
        name = getattr(t, "__name__", str(t))
        kw = {k: v for k, v in self.items() if k != _TARGET_KEY}
        return f"L({name})({kw})"


class _LazyCall:
    """``L(callable)(**kwargs) -> LazyObject`` (detectron2's ``LazyCall``)."""

    def __init__(self, target: Callable | str):
        if not (callable(target) or isinstance(target, str)):
            raise TypeError(f"L() target must be callable or dotted string, got {target!r}")
        self._target = target

    def __call__(self, **kwargs) -> LazyObject:
        obj = LazyObject(kwargs)
        obj[_TARGET_KEY] = self._target
        return obj


L = _LazyCall


def locate(name: str) -> Any:
    """Resolve a dotted name like ``odise_torch.models.odise.CategoryODISE``."""
    obj = pydoc.locate(name)
    if obj is None:
        # pydoc.locate fails on some nested attributes; do it manually
        parts = name.split(".")
        for i in range(len(parts) - 1, 0, -1):
            try:
                mod = importlib.import_module(".".join(parts[:i]))
            except ImportError:
                continue
            obj = mod
            for attr in parts[i:]:
                obj = getattr(obj, attr)
            return obj
        raise ImportError(f"Cannot locate {name!r}")
    return obj


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


def _lookup(root: Any, path_stack: list, expr: str):
    """Resolve an interpolation expression to (value, stack_at_value).

    ``${a.b.c}`` is absolute from the root. Leading dots make it relative
    (omegaconf semantics): ``${.x}`` = sibling in current node, ``${..x}`` =
    one level up, etc. The returned stack is the container chain at the
    *referenced* location, so chained interpolations resolve in the right
    frame (e.g. ``a.b = "${..c}"`` where ``c`` itself is ``"${..d}"``).
    """
    ndots = 0
    while ndots < len(expr) and expr[ndots] == ".":
        ndots += 1
    rest = expr[ndots:]
    keys = [k for k in rest.split(".") if k]
    if ndots == 0:
        node = root
        nstack = [root]
    else:
        # path_stack holds the chain of containers from root to current node.
        # ${.x} -> current node; ${..x} -> parent; ...
        idx = len(path_stack) - ndots
        if idx < 0:
            raise KeyError(f"Interpolation {expr!r} escapes config root")
        node = path_stack[idx]
        nstack = list(path_stack[: idx + 1])
    for k in keys:
        if isinstance(node, (list, tuple)):
            node = node[int(k)]
        else:
            node = node[k]
        if isinstance(node, (dict, list)):
            nstack.append(node)
    return node, nstack


_MAX_CHAIN = 100


def resolve(cfg: Any) -> Any:
    """Return a deep copy of ``cfg`` with all ``${...}`` interpolations resolved."""
    cfg = copy.deepcopy(cfg)

    def _resolve_node(node, stack, depth=0):
        if depth > _MAX_CHAIN:
            raise RecursionError(
                f"Interpolation chain too deep (cycle?) at {node!r}")
        if isinstance(node, str):
            m = _INTERP_RE.fullmatch(node)
            if m:
                val, vstack = _lookup(cfg, stack, m.group(1))
                if isinstance(val, str):
                    return _resolve_node(val, vstack, depth + 1)
                if isinstance(val, (dict, list)):
                    return _resolve_node(val, vstack[:-1], depth + 1)
                return val
            if _INTERP_RE.search(node):
                def sub(mm):
                    v, vstack = _lookup(cfg, stack, mm.group(1))
                    if isinstance(v, str):
                        v = _resolve_node(v, vstack, depth + 1)
                    return str(v)

                return _INTERP_RE.sub(sub, node)
            return node
        if isinstance(node, dict):
            new_stack = stack + [node]
            for k in list(node.keys()):
                if k == _TARGET_KEY:
                    continue
                node[k] = _resolve_node(node[k], new_stack, depth)
            return node
        if isinstance(node, list):
            new_stack = stack + [node]
            for i in range(len(node)):
                node[i] = _resolve_node(node[i], new_stack, depth)
            return node
        if isinstance(node, tuple):
            return tuple(_resolve_node(v, stack, depth) for v in node)
        return node

    return _resolve_node(cfg, [])


# ---------------------------------------------------------------------------
# Instantiation
# ---------------------------------------------------------------------------


def instantiate(cfg: Any, *, _resolved: bool = False) -> Any:
    """Recursively instantiate a config tree.

    LazyObjects become ``target(**instantiated_kwargs)``. Dicts/lists recurse.
    Everything else passes through.
    """
    if not _resolved and isinstance(cfg, (dict, list)):
        cfg = resolve(cfg)

    def _build(node):
        if isinstance(node, LazyObject) or (isinstance(node, dict) and _TARGET_KEY in node):
            target = node[_TARGET_KEY]
            if isinstance(target, str):
                target = locate(target)
            kwargs = {k: _build(v) for k, v in node.items() if k != _TARGET_KEY}
            return target(**kwargs)
        if isinstance(node, dict):
            return type(node)((k, _build(v)) for k, v in node.items())
        if isinstance(node, list):
            return [_build(v) for v in node]
        if isinstance(node, tuple):
            return tuple(_build(v) for v in node)
        return node

    return _build(cfg)


# ---------------------------------------------------------------------------
# Loading / saving / overrides
# ---------------------------------------------------------------------------


def _wrap(obj: Any) -> Any:
    """Convert plain dicts to ConfigDict recursively (lists in place)."""
    if isinstance(obj, LazyObject):
        for k, v in obj.items():
            if k != _TARGET_KEY:
                obj[k] = _wrap(v)
        return obj
    if isinstance(obj, ConfigDict):
        for k, v in obj.items():
            obj[k] = _wrap(v)
        return obj
    if isinstance(obj, dict):
        return ConfigDict((k, _wrap(v)) for k, v in obj.items())
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def load_config(path: str, keys: str | None = None) -> ConfigDict:
    """Execute a Python config file and return its top-level variables.

    As detectron2's ``LazyConfig.load``: the file is executed as a module; every
    top-level name not starting with ``_`` that holds config-like data is
    collected into the returned ConfigDict. Config files can compose via
    ``from odise_torch.config import get_config`` (model-zoo style).
    """
    path = os.path.abspath(path)
    with open(path) as f:
        src = f.read()
    module_name = "odise_cfg_" + uuid.uuid4().hex[:8]
    code = compile(src, path, "exec")
    namespace: dict = {
        "__file__": path,
        "__name__": module_name,
        "__builtins__": builtins,
    }
    exec(code, namespace)
    out = ConfigDict()
    for name, value in namespace.items():
        if name.startswith("_") or name in ("builtins",):
            continue
        if isinstance(value, (dict, list, int, float, str, bool, tuple, type(None))):
            out[name] = _wrap(value)
    if keys is not None:
        for k in keys.split("."):
            out = out[k]
    return out


def get_config(config_path: str) -> ConfigDict:
    """Load a file of the port's config tree (``odise_torch/configs``) by its
    path relative to that directory, e.g. ``"common/train.py"``."""
    path = os.path.normpath(os.path.join(_CONFIG_DIR, config_path))
    if not os.path.isfile(path):
        raise FileNotFoundError(f"Config {config_path!r} not found in {_CONFIG_DIR}")
    return load_config(path)


def _parse_value(text: str) -> Any:
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text  # bare string


def apply_overrides(cfg: ConfigDict, overrides: list[str]) -> ConfigDict:
    """Apply ``a.b.c=value`` CLI overrides in place (values literal_eval'd)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override {ov!r} is not of the form key=value")
        key, value = ov.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if isinstance(node, (list, tuple)):
                node = node[int(p)]
            elif p not in node:
                node[p] = ConfigDict()
                node = node[p]
            else:
                node = node[p]
        last = parts[-1]
        if isinstance(node, (list, tuple)):
            node[int(last)] = _parse_value(value)
        else:
            node[last] = _parse_value(value)
    return cfg


def _dump(node: Any, indent: int = 0) -> str:
    pad = "  " * indent
    if isinstance(node, dict):
        if _TARGET_KEY in node:
            t = node[_TARGET_KEY]
            tname = (
                t
                if isinstance(t, str)
                else f"{getattr(t, '__module__', '?')}.{getattr(t, '__qualname__', '?')}"
            )
            lines = [f"{pad}_target_: {tname}"]
        else:
            lines = []
        for k, v in node.items():
            if k == _TARGET_KEY:
                continue
            if isinstance(v, (dict, list)) and v:
                lines.append(f"{pad}{k}:")
                lines.append(_dump(v, indent + 1))
            else:
                lines.append(f"{pad}{k}: {v!r}")
        return "\n".join(lines)
    if isinstance(node, list):
        return "\n".join(
            f"{pad}- " + _dump(v, indent + 1).lstrip() if isinstance(v, (dict, list))
            else f"{pad}- {v!r}"
            for v in node
        )
    return f"{pad}{node!r}"


def save_config(cfg: ConfigDict, path: str) -> None:
    """Dump the config tree to a human-readable YAML-like file.

    The ``config.yaml`` backup ``default_setup`` writes. Not
    round-trippable: callable targets are written by dotted name.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(_dump(cfg) + "\n")
