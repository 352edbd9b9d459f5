"""Config system: YAML -> registered factories (port of
diner_tpu.core.config).

A config names what it builds with the declarative `module:` + `kwargs:`
shape of the reference's YAML files; `module` resolves against an explicit
registry, so a config file never runs an arbitrary import.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict

import yaml

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    """Decorator: register a class or factory under a stable config name."""
    def deco(obj):
        if name in _REGISTRY and _REGISTRY[name] is not obj:
            raise ValueError(f"duplicate registry name {name!r}")
        _REGISTRY[name] = obj
        return obj
    return deco


def resolve(name: str) -> Callable:
    """The factory registered as `name`, or as the last part of a dotted
    reference-style path."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    short = name.rsplit(".", 1)[-1]
    if short in _REGISTRY:
        return _REGISTRY[short]
    raise KeyError(f"{name!r} not registered; known: {sorted(_REGISTRY)}")


def build(conf: Dict[str, Any], **extra):
    """Instantiate {"module": name, "kwargs": {...}} from the registry."""
    kwargs = dict(conf.get("kwargs") or {})
    kwargs.update(extra)
    return resolve(conf["module"])(**kwargs)


def load_config(path) -> Dict[str, Any]:
    """The YAML file at `path`, as `yaml.safe_load` reads it."""
    with open(Path(path)) as f:
        return yaml.safe_load(f)
