"""``mx.registry``: generic named-class registries (counterpart of
``mxnet_tpu/registry.py``). ``get_register_func``, ``get_alias_func`` and
``get_create_func`` build a registry for any base class, so user code can
keep its own, as the optimizer, initializer and metric registries do.
"""
from __future__ import annotations

from typing import Dict, Type

__all__ = ["get_register_func", "get_alias_func", "get_create_func"]

_REGISTRIES: Dict[type, Dict[str, type]] = {}


def _registry(base_class) -> Dict[str, type]:
    return _REGISTRIES.setdefault(base_class, {})


def get_register_func(base_class, nickname):
    """Returns a ``register(cls, name=None)`` decorator for ``base_class``."""
    reg = _registry(base_class)

    def register(klass: Type, name=None):
        if not issubclass(klass, base_class):
            raise TypeError(
                f"cannot register {klass.__name__}: not a subclass of "
                f"{base_class.__name__}")
        reg[(name or klass.__name__).lower()] = klass
        return klass

    register.__name__ = f"register_{nickname}"
    return register


def get_alias_func(base_class, nickname):
    """Returns an ``alias(*names)`` class decorator."""
    reg = _registry(base_class)

    def alias(*names):
        def deco(klass):
            for n in names:
                reg[n.lower()] = klass
            return klass
        return deco

    alias.__name__ = f"alias_{nickname}"
    return alias


def get_create_func(base_class, nickname):
    """Returns ``create(name_or_instance, *args, **kwargs)``. Accepts an
    instance (passthrough), a registered name, or ``"name, k=v"`` strings
    (the reference's optimizer-string form)."""
    reg = _registry(base_class)

    def create(obj, *args, **kwargs):
        if isinstance(obj, base_class):
            return obj
        if not isinstance(obj, str):
            raise TypeError(f"need a {nickname} name or instance, got "
                            f"{type(obj).__name__}")
        name, _, tail = obj.partition(",")
        for kv in filter(None, (p.strip() for p in tail.split(","))):
            k, _, v = kv.partition("=")
            try:
                kwargs[k.strip()] = float(v) if "." in v or "e" in v.lower() \
                    else int(v)
            except ValueError:
                kwargs[k.strip()] = v.strip()
        key = name.strip().lower()
        if key not in reg:
            raise ValueError(
                f"unknown {nickname} {name!r}; registered: {sorted(reg)}")
        return reg[key](*args, **kwargs)

    create.__name__ = f"create_{nickname}"
    return create
