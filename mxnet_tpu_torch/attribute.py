"""``mx.attribute.AttrScope`` — scoped symbol attributes (counterpart of
``mxnet_tpu/attribute.py``): symbols created inside the scope inherit its
attrs (the mechanism behind ``__ctx_group__`` placement and lr_mult
annotations).
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current", "attr_scope"]


class _State(threading.local):
    def __init__(self):
        self.attrs = {}


_STATE = _State()


class AttrScope:
    def __init__(self, **attrs):
        for v in attrs.values():
            if not isinstance(v, str):
                raise ValueError("attributes must be strings")
        self._attrs = attrs

    def get(self, attrs=None):
        """Merge scope attrs into ``attrs`` (reference AttrScope.get)."""
        out = dict(_STATE.attrs)
        if attrs:
            out.update(attrs)
        return out

    def __enter__(self):
        self._saved = dict(_STATE.attrs)
        _STATE.attrs = {**_STATE.attrs, **self._attrs}
        return self

    def __exit__(self, *exc):
        _STATE.attrs = self._saved


def current():
    return dict(_STATE.attrs)


attr_scope = AttrScope
