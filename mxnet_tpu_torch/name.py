"""``mx.name`` — symbol auto-naming scopes (counterpart of
``mxnet_tpu/name.py``): ``NameManager`` auto-suffixes op names, ``Prefix``
prepends.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]


class _State(threading.local):
    def __init__(self):
        self.current = None


_STATE = _State()


class NameManager:
    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name, hint):
        if name:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return f"{hint}{n}"

    def __enter__(self):
        self._old = _STATE.current
        _STATE.current = self
        return self

    def __exit__(self, *exc):
        _STATE.current = self._old

    @staticmethod
    def current_manager():
        if _STATE.current is None:
            _STATE.current = NameManager()
        return _STATE.current


class Prefix(NameManager):
    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)
