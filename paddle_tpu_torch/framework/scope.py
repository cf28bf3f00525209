"""Scope: hierarchical name → value store.

≙ paddle_tpu/framework/scope.py (reference framework/scope.h:39). Values are
torch tensors on the executor's device; the executor updates read-write
state in place.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..core.enforce import NotFoundError


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Any] = {}
        self._parent = parent
        self._kids: List["Scope"] = []

    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def drop_kids(self):
        self._kids.clear()

    def set_var(self, name: str, value: Any):
        self._vars[name] = value

    def find_var(self, name: str):
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s._parent
        return None

    def has_var(self, name: str) -> bool:
        return self.find_var(name) is not None

    def get(self, name: str):
        v = self.find_var(name)
        if v is None:
            raise NotFoundError(f"variable {name!r} not found in scope")
        return v

    def erase(self, name: str):
        self._vars.pop(name, None)

    def local_var_names(self) -> List[str]:
        return list(self._vars)

    def __contains__(self, name):
        return self.has_var(name)


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def reset_global_scope():
    global _global_scope
    _global_scope = Scope()
