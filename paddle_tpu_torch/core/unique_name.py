"""Unique name generation for variables/ops.

≙ reference python/paddle/fluid/unique_name.py (UniqueNameGenerator + guard).
"""

from __future__ import annotations

import contextlib
from collections import defaultdict


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.ids = defaultdict(int)

    def __call__(self, key: str) -> str:
        tmp = self.ids[key]
        self.ids[key] += 1
        return f"{self.prefix}{key}_{tmp}"


_generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return _generator(key)


@contextlib.contextmanager
def guard(new_prefix: str = ""):
    """Fresh name namespace, e.g. for building independent programs in tests."""
    global _generator
    old = _generator
    _generator = UniqueNameGenerator(new_prefix)
    try:
        yield
    finally:
        _generator = old
