"""Shard → endpoint dispatch policies.

≙ paddle_tpu/transpiler/ps_dispatcher.py (reference python/paddle/fluid/
transpiler/ps_dispatcher.py: RoundRobin / HashName). The
DistributeTranspiler's planner assigns parameter shards to endpoints
through one of them. HashName is FNV-1a over the name's UTF-8 bytes, so
both packages send every name to the same endpoint.
"""

from __future__ import annotations

from typing import List, Sequence


class PSDispatcher:
    """Base dispatcher over a list of endpoints (≙ reference PSDispatcher)."""

    def __init__(self, pserver_endpoints: Sequence[str]):
        self._eps = list(pserver_endpoints)
        self._step = 0

    @property
    def eps(self) -> List[str]:
        return list(self._eps)

    def reset(self):
        self._step = 0

    def dispatch(self, varlist) -> List[str]:
        raise NotImplementedError


class RoundRobin(PSDispatcher):
    """≙ reference RoundRobin: cycle endpoints in order."""

    def dispatch(self, varlist) -> List[str]:
        out = []
        for _ in varlist:
            out.append(self._eps[self._step % len(self._eps)])
            self._step += 1
        return out


class HashName(PSDispatcher):
    """≙ reference HashName: stable assignment by name hash — a var always
    lands on the same endpoint regardless of dispatch order."""

    @staticmethod
    def _hash(name: str) -> int:
        # FNV-1a, 32 bits: the same in every process (builtin hash is
        # salted by PYTHONHASHSEED)
        h = 2166136261
        for ch in name.encode():
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return h

    def dispatch(self, varlist) -> List[str]:
        out = []
        for v in varlist:
            name = getattr(v, "name", None) or str(v)
            out.append(self._eps[self._hash(name) % len(self._eps)])
        return out
