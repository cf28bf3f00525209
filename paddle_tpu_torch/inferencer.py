"""Inference API.

≙ paddle_tpu/inferencer.py (reference python/paddle/fluid/inferencer.py
and the C++ predictor interface, api/paddle_inference_api.h
PaddlePredictor, api/api_impl.cc:126 NativePaddlePredictor::Run). A
Predictor holds a loaded inference program and its scope with an Executor,
whose plan cache makes repeated `run` calls with the same shapes skip the
planning. The default place is CUDAPlace(0), which raises without a card.

`Predictor.from_exported` / `ExportedPredictor` serve a StableHLO export in
the JAX package; their counterpart (torch.export) is not ported: ROADMAP.md
§1 item 4.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from . import io as pio
from .core.enforce import InvalidArgumentError, enforce
from .framework.executor import Executor
from .framework.program import Program
from .framework.scope import Scope


class Predictor:
    """Load-and-run predictor (≙ NativePaddlePredictor)."""

    def __init__(self, model_dir: str, place=None,
                 scope: Optional[Scope] = None):
        self.scope = scope or Scope()
        self.executor = Executor(place)
        self.program, self.feed_names, self.fetch_names = \
            pio.load_inference_model(model_dir, executor=self.executor,
                                     scope=self.scope)

    def run(self, feed: Dict[str, Any],
            fetch_names: Optional[Sequence[str]] = None,
            return_numpy: bool = True) -> List[Any]:
        missing = set(self.feed_names) - set(feed)
        extra = {k for k in feed
                 if k not in self.feed_names and
                 not k.endswith("@SEQLEN")}
        enforce(not missing, f"missing feeds: {sorted(missing)}",
                exc=InvalidArgumentError)
        enforce(not extra, f"unexpected feeds: {sorted(extra)}",
                exc=InvalidArgumentError)
        return self.executor.run(program=self.program, feed=feed,
                                 fetch_list=list(fetch_names or
                                                 self.fetch_names),
                                 scope=self.scope,
                                 return_numpy=return_numpy)

    def clone(self) -> "Predictor":
        """≙ PaddlePredictor::Clone — share weights (scope), with a fresh
        executor and plan cache for another thread or stream of
        requests."""
        p = object.__new__(Predictor)
        p.scope = self.scope
        p.executor = Executor(self.executor.place)
        p.program = self.program
        p.feed_names = list(self.feed_names)
        p.fetch_names = list(self.fetch_names)
        return p

    @staticmethod
    def from_exported(model_dir: str) -> "ExportedPredictor":
        return ExportedPredictor(model_dir)


class ExportedPredictor:
    """Serves an exported artifact in the JAX package: not ported."""

    def __init__(self, model_dir: str):
        pio.load_exported_model(model_dir)


class Inferencer:
    """≙ fluid.Inferencer — high-level wrapper over Predictor."""

    def __init__(self, param_path: str, place=None,
                 scope: Optional[Scope] = None):
        self._predictor = Predictor(param_path, place=place, scope=scope)

    @property
    def program(self) -> Program:
        return self._predictor.program

    def infer(self, inputs: Dict[str, Any], return_numpy: bool = True):
        return self._predictor.run(inputs, return_numpy=return_numpy)
