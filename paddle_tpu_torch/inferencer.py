"""Inference API.

≙ paddle_tpu/inferencer.py (reference python/paddle/fluid/inferencer.py
and the C++ predictor interface, api/paddle_inference_api.h
PaddlePredictor, api/api_impl.cc:126 NativePaddlePredictor::Run). A
Predictor holds a loaded inference program and its scope with an Executor,
whose plan cache makes repeated `run` calls with the same shapes skip the
planning. The default place is CUDAPlace(0), which raises without a card.

`Predictor.from_exported` / `ExportedPredictor` serve the `torch.export`
archive that `io.export_inference_model` wrote (≙ the JAX package's
StableHLO artifact): cold, with no program, no op registry and no tracer.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from . import io as pio
from .core.enforce import InvalidArgumentError, enforce
from .core.places import resolve_device
from .framework.executor import Executor, as_numpy
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
    def from_exported(model_dir: str, place=None) -> "ExportedPredictor":
        """Cold-load the archive written by save_inference_model(...,
        export=True) for `place` (default CUDAPlace(0)). The returned
        predictor runs with no program, no op registry and no tracer
        (≙ the reference's C++ predictor loading a ProgramDesc+params dir,
        api_impl.cc:126)."""
        return ExportedPredictor(model_dir, place=place)


class ExportedPredictor:
    """Serve an exported inference function (see
    io.export_inference_model). Parameters travel inside the archive. A
    call is stateless, so one predictor serves every connection thread of
    a PredictorServer."""

    def __init__(self, model_dir: str, place=None):
        self._module, self.feed_names, self.fetch_names = \
            pio.load_exported_model(model_dir, place=place)
        self.device = resolve_device(place)

    def run(self, feed: Dict[str, Any],
            fetch_names: Optional[Sequence[str]] = None,
            return_numpy: bool = True) -> List[Any]:
        # same error contract as Predictor.run
        missing = set(self.feed_names) - set(feed)
        extra = set(feed) - set(self.feed_names)
        enforce(not missing, f"missing feeds: {sorted(missing)}",
                exc=InvalidArgumentError)
        enforce(not extra, f"unexpected feeds: {sorted(extra)}",
                exc=InvalidArgumentError)
        if fetch_names is not None:
            unknown = set(fetch_names) - set(self.fetch_names)
            enforce(not unknown,
                    f"unknown fetch names {sorted(unknown)}; exported "
                    f"fetches are {self.fetch_names}",
                    exc=InvalidArgumentError)
        with torch.no_grad():
            outs = self._module(*(self._feed(feed[n])
                                  for n in self.feed_names))
        if fetch_names is not None:
            index = {n: i for i, n in enumerate(self.fetch_names)}
            outs = [outs[index[n]] for n in fetch_names]
        if return_numpy:
            return [as_numpy(o) for o in outs]
        return list(outs)

    def _feed(self, v) -> torch.Tensor:
        t = torch.as_tensor(v) if not isinstance(v, torch.Tensor) else v
        if t.dtype == torch.float64:
            t = t.float()     # float feeds run in float32, as Executor's
        return t.to(self.device)


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
