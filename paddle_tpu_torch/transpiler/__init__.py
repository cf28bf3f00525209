"""Program-rewrite layer (≙ paddle_tpu/transpiler; reference python/paddle/
fluid/transpiler/):

- `memory_optimize` / `release_memory`: rematerialization and live-out
  narrowing of the autodiff region;
- `InferenceTranspiler`: batch norm folded into the conv / fc before it,
  a program and scope rewrite (the `bn_fold_pass`);
- `QuantizeTranspiler`: fake-quantize ops for quantization-aware training
  and the weight freeze (the `quant_freeze_pass`);
- `DistributeTranspiler` with `slice_variable` and the `PSDispatcher`
  policies: the parameter-shard planner, whose per-endpoint pserver
  programs run the optimizer on flat shards.
"""

from .memory_optimization import memory_optimize, release_memory
from .inference_transpiler import InferenceTranspiler
from .quantize_transpiler import QuantizeTranspiler
from .distribute_transpiler import (DistributeTranspiler,
                                    DistributeTranspilerConfig, slice_variable)
from .ps_dispatcher import HashName, PSDispatcher, RoundRobin

__all__ = [
    "memory_optimize", "release_memory", "InferenceTranspiler",
    "QuantizeTranspiler", "DistributeTranspiler",
    "DistributeTranspilerConfig", "slice_variable",
    "PSDispatcher", "RoundRobin", "HashName",
]
