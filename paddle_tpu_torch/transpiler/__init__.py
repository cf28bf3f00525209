"""Program-rewrite layer (≙ paddle_tpu/transpiler), trimmed to the
memory-optimization transpiler: `memory_optimize` (rematerialization and
live-out narrowing of the autodiff region) and `release_memory`
(live-out narrowing alone)."""

from .memory_optimization import memory_optimize, release_memory

__all__ = ["memory_optimize", "release_memory"]
