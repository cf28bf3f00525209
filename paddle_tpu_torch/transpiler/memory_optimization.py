"""Memory-optimization transpiler.

≙ paddle_tpu/transpiler/memory_optimization.py (reference python/paddle/
fluid/transpiler/memory_optimization_transpiler.py: ControlFlowGraph :47,
memory_optimize :381, release_memory :400). The programs it writes are the
JAX package's, attr for attr; the port's executor carries them out:

1. **Rematerialization**: the vjp region's forward runs under
   torch.utils.checkpoint, so autograd's backward recomputes activations
   instead of keeping them (lowering.py `_checkpointed`). `level` selects
   the policy: 0 keeps the outputs of matrix products without batch dims
   (aten.mm / addmm), 1 keeps nothing.
2. **Live-out narrowing**: a liveness pass over the program (the
   ControlFlowGraph analogue) finds which forward vars are read *after*
   the autodiff region (metrics, fetches, optimizer inputs); the region
   publishes only those, and the rest are freed with the step's autograd
   graph.
"""

from __future__ import annotations

from typing import Optional, Sequence, Set

from ..framework.program import Program

# level → the JAX package's jax.checkpoint policy name, which the port maps
# to a selective checkpoint policy (None = save nothing, full remat)
_LEVELS = {
    0: "dots_with_no_batch_dims_saveable",  # save matmul outputs (cheap)
    1: None,                                # full remat: max memory savings
}


def _liveness_after_region(block, region_idx: int, seg: Sequence[int],
                           fetch_names: Set[str]) -> Set[str]:
    """Names read by any op after the region (skipping the region's own
    consumed forward ops) plus fetch targets — the region's live-out set
    (≙ ControlFlowGraph liveness, memory_optimization_transpiler.py:47)."""
    consumed = set(seg)
    live: Set[str] = set(fetch_names)
    for j, op in enumerate(block.ops):
        if j == region_idx or j in consumed:
            continue
        if j > min(seg):  # anything at/after the region's execution point
            live |= set(op.input_names())
    # persistable vars written inside the region (batch-norm moving stats,
    # moving quant scales) must survive: the executor writes them back to
    # the scope even though no later op reads them
    for j in seg:
        for name in block.ops[j].output_names():
            var = block.vars.get(name)
            if var is not None and getattr(var, "persistable", False):
                live.add(name)
    return live


def memory_optimize(input_program: Program,
                    skip_opt_set: Optional[Sequence[str]] = None,
                    print_log: bool = False,
                    level: int = 0) -> Program:
    """Rewrite `input_program` in place to reduce peak device memory.

    ≙ reference memory_optimize (memory_optimization_transpiler.py:381).
    level 0: remat everything except the outputs of matrix products
             without batch dims (recomputing elementwise chains is cheap;
             the products are not).
    level 1: full rematerialization (maximum memory savings).
    skip_opt_set: var names that must stay available after the step even if
             liveness says otherwise (≙ reference skip_opt_set).
    """
    if level not in _LEVELS:
        raise ValueError(f"memory_optimize level must be one of "
                         f"{sorted(_LEVELS)}, got {level!r}")
    skip = set(skip_opt_set or ())
    for block in input_program.blocks:
        for i, op in enumerate(block.ops):
            if op.type != "vjp_region":
                continue
            op.attrs["remat"] = True
            policy = _LEVELS[level]
            if policy is not None:
                op.attrs["remat_policy"] = policy
            else:
                op.attrs.pop("remat_policy", None)
            seg = op.attrs.get("fwd_ops") or []
            if seg:
                live = _liveness_after_region(
                    block, i, seg, fetch_names=skip)
                # loss + anything liveness found + explicit keeps
                live.add(op.attrs["loss"])
                op.attrs["live_out"] = sorted(live)
            if print_log:
                kept = len(op.attrs.get("live_out", []))
                print(f"memory_optimize: region@{i} remat="
                      f"{_LEVELS[level] or 'full'} live_out={kept} vars")
    input_program._bump()
    return input_program


def release_memory(input_program: Program,
                   skip_opt_set: Optional[Sequence[str]] = None) -> Program:
    """Narrow region live-outs without enabling remat.

    ≙ reference release_memory (memory_optimization_transpiler.py:400), which
    inserts delete_var ops for dead vars. Here dead forward vars are simply
    not published from the autodiff region, and are freed with its graph.
    """
    skip = set(skip_opt_set or ())
    for block in input_program.blocks:
        for i, op in enumerate(block.ops):
            if op.type != "vjp_region":
                continue
            seg = op.attrs.get("fwd_ops") or []
            if seg:
                live = _liveness_after_region(block, i, seg, fetch_names=skip)
                live.add(op.attrs["loss"])
                op.attrs["live_out"] = sorted(live)
    input_program._bump()
    return input_program
