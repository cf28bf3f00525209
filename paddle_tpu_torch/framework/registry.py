"""Op registry: op type → torch lowering.

≙ paddle_tpu/framework/registry.py. Each op registers ONE lowering: a plain
function `(ctx, ins, attrs) -> outs` over torch tensors, where `ins` and
`outs` map slot names to lists of tensors. The executor calls the lowerings
eagerly, op by op (lowering.py). Hand-written kernels sit behind the
lowerings that need them (fusion/decode_attention.py,
ops/flash_attention.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from ..core.enforce import AlreadyExistsError, NotFoundError

LowerFn = Callable[["LowerCtx", Dict[str, List[Any]], Dict[str, Any]],
                   Dict[str, List[Any]]]

# An infer_spec takes (ctx, in_shapes, in_dtypes, attrs) where in_shapes /
# in_dtypes mirror the lowering's ins layout (slot -> list of shape tuples /
# dtypes) and returns outs: slot -> list of (shape, dtype) pairs. `ctx` is
# an analysis.InferCtx. Most ops need none: the analyzer runs the lowering
# itself on meta tensors (framework/analysis.py), so the lowering IS the
# shape function; an explicit spec is for an op whose lowering cannot run
# on its own.
InferFn = Callable[[Any, Dict[str, List[tuple]], Dict[str, List[Any]],
                    Dict[str, Any]], Dict[str, List[tuple]]]


@dataclass
class OpDef:
    type: str
    lower: LowerFn
    # optional explicit shape/dtype rule; None = run the lowering on meta
    # tensors (framework/analysis.py infer_op)
    infer_spec: Optional[InferFn] = None


_OPS: Dict[str, OpDef] = {}


def register_op(op_type: str):
    """Decorator registering a lowering (≙ REGISTER_OPERATOR)."""

    def deco(fn: LowerFn) -> LowerFn:
        if op_type in _OPS:
            raise AlreadyExistsError(f"op {op_type!r} already registered")
        _OPS[op_type] = OpDef(op_type, fn)
        return fn

    return deco


def register_infer_spec(op_type: str):
    """Decorator attaching an explicit shape/dtype rule to a registered op
    (≙ the JAX package's, and the reference's InferShape functions)."""

    def deco(fn: InferFn) -> InferFn:
        op = _OPS.get(op_type)
        if op is None:
            raise NotFoundError(
                f"cannot attach infer_spec: op {op_type!r} not registered")
        if op.infer_spec is not None:
            raise AlreadyExistsError(
                f"op {op_type!r} already has an infer_spec")
        op.infer_spec = fn
        return fn

    return deco


# A shard rule maps an op's input shardings to its output shardings and
# records the collectives the tp rewrite must splice (framework/sharding.py
# ShardCtx): (sctx, in_specs, attrs) -> {slot: [spec, ...]}. A side table,
# as in the JAX package.
_SHARD_RULES: Dict[str, Any] = {}


def register_shard_spec(op_type: str):
    """Decorator registering the sharding-propagation rule for `op_type`
    (lives alongside register_infer_spec: how shardings flow through the
    op instead of shapes)."""

    def deco(fn):
        if op_type in _SHARD_RULES:
            raise AlreadyExistsError(
                f"op {op_type!r} already has a shard-propagation rule")
        _SHARD_RULES[op_type] = fn
        return fn

    return deco


def lookup_shard_rule(op_type: str):
    """The registered shard-propagation rule for `op_type`, or None."""
    return _SHARD_RULES.get(op_type)


# An effect rule refines the dataflow effect set of one op
# (framework/dataflow.py): (op) -> dict with any of the keys
#   collective_axes: mesh axes the op communicates over,
#   rng:             True when the op draws per-step randomness,
#   inplace:         ((in_name, out_name), ...) aliased buffer pairs beyond
#                    the same-name read+write default.
# reads/writes always derive from op.inputs/op.outputs; rules only ADD what
# the slot lists cannot express. A side table, as in the JAX package.
_EFFECT_RULES: Dict[str, Any] = {}


def register_effects(op_type: str):
    """Decorator registering the dataflow effect rule for `op_type`."""

    def deco(fn):
        if op_type in _EFFECT_RULES:
            raise AlreadyExistsError(
                f"op {op_type!r} already has an effect rule")
        _EFFECT_RULES[op_type] = fn
        return fn

    return deco


def lookup_effect_rule(op_type: str):
    """The registered effect rule for `op_type`, or None (pure compute:
    reads its inputs, writes its outputs, no collectives, no rng). The
    builtin op modules register theirs on import."""
    _ensure_builtin_ops()
    return _EFFECT_RULES.get(op_type)


def lookup_op(op_type: str) -> OpDef:
    op = _OPS.get(op_type)
    if op is None:
        # the builtin op modules self-register on import
        _ensure_builtin_ops()
        op = _OPS.get(op_type)
    if op is None:
        raise NotFoundError(f"no op registered with type {op_type!r}; "
                            f"known ops: {sorted(_OPS)}")
    return op


def registered_ops() -> List[str]:
    _ensure_builtin_ops()
    return sorted(_OPS)


_builtins_loaded = False


def _ensure_builtin_ops():
    global _builtins_loaded
    if _builtins_loaded:
        return
    _builtins_loaded = True
    # import for registration side effects
    from ..ops import (beam_search_ops, control_ops,  # noqa: F401
                       detection_ops, elementwise, flash_attention,
                       loss_ops, metric_ops, nn_ops, optimizer_ops,
                       random_ops, reduce_ops, sequence_label_ops,
                       sequence_ops, tensor_ops)
    from ..fusion import decode_attention, recurrent  # noqa: F401
    from . import lowering  # noqa: F401  (the vjp_region entry)


@dataclass
class LowerCtx:
    """Per-run context handed to lowerings (≙ ExecutionContext).

    device: where the run's tensors live; ops that create tensors from
        attributes (fill_constant, assign_value, random ops) allocate there.
    seed: the run's seed; `generator()` draws from one torch.Generator on
        `device` seeded with it, created on first use.
    op: the Operator being lowered (set by `run_op`), so a lowering can
        tell whether its output variable is the one it reads.
    constants: memo of attribute-built tensors, shared by every run of one
        plan (the executor passes the plan's), so a constant table is built
        and copied to the device once, not per run.
    fetch_names: the run's fetch list.
    is_test: inference mode for the whole run (dropout scales instead of
        drawing), besides each op's own `is_test` attr.
    read_names: every variable the plan reads or the run fetches or keeps
        as state, or None (unknown: every output is needed). A lowering
        skips an optional output nobody reads (`needed`), as XLA drops dead
        code in the JAX package.
    extras: run-wide values for lowerings; the executor sets "program" to
        the program it planned (the fused clone), whose blocks a
        control-flow op's `sub_block` attribute indexes.
    recomputing: True while a rematerialized forward runs again inside
        autograd's backward (lowering.py `_checkpointed`).
    deferred: under remat, the persistable-state updates of the region's
        forward, run once after its backward (`update_state`).
    exporting: the run is traced into a graph (io.export_train_program):
        `generator()` gives None, so draws come from the process's default
        generator, which whoever runs the graph seeds for the step (a
        traced graph cannot hold a seeded torch.Generator).
    """
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    seed: int = 0
    op: Any = None
    constants: dict = field(default_factory=dict)
    fetch_names: tuple = ()
    is_test: bool = False
    read_names: Optional[frozenset] = None
    extras: dict = field(default_factory=dict)
    recomputing: bool = False
    deferred: Optional[list] = None
    exporting: bool = False
    _generator: Optional[torch.Generator] = None
    _rng_counter: int = 0

    def generator(self, seed: int = 0) -> torch.Generator:
        """A fixed-seed generator when `seed` is nonzero (an op's own seed
        attr), else the run's shared generator; None under `exporting`."""
        if self.exporting:
            return None
        if seed:
            return torch.Generator(device=self.device).manual_seed(seed)
        if self._generator is None:
            self._generator = torch.Generator(
                device=self.device).manual_seed(self.seed)
        return self._generator

    def next_key(self) -> int:
        """A fresh seed from the run's seed, one per call (≙ the JAX
        package's `next_key`, which splits the run's PRNG key): for a
        lowering that needs a generator of its own."""
        self._rng_counter += 1
        return (self.seed * 1000003 + self._rng_counter) % 2147483648

    def writes_input(self, in_slot: str, out_slot: str) -> bool:
        """True when the current op's `out_slot` names the same variable as
        its `in_slot`: the op rebinds the variable it reads, so the lowering
        may update that tensor in place."""
        op = self.op
        return (op is not None and bool(op.inputs.get(in_slot))
                and op.inputs.get(in_slot) == op.outputs.get(out_slot))

    def update_state(self, fn: Callable[[], Any]):
        """Run `fn`, an in-place update of persistable state, once a step:
        now, or under remat after the region's backward, so that the
        forward and its recompute read the same state and the update is
        not applied twice."""
        if self.deferred is None:
            fn()
        elif not self.recomputing:
            self.deferred.append(fn)

    def needed(self, name: str) -> bool:
        """Whether anything reads variable `name` after the op makes it."""
        return self.read_names is None or name in self.read_names

    def constant(self, make: Callable[[], Any]) -> Any:
        """The current op's attribute-built output (a tensor, or a tuple of
        them), made once per plan.
        Only ops writing non-persistable variables are memoized: a
        persistable output may later be updated in place."""
        op = self.op
        if op is None or any(
                op.block.has_var(n) and op.block.var(n).persistable
                for n in op.output_names()):
            return make()
        key = id(op)
        t = self.constants.get(key)
        if t is None:
            t = self.constants[key] = make()
        return t
