"""Program IR: Program / Block / Operator / Variable / Parameter.

≙ paddle_tpu/framework/program.py (itself ≙ the reference's ProgramDesc IR,
python/paddle/fluid/framework.py). The program is a lightweight in-memory op
DAG serialized as JSON; `to_json` / `from_json` write and read the same
format as the JAX package, so a program built by either loads in the other.
Variables carry a `torch.dtype`. The executor interprets the global block op
by op (executor.py); a control-flow op runs its sub-block's plan
(ops/control_ops.py).
"""

from __future__ import annotations

import contextlib
import json
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from ..core import unique_name
from ..core.dtypes import convert_dtype, dtype_name
from ..core.enforce import (AlreadyExistsError, InvalidArgumentError,
                            NotFoundError, enforce)

# Reserved data-var name of the per-row batch validity mask (1.0 = a real
# row), declared by layers.batch_row_mask(); the Executor feeds all-ones
# when the program declares it and the caller does not feed it.
BATCH_ROW_MASK_NAME = "@batch_row_mask"


class Variable:
    """A named tensor slot in a block (≙ VarDesc + fluid.framework.Variable,
    reference python/paddle/fluid/framework.py:142).

    shape may contain -1 for dims unknown until feed time (batch dim).
    ``lod_level > 0`` marks a sequence variable: its runtime value is a padded
    dense array accompanied by a companion length variable ``<name>@SEQLEN``
    (the static-shape translation of the reference's LoD ragged offsets,
    reference paddle/fluid/framework/lod_tensor.h:58).
    """

    def __init__(self, block, name, shape=None, dtype="float32",
                 persistable=False, stop_gradient=True, lod_level=0,
                 is_data=False, trainable=False):
        self.block = block
        self.name = name
        self.shape = tuple(int(d) for d in shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.lod_level = lod_level
        self.is_data = is_data
        self.trainable = trainable
        self.op = None  # producer op, set by Block.append_op
        # byte-lean staging of a data var: (wire dtype, scale). A feed of
        # the wire dtype is cast to `dtype` and scaled on the device
        # (layers.data(staging_dtype=...), Executor)
        self.staging = None

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={dtype_name(self.dtype)}, persistable={self.persistable})")

    @property
    def ndim(self):
        return len(self.shape) if self.shape is not None else None

    # -- arithmetic (≙ math_op_patch.py operator overloads) --
    def _binary(self, other, op_type, reverse=False):
        from ..layers import math_ops
        return math_ops.elementwise_binary_dispatch(self, other, op_type,
                                                    reverse)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __rtruediv__(self, other):
        return self._binary(other, "elementwise_div", reverse=True)

    def __pow__(self, other):
        return self._binary(other, "elementwise_pow")

    def __neg__(self):
        from ..layers import math_ops
        return math_ops.scale(self, scale=-1.0)

    def astype(self, dtype):
        from ..layers import tensor as tensor_layers
        return tensor_layers.cast(self, dtype)


class Parameter(Variable):
    """A trainable persistable variable (≙ fluid.framework.Parameter,
    reference python/paddle/fluid/framework.py:1874)."""

    def __init__(self, block, name, shape, dtype="float32", trainable=True,
                 regularizer=None, gradient_clip=None, **kw):
        super().__init__(block, name, shape=shape, dtype=dtype,
                         persistable=True, stop_gradient=not trainable,
                         trainable=trainable, **kw)
        self.regularizer = regularizer
        self.gradient_clip = gradient_clip
        self.optimize_attr = {"learning_rate": 1.0}


class Operator:
    """One op in a block (≙ OpDesc + fluid.framework.Operator,
    reference python/paddle/fluid/framework.py:431).

    inputs/outputs map slot name → list of variable names. attrs are plain
    JSON-able python values (plus numpy arrays for constant payloads).
    """

    def __init__(self, block, op_type: str,
                 inputs: Optional[Dict[str, Sequence]] = None,
                 outputs: Optional[Dict[str, Sequence]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        from .registry import lookup_op  # late import to avoid cycle
        lookup_op(op_type)  # raise early on unknown op type
        self.block = block
        self.type = op_type
        self.inputs = {k: [v.name if isinstance(v, Variable) else v
                           for v in _as_list(vs)]
                       for k, vs in (inputs or {}).items()}
        self.outputs = {k: [v.name if isinstance(v, Variable) else v
                            for v in _as_list(vs)]
                        for k, vs in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input_names(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    def __repr__(self):
        return f"Operator({self.type}: {self.inputs} -> {self.outputs})"


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class Block:
    """Ordered ops + named vars (≙ BlockDesc, reference
    paddle/fluid/framework/framework.proto:164, block_desc.h)."""

    def __init__(self, program, idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent(self) -> Optional["Block"]:
        return None if self.parent_idx < 0 else self.program.blocks[self.parent_idx]

    def create_var(self, name=None, **kw) -> Variable:
        name = name or unique_name.generate("tmp")
        if name in self.vars:
            raise AlreadyExistsError(f"variable {name!r} already exists in block")
        v = Variable(self, name, **kw)
        self.vars[name] = v
        self.program._bump()
        return v

    def create_parameter(self, name=None, shape=None, dtype="float32",
                         **kw) -> Parameter:
        name = name or unique_name.generate("param")
        enforce(shape is not None, "parameter shape required",
                exc=InvalidArgumentError)
        p = Parameter(self, name, shape, dtype=dtype, **kw)
        self.vars[name] = p
        self.program._bump()
        return p

    def var(self, name: str) -> Variable:
        """Find var in this block or ancestors (≙ Scope-like desc lookup)."""
        v = self.find_var_recursive(name)
        if v is None:
            raise NotFoundError(
                f"variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return self.find_var_recursive(name) is not None

    def find_var_recursive(self, name: str) -> Optional[Variable]:
        """The variable `name` of this block or its nearest ancestor that
        has one, else None."""
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent
        return None

    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        for out_name in op.output_names():
            if out_name in self.vars:
                self.vars[out_name].op = op
        self.program._bump()
        return op

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]


class Program:
    """A whole trainable/inference program (≙ ProgramDesc + fluid Program,
    reference python/paddle/fluid/framework.py:1339)."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._current_block_idx = 0
        self._version = 0  # bumped on any mutation; part of the plan cache key
        self.random_seed = 0

    # -- mutation tracking --
    def _bump(self):
        self._version += 1

    # -- block management --
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def _create_block(self, parent_idx=None) -> Block:
        """Append a sub-block (a control-flow op's body, ≙ the BLOCK attr)
        whose parent is the current block, and make it current."""
        parent_idx = self._current_block_idx if parent_idx is None \
            else parent_idx
        b = Block(self, len(self.blocks), parent_idx)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        self._bump()
        return b

    def _rollback(self):
        """Make the current block's parent current again."""
        self._current_block_idx = self.current_block().parent_idx

    def all_parameters(self) -> List[Parameter]:
        return [p for b in self.blocks for p in b.all_parameters()]

    # -- cloning (≙ Program.clone) --
    def clone(self, for_test: bool = False) -> "Program":
        p = Program()
        p.random_seed = self.random_seed
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            for name, v in b.vars.items():
                cls = Parameter if isinstance(v, Parameter) else Variable
                if cls is Parameter:
                    nv = Parameter(nb, name, v.shape, dtype=v.dtype,
                                   trainable=v.trainable,
                                   regularizer=v.regularizer,
                                   gradient_clip=v.gradient_clip)
                else:
                    nv = Variable(nb, name, shape=v.shape, dtype=v.dtype,
                                  persistable=v.persistable,
                                  stop_gradient=v.stop_gradient,
                                  lod_level=v.lod_level, is_data=v.is_data)
                for extra in ("sharding_spec", "is_optimizer_state",
                              "optimize_attr", "staging", "accumulator_of",
                              "dp_shard_update", "dp_replica_state",
                              "tp_spec", "buffer_slot"):
                    if hasattr(v, extra):
                        setattr(nv, extra, getattr(v, extra))
                nb.vars[name] = nv
            for op in b.ops:
                attrs = dict(op.attrs)
                if for_test:
                    attrs["is_test"] = True
                nop = Operator(nb, op.type, {}, {}, attrs)
                nop.inputs = {k: list(v) for k, v in op.inputs.items()}
                nop.outputs = {k: list(v) for k, v in op.outputs.items()}
                nb.ops.append(nop)
            p.blocks.append(nb)
        # the tp rewrite's markers ride through clones (the comm rewrite
        # clones a tp-rewritten program), as in the JAX package
        for marker in ("_tp_applied", "_tp_size", "_tp_n_collectives"):
            if hasattr(self, marker):
                setattr(p, marker, getattr(self, marker))
        p._current_block_idx = 0
        return p

    def prune(self, targets: Sequence[Union[str, Variable]]) -> "Program":
        """A clone keeping only the ops block 0 needs to compute `targets`
        (≙ framework/prune.cc; save_inference_model uses it). Backward and
        optimizer ops never survive: an update op also "produces" its
        parameter's name, but inference reads the incoming value."""
        target_names = {t.name if isinstance(t, Variable) else t
                        for t in targets}
        block = self.global_block()
        needed = set(target_names)
        keep: List[int] = []
        for i in range(len(block.ops) - 1, -1, -1):
            op = block.ops[i]
            if (op.type == "vjp_region"
                    or op.attrs.get("op_role") in ("optimize", "backward")):
                continue
            if needed & set(op.output_names()):
                keep.append(i)
                needed |= set(op.input_names())
        keep.reverse()
        pruned = self.clone()
        pb = pruned.global_block()
        pb.ops = [pb.ops[i] for i in keep]
        used = set(target_names)
        for op in pb.ops:
            used |= set(op.input_names()) | set(op.output_names())
        pb.vars = {n: v for n, v in pb.vars.items() if n in used}
        pruned._bump()
        return pruned

    # -- serialization (JSON stands in for the reference's protobuf) --
    def to_json(self) -> str:
        def enc_attr(v):
            if isinstance(v, np.ndarray):
                return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            if isinstance(v, np.generic):
                return v.item()
            return v

        data = {"random_seed": self.random_seed, "blocks": []}
        for b in self.blocks:
            data["blocks"].append({
                "idx": b.idx, "parent_idx": b.parent_idx,
                "vars": [{
                    "name": v.name,
                    "shape": list(v.shape) if v.shape is not None else None,
                    "dtype": dtype_name(v.dtype),
                    "persistable": v.persistable,
                    "stop_gradient": v.stop_gradient,
                    "lod_level": v.lod_level, "is_data": v.is_data,
                    "is_parameter": isinstance(v, Parameter),
                    "trainable": v.trainable,
                    "sharding_spec": list(getattr(v, "sharding_spec", None))
                    if getattr(v, "sharding_spec", None) is not None else None,
                    "is_optimizer_state": getattr(v, "is_optimizer_state",
                                                  False),
                } for v in b.vars.values()],
                "ops": [{
                    "type": op.type, "inputs": op.inputs,
                    "outputs": op.outputs,
                    "attrs": {k: enc_attr(v) for k, v in op.attrs.items()},
                } for op in b.ops],
            })
        return json.dumps(data)

    @staticmethod
    def from_json(s: str) -> "Program":
        def dec_attr(v):
            if isinstance(v, dict) and "__ndarray__" in v:
                return np.asarray(v["__ndarray__"], dtype=v["dtype"])
            return v

        data = json.loads(s)
        p = Program()
        p.random_seed = data.get("random_seed", 0)
        p.blocks = []
        for bd in data["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                if vd.get("is_parameter"):
                    v = Parameter(b, vd["name"], vd["shape"], dtype=vd["dtype"],
                                  trainable=vd.get("trainable", True))
                else:
                    v = Variable(b, vd["name"], shape=vd["shape"],
                                 dtype=vd["dtype"],
                                 persistable=vd["persistable"],
                                 stop_gradient=vd["stop_gradient"],
                                 lod_level=vd.get("lod_level", 0),
                                 is_data=vd.get("is_data", False))
                if vd.get("sharding_spec") is not None:
                    v.sharding_spec = tuple(vd["sharding_spec"])
                if vd.get("is_optimizer_state"):
                    v.is_optimizer_state = True
                b.vars[v.name] = v
            for od in bd["ops"]:
                op = Operator(b, od["type"], {}, {},
                              {k: dec_attr(v) for k, v in od["attrs"].items()})
                op.inputs = od["inputs"]
                op.outputs = od["outputs"]
                b.ops.append(op)
            p.blocks.append(b)
        return p

    def __repr__(self):
        lines = []
        for b in self.blocks:
            lines.append(f"block {b.idx} (parent {b.parent_idx}):")
            for v in b.vars.values():
                lines.append(f"  var {v.name}: shape={v.shape} "
                             f"dtype={dtype_name(v.dtype)}"
                             + (" persistable" if v.persistable else ""))
            for op in b.ops:
                lines.append(f"  op {op.type}: {op.inputs} -> {op.outputs}")
        return "\n".join(lines)


# --- default program registry (≙ fluid default_main_program/startup_program,
#     reference python/paddle/fluid/framework.py:1958-2026) ---

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    """Switch default programs within a scope (≙ fluid.program_guard)."""
    global _main_program, _startup_program
    old_main, old_startup = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program, _startup_program = old_main, old_startup


def reset_default_programs():
    global _main_program, _startup_program
    _main_program = Program()
    _startup_program = Program()
