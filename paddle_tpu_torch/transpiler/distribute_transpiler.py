"""Distribute transpiler: the parameter-shard planner with the reference's
API.

≙ paddle_tpu/transpiler/distribute_transpiler.py (reference python/paddle/
fluid/transpiler/distribute_transpiler.py:131). The reference splits each
param / grad into ~even blocks (slice_variable :69), dispatches the shards
to parameter-server endpoints, and rewrites the trainer program with
send / recv / barrier RPC ops; each pserver runs the optimizer for its
shards. The JAX package keeps the planning layer and compiles the
transport into collectives; so does the port, whose collectives are
torch.distributed's:

- `slice_variable`: the reference's even-block splitting math (row-aligned
  blocks of at least `MIN_BLOCK_SIZE` elements);
- `DistributeTranspiler.transpile`: assigns every (param, grad) shard to
  an endpoint through a PSDispatcher and annotates the trainer program's
  optimizer ops with their owners (`shard_endpoints`);
- `get_pserver_program`: a runnable per-endpoint Program holding that
  endpoint's flat param shards and the optimizer ops cloned onto them,
  run by a plain Executor fed the gradient shards (on one card or on the
  CPU: no RPC); `get_startup_program` initializes its state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from ..core.dtypes import dtype_name
from ..core.enforce import InvalidArgumentError, enforce
from ..framework.program import Program, Variable, default_main_program
from .ps_dispatcher import PSDispatcher, RoundRobin

MIN_BLOCK_SIZE = 8192  # ≙ reference distribute_transpiler.py:128


@dataclass
class VarBlock:
    """One shard of a variable (≙ reference VarBlock "varname:blockid:size")."""
    varname: str
    block_id: int
    begin: int   # flat-element offset
    size: int    # flat-element count

    def __str__(self):
        return f"{self.varname}:{self.block_id}:{self.size}"


def slice_variable(var_list: Sequence[Variable], slice_count: int,
                   min_block_size: int = MIN_BLOCK_SIZE) -> List[List[VarBlock]]:
    """Split each var into at most `slice_count` ~even flat blocks of at
    least `min_block_size` elements (≙ reference slice_variable,
    distribute_transpiler.py:69). Returns one block list per input var."""
    blocks: List[List[VarBlock]] = []
    for var in var_list:
        numel = 1
        for d in var.shape:
            numel *= max(int(d), 1)
        split_count = min(slice_count,
                          max(1, numel // min_block_size))
        block_size = int(math.ceil(numel / float(split_count)))
        if numel > 1 and len(var.shape) >= 1 and var.shape[0] > 0:
            # align to whole rows like the reference, so a shard is a
            # contiguous row range (needed for embedding-row dispatch)
            dim1 = max(1, numel // max(int(var.shape[0]), 1))
            remains = block_size % dim1
            if remains != 0:
                block_size += dim1 - remains
        split_count = int(math.ceil(numel / float(block_size)))
        var_blocks = []
        for b in range(split_count):
            begin = b * block_size
            size = min(block_size, numel - begin)
            var_blocks.append(VarBlock(var.name, b, begin, size))
        blocks.append(var_blocks)
    return blocks


@dataclass
class ShardPlan:
    """Result of transpile(): who owns which shard."""
    # endpoint -> list of (param VarBlock, grad VarBlock, optimize op index)
    by_endpoint: Dict[str, List] = field(default_factory=dict)
    # varname -> list of (VarBlock, endpoint)
    by_var: Dict[str, List] = field(default_factory=dict)
    trainers: int = 1
    sync_mode: bool = True


@dataclass
class DistributeTranspilerConfig:
    """≙ reference DistributeTranspilerConfig: split_method is a
    PSDispatcher subclass; min_block_size bounds shard granularity."""
    split_method: type = RoundRobin
    min_block_size: int = MIN_BLOCK_SIZE
    slice_var_up: bool = True


class DistributeTranspiler:
    """≙ reference DistributeTranspiler (distribute_transpiler.py:131)."""

    def __init__(self, config: Optional[DistributeTranspilerConfig] = None):
        self.config = config or DistributeTranspilerConfig()
        self._plan: Optional[ShardPlan] = None
        self._program: Optional[Program] = None
        # pserver-program id -> {var name: non-zero init value}
        self._init_values: Dict[int, Dict[str, float]] = {}

    @staticmethod
    def _numel(var) -> int:
        n = 1
        for d in var.shape:
            n *= max(int(d), 1)
        return n

    def _acc_shape_and_init(self, src_block, src_name: str, pb: VarBlock,
                            src_op=None, slot: str = ""):
        """Shard shape + startup init for an optimizer accumulator. An
        accumulator with the PARAM's total numel shards to [pb.size];
        anything else (scalar beta-power state etc.) keeps its source shape.
        Beta-power init comes from the optimizer op's own attrs (the exact
        value the trainer would start from), falling back to the live scope
        value, so pserver math matches trainer math."""
        src_var = src_block.vars.get(src_name)
        param_var = src_block.vars.get(pb.varname)
        if src_var is not None and param_var is not None and \
                self._numel(src_var) != self._numel(param_var):
            init = None
            if src_op is not None:
                # adam/adamax beta-power accumulators start at beta^1
                if slot.startswith("Beta1Pow") and "beta1" in src_op.attrs:
                    init = float(src_op.attrs["beta1"])
                elif slot.startswith("Beta2Pow") and "beta2" in src_op.attrs:
                    init = float(src_op.attrs["beta2"])
            if init is None:
                # the live value: one host read at transpile time, off any
                # step's path
                from ..framework.scope import global_scope
                value = global_scope().find_var(src_name)
                if value is not None and torch.as_tensor(value).numel():
                    init = float(torch.as_tensor(value).reshape(-1)[0])
            return list(src_var.shape), init
        return [pb.size], None

    # -- the main entry (reference :179) ----------------------------------

    def transpile(self, trainer_id: int, program: Optional[Program] = None,
                  pservers: str = "127.0.0.1:6174", trainers: int = 1,
                  sync_mode: bool = True, startup_program=None):
        enforce(trainer_id >= 0, "trainer_id must be >= 0",
                exc=InvalidArgumentError)
        program = program or default_main_program()
        eps = pservers.split(",") if isinstance(pservers, str) else list(pservers)
        dispatcher: PSDispatcher = self.config.split_method(eps)

        block = program.global_block()
        params = [p for p in program.all_parameters() if p.trainable]
        # optimize ops keyed by the param they update
        opt_ops: Dict[str, int] = {}
        for i, op in enumerate(block.ops):
            if op.attrs.get("op_role") == "optimize" and "Param" in op.inputs:
                opt_ops[op.inputs["Param"][0]] = i

        plan = ShardPlan(trainers=trainers, sync_mode=sync_mode)
        slice_count = len(eps) if self.config.slice_var_up else 1
        grouped = slice_variable(params, slice_count,
                                 self.config.min_block_size)
        for param, pblocks in zip(params, grouped):
            endpoints = dispatcher.dispatch(pblocks)
            for vb, ep in zip(pblocks, endpoints):
                gb = VarBlock(vb.varname + "@GRAD", vb.block_id,
                              vb.begin, vb.size)
                plan.by_endpoint.setdefault(ep, []).append(
                    (vb, gb, opt_ops.get(param.name)))
                plan.by_var.setdefault(param.name, []).append((vb, ep))

        # Annotate the trainer program with each parameter's owners (the
        # JAX package's shard-ownership map, where the reference appends
        # send / recv ops)
        for param in params:
            owners = [ep for _, ep in plan.by_var[param.name]]
            for op in block.ops:
                if op.attrs.get("op_role") == "optimize" and \
                        op.inputs.get("Param", [None])[0] == param.name:
                    op.attrs["shard_endpoints"] = owners
        program._bump()
        self._plan = plan
        self._program = program
        return self

    # -- program accessors (reference get_trainer_program :343 /
    #    get_pserver_program :397) ----------------------------------------

    def get_trainer_program(self) -> Program:
        """The trainer-side program. Unlike the reference (which inserts
        send/recv ops), it is returned with shard annotations only."""
        enforce(self._program is not None, "call transpile() first",
                exc=InvalidArgumentError)
        return self._program

    def get_shard_plan(self) -> ShardPlan:
        enforce(self._plan is not None, "call transpile() first",
                exc=InvalidArgumentError)
        return self._plan

    def get_pserver_program(self, endpoint: str) -> Program:
        """A runnable parameter-service program for `endpoint`:
        for each assigned shard, a param-shard var, a grad-shard feed var,
        and the optimizer op cloned onto the shard. ≙ reference
        get_pserver_program (one optimize sub-block per shard,
        distribute_transpiler.py:397 / listen_and_serv_op.cc:102)."""
        enforce(self._plan is not None, "call transpile() first",
                exc=InvalidArgumentError)
        shards = self._plan.by_endpoint.get(endpoint, [])
        src_block = self._program.global_block()
        prog = Program()
        blk = prog.global_block()
        for pb, gb, opt_idx in shards:
            suffix = f".block{pb.block_id}"
            pname, gname = pb.varname + suffix, gb.varname + suffix
            blk.create_var(name=pname, shape=[pb.size], dtype="float32",
                           persistable=True)
            blk.create_var(name=gname, shape=[gb.size], dtype="float32")
            if opt_idx is None:
                # no optimizer on this param — plain sgd placeholder is NOT
                # appended; shard is fetch/update-by-assignment only
                continue
            src_op = src_block.ops[opt_idx]
            inputs = {"Param": [pname], "Grad": [gname]}
            outputs = {"ParamOut": [pname]}
            for slot, names in src_op.inputs.items():
                if slot in ("Param", "Grad"):
                    continue
                if slot == "LearningRate":
                    lr = names[0]
                    if not blk.has_var(lr):
                        blk.create_var(name=lr, shape=[], dtype="float32",
                                       persistable=True)
                    inputs[slot] = [lr]
                else:
                    # accumulator shard: param-shaped accumulators (moments)
                    # shard with the param; scalar state (Adam's Beta1Pow/
                    # Beta2Pow) keeps its own shape and initial value
                    acc = names[0] + suffix
                    if not blk.has_var(acc):
                        shape, init = self._acc_shape_and_init(
                            src_block, names[0], pb, src_op, slot)
                        blk.create_var(name=acc, shape=shape,
                                       dtype="float32", persistable=True)
                        if init is not None:
                            self._init_values.setdefault(id(prog), {})[
                                acc] = init
                    inputs[slot] = [acc]
            for slot, names in src_op.outputs.items():
                if slot in ("ParamOut",):
                    continue
                outputs[slot] = [names[0] + suffix]
                tgt = names[0] + suffix
                if not blk.has_var(tgt):
                    shape, init = self._acc_shape_and_init(
                        src_block, names[0], pb, src_op, slot)
                    blk.create_var(name=tgt, shape=shape,
                                   dtype="float32", persistable=True)
                    if init is not None:
                        self._init_values.setdefault(id(prog), {})[
                            tgt] = init
            blk.append_op(type=src_op.type, inputs=inputs, outputs=outputs,
                          attrs={k: v for k, v in src_op.attrs.items()
                                 if k not in ("shard_endpoints",)})
        return prog

    def get_startup_program(self, endpoint: str,
                            pserver_program: Optional[Program] = None):
        """Startup program initializing `endpoint`'s shard vars to zeros
        (real values arrive via the first checkpoint/push, as in the
        reference where trainers push initial params)."""
        prog = pserver_program or self.get_pserver_program(endpoint)
        inits = self._init_values.get(id(prog), {})
        startup = Program()
        blk = startup.global_block()
        for name, var in prog.global_block().vars.items():
            if not var.persistable:
                continue
            blk.create_var(name=name, shape=var.shape, dtype=var.dtype,
                           persistable=True)
            blk.append_op(type="fill_constant", inputs={},
                          outputs={"Out": [name]},
                          attrs={"shape": list(var.shape) or [],
                                 "dtype": dtype_name(var.dtype),
                                 "value": inits.get(name, 0.0)})
        return startup
