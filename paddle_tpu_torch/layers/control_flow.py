"""Control-flow layers: StaticRNN and comparisons.

≙ paddle_tpu/layers/control_flow.py, trimmed to what the ported models
build: `StaticRNN` (the NMT decoder), `less_than` (the decode tick's
position mask), `greater_than` and `equal` (the packed LM's loss mask).
DynamicRNN, While, IfElse and Switch are not ported yet (ROADMAP.md port
queue items 3 and 4).

StaticRNN creates a real sub-block in the program (≙ the BLOCK attr in
framework.proto); its `static_rnn` op runs the block once per time step
(ops/control_ops.py), differentiably.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

from ..core.dtypes import dtype_name
from ..core.enforce import InvalidArgumentError, enforce
from ..framework.program import Variable, default_main_program
from ..layer_helper import LayerHelper


def _outside_reads(block, exclude_inner: Sequence[str] = ()) -> List[str]:
    """The variables a sub-block reads that none of its ops (nor
    `exclude_inner`) produces, in first-read order (≙ the reads half of
    the JAX package's `_analyze_sub_block`)."""
    produced = set(exclude_inner)
    reads: List[str] = []
    for op in block.ops:
        for n in op.input_names():
            if n not in produced and n not in reads:
                reads.append(n)
        produced.update(op.output_names())
    return reads


class StaticRNN:
    """≙ fluid.layers.StaticRNN (reference control_flow.py:430): an explicit
    per-step block over a fixed-length (padded) time dimension.

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)          # [B, T, ...] -> [B, ...]
            h_prev = rnn.memory(init=h0)
            h = ...                          # ops of one step
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()                          # [B, T, ...]

    Variables of the enclosing block that the step reads (parameters
    included) become the op's `Captures`, so `append_backward` sees them
    as inputs of the op and differentiates them."""

    def __init__(self, name: Optional[str] = None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.program = default_main_program()
        self._step_inputs: List[Variable] = []   # outer [B,T,...] vars
        self._step_vars: List[Variable] = []     # inner per-step views
        self._memories: List[Variable] = []      # inner pre-state vars
        self._init_mems: List[Variable] = []     # outer init values
        self._mem_updates: Dict[str, str] = {}   # pre name -> new name
        self._step_outputs: List[Variable] = []  # inner step outputs
        self._outer_outputs: List[Variable] = []
        self._final_mems: List[Variable] = []
        self._seq_lens: Optional[Variable] = None
        self._sub = None
        self._parent = None

    @contextlib.contextmanager
    def step(self):
        self._parent = self.program.current_block()
        self._sub = self.program._create_block()
        try:
            yield
        except BaseException:
            # a failing step body must surface ITS error, not the
            # finalizer's complaint about a half-built block
            self.program._rollback()
            raise
        self.program._rollback()
        self._finalize()

    # -- inside-step API --------------------------------------------------
    def step_input(self, x: Variable) -> Variable:
        """Register a [B, T, ...] sequence; returns the per-step [B, ...]
        view usable inside the block."""
        enforce(self._sub is not None and
                self.program.current_block() is self._sub,
                "step_input must be called inside rnn.step()",
                exc=InvalidArgumentError)
        v = self._sub.create_var(
            shape=[x.shape[0]] + list(x.shape[2:]),
            dtype=dtype_name(x.dtype), stop_gradient=False)
        self._step_inputs.append(x)
        self._step_vars.append(v)
        return v

    def memory(self, init: Variable) -> Variable:
        """Loop-carried state initialized from `init` [B, ...]."""
        enforce(self.program.current_block() is self._sub,
                "memory must be called inside rnn.step()",
                exc=InvalidArgumentError)
        v = self._sub.create_var(shape=list(init.shape),
                                 dtype=dtype_name(init.dtype),
                                 stop_gradient=False)
        self._memories.append(v)
        self._init_mems.append(init)
        return v

    def update_memory(self, mem: Variable, new: Variable):
        self._mem_updates[mem.name] = new.name

    def step_output(self, out: Variable):
        self._step_outputs.append(out)

    def set_sequence_lengths(self, seq_lens: Variable):
        """Freeze memories and zero outputs past each sequence's length."""
        self._seq_lens = seq_lens

    # -- finalize ---------------------------------------------------------
    def _finalize(self):
        enforce(self._step_inputs, "StaticRNN needs at least one step_input",
                exc=InvalidArgumentError)
        enforce(set(self._mem_updates) == {m.name for m in self._memories},
                "every memory needs update_memory", exc=InvalidArgumentError)
        pre_names = [m.name for m in self._memories]
        new_names = [self._mem_updates[n] for n in pre_names]
        inner_defined = {v.name for v in self._step_vars} | set(pre_names)
        captures = [n for n in _outside_reads(self._sub, inner_defined)
                    if self._parent.has_var(n)]

        t = self._step_inputs[0].shape[1]
        outer_outs = [self._parent.create_var(
            name=None, shape=[so.shape[0], t] + list(so.shape[1:]),
            dtype=dtype_name(so.dtype), stop_gradient=False)
            for so in self._step_outputs]
        final_mems = [self._parent.create_var(
            name=None, shape=list(m.shape), dtype=dtype_name(m.dtype),
            stop_gradient=False) for m in self._memories]
        self._outer_outputs = outer_outs
        self._final_mems = final_mems
        inputs = {"StepInputs": [v.name for v in self._step_inputs],
                  "InitMems": [v.name for v in self._init_mems],
                  "Captures": captures}
        if self._seq_lens is not None:
            inputs["SeqLens"] = [self._seq_lens.name]
        self._parent.append_op(
            type="static_rnn",
            inputs=inputs,
            outputs={"Out": [v.name for v in outer_outs],
                     "FinalMems": [v.name for v in final_mems]},
            attrs={"sub_block": self._sub.idx,
                   "step_input_names": [v.name for v in self._step_vars],
                   "pre_mem_names": pre_names,
                   "new_mem_names": new_names,
                   "step_output_names": [o.name for o in self._step_outputs],
                   "capture_names": captures,
                   # the layer builds forward loops only; the op's
                   # reversed branch is reached through this attribute
                   "is_reverse": False})

    def __call__(self):
        outs = self._outer_outputs
        return outs[0] if len(outs) == 1 else outs

    def final_memories(self):
        fm = self._final_mems
        return fm[0] if len(fm) == 1 else fm


def _compare(op_type, x, y, cond=None):
    from .math_ops import _broadcast_shape
    helper = LayerHelper(op_type)
    if cond is None:
        # declared shape must be the broadcast of both operands (the old
        # x.shape under-declared broadcast dims — flagged by the static
        # analyzer, framework/analysis.py)
        cond = helper.create_tmp_variable(
            dtype="bool", shape=_broadcast_shape(x.shape, y.shape),
            stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def less_than(x, y, cond=None):
    return _compare("less_than", x, y, cond)


def greater_than(x, y, cond=None):
    return _compare("greater_than", x, y, cond)


def equal(x, y, cond=None):
    return _compare("equal", x, y, cond)
