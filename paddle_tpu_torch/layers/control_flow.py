"""Control-flow layers: While, StaticRNN, DynamicRNN, IfElse, cond, Switch,
the comparisons, increment and the tensor arrays.

≙ paddle_tpu/layers/control_flow.py (reference
python/paddle/fluid/layers/control_flow.py: While:655, StaticRNN:430,
DynamicRNN:1542, IfElse:1412, Switch:1286). The builders create real
sub-blocks in the program (≙ the BLOCK attr in framework.proto) and emit the
JAX package's ops with its attributes, so a program built by either
package serializes to the same JSON. The ops run the sub-blocks eagerly
(ops/control_ops.py):

- StaticRNN / DynamicRNN (`static_rnn`): a loop over the static T,
  differentiable; DynamicRNN freezes rows past their lengths.
- While (`while`): reads its condition on the host once an iteration;
  forward-only, as the JAX package's lax.while_loop.
- IfElse (`cond_block`) and Switch (`switch_case`) run every branch and
  merge on the device; `cond` (`lazy_cond`) reads its scalar predicate
  on the host and runs one branch.
- Tensor arrays are preallocated [max_len, ...] variables; array_write
  returns the updated array (the JAX package's static-shape translation
  of the reference's growing LoDTensorArray).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

from ..core.dtypes import dtype_name
from ..core.enforce import InvalidArgumentError, enforce
from ..framework.program import Variable, default_main_program
from ..layer_helper import LayerHelper


def _analyze_sub_block(block, exclude_inner: Sequence[str] = ()):
    """(reads from outside, writes) of a sub-block, each in first-use
    order: the variables its ops read that none of them (nor
    `exclude_inner`) produces before, and the variables they write."""
    produced = set(exclude_inner)
    reads: List[str] = []
    writes: List[str] = []
    for op in block.ops:
        for n in op.input_names():
            if n not in produced and n not in reads:
                reads.append(n)
        for n in op.output_names():
            produced.add(n)
            if n not in writes:
                writes.append(n)
    return reads, writes


def _captures(parent, *blocks):
    """The parent's variables any of `blocks` reads, in first-read
    order."""
    captures = []
    for b in blocks:
        for n in _analyze_sub_block(b)[0]:
            if n not in captures and parent.has_var(n):
                captures.append(n)
    return captures


class While:
    """≙ fluid.layers.While (reference control_flow.py:655).

    cond: a scalar bool variable. Variables the body assigns that exist
    outside it become loop-carried state (their values after the loop are
    visible after it). The `while` op reads cond on the host once an
    iteration and is forward-only (ops/control_ops.py).

        i = layers.fill_constant([1], "int64", 0)
        n = layers.fill_constant([1], "int64", 10)
        cond = layers.less_than(i, n)
        w = While(cond)
        with w.block():
            ... body ops, which must re-assign `cond` ...
    """

    def __init__(self, cond: Variable, name: Optional[str] = None):
        enforce(cond.dtype is not None, "cond must be a bool variable",
                exc=InvalidArgumentError)
        self.cond = cond
        self.helper = LayerHelper("while", name=name)
        self.program = default_main_program()

    @contextlib.contextmanager
    def block(self):
        parent = self.program.current_block()
        sub = self.program._create_block()
        try:
            yield
        finally:
            self.program._rollback()
        reads, writes = _analyze_sub_block(sub)
        # loop-carried: cond and every variable the body writes that
        # exists outside it (same-name update, ≙ while_op's scope vars)
        carry = [self.cond.name]
        for n in writes:
            if n != self.cond.name and parent.has_var(n) and n not in carry:
                carry.append(n)
        captures = [n for n in reads
                    if n not in carry and parent.has_var(n)]
        parent.append_op(
            type="while",
            inputs={"Carry": list(carry), "Captures": captures},
            outputs={"Out": list(carry)},
            attrs={"sub_block": sub.idx, "carry_names": list(carry),
                   "capture_names": captures, "cond_name": self.cond.name})


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

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

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
        reads, _ = _analyze_sub_block(self._sub, inner_defined)
        captures = [n for n in reads if self._parent.has_var(n)]

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


class DynamicRNN(StaticRNN):
    """≙ fluid.layers.DynamicRNN (reference control_flow.py:1542). The
    ragged (LoD) batch is the padded batch with lengths: the same loop as
    StaticRNN, freezing memories and zeroing outputs past each row's
    length. The lengths come from `seq_lens` or from the first step
    input's companion (`get_seqlen`)."""

    def __init__(self, seq_lens: Optional[Variable] = None, name=None):
        super().__init__(name=name)
        if seq_lens is not None:
            self.set_sequence_lengths(seq_lens)

    @contextlib.contextmanager
    def block(self):
        with self.step():
            yield

    def static_input(self, x: Variable) -> Variable:
        """A non-sequence input seen by every step (captured)."""
        return x

    def step_input(self, x: Variable) -> Variable:
        if self._seq_lens is None:
            from .sequence import get_seqlen
            sl = getattr(x, "seqlen_var", None)
            if sl is None:
                try:
                    sl = get_seqlen(x)
                except Exception:
                    sl = None
            if sl is not None:
                self.set_sequence_lengths(sl)
        return super().step_input(x)


class IfElse:
    """≙ fluid.layers.IfElse (reference control_flow.py:1412): a batched
    two-branch conditional. Both branches compute on the full batch and
    the outputs merge row by row by the [B, 1] bool condition (the
    `cond_block` op)."""

    def __init__(self, cond: Variable, name: Optional[str] = None):
        self.cond = cond
        self.program = default_main_program()
        self._blocks = {}          # True/False -> block
        self._outs = {True: [], False: []}
        self._parent = None
        self._in_branch = None

    @contextlib.contextmanager
    def true_block(self):
        with self._branch(True):
            yield

    @contextlib.contextmanager
    def false_block(self):
        with self._branch(False):
            yield

    @contextlib.contextmanager
    def _branch(self, is_true: bool):
        self._parent = self.program.current_block()
        sub = self.program._create_block()
        self._blocks[is_true] = sub
        self._in_branch = is_true
        try:
            yield
        finally:
            self.program._rollback()
            self._in_branch = None

    def input(self, x: Variable) -> Variable:
        """The reference gathers the branch's rows here; the full batch
        flows through both branches instead (merged at the output)."""
        return x

    def output(self, *outs):
        enforce(self._in_branch is not None,
                "IfElse.output must be called inside a branch block",
                exc=InvalidArgumentError)
        self._outs[self._in_branch].extend(outs)

    def __call__(self):
        enforce(True in self._blocks and False in self._blocks,
                "both true_block and false_block are required",
                exc=InvalidArgumentError)
        t_outs = self._outs[True]
        f_outs = self._outs[False]
        enforce(len(t_outs) == len(f_outs) and t_outs,
                "branches must produce the same number of outputs",
                exc=InvalidArgumentError)
        captures = _captures(self._parent, self._blocks[True],
                             self._blocks[False])
        merged = [self._parent.create_var(
            shape=list(tv.shape), dtype=dtype_name(tv.dtype),
            stop_gradient=False) for tv in t_outs]
        self._parent.append_op(
            type="cond_block",
            inputs={"Cond": [self.cond.name], "Captures": captures},
            outputs={"Out": [v.name for v in merged]},
            attrs={"true_block": self._blocks[True].idx,
                   "false_block": self._blocks[False].idx,
                   "capture_names": captures,
                   "true_out_names": [v.name for v in t_outs],
                   "false_out_names": [v.name for v in f_outs]})
        return merged  # always a list, as the reference's IfElse()()


def cond(pred: Variable, true_fn, false_fn):
    """The functional scalar conditional (`lazy_cond`: one branch runs,
    picked on the host). true_fn / false_fn build ops and return a
    Variable or a list of them."""
    program = default_main_program()
    parent = program.current_block()

    def build(fn):
        sub = program._create_block()
        try:
            out = fn()
        finally:
            program._rollback()
        outs = out if isinstance(out, (list, tuple)) else [out]
        return sub, list(outs)

    t_sub, t_outs = build(true_fn)
    f_sub, f_outs = build(false_fn)
    enforce(len(t_outs) == len(f_outs),
            "cond branches must return the same number of outputs",
            exc=InvalidArgumentError)
    captures = _captures(parent, t_sub, f_sub)
    merged = [parent.create_var(shape=list(tv.shape),
                                dtype=dtype_name(tv.dtype),
                                stop_gradient=False)
              for tv in t_outs]
    parent.append_op(
        type="lazy_cond",
        inputs={"Cond": [pred.name], "Captures": captures},
        outputs={"Out": [v.name for v in merged]},
        attrs={"true_block": t_sub.idx, "false_block": f_sub.idx,
               "capture_names": captures,
               "true_out_names": [v.name for v in t_outs],
               "false_out_names": [v.name for v in f_outs]})
    return merged[0] if len(merged) == 1 else merged


class Switch:
    """≙ fluid.layers.Switch (reference control_flow.py:1286), the
    learning-rate schedules' piecewise construct. Each case block assigns
    a value to a target variable; the first true condition wins, the
    default block otherwise (the `switch_case` op)."""

    def __init__(self, name: Optional[str] = None):
        self.program = default_main_program()
        self._conds: List[Variable] = []
        self._case_blocks = []
        self._case_out_names: List[str] = []
        self._parent = None
        self._target: Optional[Variable] = None

    @contextlib.contextmanager
    def case(self, condition: Variable):
        self._conds.append(condition)
        with self._case_ctx():
            yield

    @contextlib.contextmanager
    def default(self):
        with self._case_ctx():
            yield

    @contextlib.contextmanager
    def _case_ctx(self):
        if self._parent is None:
            self._parent = self.program.current_block()
        sub = self.program._create_block()
        try:
            yield
        finally:
            self.program._rollback()
        enforce(sub.ops, "empty Switch case", exc=InvalidArgumentError)
        out_names = sub.ops[-1].output_names()
        enforce(len(out_names) >= 1, "case block must produce a value",
                exc=InvalidArgumentError)
        self._case_blocks.append(sub)
        self._case_out_names.append(out_names[0])
        # the target: by convention every case assigns the same outer var
        if self._target is None and self._parent.has_var(out_names[0]):
            self._target = self._parent.var(out_names[0])

    def finish(self, out: Optional[Variable] = None) -> Variable:
        """Merge the cases. If they assigned an outer variable (the
        reference's `assign` style), the merged value lands back in it."""
        parent = self._parent
        captures = _captures(parent, *self._case_blocks)
        target = out or self._target
        inputs = {"Conds": [c.name for c in self._conds],
                  "Captures": captures}
        if target is None:
            proto = self._case_blocks[0].var(self._case_out_names[0])
            target = parent.create_var(shape=list(proto.shape),
                                       dtype=dtype_name(proto.dtype),
                                       stop_gradient=False)
        elif target.op is not None or target.is_data:
            # without a default the target keeps its value before the
            # switch
            inputs["Prev"] = [target.name]
        parent.append_op(
            type="switch_case",
            inputs=inputs,
            outputs={"Out": [target.name]},
            attrs={"case_blocks": [b.idx for b in self._case_blocks],
                   "case_out_names": list(self._case_out_names),
                   "capture_names": captures})
        return target


def increment(x: Variable, value: float = 1.0, in_place: bool = False,
              name: Optional[str] = None) -> Variable:
    helper = LayerHelper("increment", name=name)
    if in_place:
        out = x
    else:
        out = helper.create_tmp_variable(dtype=dtype_name(x.dtype),
                                         shape=x.shape)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def _compare(op_type, x, y, cond=None):
    from .math_ops import _broadcast_shape
    helper = LayerHelper(op_type)
    if cond is None:
        # the declared shape is the broadcast of both operands
        cond = helper.create_tmp_variable(
            dtype="bool", shape=_broadcast_shape(x.shape, y.shape),
            stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def less_than(x, y, cond=None):
    return _compare("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _compare("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _compare("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _compare("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _compare("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _compare("not_equal", x, y, cond)


# ---- tensor arrays (≙ reference control_flow.py :741-1148, create_array /
# array_write / array_read / array_length over LoDTensorArray). An array is
# a preallocated [max_len, ...] variable and a write returns the updated
# array, as in the JAX package: the capacity is declared up front.


def create_array(dtype, initial_value=0.0, max_len=None, shape=None,
                 name=None):
    """A [max_len, *shape] array variable filled with `initial_value`
    (≙ create_array; max_len and shape are the static-shape contract)."""
    enforce(max_len is not None and shape is not None,
            "create_array needs a static max_len and element shape",
            exc=InvalidArgumentError)
    enforce(int(max_len) > 0, "create_array needs max_len >= 1",
            exc=InvalidArgumentError)
    enforce(all(int(d) > 0 for d in shape),
            "create_array element shape must be fully static (no -1): "
            "preallocated arrays cannot defer dims to feed time",
            exc=InvalidArgumentError)
    helper = LayerHelper("create_array", name=name)
    out = helper.create_tmp_variable(dtype=dtype,
                                     shape=[int(max_len)] + list(shape))
    helper.append_op(type="fill_constant", inputs={},
                     outputs={"Out": [out]},
                     attrs={"shape": [int(max_len)] + list(shape),
                            "dtype": dtype, "value": float(initial_value)})
    return out


def array_write(x, i, array):
    """The array with x written at index i, a NEW variable (≙ array_write;
    callers thread the returned variable)."""
    helper = LayerHelper("array_write")
    out = helper.create_tmp_variable(dtype=dtype_name(array.dtype),
                                     shape=list(array.shape))
    helper.append_op(type="array_write",
                     inputs={"Array": [array], "X": [x], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_read(array, i):
    """≙ array_read: the element at index i."""
    helper = LayerHelper("array_read")
    out = helper.create_tmp_variable(dtype=dtype_name(array.dtype),
                                     shape=list(array.shape[1:]))
    helper.append_op(type="array_read",
                     inputs={"Array": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array):
    """≙ array_length: the array's (static) capacity."""
    helper = LayerHelper("array_length")
    out = helper.create_tmp_variable(dtype="int64", shape=[])
    helper.append_op(type="array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out
