"""ParallelExecutor: data-, sequence- and tensor-parallel program execution.

≙ paddle_tpu/parallel/parallel_executor.py (≙ reference
framework/parallel_executor.cc:119 + python/paddle/fluid/
parallel_executor.py:32). The JAX executor compiles the program once
under jit with sharding annotations over a device mesh; the port runs one
process per rank (`distributed.init_parallel_env`), each executing the
program on its own card over its own rows of the batch, with the
collectives a torch.distributed call among the ranks of a mesh axis.

- Feeds: every rank is given the GLOBAL feed and takes its own rows of
  every batch-led feed (declared [-1, ...], or undeclared sidecars); a
  partial batch is first padded to a dp multiple by wrapping real rows,
  with the padded rows zeroed in `batch_row_mask` (`_pad_for_dp`).
- Parameters are broadcast from the mesh's first rank at the first run
  (≙ BCastParamsToDevices, parallel_executor.cc:210); state the rewrites
  split (ZeRO-1 accumulators, tp blocks, error-feedback residuals) is then
  cut to this rank's block in the scope.
- AllReduce / Reduce (the JAX package's SPMD modes) keep its global-batch
  semantics for every op: a value is split over a data axis (a batch-led
  value's dim 0 over dp, a sequence-led value's sequence dim over sp,
  `_SplitPlan`), and an op that is not row-wise along a split dim
  (ROW_CLASS, or the op's sharding-propagation rule) runs over the whole
  axis: its split inputs all-gathered (the backward reduce-scatters), the
  rank's rows kept of each output still split. The batch reductions
  (`mean`, `reduce_sum` / `reduce_mean`, `accuracy`, train-mode
  `batch_norm`'s statistics; `reduce_max` / `reduce_min` without a
  gradient) keep their exact cheap forms: the local part summed over the
  split axes, the all-reduce's transpose (an all-reduce) in the backward.
  Each rank's parameter gradients are then averaged over dp (and sp).
  With every rank seeding its backward with 1, that average is exactly
  the gradient of the global loss (a collective's backward carries the
  other ranks' share, and a term the ranks compute alike counts once). So
  a rank whose rows are all padding reduces nothing locally and still
  sees the global loss (no NaN). AllReduce averages the gradients with
  one bucketed all-reduce per dtype and axis; Reduce runs grad_comm's
  rewrite (reduce-scatter, the optimizer on this rank's dp slice with its
  accumulators split on dim 0, all-gather of the parameter).
- Sequence parallelism (`enable_sequence_parallel` on a mesh with an sp
  axis): a sequence feed (lod_level > 0, rank >= 2) is split [B over dp,
  T over sp], the others (and sidecars such as tokens@SEQLEN) over dp
  only. `fused_attention` over sp-split q / k / v runs the ring
  (ring_attention.py, K1 a live block, K2 / K3 in the backward; K and V
  never gathered). In the LM: the head split's reshape takes the rank's
  sequence length; the position table, the targets and the length mask,
  whole over sp, are cut to the rank's columns where they meet the split
  activations; the masked loss's sums are reduced over dp and sp; a
  sequence-led fetch is gathered over sp. Packed batches split no feed
  over sp (their tokens have lod_level 0): each sp rank runs the whole
  sequence, as in the JAX package. The manual modes refuse sp.
- ReduceScatter and `quant_comm` (the JAX package's explicit modes) are
  per-rank local means by that package's own design: the step runs
  per rank and `dp_grad_comm` averages the gradients, on a float32,
  bfloat16 or int8 wire with error feedback; sum-reduced losses,
  batch-global ops and indivisible batches are refused as there.
- Tensor parallelism: a program annotated for tp (`annotate_tp`,
  `ParamAttr(sharding_spec=)`) run on a mesh with a tp axis goes through
  framework/sharding.py's tp_shard_pass, in every mode (the JAX package
  leaves the SPMD modes to XLA's partitioner).
- Fetches: a batch-led fetch is gathered over dp and stripped of padding;
  a tp-split value is gathered over tp; in the explicit modes a
  non-batch-led float fetch is the mean over dp (a sum fetch is refused).
- Dropout draws per rank from (seed, step, dp coordinate); tp ranks share
  their draws.

- Pipeline parallelism (`BuildStrategy.pipeline_stages` = K on a mesh
  whose pp axis has exactly K ranks): framework/passes.py
  pipeline_partition_pass cuts the program into K stages and rank k runs
  stage k's ticks of the schedule (parallel/pipeline.py), its boundary
  buffers moving point to point over the pp group. The step is per rank
  (manual) as in the explicit modes; with a dp axis the region averages
  the gradients over dp, or grad_comm's rewrite does (ReduceScatter).
- `BuildStrategy.memory_plan`: framework/memory_plan.py's pass over the
  program as rewritten (after the tp, dp-comm and pipeline passes).
- `BuildStrategy.offload_optimizer_state`: each rank's optimizer
  accumulators (its ZeRO-1 rows) live in pinned host memory between
  steps (framework/offload.py `HostOptimizerState`): restored at step
  entry, offloaded after the fetches, every order from events.
- `BuildStrategy.auto_parallel`: on the first prepare the planner
  (framework/auto_parallel.py) chooses the strategy (memory plans
  included) and the mesh's factorization over this executor's ranks,
  which the executor adopts; `auto_plan_report`, `cost_report` and
  `memory_report` read it.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.enforce import InvalidArgumentError, enforce
from ..core.places import CPUPlace, CUDAPlace
from ..framework.executor import Executor, as_numpy
from ..framework.registry import lookup_shard_rule
from ..framework.sharding import OpActions, ShardCtx
from ..framework.program import Program, Variable, default_main_program
from ..framework.scope import Scope, global_scope
from ..framework.selected_rows import TracedSelectedRows
from . import collective as C
from . import grad_comm as _grad_comm
from . import pipeline as _pipeline
from . import tensor_parallel as _tensor_parallel
from .mesh import (DATA_AXIS, MODEL_AXIS, PIPELINE_AXIS, SEQUENCE_AXIS,
                   DeviceMesh, Placement, get_default_mesh)
from .strategy import (BuildStrategy, ExecutionStrategy,
                       GradientScaleStrategy, ReduceStrategy)

def register_split_state(scope: Scope, name: str, mesh: DeviceMesh,
                         placement: Placement, shape):
    """Record on `scope` that var `name` holds this rank's block of a
    tensor of global `shape`, placed by `placement` over `mesh` — what a
    save reads to gather the global value, and a load to cut it back."""
    reg = scope.__dict__.setdefault("_split_state", {})
    reg[name] = (mesh, placement, tuple(int(d) for d in shape))


def split_state(scope: Scope) -> Dict[str, tuple]:
    """name -> (mesh, placement, global shape) of the vars a
    ParallelExecutor split in `scope` (empty for any other scope)."""
    return scope.__dict__.get("_split_state", {})


def gather_global(value: torch.Tensor, mesh: DeviceMesh,
                  placement: Placement) -> torch.Tensor:
    """The global tensor from this rank's block: an all-gather per split
    axis, minor axis first (a collective every rank of the mesh calls)."""
    with mesh:
        for d, s in enumerate(placement):
            if s is None:
                continue
            for a in reversed(s if isinstance(s, (tuple, list)) else (s,)):
                if mesh.axis_size(a) > 1:
                    value = C.all_gather(value.contiguous(), a, d)
    return value


# ---------------------------------------------------------------------------
# global-batch semantics: ops that mix rows along a split dimension
# ---------------------------------------------------------------------------
#
# In the AllReduce / Reduce modes a value may be split over a data axis of
# the mesh: dim 0 over dp when it is declared batch-led ([-1, ...]), and,
# under sequence parallelism, the dim that holds the sequence over sp
# (seeded at the sp-split feeds and carried through the program by
# `_SplitPlan`). An op is ROW-WISE along a split dim when each output row
# along it depends only on the same input row: every rank then runs it on
# its own rows. Where an op has a sharding-propagation rule
# (framework/sharding.py), the rule decides: row-wise when it keeps the
# split on one dim of its outputs with no conflict and no partial sum.
# Every other op has a class by its meaning in ROW_CLASS. An op that is
# not row-wise is lowered over the whole axis: its split inputs are
# all-gathered (the backward reduce-scatters), it runs on the global
# tensors, and each output that is still split keeps the rank's rows.
# The reductions keep their cheaper exact forms (GLOBAL_BATCH_OPS).


def _dims_of(op, name, default, rank):
    a = op.attrs.get(name, default)
    if a is None:
        return None
    dims = a if isinstance(a, (list, tuple)) else (a,)
    return {int(d) % max(rank, 1) for d in dims}


def _every(op, slot, dim, rank):
    return True


def _rows(op, slot, dim, rank):
    return dim == 0


def _mixes(op, slot, dim, rank):
    return False


def _but(name, default):
    """Row-wise along every dim but the one(s) attr `name` names."""
    def rowwise(op, slot, dim, rank):
        dims = _dims_of(op, name, default, rank)
        return dims is not None and dim not in dims
    return rowwise


def _before(name, default):
    """Row-wise along the dims before attr `name`'s (stack / unstack: the
    dims after it move)."""
    def rowwise(op, slot, dim, rank):
        a = int(op.attrs.get(name, default))
        return dim < (a % (rank + 1) if a < 0 else a)
    return rowwise


def _not_last(op, slot, dim, rank):
    return dim != rank - 1


def _unreduced(op, slot, dim, rank):
    if op.attrs.get("reduce_all", False) or op.attrs.get("dim") is None:
        return False
    return dim not in _dims_of(op, "dim", None, rank)


def _slot(*slots):
    """Row-wise along any dim of the listed input slots (a lookup's ids,
    a gather's index); a split table is gathered."""
    def rowwise(op, slot, dim, rank):
        return slot in slots
    return rowwise


def _flatten(op, slot, dim, rank):
    return dim == 0 and int(op.attrs.get("axis", 1)) >= 1


def _pad(op, slot, dim, rank):
    p = op.attrs.get("paddings") or ()
    return not any(p[2 * dim:2 * dim + 2])


def _expand(op, slot, dim, rank):
    t = op.attrs.get("expand_times") or ()
    return dim < len(t) and int(t[dim]) == 1


_POINTWISE = (
    "adadelta", "adagrad", "adam", "adamax", "arange", "assign_value",
    "brelu", "ceil", "cos", "decayed_adagrad", "elementwise_floordiv",
    "elementwise_mod", "fake_dequantize_max_abs", "fill_constant", "floor",
    "ftrl", "gaussian_random", "hard_shrink", "hard_sigmoid", "hinge_loss",
    "huber_loss", "increment", "lamb", "log_loss", "logical_and",
    "logical_not", "logical_or", "logical_xor", "logsigmoid",
    "margin_rank_loss", "momentum", "mse_loss", "one_hot",
    "piecewise_decay", "pow", "print", "proximal_adagrad", "proximal_gd",
    "rank_loss", "reciprocal", "rmsprop", "round", "sequence_mask", "sgd",
    "sigmoid_cross_entropy_with_logits", "sign", "silu", "sin",
    "soft_shrink", "swish", "tanh_shrink", "thresholded_relu",
    "truncated_gaussian_random", "uniform_random", "where",
    # the collectives of the other axes move whole rows of the data axes
    "dp_grad_comm", "dp_shard_all_gather", "dp_shard_slice", "pp_recv",
    "pp_send", "tp_allreduce", "tp_ident")

# row-wise along the batch dim only: each example's rows are its own
_BATCH_ROWS = (
    "anchor_generator", "bilinear_interp", "bilinear_tensor_product",
    "box_coder", "conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
    "cos_sim", "crf_decoding", "ctc_align", "density_prior_box",
    "depthwise_conv2d", "dynamic_gru", "dynamic_lstm", "dynamic_lstmp",
    "fill_constant_batch_size_like", "fused_decode_attention", "fused_gru",
    "fused_lstm", "gaussian_random_batch_size_like", "grid_sampler",
    "gru_unit", "hierarchical_sigmoid", "im2sequence", "linear_chain_crf",
    "lrn", "lstm_unit", "maxout", "multiplex", "nce", "pool2d", "pool3d",
    "prelu", "prior_box", "random_crop", "row_conv", "sampling_id",
    "sequence_concat", "sequence_conv", "sequence_erase", "sequence_expand",
    "sequence_first_step", "sequence_last_step", "sequence_pad",
    "sequence_pool", "sequence_reshape", "sequence_reverse",
    "sequence_slice", "sequence_softmax", "smooth_l1_loss", "spp",
    "squared_l2_distance", "uniform_random_batch_size_like", "warpctc")

# mix every row: batch statistics, variable-length outputs, control flow
_MIXING = (
    "array_length", "array_read", "array_write", "auc", "beam_search",
    "bipartite_match", "cache_write", "chunk_eval", "clip_by_norm",
    "cond_block", "crop", "detection_map", "edit_distance", "expand_as",
    "fake_quantize_abs_max", "fake_quantize_moving_average_abs_max",
    "gather_tree", "generate_proposals", "iou_similarity", "is_empty",
    "isfinite", "lazy_cond", "mean_iou", "merge_ids", "multiclass_nms",
    "pad_constant_like", "paged_cache_write", "paged_cache_write_quant",
    "positive_negative_pair", "pp_pipeline_region", "precision_recall",
    "roi_pool", "rpn_target_assign", "scatter", "shape", "split_ids",
    "squared_l2_norm", "ssd_loss", "static_rnn", "switch_case",
    "target_assign", "vjp_region", "while")

#: op type -> rowwise(op, slot, dim, rank): the class of every registered
#: op with neither a sharding-propagation rule nor a cheap form in
#: GLOBAL_BATCH_OPS, and of the tp_* / pp_* collectives, whose rules
#: describe the axis they communicate over
ROW_CLASS = {
    **{t: _every for t in _POINTWISE},
    **{t: _rows for t in _BATCH_ROWS},
    **{t: _mixes for t in _MIXING},
    "arg_max": _but("axis", -1), "arg_min": _but("axis", -1),
    "argsort": _but("axis", -1), "cumsum": _but("axis", -1),
    "l2_normalize": _but("axis", -1), "norm": _but("axis", -1),
    "reverse": _but("axis", 0), "slice": _but("axes", None),
    "split": _but("axis", 0), "tp_allgather": _but("dim", 0),
    "tp_split": _but("dim", 0), "cross_entropy": _not_last,
    "label_smooth": _not_last, "top_k": _not_last, "qmatmul": _not_last,
    "reduce_prod": _unreduced,
    "stack": _before("axis", 0), "unstack": _before("axis", 0),
    "gather": _slot("Index"), "lookup_sparse_table": _slot("Ids"),
    "qlookup": _slot("Ids"), "tp_vocab_lookup": _slot("Ids"),
    "flatten": _flatten, "pad": _pad, "expand": _expand,
}

#: multi-input ops whose inputs meet dim for dim: a whole input meeting an
#: sp-split one is cut to the rank's columns (`_SplitPlan._cuts`), so the
#: split one is never gathered (the LM's targets against its logits)
_ALIGNED = frozenset({
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "elementwise_floordiv", "elementwise_mod",
    "less_than", "less_equal", "greater_than", "greater_equal", "equal",
    "not_equal", "logical_and", "logical_or", "logical_xor", "where",
    "softmax_with_cross_entropy", "cross_entropy",
    "sigmoid_cross_entropy_with_logits", "mse_loss", "log_loss",
    "huber_loss", "smooth_l1_loss", "hinge_loss", "rank_loss",
    "margin_rank_loss", "sum"})


class _OpSplit:
    """How one op of a global-batch step runs over the data axes."""

    __slots__ = ("gathers", "slices", "cuts", "reduce_axes", "ring",
                 "shape")

    def __init__(self):
        self.gathers: List[tuple] = []      # inputs (slot, i, axis, dim)
        self.slices: List[tuple] = []       # outputs (slot, i, axis, dim)
        self.cuts: List[tuple] = []         # whole inputs (slot, i, dim)
        self.reduce_axes: List[str] = []    # a reduction's split axes
        self.ring = False                   # fused_attention over sp
        self.shape = None                   # a reshape's local target


class _SplitPlan:
    """The data-axis split of every value of a program's global block,
    and how each op runs over it. dp: a value declared batch-led is split
    on dim 0 (when dp > 1). sp: the sp-split feeds seed it and each op's
    rule or class carries it to its outputs, so after the LM's head split
    (`transpose(perm=[0, 2, 1, 3])`) it sits on dim 2."""

    def __init__(self, program: Program, mesh: DeviceMesh, sp_feeds=()):
        self.block = block = program.global_block()
        self.dp = mesh.axis_size(DATA_AXIS) > 1
        self.sp_size = mesh.axis_size(SEQUENCE_AXIS)
        self.sp_dim: Dict[str, int] = {n: 1 for n in sp_feeds}
        self.ops: Dict[int, _OpSplit] = {}
        for idx, op in enumerate(block.ops):
            if op.type in ("vjp_region", "pp_pipeline_region"):
                continue
            d = self._plan_op(idx, op)
            if d is not None:
                self.ops[id(op)] = d

    def _shape(self, name):
        if not self.block.has_var(name):
            return None
        return self.block.var(name).shape

    def _rank(self, name) -> Optional[int]:
        shape = self._shape(name)
        return None if shape is None else len(shape)

    def dp_led(self, name) -> bool:
        shape = self._shape(name) if self.dp else None
        return bool(shape) and shape[0] == -1

    # -- one op -----------------------------------------------------------
    def _plan_op(self, idx, op) -> Optional[_OpSplit]:
        ins = [(slot, i, n) for slot, names in op.inputs.items()
               for i, n in enumerate(names)]
        dp_in = [(s, i) for s, i, n in ins if self.dp_led(n)]
        sp_in = {(s, i): self.sp_dim[n] for s, i, n in ins
                 if n in self.sp_dim}
        if not dp_in and not sp_in:
            return None
        enforce(op.type in ROW_CLASS or op.type in GLOBAL_BATCH_OPS
                or lookup_shard_rule(op.type) is not None,
                f"op {op.type!r} reads a value split over the data axes "
                f"but has neither a sharding-propagation rule nor a class "
                f"in parallel_executor.ROW_CLASS: classify it",
                exc=InvalidArgumentError)
        d = _OpSplit()
        if sp_in and op.type in _ALIGNED:
            self._cuts(op, sp_in, d)
        out_sp: Dict[str, int] = {}
        if op.type in GLOBAL_BATCH_OPS:
            out_sp = self._reduction(op, sp_in, d)
        elif sp_in and op.type == "fused_attention" and all(
                sp_in.get((s, 0)) == 2 for s in ("Q", "K", "V")) and all(
                sp_in.get((s, 0)) == 1 for s in ("QSeg", "KVSeg")
                if op.inputs.get(s)):
            d.ring = True
            out_sp = {n: 2 for n in op.output_names()}
        else:
            ok_dp, ok_sp, out_sp = self._rowwise(idx, op, ins, sp_in)
            if not ok_dp:
                d.gathers += [(s, i, DATA_AXIS, 0) for s, i in dp_in]
            if not ok_sp:
                d.gathers += [(s, i, SEQUENCE_AXIS, dim)
                              for (s, i), dim in sp_in.items()]
                out_sp = {}
            elif op.type == "reshape" and sp_in:
                d.shape = self._local_shape(op, out_sp)
        if any(g[2] == DATA_AXIS for g in d.gathers):
            d.slices = [(slot, i, DATA_AXIS, 0)
                        for slot, names in op.outputs.items()
                        for i, n in enumerate(names) if self.dp_led(n)]
        self.sp_dim.update(out_sp)
        return d

    def _cuts(self, op, sp_in, d):
        """Whole inputs meeting an sp-split one dim for dim (trailing
        aligned, or at an elementwise op's `axis`) are cut to the rank's
        columns; a size-1 dim broadcasts and stays whole."""
        axis = op.attrs.get("axis", -1) if op.type.startswith(
            "elementwise_") else -1
        names = [(s, i, n) for s, ns in op.inputs.items()
                 for i, n in enumerate(ns) if self._shape(n)]
        for (rs, ri), rdim in list(sp_in.items()):
            ref = self._shape(op.inputs[rs][ri])
            for s, i, n in names:
                if (s, i) in sp_in:
                    continue
                shape = self._shape(n)
                # Y aligns with X at `axis` (trailing when -1)
                if s == "Y" and axis not in (None, -1):
                    j = rdim - int(axis)
                elif rs == "Y" and axis not in (None, -1):
                    j = rdim + int(axis)
                else:
                    j = rdim - (len(ref) - len(shape))
                if 0 <= j < len(shape) and shape[j] == ref[rdim] \
                        and shape[j] > 1:
                    d.cuts.append((s, i, j))
                    sp_in[(s, i)] = j

    def _reduction(self, op, sp_in, d) -> Dict[str, int]:
        """The exact cheap forms: the local result summed (or maxed) over
        each split axis a reduced dim carries. reduce_max / reduce_min
        under a gradient, and batch_norm over sp, gather instead."""
        slot = "Indices" if op.type == "accuracy" else "X"
        xname = op.inputs[slot][0]
        rank = self._rank(xname) or 0
        if op.type == "batch_norm":
            ch = 1 if op.attrs.get("data_layout", "NCHW") == "NCHW" \
                else rank - 1
            reduced = set(range(rank)) - {ch}
        elif (op.type in ("mean", "accuracy")
              or op.attrs.get("reduce_all", False)
              or op.attrs.get("dim") is None):
            reduced = set(range(rank))
        else:
            reduced = _dims_of(op, "dim", None, rank)
        split = {0: DATA_AXIS} if self.dp_led(xname) else {}
        if (slot, 0) in sp_in:
            split[sp_in[(slot, 0)]] = SEQUENCE_AXIS
        d.reduce_axes = [a for k, a in sorted(split.items()) if k in reduced]
        if op.type == "batch_norm" and SEQUENCE_AXIS in d.reduce_axes:
            d.gathers.append(("X", 0, SEQUENCE_AXIS, sp_in[("X", 0)]))
            d.reduce_axes.remove(SEQUENCE_AXIS)
        if op.type in ("reduce_max", "reduce_min"):
            # the gather a gradient takes
            d.gathers += [(slot, 0, a, k) for k, a in sorted(split.items())
                          if k in reduced]
        dim = sp_in.get((slot, 0))
        if dim is None or dim in reduced or op.type == "accuracy":
            return {}
        if op.type == "batch_norm":
            return {n: dim for n in op.outputs.get("Y", ())}
        if not op.attrs.get("keep_dim", False):
            dim -= sum(1 for k in reduced if k < dim)
        return {n: dim for n in op.outputs.get("Out", ())}

    def _rowwise(self, idx, op, ins, sp_in):
        """(row-wise along dp's dim 0, row-wise along the sp dims, the sp
        dim of each output), by the op's class or its propagation rule."""
        cls = ROW_CLASS.get(op.type)
        dp_in = [(s, n) for s, i, n in ins if self.dp_led(n)]
        if cls is not None:
            ok_dp = all(cls(op, s, 0, self._rank(n)) for s, n in dp_in)
            ok_sp = all(cls(op, s, dim, self._rank(op.inputs[s][i]))
                        for (s, i), dim in sp_in.items())
            out_sp = {}
            if sp_in and ok_sp:
                dim = next(iter(sp_in.values()))
                out_sp = {n: dim for n in op.output_names()
                          if (self._rank(n) or 0) > dim}
            return ok_dp, ok_sp, out_sp
        rule = lookup_shard_rule(op.type)
        out_sp: Dict[str, int] = {}
        ok_dp = not dp_in or self._rule_keeps(idx, op, rule, DATA_AXIS,
                                              {}, sp_in)
        ok_sp = not sp_in or self._rule_keeps(idx, op, rule,
                                              SEQUENCE_AXIS, out_sp, sp_in)
        return ok_dp, ok_sp, out_sp

    def _rule_keeps(self, idx, op, rule, axis, out_dims, sp_in) -> bool:
        """Does the propagation rule keep `axis`' split on one dim of the
        outputs, with no conflict and no partial sum? dp must stay on the
        batch-led outputs' dim 0. Fills `out_dims` (name -> dim)."""
        in_specs = {}
        for slot, names in op.inputs.items():
            specs = []
            for i, n in enumerate(names):
                rank = self._rank(n)
                s = None if rank is None else [None] * rank
                if s is not None and axis == DATA_AXIS and self.dp_led(n):
                    s[0] = DATA_AXIS
                elif s is not None and (slot, i) in sp_in \
                        and axis == SEQUENCE_AXIS:
                    s[sp_in[(slot, i)]] = SEQUENCE_AXIS
                specs.append(None if s is None else tuple(s))
            in_specs[slot] = specs
        sctx = ShardCtx(block=self.block, op=op, op_idx=idx, axis=axis,
                        actions=OpActions(op_idx=idx), diagnostics=[])
        out = rule(sctx, in_specs, dict(op.attrs)) or {}
        if (any(x.severity == "error" for x in sctx.diagnostics)
                or sctx.actions.psums or sctx.actions.gathers):
            return False
        kept = False
        for slot, names in op.outputs.items():
            specs = out.get(slot) or ()
            for i, n in enumerate(names):
                s = specs[i] if i < len(specs) else None
                dims = [k for k, a in enumerate(s or ()) if a == axis]
                if len(dims) > 1:
                    return False
                if axis == DATA_AXIS and (dims == [0]) != self.dp_led(n):
                    return False
                if dims:
                    out_dims[n] = dims[0]
                    kept = True
        return kept or axis == DATA_AXIS

    def _local_shape(self, op, out_sp):
        """A reshape target with its sp-split dim at the rank's length
        (the LM's head split names the whole sequence length)."""
        shape = list(op.attrs.get("shape") or ())
        dim = out_sp.get(op.outputs["Out"][0])
        if dim is not None and dim < len(shape) and shape[dim] > 0:
            shape[dim] //= self.sp_size
        return shape


def _local_block(x, axis, dim):
    """This rank's block of `x` on `dim` over mesh axis `axis`."""
    n = C.axis_size(axis)
    if n == 1:
        return x
    c = x.shape[dim] // n
    return x.narrow(dim, C.axis_index(axis) * c, c)


def _all_gather(x, axis, dim):
    if x.dtype == torch.bool:
        return C.all_gather(x.to(torch.uint8).contiguous(), axis,
                            dim).to(torch.bool)
    return C.all_gather(x.contiguous(), axis, dim)


def _psum(x, axes, reduce_op=None):
    """x summed (or reduced by `reduce_op`, no gradient) over each axis."""
    for a in axes:
        if reduce_op is None:
            x = C.all_reduce(x, a)
        else:
            group = C._group(a)
            if group is not None:
                x = C._ar(x, group, reduce_op)
    return x


def _count(axes) -> int:
    return int(np.prod([C.axis_size(a) for a in axes]))


def _global_mean(ctx, ins, attrs, lower, axes):
    y = lower(ctx, ins, attrs)["Out"][0]
    return {"Out": [_psum(y, axes) / _count(axes)]}


def _global_reduce(kind):
    def fn(ctx, ins, attrs, lower, axes):
        y = lower(ctx, ins, attrs)["Out"][0]
        if kind == "sum":
            return {"Out": [_psum(y, axes)]}
        if kind == "mean":
            return {"Out": [_psum(y, axes) / _count(axes)]}
        import torch.distributed as dist
        return {"Out": [_psum(y, axes, dist.ReduceOp.MAX if kind == "max"
                              else dist.ReduceOp.MIN)]}
    return fn


def _global_accuracy(ctx, ins, attrs, lower, axes):
    out = lower(ctx, ins, attrs)
    correct = _psum(out["Correct"][0].to(torch.float32), axes)
    total = _psum(out["Total"][0].to(torch.float32), axes)
    return {"Accuracy": [correct / total],
            "Correct": [correct.to(torch.int32)],
            "Total": [total.to(torch.int32)]}


class _BNTrainGlobal(torch.autograd.Function):
    """Train-mode batch norm with the statistics of the whole dp batch:
    the local shifted sums are all-reduced in the forward, and the
    backward's two [C] sums in the backward (their transpose). The scale
    and bias gradients stay this rank's share, which the gradient average
    over dp completes. The closed form is the one-card `_BNTrain`'s."""

    @staticmethod
    def forward(ctx, x, scale, bias, shift, axes, bshape, eps, group):
        from ..ops.nn_ops import _bn_affine
        xs = x - shift.float().reshape(bshape)
        n_local = float(np.prod([x.shape[a] for a in axes]))
        sums = torch.stack([xs.sum(axes, dtype=torch.float32),
                            xs.float().square().sum(axes)])
        count = torch.full((1,), n_local, dtype=torch.float32,
                           device=x.device)
        sums = C._ar(torch.cat([sums.reshape(-1), count]), group)
        n = sums[-1]
        s = sums[:-1].reshape(2, -1) / n
        m1, m2 = s[0], s[1]
        mean = m1 + shift.float()
        var = torch.clamp_min(m2 - m1.square(), 0.0)
        inv = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, mean, inv, scale, n)
        ctx.axes, ctx.bshape, ctx.group = axes, bshape, group
        ctx.mark_non_differentiable(mean, var)
        return _bn_affine(x, scale, bias, mean, inv, bshape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, inv, scale, n = ctx.saved_tensors
        axes, bshape = ctx.axes, ctx.bshape
        xc = x - mean.reshape(bshape)
        sum_dy = dy.sum(axes, dtype=torch.float32)
        sum_dy_xc = (dy * xc).sum(axes)
        both = C._ar(torch.cat([sum_dy, sum_dy_xc]), ctx.group)
        g_dy, g_dy_xc = both.chunk(2)
        c0 = (scale * inv).reshape(bshape)
        c1 = (g_dy / n).reshape(bshape)
        c2 = (inv * inv * g_dy_xc / n).reshape(bshape)
        dx = (dy - c1).sub_(xc.mul_(c2)).mul_(c0)
        return (dx.to(x.dtype), (inv * sum_dy_xc).to(scale.dtype), sum_dy,
                None, None, None, None, None)


def _global_batch_norm(ctx, ins, attrs, lower, axes):
    group = C._group(DATA_AXIS)
    if attrs.get("is_test", False) or ctx.is_test or group is None:
        return lower(ctx, ins, attrs)
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != axis)
    bshape = tuple(x.shape[i] if i == axis else 1 for i in range(x.dim()))
    y, batch_mean, batch_var = _BNTrainGlobal.apply(
        x, scale, bias, mean.detach(), axes, bshape, eps, group)
    inv = torch.rsqrt(batch_var + eps)
    rest = 1 - momentum
    if ctx.writes_input("Mean", "MeanOut"):
        ctx.update_state(lambda: mean.mul_(momentum).add_(rest * batch_mean))
        mean_out = mean
    else:
        mean_out = momentum * mean + rest * batch_mean
    if ctx.writes_input("Variance", "VarianceOut"):
        ctx.update_state(lambda: var.mul_(momentum).add_(rest * batch_var))
        var_out = var
    else:
        var_out = momentum * var + rest * batch_var
    return {"Y": [y], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [batch_mean], "SavedVariance": [inv]}


#: the reductions over a split dim with an exact form cheaper than a
#: gather: fn(ctx, ins, attrs, lower, axes) with `axes` the split axes the
#: reduced dims carry. reduce_max / reduce_min take it without a gradient.
GLOBAL_BATCH_OPS = {
    "mean": _global_mean,
    "reduce_sum": _global_reduce("sum"),
    "reduce_mean": _global_reduce("mean"),
    "reduce_max": _global_reduce("max"),
    "reduce_min": _global_reduce("min"),
    "accuracy": _global_accuracy,
    "batch_norm": _global_batch_norm,
}


class _SplitLowering:
    """The `op_overrides` of a global-batch step (lowering.py `run_op`):
    every op of the step's program is lowered by its `_OpSplit`."""

    def __init__(self, split: _SplitPlan):
        self.split = split

    def get(self, op_type, default=None):
        return self.lower

    def lower(self, ctx, ins, attrs, lower):
        d = self.split.ops.get(id(ctx.op))
        if d is None:          # no split input, or a sub-block's op
            return lower(ctx, ins, attrs)
        if d.cuts:
            ins = {k: list(v) for k, v in ins.items()}
            for s, i, dim in d.cuts:
                ins[s][i] = _local_block(ins[s][i], SEQUENCE_AXIS, dim)
        if d.ring:
            return _ring_fused_attention(ins, attrs)
        if d.shape is not None:
            attrs = dict(attrs, shape=d.shape)
        op_type = ctx.op.type
        if d.reduce_axes and op_type in GLOBAL_BATCH_OPS and not (
                op_type in ("reduce_max", "reduce_min")
                and ins["X"][0].requires_grad):
            if d.gathers:      # batch_norm over sp first gathers sp
                ins = self._gather(ins, d.gathers)
            return GLOBAL_BATCH_OPS[op_type](ctx, ins, attrs, lower,
                                             d.reduce_axes)
        if not d.gathers:
            return lower(ctx, ins, attrs)
        out = lower(ctx, self._gather(ins, d.gathers), attrs)
        for slot, i, axis, dim in d.slices:
            vals = out.get(slot)
            if vals is not None and i < len(vals) \
                    and isinstance(vals[i], torch.Tensor):
                vals = out[slot] = list(vals)
                vals[i] = _local_block(vals[i], axis, dim)
        return out

    @staticmethod
    def _gather(ins, gathers):
        ins = {k: list(v) for k, v in ins.items()}
        for s, i, axis, dim in gathers:
            if isinstance(ins[s][i], torch.Tensor):
                ins[s][i] = _all_gather(ins[s][i], axis, dim)
        return ins


def _ring_fused_attention(ins, attrs):
    """`fused_attention` over sp-split q / k / v ([B, H, t, D]): the ring
    (ring_attention.py) over the sp group, K1 a live block in the forward
    and K2 / K3 in the backward against the global logsumexp. K and V are
    never gathered; causal blocks take their global offsets from the
    ring's step case, and segment ids go to the ring block by block."""
    from .ring_attention import _RingAttention
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    seg = None
    if ins.get("QSeg"):
        seg = ins["QSeg"][0].to(torch.int32).contiguous()
    scale = attrs.get("scale")
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    out = _RingAttention.apply(q.contiguous(), k.contiguous(),
                               v.contiguous(), seg, SEQUENCE_AXIS,
                               bool(attrs.get("causal", False)), scale)
    return {"Out": [out]}


def _flat_allreduce_mean(tensors, axis):
    """All-reduce a list of tensors as one flat buffer per dtype and divide
    by the axis size; returns the reduced tensors in order."""
    n = C.axis_size(axis)
    group = C._group(axis)
    out = list(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idxs in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idxs])
        if group is not None:
            flat = C._ar(flat, group)
        flat = flat / n
        off = 0
        for i in idxs:
            k = tensors[i].numel()
            out[i] = flat[off:off + k].view_as(tensors[i])
            off += k
    return out


def _allreduce_grads(env, names, axes=(DATA_AXIS,)):
    """Every gradient the region made, averaged over the data `axes` (dp
    in AllReduce mode; sp too under sequence parallelism, where ZeRO-1's
    rewrite then averages over dp). A sparse embedding gradient's rows
    and values are gathered instead (values scaled by 1/size)."""
    dense = [n for n in names if isinstance(env.get(n), torch.Tensor)]
    for axis in axes:
        for n, g in zip(dense, _flat_allreduce_mean(
                [env[n] for n in dense], axis)):
            env[n] = g
        size = C.axis_size(axis)
        for n in names:
            g = env.get(n)
            if isinstance(g, TracedSelectedRows):
                env[n] = TracedSelectedRows(
                    C.all_gather(g.rows, axis, 0),
                    C.all_gather(g.value, axis, 0) / size, g.height)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


class ParallelExecutor(Executor):
    """Multi-rank executor (≙ fluid.ParallelExecutor). `use_cuda` is
    Fluid's name for the JAX package's `use_tpu`: True runs this rank on
    `CUDAPlace(local_rank)` over NCCL, False on the CPU over gloo (the
    tests' worlds). Each rank of the mesh constructs its own executor and
    calls `run` with the same global feed."""

    def __init__(self,
                 use_cuda: bool = True,
                 loss_name: Optional[str] = None,
                 main_program: Optional[Program] = None,
                 share_vars_from: Optional["ParallelExecutor"] = None,
                 exec_strategy: Optional[ExecutionStrategy] = None,
                 build_strategy: Optional[BuildStrategy] = None,
                 num_trainers: int = 1,
                 trainer_id: int = 0,
                 scope: Optional[Scope] = None,
                 mesh: Optional[DeviceMesh] = None):
        from ..distributed.env import local_rank
        self.mesh = mesh or get_default_mesh()
        enforce(self.mesh.in_mesh,
                f"rank {self.mesh.rank} is not in the mesh (ranks "
                f"{self.mesh.ranks}); only its ranks run its executor",
                exc=InvalidArgumentError)
        if self.mesh.joined:
            import torch.distributed as dist
            backend = dist.get_backend()
            want = "nccl" if use_cuda else "gloo"
            enforce(backend == want,
                    f"use_cuda={use_cuda} runs its collectives on {want}, "
                    f"but this world joined {backend}: a CUDA place uses "
                    f"NCCL and a CPU place gloo, with no other path",
                    exc=InvalidArgumentError)
        super().__init__(CUDAPlace(local_rank()) if use_cuda
                         else CPUPlace())
        self.use_cuda = use_cuda
        self.loss_name = loss_name
        self.main_program = main_program
        self.exec_strategy = exec_strategy or ExecutionStrategy()
        self.build_strategy = build_strategy or BuildStrategy()
        self.scope = scope or global_scope()
        if share_vars_from is not None:
            self.scope = share_vars_from.scope
        self._dp = self.mesh.axis_size(DATA_AXIS)
        self._comm_cache: Dict[Any, Program] = {}
        self._tp_cache: Dict[Any, Program] = {}
        self._pp_cache: Dict[Any, Program] = {}
        self._pp_transport = None
        self._feed_shapes: Dict[str, tuple] = {}
        self._synced = set()
        bs = self.build_strategy
        if _grad_comm.explicit_comm_config(bs) is not None:
            enforce(DATA_AXIS in self.mesh.axes,
                    f"the explicit gradient pipeline (ReduceScatter / "
                    f"quant_comm) needs a {DATA_AXIS!r} axis in the mesh, "
                    f"got axes {self.mesh.axis_names}",
                    exc=InvalidArgumentError)
        if bs.gradient_scale_strategy == GradientScaleStrategy.CoeffNumDevice:
            raise NotImplementedError(
                "GradientScaleStrategy.CoeffNumDevice is not implemented: "
                "the global-batch `mean` already scales the loss gradient; "
                "build the program with a mean-reduced loss "
                "(GradientScaleStrategy.One) instead")
        self._plan_cache: Dict[Any, Program] = {}
        self._split_cache: Dict[Any, _SplitPlan] = {}
        self._split: Optional[_SplitPlan] = None
        self._host_opt = None
        self._host_opt_key = None

    # -- placement --------------------------------------------------------
    @staticmethod
    def _find_var(program: Program, name: str) -> Optional[Variable]:
        for b in program.blocks:
            if b.has_var(name):
                return b.var(name)
        return None

    def _state_sharding(self, program: Program, name: str) -> Placement:
        """Where a state var lives: split per its rewrite markers (a tp
        block per `tp_spec`; dim 0 over dp for ZeRO-1 accumulators and
        per-rank residuals, within the tp block), else replicated."""
        v = self._find_var(program, name)
        if v is None or not v.shape:
            return self.mesh.replicated()
        rank = len(v.shape)
        tp_spec = list(getattr(v, "tp_spec", None) or ())
        tp_spec += [None] * (rank - len(tp_spec))
        tp_live = getattr(program, "_tp_applied", False)
        entries: List[Any] = [MODEL_AXIS if (s == MODEL_AXIS and tp_live)
                              else None for s in tp_spec[:rank]]
        if (getattr(v, "dp_shard_update", False)
                or getattr(v, "dp_replica_state", False)):
            entries[0] = ((MODEL_AXIS, DATA_AXIS)
                          if entries[0] == MODEL_AXIS else DATA_AXIS)
        if not any(e is not None for e in entries):
            return self.mesh.replicated()
        return self.mesh.sharding(*entries)

    def state_sharding(self, program: Program, name: str) -> Placement:
        return self._state_sharding(program, name)

    @property
    def device_count(self) -> int:
        return self.mesh.num_devices

    # -- the rewrites -----------------------------------------------------
    def _manual(self, program) -> bool:
        """Does the step run per rank (the explicit dp modes, a pipeline)
        rather than under global-batch semantics?"""
        return ((getattr(program, "_dp_comm_applied", False)
                 and not getattr(program, "_zero1_applied", False))
                or getattr(program, "_pp_applied", False))

    def _gate_manual_mode(self, program: Program, what: str,
                          manual: bool = True):
        """≙ the JAX package's gate: the manual modes (explicit dp comm, a
        pipeline) refuse sequence parallelism, which splits each dp
        shard's sequences the per-rank step consumes whole; every mode
        refuses parameters sharded over a non-tp axis, and tp-sharded ones
        the tp rewrite did not make executable. A split over an axis of
        size 1 is replicated (the JAX gate refuses it: its tp rewrite
        needs tp >= 2)."""
        from ..core import flags
        from ..framework.sharding import tp_component
        enforce(not (manual and self.build_strategy.enable_sequence_parallel),
                f"{what} runs the step manually over the whole mesh and "
                f"consumes each dp shard's sequences WHOLE, so "
                f"sequence-parallel feed splitting "
                f"(enable_sequence_parallel) cannot compose with it (with "
                f"or without TP). Use the SPMD AllReduce/Reduce "
                f"strategies for sp programs; tp-sharded params compose "
                f"with {what} via the tp_shard_pass path",
                exc=InvalidArgumentError)
        for b in program.blocks:
            for v in b.vars.values():
                spec = getattr(v, "sharding_spec", None)
                if not v.persistable or spec is None:
                    continue
                axes = set()
                for s in self.mesh.pspec(*spec):
                    if isinstance(s, (tuple, list)):
                        axes.update(s)
                    elif s is not None:
                        axes.add(s)
                # an axis of size 1 splits nothing: replicated
                axes = {a for a in axes if self.mesh.axis_size(a) > 1}
                non_tp = sorted(axes - {MODEL_AXIS})
                if non_tp:
                    raise InvalidArgumentError(
                        f"parameter {v.name!r} is sharded over mesh axes "
                        f"{non_tp} — {what} runs the step per rank and only "
                        f"the tp axis has a rewrite pass (tp_shard_pass) "
                        f"that splices the needed collectives")
                if axes and not getattr(program, "_tp_applied", False):
                    hint = ("the PTPU_TP_SHARD=0 kill switch disabled the "
                            "tp_shard_pass rewrite"
                            if not flags.get_flag("tp_shard") else
                            "the annotation sits on a sub-block parameter")
                    raise InvalidArgumentError(
                        f"parameter {v.name!r} is tp-sharded "
                        f"({tp_component(spec)}) but the program was not "
                        f"rewritten for tp execution: {hint}")

    def _apply_tp_shard(self, program: Program) -> Program:
        from ..core import flags
        from ..framework.sharding import has_tp_annotations
        tpn = self.mesh.axis_size(MODEL_AXIS)
        if (tpn <= 1 or not flags.get_flag("tp_shard")
                or getattr(program, "_tp_applied", False)
                or not has_tp_annotations(program)):
            return program
        key = (id(program), program._version, tpn)
        rewritten = self._tp_cache.get(key)
        if rewritten is None:
            from ..framework.passes import get_pass
            rewritten = get_pass("tp_shard_pass", tp=tpn)(program)
            self._tp_cache[key] = rewritten
        return rewritten

    def _prepare_program(self, program: Program, scope: Scope) -> Program:
        """The program as this executor runs it, each rewrite cached per
        (program, version, config):

        0. the auto-parallel planner (`auto_parallel`) may first replace
           the strategy and mesh the rewrites below are made for;
        1. tp_shard_pass for a tp-annotated program on a tp mesh;
        2. grad_comm's rewrite for the explicit modes (ReduceScatter /
           quant_comm), or for ZeRO-1 (Reduce) when no pipeline runs (the
           pipeline's step is per rank: its region averages over dp);
        3. pipeline_partition_pass (`pipeline_stages` >= 2) on the
           (possibly comm-rewritten) program;
        4. memory_plan_pass (`memory_plan`, PTPU_MEMORY_PLAN=1) over the
           program AS REWRITTEN: scheduling, buffer coloring and the
           remat-vs-stash search decide on the ops the step runs."""
        if getattr(program, "_memory_plan_applied", False):
            return program
        self._maybe_auto_plan(program)
        return self._apply_memory_plan(
            self._prepare_parallel(program, scope))

    def _apply_memory_plan(self, program: Program) -> Program:
        """≙ the JAX package's: memory_plan_pass (cached) with every
        strategy field the plan reads in the key."""
        from ..core import flags
        bs = self.build_strategy
        if (not getattr(bs, "memory_plan", False)
                or not flags.get_flag("memory_plan")
                or getattr(program, "_memory_plan_applied", False)):
            return program
        batch = max((s[0] for s in self._feed_shapes.values()
                     if len(s) >= 1), default=8)
        budget_s = float(getattr(bs, "memory_plan_time_budget_s", 0.0)
                         or 0.0)
        prevent_cse = bool(getattr(bs, "memory_plan_prevent_cse", False))
        time_frac = float(getattr(bs, "memory_plan_time_frac", 0.02))
        stash_host = bool(getattr(bs, "memory_plan_stash_to_host", False))
        key = (id(program), program._version, int(batch), budget_s,
               prevent_cse, time_frac, stash_host)
        planned = self._plan_cache.get(key)
        if planned is None:
            from ..framework.passes import get_pass
            planned = get_pass(
                "memory_plan_pass", nominal_batch=int(batch),
                time_budget_s=(budget_s or None),
                time_budget_frac=time_frac,
                remat_prevent_cse=prevent_cse,
                stash_to_host=stash_host)(program)
            # the port's own markers ride the planned clone too
            for m in ("_zero1_applied", "_tp_applied"):
                setattr(planned, m, getattr(program, m, False))
            self._plan_cache[key] = planned
        return planned

    def _prepare_parallel(self, program: Program, scope: Scope) -> Program:
        if getattr(program, "_pp_applied", False):
            return program
        bs = self.build_strategy
        pcfg = _pipeline.pipeline_config(bs)
        if not getattr(program, "_dp_comm_applied", False):
            program = self._apply_tp_shard(program)
            cfg = _grad_comm.explicit_comm_config(bs)
            if cfg is not None:
                self._gate_manual_mode(
                    program, "the explicit gradient pipeline "
                    "(ReduceScatter / quant_comm)")
            elif bs.reduce_strategy == ReduceStrategy.Reduce \
                    and pcfg is None:
                cfg = {"shard_update": True, "quant": "",
                       "block": int(bs.quant_comm_block),
                       "error_feedback": False,
                       "bucket_bytes": int(bs.comm_bucket_bytes),
                       "global_batch": True}
            else:
                self._gate_manual_mode(program, "ParallelExecutor",
                                       manual=False)
            if cfg is not None:
                key = (id(program), program._version,
                       tuple(sorted(cfg.items())))
                rewritten = self._comm_cache.get(key)
                if rewritten is None:
                    rewritten = _grad_comm.comm_optimize_pass(
                        program, self._dp, cfg)
                    rewritten._zero1_applied = bool(cfg.get("global_batch"))
                    self._comm_cache[key] = rewritten
                program = rewritten
        if pcfg is not None:
            program = self._apply_pipeline(program, pcfg)
        return program

    def _apply_pipeline(self, program: Program, pcfg: Dict) -> Program:
        """pipeline_partition_pass (cached) for the resolved pipeline
        config, on a mesh whose pp axis has exactly one rank per stage."""
        enforce(PIPELINE_AXIS in self.mesh.axes
                and self.mesh.axis_size(PIPELINE_AXIS) == pcfg["stages"],
                f"BuildStrategy.pipeline_stages={pcfg['stages']} needs a "
                f"{PIPELINE_AXIS!r} mesh axis of exactly that size; this "
                f"mesh has axes {dict(self.mesh.axes)}",
                exc=InvalidArgumentError)
        self._gate_manual_mode(program, "pipeline-parallel execution")
        key = (id(program), program._version, tuple(sorted(pcfg.items())))
        rewritten = self._pp_cache.get(key)
        if rewritten is None:
            from ..framework.passes import get_pass
            has_dp = DATA_AXIS in self.mesh.axes
            rewritten = get_pass(
                "pipeline_partition_pass",
                num_stages=pcfg["stages"],
                num_microbatches=pcfg["microbatches"],
                schedule=pcfg["schedule"],
                dp_axis=DATA_AXIS if has_dp else "",
                # grad_comm owns the dp reduction when its rewrite ran
                reduce_dp=(has_dp and not getattr(
                    program, "_dp_comm_applied", False)),
            )(program)
            rewritten._zero1_applied = False
            self._pp_cache[key] = rewritten
        return rewritten

    # -- the auto-parallel planner ------------------------------------------
    def _maybe_auto_plan(self, program: Program):
        """BuildStrategy.auto_parallel: run the planner
        (framework/auto_parallel.py) once per (program version, rank count,
        batch) and ADOPT its choice — the chosen BuildStrategy knobs and the
        chosen factorization of this executor's ranks. Planning starts from
        the user's strategy (the quantized wire stays pinned to it), so
        repeated prepares converge. The kill switch PTPU_AUTO_PARALLEL=0
        reverts to the user's strategy and mesh. A new mesh is made on
        every rank in the same order (its process groups are collective
        calls): every rank of the world runs this executor."""
        from ..core import flags
        if not getattr(self.build_strategy, "auto_parallel", False):
            return
        if getattr(self, "_auto_plan_suspended", False):
            # replan_on_restore prices the kept side through
            # prepare_program; planning here would adopt mid-pricing
            return
        if not flags.get_flag("auto_parallel"):
            orig = getattr(self, "_auto_orig", None)
            if orig is not None and getattr(self, "_auto_adopted", False):
                self.build_strategy, self.mesh = orig
                self._dp = self.mesh.axis_size(DATA_AXIS)
                self._auto_adopted = False
                self._auto_plan = None
                self._auto_plan_keys = set()
            return
        if (getattr(program, "_dp_comm_applied", False)
                or getattr(program, "_pp_applied", False)
                or getattr(program, "_memory_plan_applied", False)):
            return   # already-rewritten view: the decision was made
        batch = max((s[0] for s in self._feed_shapes.values()
                     if len(s) >= 1), default=8)
        key = (id(program), program._version, self.mesh.num_devices,
               int(batch))
        done = getattr(self, "_auto_plan_keys", None)
        if done is None:
            done = self._auto_plan_keys = set()
        # batch None: an elastic restore's decision, for any batch
        # (auto_parallel.replan_on_restore priced it against the one-time
        # reshard; re-planning here would override it without that price)
        if key in done or key[:3] + (None,) in done:
            return
        from ..framework import auto_parallel as _auto
        if not getattr(self, "_auto_orig", None):
            self._auto_orig = (self.build_strategy, self.mesh)
        base = self._auto_orig[0]
        result = _auto.plan(
            program, self.mesh.num_devices, nominal_batch=int(batch),
            strategy_base=base,
            space=_auto.numerics_preserving_space(base))
        done.add(key)
        self._auto_plan = result
        self.build_strategy = result.strategy
        if dict(result.mesh_axes) != dict(self.mesh.axes):
            meshes = getattr(self, "_auto_meshes", None)
            if meshes is None:
                meshes = self._auto_meshes = {}
            axes_key = tuple(sorted(result.mesh_axes.items()))
            mesh = meshes.get(axes_key)
            if mesh is None:
                mesh = meshes[axes_key] = DeviceMesh(
                    self._auto_orig[1].ranks, dict(result.mesh_axes))
            self.mesh = mesh
            self._pp_transport = None
        self._dp = self.mesh.axis_size(DATA_AXIS)
        self._auto_adopted = True

    def auto_plan_report(self):
        """The adopted PlanResult of the auto-parallel planner — None
        until a prepare ran with BuildStrategy.auto_parallel=True (and the
        PTPU_AUTO_PARALLEL kill switch up)."""
        return getattr(self, "_auto_plan", None)

    def prepare_program(self, program: Optional[Program] = None,
                        scope: Optional[Scope] = None) -> Program:
        """The program AS THIS EXECUTOR RUNS IT (after the rewrites)."""
        return self._prepare_program(
            program or self.main_program or default_main_program(),
            scope or self.scope)

    # -- state ------------------------------------------------------------
    def _sync_state(self, program: Program, scope: Scope):
        """At the first run of a (program, scope): broadcast every
        persistable the program uses from the mesh's first rank (one
        flat broadcast per dtype), then cut each split var to this rank's
        block and zero-create the per-rank error-feedback residuals."""
        key = (id(program), program._version, id(scope))
        if key in self._synced:
            self._cut_full_values(program, scope)
            return
        from ..observability import tracing as _tracing
        with _tracing.span("collective", "parallel/sync_state"):
            names = sorted({v.name for b in program.blocks
                            for v in b.vars.values()
                            if v.persistable and scope.has_var(v.name)})
            local = {n for n in names
                     if not self._state_sharding(program, n).is_replicated
                     and self._is_local(program, scope, n)}
            if self.mesh.joined:
                tensors = [scope.get(n) for n in names if n not in local
                           and isinstance(scope.get(n), torch.Tensor)]
                self._broadcast(tensors)
            for n in names:
                place = self._state_sharding(program, n)
                if place.is_replicated:
                    continue
                register_split_state(scope, n, self.mesh, place,
                                     self._find_var(program, n).shape)
                if n not in local:
                    scope.set_var(n, self.mesh.local_slice(
                        scope.get(n), place).contiguous())
            for b in program.blocks:
                for v in b.vars.values():
                    if getattr(v, "dp_replica_state", False) \
                            and not scope.has_var(v.name):
                        shape = list(v.shape)
                        shape[0] = 1
                        scope.set_var(v.name, torch.zeros(
                            shape, dtype=torch.float32, device=self.device))
        self._synced.add(key)

    def _cut_full_values(self, program, scope):
        """After the first run: a split var whose scope value is whole
        again (a non-sharded checkpoint loaded into the scope) is cut back
        to this rank's block."""
        for n, (mesh, place, shape) in split_state(scope).items():
            if mesh is not self.mesh or not scope.has_var(n):
                continue
            val = scope.get(n)
            if (isinstance(val, torch.Tensor)
                    and tuple(val.shape) == tuple(shape)):
                scope.set_var(n, self.mesh.local_slice(
                    val.to(self.device), place).contiguous())

    def _is_local(self, program, scope, name) -> bool:
        """Does the scope already hold this rank's block of a split var
        (an earlier executor on the same scope cut it)?"""
        v = self._find_var(program, name)
        val = scope.get(name)
        return (v is not None and v.shape is not None
                and tuple(val.shape) != tuple(v.shape))

    def _broadcast(self, tensors):
        import torch.distributed as dist
        src = self.mesh.ranks[0]
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src=src, group=self.mesh.mesh_group)
            off = 0
            for t in ts:
                k = t.numel()
                t.copy_(flat[off:off + k].view_as(t))
                off += k

    # -- feeds and fetches -------------------------------------------------
    def _batch_led_feed(self, program: Program, name: str) -> bool:
        """A feed DECLARED batch-led ([-1, ...]), or undeclared (sidecars
        like @SEQLEN, batch-led by construction)."""
        v = self._find_var(program, name)
        shape = getattr(v, "shape", None) if v is not None else None
        return shape is None or (bool(shape) and shape[0] == -1)

    def _pad_for_dp(self, program, feed):
        """Make a partial batch runnable: pad every batch-led feed up to the
        next dp multiple by wrapping real rows, and zero the padded rows of
        the batch-row mask so a mask-weighted loss counts real rows only
        (≙ reference details/data_balance_op_handle.cc). Returns (feed,
        real_rows, padded_rows)."""
        from ..framework.program import BATCH_ROW_MASK_NAME
        sizes = {np.shape(v)[0] for n, v in feed.items()
                 if np.ndim(v) >= 1 and self._batch_led_feed(program, n)}
        if not sizes:
            return feed, None, None
        enforce(len(sizes) == 1,
                f"feed batch dims disagree across vars: {sorted(sizes)} "
                f"(≙ SplitLoDTensor batch split needs one batch size)",
                exc=InvalidArgumentError)
        b = sizes.pop()
        m = getattr(program, "_pp_microbatches", 0)
        if m:
            enforce(b % (self._dp * m) == 0,
                    f"feed batch size {b} is not divisible by "
                    f"dp * num_microbatches = {self._dp} * {m}: the "
                    f"pipeline schedule derives the global-mean loss from "
                    f"EQUAL microbatches on EQUAL dp shards, so "
                    f"wrap-padding would bias it. Feed divisible batches "
                    f"in pipeline mode", exc=InvalidArgumentError)
        if b % self._dp == 0:
            return feed, b, b
        enforce(_grad_comm.explicit_comm_config(self.build_strategy) is None,
                f"feed batch size {b} is not divisible by data-parallel "
                f"degree {self._dp}: the explicit gradient pipeline "
                f"(ReduceScatter / quant_comm) derives the global-mean "
                f"gradient from EQUAL per-shard batches, so wrap-padding "
                f"would bias it. Feed dp-divisible batches in this mode",
                exc=InvalidArgumentError)
        enforce(BATCH_ROW_MASK_NAME in program.global_block().vars,
                f"feed batch size {b} is not divisible by data-parallel "
                f"degree {self._dp}, and the program does not declare "
                f"layers.batch_row_mask() — padding without a mask would "
                f"silently bias an unweighted mean loss (wrapped rows "
                f"counted twice). Either make the batch dp-divisible or "
                f"declare the mask and weight the loss by it "
                f"(loss = reduce_sum(per_ex*mask)/reduce_sum(mask))",
                exc=InvalidArgumentError)
        p = ((b + self._dp - 1) // self._dp) * self._dp
        idx = np.arange(p) % b
        out = {}
        for name, val in feed.items():
            if (np.ndim(val) >= 1 and np.shape(val)[0] == b
                    and self._batch_led_feed(program, name)):
                out[name] = np.take(np.asarray(val), idx, axis=0)
            else:
                out[name] = val
        if BATCH_ROW_MASK_NAME in out:
            mask = np.asarray(out[BATCH_ROW_MASK_NAME], np.float32).copy()
        else:
            mask = np.ones((p,), np.float32)
        mask[b:] = 0.0
        out[BATCH_ROW_MASK_NAME] = mask
        return out, b, p

    def _sp_on(self, program) -> bool:
        """Sequence parallelism: `enable_sequence_parallel` on a mesh with
        an sp axis (of any size: sp 1 runs the split and a one-block
        ring), in the global-batch modes."""
        return (bool(self.build_strategy.enable_sequence_parallel)
                and SEQUENCE_AXIS in self.mesh.axes
                and not self._manual(program))

    def _sp_feed(self, program, name, val) -> bool:
        """≙ the JAX `_feed_sharding`: a sequence feed (declared with
        lod_level > 0, fed at rank >= 2) is split [B over dp, T over sp];
        the other feeds (and sidecars such as tokens@SEQLEN) over dp
        only."""
        v = self._find_var(program, name)
        return (self._sp_on(program) and v is not None
                and getattr(v, "lod_level", 0) > 0 and np.ndim(val) >= 2)

    def _local_feed(self, program, feed):
        """This rank's rows of every batch-led feed (the global batch is
        dp-divisible by now), and its columns of every sp-split one."""
        i = self.mesh.axis_index(DATA_AXIS)
        sp = self.mesh.axis_size(SEQUENCE_AXIS)
        j = self.mesh.axis_index(SEQUENCE_AXIS)
        out = {}
        for name, val in feed.items():
            if np.ndim(val) >= 1 and self._batch_led_feed(program, name):
                c = np.shape(val)[0] // self._dp
                val = val[i * c:(i + 1) * c]
            if self._sp_feed(program, name, val):
                t = np.shape(val)[1]
                enforce(t % sp == 0,
                        f"sequence feed {name!r} of length {t} does not "
                        f"split over sp={sp}: feed a length divisible by "
                        f"the sp axis", exc=InvalidArgumentError)
                val = val[:, j * (t // sp):(j + 1) * (t // sp)]
            out[name] = val
        return out

    def _batch_led_fetches(self, program, fetch_list):
        out = []
        for f in fetch_list or []:
            name = f.name if isinstance(f, Variable) else f
            v = self._find_var(program, name)
            shape = getattr(v, "shape", None) if v is not None else None
            out.append(bool(shape) and shape[0] == -1)
        return out

    def _check_fetches(self, program, fetch_names, batch_led):
        """A pipeline's forward activations exist per microbatch on their
        stage only: fetching one is refused. The manual modes return
        non-batch-led fetches as the mean over dp: a directly detectable
        sum fetch is refused (≙ the JAX package's contract)."""
        hidden = getattr(program, "_pp_hidden", frozenset())
        for name in fetch_names:
            enforce(name not in hidden,
                    f"fetch target {name!r} is a forward activation "
                    f"(or a value derived from one — e.g. a pruned "
                    f"metric head) computed inside the pipeline "
                    f"region: its values only ever exist "
                    f"per-microbatch on their stage's device, so "
                    f"pipeline mode can fetch only the loss (and "
                    f"values computed outside the region). Drop the "
                    f"fetch or run without pipeline_stages",
                    exc=InvalidArgumentError)
        if not self._manual(program) or DATA_AXIS not in self.mesh.axes:
            return
        producers = {n: op.type for blk in program.blocks
                     for op in blk.ops for n in op.output_names()}
        for name, led in zip(fetch_names, batch_led):
            if led:
                continue
            enforce(producers.get(name) not in ("reduce_sum", "sum"),
                    f"fetch {name!r} is a sum reduction: manual-mode "
                    f"execution returns non-batch-led fetches as "
                    f"the MEAN over data shards, which would silently "
                    f"divide a batch sum by {self._dp}. Fetch a "
                    f"mean-form statistic (or the per-row tensor) "
                    f"instead, or use the SPMD AllReduce/Reduce "
                    f"strategies", exc=InvalidArgumentError)

    def _merge_fetch(self, program, name, t, led, stacked=False):
        """A rank's fetch -> the global value."""
        if not isinstance(t, torch.Tensor):
            return t
        axis0 = 1 if stacked else 0
        split = self._split
        sp_dim = split.sp_dim.get(name) if split is not None else None
        if sp_dim is not None and t.dim() > sp_dim + axis0:
            # a sequence-led fetch: the rank's columns gathered over sp
            t = C.all_gather(t.contiguous(), SEQUENCE_AXIS, sp_dim + axis0)
        if led and t.dim() > axis0:
            t = C.all_gather(t, DATA_AXIS, axis0)
        elif (self._manual(program) and t.is_floating_point()
              and DATA_AXIS in self.mesh.axes):
            t = C.all_reduce(t, DATA_AXIS) / self._dp
        v = self._find_var(program, name)
        spec = getattr(v, "tp_spec", None) if v is not None else None
        if spec and getattr(program, "_tp_applied", False):
            for d, s in enumerate(spec):
                if s == MODEL_AXIS and d + axis0 < t.dim():
                    t = C.all_gather(t, MODEL_AXIS, d + axis0)
        return t

    # -- a step -------------------------------------------------------------
    def _step_seed(self, seed: int) -> int:
        return (seed + self.mesh.axis_index(DATA_AXIS) * 2654435761) \
            % 2147483648

    def _step_extras(self, plan) -> Dict[str, Any]:
        program = plan.program
        if getattr(program, "_pp_applied", False):
            if self._pp_transport is None \
                    or self._pp_transport.mesh is not self.mesh:
                self._pp_transport = _pipeline.DistTransport(
                    self.mesh, PIPELINE_AXIS)
            return {"pp_transport": self._pp_transport}
        if self._manual(program):
            self._split = None
            return {}
        sp_feeds = tuple(n for n in plan.feed_names
                         if self._sp_on(program)
                         and getattr(self._find_var(program, n),
                                     "lod_level", 0) > 0
                         and len(getattr(self._find_var(program, n),
                                         "shape", None) or ()) >= 2)
        key = ("split_plan", id(self.mesh), sp_feeds)
        split = plan.constants.get(key)
        if split is None:
            split = plan.constants[key] = _SplitPlan(program, self.mesh,
                                                     sp_feeds)
        self._split = split
        extras = {"op_overrides": _SplitLowering(split)}
        # parameter gradients: averaged over dp, and over sp, where each
        # rank's share is its own columns' (the global loss's gradient)
        axes = (DATA_AXIS, SEQUENCE_AXIS) if sp_feeds else (DATA_AXIS,)
        if getattr(program, "_dp_comm_applied", False):
            # ZeRO-1's rewrite averages over dp itself
            axes = axes[1:]
        if axes:
            extras["grad_allreduce"] = functools.partial(_allreduce_grads,
                                                         axes=axes)
        return extras

    def _run_env(self, plan, feed_vals, ro_vals, rw_vals, random_seed):
        from ..observability import tracing as _tracing
        with self.mesh, _tracing.rank_scope(
                "mesh", self.mesh.rank, self.mesh.num_devices), \
                _grad_comm.dp_index_scope(
                    self.mesh.axis_index(DATA_AXIS)), \
                _tensor_parallel.tp_index_scope(
                    self.mesh.axis_index(MODEL_AXIS)), \
                _pipeline.pp_index_scope(
                    self.mesh.axis_index(PIPELINE_AXIS)):
            return super()._run_env(plan, feed_vals, ro_vals, rw_vals,
                                    random_seed)

    def _enter(self, program, scope, feeds):
        program = program or self.main_program or default_main_program()
        scope = scope or self.scope
        if feeds and feeds[0]:
            # the planner's nominal batch
            self._feed_shapes = {n: np.shape(v)
                                 for n, v in feeds[0].items()}
        program = self._prepare_program(program, scope)
        # ZeRO-offload: the accumulators come back at step entry (h2d on
        # the side stream, the compute stream waits on it)
        host_opt = self._host_optimizer_state(program, scope)
        if host_opt is not None:
            host_opt.restore()
        self._sync_state(program, scope)
        real_b = padded_b = None
        local = []
        for feed in feeds:
            f, real_b, padded_b = self._pad_for_dp(program, dict(feed or {}))
            f = self._synthesize_batch_mask(program, f)
            local.append(self._local_feed(program, f))
        return program, scope, local, real_b, padded_b

    def _finish(self, program, fetch_list, fetches, real_b, padded_b,
                stacked, return_numpy):
        names = [f.name if isinstance(f, Variable) else f
                 for f in (fetch_list or [])]
        led = self._batch_led_fetches(program, names)
        with self.mesh:
            out = [self._merge_fetch(program, n, t, l, stacked)
                   for n, t, l in zip(names, fetches, led)]
        if real_b is not None and padded_b != real_b:
            out = [(f[:, :real_b] if stacked else f[:real_b])
                   if (l and isinstance(f, torch.Tensor)
                       and f.dim() >= (2 if stacked else 1)) else f
                   for f, l in zip(out, led)]
        if return_numpy:
            return [as_numpy(f) for f in out]
        return out

    def run(self,
            fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
            feed: Optional[Dict[str, Any]] = None,
            program: Optional[Program] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True):
        """≙ ParallelExecutor.run (reference parallel_executor.py:168):
        one step of the global batch `feed` over the mesh. Argument order
        follows the reference (fetch_list first)."""
        program, scope, (lfeed,), real_b, padded_b = self._enter(
            program, scope, [feed])
        names = [f.name if isinstance(f, Variable) else f
                 for f in (fetch_list or [])]
        self._check_fetches(program, names,
                            self._batch_led_fetches(program, names))
        fetches = super().run(program=program, feed=lfeed,
                              fetch_list=names, scope=scope,
                              return_numpy=False)
        out = self._finish(program, names, fetches, real_b, padded_b,
                           False, return_numpy)
        self._offload_after_step()
        return out

    def run_steps(self, feed_list, fetch_list=None, program=None,
                  scope=None, return_numpy=True):
        """k steps of one feed signature in one call (see
        Executor.run_steps); each step's global batch is split over dp
        exactly as in run(). Fetches are stacked over steps."""
        enforce(len(feed_list) >= 1, "run_steps needs at least one feed",
                exc=InvalidArgumentError)
        program, scope, lfeeds, real_b, padded_b = self._enter(
            program, scope, feed_list)
        names = [f.name if isinstance(f, Variable) else f
                 for f in (fetch_list or [])]
        self._check_fetches(program, names,
                            self._batch_led_fetches(program, names))
        fetches = super().run_steps(lfeeds, fetch_list=names,
                                    program=program, scope=scope,
                                    return_numpy=False)
        out = self._finish(program, names, fetches, real_b, padded_b,
                           True, return_numpy)
        self._offload_after_step()
        return out

    def prepare(self, program=None, feed=None, fetch_list=None,
                scope=None):
        """A bound step pins the read-write state at bind time; with the
        optimizer state offloaded the executor drops those tensors
        between steps and restores fresh ones, which a bound step would
        not see: refused (run() / run_steps() restore and offload)."""
        enforce(not getattr(self.build_strategy, "offload_optimizer_state",
                            False),
                "ParallelExecutor.prepare with offload_optimizer_state: a "
                "bound step would hold accumulators the executor drops "
                "between steps; call run() or run_steps()",
                exc=InvalidArgumentError)
        return super().prepare(program, feed, fetch_list, scope)

    # -- host-offloaded optimizer state (framework/offload.py) -------------
    def _host_optimizer_state(self, program, scope):
        """The HostOptimizerState of this (program, scope), built on first
        use; None when the knob is off, the PTPU_OFFLOAD=0 kill switch is
        down, or the program has no optimizer accumulators. Each rank
        offloads its own blocks (its ZeRO-1 rows)."""
        if not getattr(self.build_strategy, "offload_optimizer_state",
                       False):
            return None
        if os.environ.get("PTPU_OFFLOAD", "1") == "0":
            return None
        from ..framework import offload as _offload
        key = (id(program), program._version, id(scope))
        if self._host_opt_key == key:
            return self._host_opt
        prev = self._host_opt
        if prev is not None:
            # the program or scope changed: bring the old state home and
            # return its slab before re-keying
            prev.restore()
            prev.release()
            self._host_opt = self._host_opt_key = None
        names = _offload.optimizer_state_names(program, scope)
        if not names:
            return None
        self._host_opt = _offload.HostOptimizerState(
            scope, names, stream=_offload.shared_stream(self.place))
        self._host_opt_key = key
        return self._host_opt

    def _offload_after_step(self):
        if self._host_opt is not None \
                and self._host_opt_key is not None:
            self._host_opt.offload()

    # -- reports ------------------------------------------------------------
    def cost_report(self, program: Optional[Program] = None,
                    scope: Optional[Scope] = None,
                    nominal_batch: int = 8) -> Dict:
        """framework.costs.predict() over the program AS THIS EXECUTOR
        RUNS IT (after the tp / dp-comm / pipeline rewrites), with the
        mesh's dp / tp degrees filled in."""
        from ..framework import costs as _costs
        program = program or self.main_program or default_main_program()
        rewritten = self._prepare_program(program, scope or self.scope)
        return _costs.predict(rewritten, self.build_strategy, dp=self._dp,
                              tp=self.mesh.axis_size(MODEL_AXIS),
                              nominal_batch=nominal_batch)

    def memory_report(self, feed, program: Optional[Program] = None,
                      scope: Optional[Scope] = None,
                      nominal_batch: int = 8) -> Dict:
        """Predicted and measured memory of the program as run, in one
        dict: `predicted` is cost_report()["memory"], `measured` the
        census of one step on this rank (`observability.memory.
        device_memory_census`, run on copies of the state; every rank of
        the mesh calls it together, as a step)."""
        from ..observability.memory import device_memory_census
        report = self.cost_report(program=program, scope=scope,
                                  nominal_batch=nominal_batch)
        program, scope, (lfeed,), _, _ = self._enter(program, scope, [feed])
        census = device_memory_census(self, lfeed, scope, program=program)
        self._offload_after_step()
        return {"predicted": report["memory"], "measured": census}
