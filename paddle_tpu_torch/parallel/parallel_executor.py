"""ParallelExecutor: data- and tensor-parallel program execution.

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
  semantics: every op that reduces over the batch dim (`mean`,
  `reduce_sum` / `reduce_mean` over dim 0 or all dims, train-mode
  `batch_norm`'s statistics, `accuracy`) sums its local part over the dp
  group, with the all-reduce's transpose (an all-reduce) in the backward;
  each rank's parameter gradients are then averaged over dp. With every
  rank seeding its backward with 1, that average is exactly the gradient
  of the global loss (each batch reduction's backward all-reduce carries
  the other ranks' share, and a term the ranks compute alike counts once).
  So a rank whose rows are all padding reduces nothing locally and still
  sees the global loss (no NaN). AllReduce averages the gradients with one
  bucketed all-reduce per dtype; Reduce runs grad_comm's rewrite
  (reduce-scatter, the optimizer on this rank's dp slice with its
  accumulators split on dim 0, all-gather of the parameter).
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
- `BuildStrategy.auto_parallel`: on the first prepare the planner
  (framework/auto_parallel.py) chooses the strategy and the mesh's
  factorization over this executor's ranks, which the executor adopts;
  `auto_plan_report`, `cost_report` and `memory_report` read it.

Waiting (each raises naming ROADMAP.md §1 item 4): the host-offloaded
optimizer state, the memory planner on the rewritten program
(`memory_plan`), and sequence-parallel program execution
(`enable_sequence_parallel` on a mesh with an sp axis; ring attention
itself is `ring_attention.py`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.enforce import InvalidArgumentError, enforce
from ..core.places import CPUPlace, CUDAPlace
from ..framework.executor import Executor, as_numpy
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

_WAIT = "{what} is not ported: ROADMAP.md §1 item 4 ({part})"


# ---------------------------------------------------------------------------
# global-batch lowerings (AllReduce / Reduce): reductions over the dp batch
# ---------------------------------------------------------------------------


def _batch_led(op, slot: str) -> bool:
    """Is input `slot` of `op` declared batch-led ([-1, ...])?"""
    names = op.inputs.get(slot) or ()
    if not names or not op.block.has_var(names[0]):
        return False
    shape = op.block.var(names[0]).shape
    return bool(shape) and shape[0] == -1


def _reduces_dim0(attrs, rank: int) -> bool:
    dim = attrs.get("dim")
    if attrs.get("reduce_all", False) or dim is None:
        return True
    dims = dim if isinstance(dim, (list, tuple)) else (dim,)
    return 0 in {int(d) % max(rank, 1) for d in dims}


def _psum(x):
    return C.all_reduce(x, DATA_AXIS)


def _global_mean(ctx, ins, attrs, lower):
    out = lower(ctx, ins, attrs)
    if not _batch_led(ctx.op, "X"):
        return out
    return {"Out": [_psum(out["Out"][0]) / C.axis_size(DATA_AXIS)]}


def _global_reduce(kind):
    def fn(ctx, ins, attrs, lower):
        out = lower(ctx, ins, attrs)
        x = ins["X"][0]
        if not (_batch_led(ctx.op, "X") and _reduces_dim0(attrs, x.dim())):
            return out
        y = out["Out"][0]
        if kind == "sum":
            return {"Out": [_psum(y)]}
        if kind == "mean":
            return {"Out": [_psum(y) / C.axis_size(DATA_AXIS)]}
        if kind in ("max", "min") and not y.requires_grad:
            import torch.distributed as dist
            group = C._group(DATA_AXIS)
            if group is None:
                return out
            op = dist.ReduceOp.MAX if kind == "max" else dist.ReduceOp.MIN
            return {"Out": [C._ar(y, group, op)]}
        raise NotImplementedError(_WAIT.format(
            what=f"reduce_{kind} over the data-parallel batch dim"
            + (" with a gradient" if kind in ("max", "min") else ""),
            part="multi-GPU parallelism"))
    return fn


def _global_accuracy(ctx, ins, attrs, lower):
    out = lower(ctx, ins, attrs)
    if not _batch_led(ctx.op, "Indices"):
        return out
    correct = _psum(out["Correct"][0].to(torch.float32))
    total = _psum(out["Total"][0].to(torch.float32))
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


def _global_batch_norm(ctx, ins, attrs, lower):
    group = C._group(DATA_AXIS)
    if (attrs.get("is_test", False) or ctx.is_test or group is None
            or not _batch_led(ctx.op, "X")):
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


def _refuse_over_batch(slot):
    def fn(ctx, ins, attrs, lower):
        if _batch_led(ctx.op, slot) and C.axis_size(DATA_AXIS) > 1:
            raise NotImplementedError(_WAIT.format(
                what=f"op {ctx.op.type!r} over a data-parallel batch "
                     f"(its statistics span every rank)",
                part="multi-GPU parallelism"))
        return lower(ctx, ins, attrs)
    return fn


#: ops whose result spans the batch dim, lowered over the whole dp batch
GLOBAL_BATCH_OPS = {
    "mean": _global_mean,
    "reduce_sum": _global_reduce("sum"),
    "reduce_mean": _global_reduce("mean"),
    "reduce_max": _global_reduce("max"),
    "reduce_min": _global_reduce("min"),
    "reduce_prod": _global_reduce("prod"),
    "accuracy": _global_accuracy,
    "batch_norm": _global_batch_norm,
    "auc": _refuse_over_batch("Predict"),
    "precision_recall": _refuse_over_batch("Indices"),
    "mean_iou": _refuse_over_batch("Predictions"),
    "chunk_eval": _refuse_over_batch("Inference"),
    "detection_map": _refuse_over_batch("DetectRes"),
}


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


def _allreduce_grads(env, names):
    """AllReduce mode: every gradient the region made, averaged over dp.
    A sparse embedding gradient's rows and values are gathered instead
    (each rank's rows, values scaled by 1/dp)."""
    dense = [n for n in names if isinstance(env.get(n), torch.Tensor)]
    for n, g in zip(dense, _flat_allreduce_mean([env[n] for n in dense],
                                                DATA_AXIS)):
        env[n] = g
    dp = C.axis_size(DATA_AXIS)
    for n in names:
        g = env.get(n)
        if isinstance(g, TracedSelectedRows):
            env[n] = TracedSelectedRows(
                C.all_gather(g.rows, DATA_AXIS, 0),
                C.all_gather(g.value, DATA_AXIS, 0) / dp, g.height)


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
        for field_, part in (("offload_optimizer_state",
                              "offload.HostOptimizerState"),
                             ("memory_plan", "the memory planner on the "
                              "rewritten program")):
            if getattr(bs, field_):
                raise NotImplementedError(_WAIT.format(
                    what=f"BuildStrategy.{field_}", part=part))
        if (bs.enable_sequence_parallel
                and self.mesh.axis_size(SEQUENCE_AXIS) > 1):
            raise NotImplementedError(_WAIT.format(
                what="sequence-parallel program execution (each rank's "
                     "sequence columns through every op)",
                part="multi-GPU parallelism"))

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

    def _gate_manual_mode(self, program: Program, what: str):
        """≙ the JAX package's gate: the explicit modes refuse parameters
        sharded over a non-tp axis, and tp-sharded ones the tp rewrite did
        not make executable. A split over an axis of size 1 is replicated
        (the JAX gate refuses it: its tp rewrite needs tp >= 2)."""
        from ..core import flags
        from ..framework.sharding import tp_component
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
           (possibly comm-rewritten) program."""
        if getattr(program, "_pp_applied", False):
            return program
        self._maybe_auto_plan(program)
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
                self._gate_manual_mode(program, "ParallelExecutor")
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
                or getattr(program, "_pp_applied", False)):
            return   # already-rewritten view: the decision was made
        batch = max((s[0] for s in self._feed_shapes.values()
                     if len(s) >= 1), default=8)
        key = (id(program), program._version, self.mesh.num_devices,
               int(batch))
        done = getattr(self, "_auto_plan_keys", None)
        if done is None:
            done = self._auto_plan_keys = set()
        if key in done:
            return
        from ..framework import auto_parallel as _auto
        if not getattr(self, "_auto_orig", None):
            self._auto_orig = (self.build_strategy, self.mesh)
        base = self._auto_orig[0]
        # the numerics-preserving space, memory plans left out: the port
        # runs none on a rewritten program yet (ROADMAP.md §1 item 4)
        space = _auto.numerics_preserving_space(base)
        space.memory_plan = (False,)
        result = _auto.plan(
            program, self.mesh.num_devices, nominal_batch=int(batch),
            strategy_base=base, space=space)
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
                if n in local:
                    continue
                place = self._state_sharding(program, n)
                if not place.is_replicated:
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

    def _local_feed(self, program, feed):
        """This rank's rows of every batch-led feed (the global batch is
        dp-divisible by now)."""
        i = self.mesh.axis_index(DATA_AXIS)
        out = {}
        for name, val in feed.items():
            if np.ndim(val) >= 1 and self._batch_led_feed(program, name):
                c = np.shape(val)[0] // self._dp
                val = val[i * c:(i + 1) * c]
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
            return {}
        extras = {"op_overrides": GLOBAL_BATCH_OPS}
        if not getattr(program, "_dp_comm_applied", False):
            extras["grad_allreduce"] = _allreduce_grads
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
        return self._finish(program, names, fetches, real_b, padded_b,
                            False, return_numpy)

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
        return self._finish(program, names, fetches, real_b, padded_b,
                            True, return_numpy)

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
        return {"predicted": report["memory"], "measured": census}
