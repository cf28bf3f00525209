"""Block → eager op-by-op execution, and autodiff regions on torch.autograd.

≙ paddle_tpu/framework/lowering.py. Where the JAX package traces the whole
block into one jax function for XLA to compile, the port interprets the
block eagerly: `build_plan` fixes the op order once, `run_plan` calls each
op's torch lowering in turn over a name → tensor environment. A
control-flow op (`static_rnn`) plans its sub-block the same way and runs
that plan per step (ops/control_ops.py).

A `vjp_region` op (appended by `backward.append_backward`) records a loss,
the forward ops that compute it and the variables to differentiate; it runs
at the position of its first forward op, through `run_vjp_region` on
torch.autograd where the JAX package uses jax.vjp. Gradients appear as
`<name>@GRAD` variables, so optimizer ops read them like any other; an
`is_sparse` embedding table's as a TracedSelectedRows. The region runs
under torch.utils.checkpoint where memory_optimize (remat) or the memory
planner (remat_segments) asked for it.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Sequence, Set

import torch
from torch.autograd.profiler import record_function
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core import flags
from ..core.dtypes import convert_dtype
from ..core.enforce import EnforceError, NotFoundError
from .program import Block, Operator
from .registry import LowerCtx, lookup_op, register_op
from .selected_rows import TracedSelectedRows

GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


def _gather_inputs(op: Operator, env: Dict[str, Any]) -> Dict[str, List[Any]]:
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if n not in env:
                raise NotFoundError(
                    f"op {op.type!r} reads variable {n!r} (slot {slot!r}) "
                    f"which is not initialized — run the startup program or "
                    f"feed it")
            vals.append(env[n])
        ins[slot] = vals
    return ins


def _scatter_outputs(op: Operator, outs: Dict[str, List[Any]],
                     env: Dict[str, Any]):
    check_nan = flags.get_flag("check_nan_inf")
    block = op.block
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        for n, v in zip(names, vals):
            if v is None:
                continue
            if v.requires_grad and block.has_var(n):
                # a non-persistable stop_gradient variable is cut from the
                # graph (≙ jax.lax.stop_gradient in the JAX package)
                var = block.var(n)
                if var.stop_gradient and not var.persistable:
                    v = v.detach()
            if (check_nan and v.is_floating_point()
                    and not bool(torch.isfinite(v).all())):
                raise FloatingPointError(
                    f"NaN/Inf detected in output {n!r} of op {op.type!r}")
            env[n] = v


def run_op(op: Operator, env: Dict[str, Any], ctx: LowerCtx):
    opdef = lookup_op(op.type)
    ins = _gather_inputs(op, env)
    ctx.op = op
    # a run may lower some ops its own way (ParallelExecutor: reductions
    # over the data-parallel batch span every rank); the override gets
    # the op's own lowering to build on
    override = ctx.extras.get("op_overrides", {}).get(op.type)
    try:
        outs = (override(ctx, ins, op.attrs, opdef.lower)
                if override is not None
                else opdef.lower(ctx, ins, op.attrs))
    except (EnforceError, NotImplementedError):
        raise
    except Exception as e:  # re-raise with op context, keep traceback
        raise type(e)(f"[while lowering op {op.type!r} "
                      f"{op.inputs} -> {op.outputs}] {e}") from e
    finally:
        ctx.op = None
    _scatter_outputs(op, outs or {}, env)


def _ancestor_op_indices(block: Block, upto: int, roots: Set[str]) -> List[int]:
    """Indices (< upto) of ops needed to compute vars in `roots`
    (≙ _find_op_path_, reference python/paddle/fluid/backward.py:645)."""
    needed = set(roots)
    keep = []
    for i in range(upto - 1, -1, -1):
        op = block.ops[i]
        if needed & set(op.output_names()):
            keep.append(i)
            needed |= set(op.input_names())
    keep.reverse()
    return keep


#: region op types beside `vjp_region` -> runner(region_op, env, ctx):
#: parallel/pipeline.py registers `pp_pipeline_region` on import.
REGION_RUNNERS: Dict[str, Any] = {}


def build_plan(block: Block) -> List[Operator]:
    """The block's ops in execution order. Ops consumed by a region
    (`vjp_region`, or a pipeline's `pp_pipeline_region` with its stages'
    ops and boundary markers) run inside it; the region runs at the
    position of its earliest forward op, so later consumers see the
    forward values. Regions sharing their first op keep program order."""
    regions: Dict[int, List[Operator]] = {}
    consumed: Set[int] = set()
    for op in block.ops:
        if op.type in _REGION_TYPES and op.attrs["fwd_ops"]:
            seg = op.attrs["fwd_ops"]
            regions.setdefault(min(seg), []).append(op)
            consumed |= set(seg)
    plan = []
    for i, op in enumerate(block.ops):
        plan.extend(regions.get(i, ()))
        if i in consumed or op.type in _REGION_TYPES:
            continue
        plan.append(op)
    return plan


_REGION_TYPES = ("vjp_region", "pp_pipeline_region")


def run_plan(plan: List[Operator], env: Dict[str, Any], ctx: LowerCtx,
             release=None):
    """Run the plan's ops over `env`. `release` (executor.py
    `_release_schedule`): for each op, the names to drop from `env` after
    it, each at its last use, so the caching allocator reuses their blocks
    for the next var of the same size. Sub-blocks pass none: their envs
    die with their op."""
    for i, op in enumerate(plan):
        if op.type == "vjp_region":
            run_vjp_region(op, env, ctx)
        elif op.type in _REGION_TYPES:
            if op.type not in REGION_RUNNERS:
                # the engine registers on import of parallel/pipeline.py
                from ..parallel import pipeline  # noqa: F401
            REGION_RUNNERS[op.type](op, env, ctx)
        else:
            run_op(op, env, ctx)
        if release is not None:
            for n in release[i]:
                env.pop(n, None)
    return env


# Optimizer ops with a SelectedRows (sparse) apply branch — the only
# consumers of a sparse embedding gradient (≙ the reference's SelectedRows
# optimizer kernels, adam_op.h / math/selected_rows_functor.cc).
SPARSE_CAPABLE_OPT_OPS = frozenset({"sgd", "momentum", "adam"})


def _find_sparse_embedding_specs(seg_ops, target_names, env, block, ctx):
    """Params whose gradient can ship as (rows, values) instead of a dense
    [vocab, dim] tensor: an is_sparse lookup_table param, read exactly once
    in the segment, ids available before the region, every block-level
    consumer of its @GRAD a sparse-capable optimizer op, and the grad not
    fetched. Returns (param, lookup output, ids, padding_idx) for each."""
    specs = []
    for op in seg_ops:
        if op.type != "lookup_table" or not op.attrs.get("is_sparse"):
            continue
        w = op.inputs["W"][0]
        gname = grad_var_name(w)
        if w not in target_names or gname in ctx.fetch_names:
            continue
        ids_name = op.inputs["Ids"][0]
        if ids_name not in env:
            continue      # ids computed inside the region: dense
        reads = sum(n == w for o in seg_ops
                    for ns in o.inputs.values() for n in ns)
        if reads != 1:
            continue      # the table read elsewhere: grads would be partial
        consumers = [o.type for o in block.ops
                     if gname in {n for ns in o.inputs.values() for n in ns}]
        if not consumers or any(t not in SPARSE_CAPABLE_OPT_OPS
                                for t in consumers):
            continue
        specs.append((w, op.outputs["Out"][0], ids_name,
                      op.attrs.get("padding_idx", None)))
    return specs


def remat_boundaries(seg_op_lists, out_need: Set[str]):
    """Per-segment carried-out name lists for a segmented-remat region
    (≙ the JAX package's, which its memory planner shares): segment i's
    boundary is the names produced at or before segment i that a LATER
    segment reads, or that the region must publish (`out_need`: the
    narrowed live-out set plus the loss). Everything else a segment
    produces is recomputed from its boundary input in the backward."""
    reads_after = []
    acc: Set[str] = set()
    for ops in reversed(seg_op_lists):
        reads_after.insert(0, set(acc))
        for op in ops:
            acc |= set(op.input_names())
    boundaries = []
    avail: Set[str] = set()
    for i, ops in enumerate(seg_op_lists):
        for op in ops:
            avail |= set(op.output_names())
        boundaries.append(sorted((reads_after[i] | out_need) & avail))
    return boundaries


_ATEN = torch.ops.aten
# jax.checkpoint_policies names the JAX package writes into `remat_policy`
# (memory_optimize level 0, the memory planner) -> the aten ops whose
# outputs the forward keeps; everything else is recomputed. K1's
# launch sits inside an autograd.Function that no policy sees, so it is
# recomputed under each, as jax.checkpoint recomputes the Pallas call.
_SAVEABLE = {
    "dots_with_no_batch_dims_saveable": (_ATEN.mm.default,
                                         _ATEN.addmm.default),
    "dots_saveable": (_ATEN.mm.default, _ATEN.addmm.default,
                      _ATEN.bmm.default, _ATEN.baddbmm.default),
}


def _checkpointed(fn, ctx: LowerCtx, policy_name):
    """`fn` (no arguments; it closes over its inputs) under
    torch.utils.checkpoint, non-reentrant: the forward keeps only what
    `policy_name` saves and autograd's backward runs `fn` again for the
    rest (≙ jax.checkpoint). Two things jax.checkpoint gets for free:

    - the recompute draws what the forward drew. Dropout draws from the
      run's own generator (`LowerCtx.generator`), which checkpoint's
      preserve_rng_state does not stash: its state is set back to the
      forward's for the recompute, and to where it was after;
    - persistable state moves once a step. Under `ctx.recomputing` a
      lowering skips its state update; `ctx.update_state` defers the
      forward's own until after the backward."""
    gen = ctx.generator()
    drawn_from = gen.get_state()
    calls = [0]

    def run():
        calls[0] += 1
        if calls[0] == 1:
            return fn()
        resume = gen.get_state()
        gen.set_state(drawn_from)
        ctx.recomputing = True
        try:
            return fn()
        finally:
            ctx.recomputing = False
            gen.set_state(resume)

    kw = {}
    if policy_name is not None:
        if policy_name not in _SAVEABLE:
            raise NotImplementedError(
                f"remat_policy {policy_name!r}: the port maps "
                f"{sorted(_SAVEABLE)} (and none: recompute everything)")
        saved = _SAVEABLE[policy_name]

        def policy(_ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op in saved
                    else CheckpointPolicy.PREFER_RECOMPUTE)
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return checkpoint(run, use_reentrant=False, preserve_rng_state=False,
                      **kw)


def _published(attrs, seg_ops, ctx):
    """The forward names the region writes into the environment: all it
    produces, or, where memory_optimize narrowed it (`live_out`), that set
    plus this run's fetches (liveness cannot see fetch lists)."""
    produced: List[str] = []
    for op in seg_ops:
        for n in op.output_names():
            if n not in produced:
                produced.append(n)
    live_out = attrs.get("live_out")
    if live_out is not None:
        live = set(live_out) | set(ctx.fetch_names)
        produced = [n for n in produced if n in live]
    return produced


def _var_bytes(block, name) -> int:
    """A variable's bytes per example (a -1 dim counts as 1)."""
    if not block.has_var(name):
        return 0
    v = block.var(name)
    n = 1
    for d in v.shape or ():
        n *= abs(d)
    return n * convert_dtype(v.dtype).itemsize


def _remat_cuts(seg_indices, block, out_need):
    """Segments for a `remat` region the memory planner did not segment:
    about sqrt(n) of its n ops each, every cut at the cheapest point near
    its even share (the fewest bytes of region-made values a later
    segment reads: in a Transformer, the residual stream between two
    sub-layers). Eager torch recomputes a checkpoint's whole forward at
    its first unpack in the backward, so one checkpoint over the region
    would hold every recomputed activation at once and save nothing at
    the peak (PERF.md §6); segments bring the peak down to the carried
    boundaries plus one segment's activations, as jax.checkpoint's
    recompute, scheduled by XLA, does for the JAX package."""
    ops = [block.ops[i] for i in seg_indices]
    n = len(ops)
    k = max(1, round(math.sqrt(n)))
    if k == 1:
        return [list(seg_indices)]
    reads_after = [set() for _ in range(n + 1)]
    acc = set(out_need)
    for j in range(n - 1, -1, -1):
        acc |= set(ops[j].input_names())
        reads_after[j] = set(acc)
    cost, made = [0] * n, set()
    for j in range(1, n):
        made |= set(ops[j - 1].output_names())
        cost[j] = sum(_var_bytes(block, m) for m in made & reads_after[j])
    cuts, half = [], n / (2 * k)
    for t in range(1, k):
        ideal = t * n / k
        lo = max(int(ideal - half), (cuts[-1] if cuts else 0) + 1)
        hi = min(int(ideal + half), n - 1)
        if lo <= hi:
            cuts.append(min(range(lo, hi + 1),
                            key=lambda j: (cost[j], abs(j - ideal))))
    edges = [0] + cuts + [n]
    return [list(seg_indices[a:b]) for a, b in zip(edges, edges[1:])]


def _segmented_forward(region_op, segments, base, ctx, produced):
    """The forward as a chain of checkpointed segment functions: segment i
    carries out only its `remat_boundaries`, and the backward recomputes
    segment i's other activations from its carried input. The segments
    are the memory planner's `remat_segments`, or `_remat_cuts`'.
    `remat_prevent_cse` has no effect here: eager torch has no
    common-subexpression pass to undo a recompute. Returns the last
    segment's carried values by name."""
    attrs = region_op.attrs
    block = region_op.block
    seg_op_lists = [[block.ops[i] for i in seg] for seg in segments]
    # at run time, not plan time: this run's fetches are carried out of
    # the segment that makes them
    boundaries = remat_boundaries(seg_op_lists,
                                  set(produced) | {attrs["loss"]})
    carried: Dict[str, Any] = {}
    for ops, bn in zip(seg_op_lists, boundaries):
        def seg_fn(_ops=ops, _carried=carried, _bn=bn):
            e = dict(base)
            e.update(_carried)
            for op in _ops:
                run_op(op, e, ctx)
            return {n: e[n] for n in _bn if n in e}
        carried = _checkpointed(seg_fn, ctx, attrs.get("remat_policy"))
    return carried


def run_vjp_region(region_op: Operator, env: Dict[str, Any], ctx: LowerCtx):
    """Run a forward segment with grad enabled and differentiate its loss
    (≙ append_backward's grad-op chain, reference backward.py:315-469).

    Each dense target is replaced by a detached alias of its tensor that
    requires grad — the scope's tensor itself never enters the graph. The
    loss gradient is seeded with ones (`loss@GRAD`); each target's gradient
    lands in `<name>@GRAD`, zeros where the loss does not reach it (as
    jax.vjp gives). The forward values come out detached.

    - Sparse embedding tables (`_find_sparse_embedding_specs`): the
      gradient is taken with respect to a zero tensor added to the lookup's
      output, whose gradient IS the per-row values; the table takes no
      [vocab, dim] gradient, and its @GRAD is a TracedSelectedRows of the
      ids and those values (padding_idx rows zeroed).
    - `remat` (transpiler.memory_optimize) and `remat_segments` (the
      memory planner): the forward runs as one checkpointed function per
      segment (`_checkpointed`, torch.utils.checkpoint with
      `remat_policy`), the planner's segments or `_remat_cuts`'. A region
      with a sparse table runs un-segmented under one checkpoint, as the
      JAX package keeps it un-segmented.
    - `live_out` narrows what the region publishes (`_published`)."""
    attrs = region_op.attrs
    block = region_op.block
    seg_indices = attrs["fwd_ops"]
    seg_ops = [block.ops[i] for i in seg_indices]
    targets: Sequence[str] = attrs["targets"]
    loss_name: str = attrs["loss"]
    produced = _published(attrs, seg_ops, ctx)
    specs = _find_sparse_embedding_specs(seg_ops, targets, env, block, ctx)
    segments = attrs.get("remat_segments")
    has_sparse = any(op.type == "lookup_table" and op.attrs.get("is_sparse")
                     for op in seg_ops)
    if not (segments and sorted(i for s in segments for i in s)
            == sorted(seg_indices)):
        segments = None
    remat = bool(segments) or bool(attrs.get("remat"))
    if remat and not segments and not has_sparse:
        key = ("remat_cuts", id(region_op), tuple(produced))
        segments = ctx.constants.get(key)
        if segments is None:
            segments = ctx.constants[key] = _remat_cuts(
                seg_indices, block, set(produced) | {loss_name})
    segmented = bool(segments) and not has_sparse
    sparse = {w for w, _, _, _ in specs}
    dense = [n for n in targets if n not in sparse]
    missing = [n for n in dense if n not in env]
    if missing:
        raise NotFoundError(
            f"vjp_region differentiates wrt {missing} which are not "
            f"initialized — run the startup program or feed them")
    leaves = [env[n].detach().requires_grad_() for n in dense]
    perturbs, perturb_of = [], {}
    for w, out, ids_name, _ in specs:
        ids = env[ids_name]
        if ids.dim() >= 2 and ids.shape[-1] == 1:
            ids = ids.squeeze(-1)
        perturb_of[out] = len(perturbs)
        perturbs.append(torch.zeros(tuple(ids.shape) + (env[w].shape[1],),
                                    dtype=env[w].dtype, device=env[w].device,
                                    requires_grad=True))
    base = dict(env)
    base.update(zip(dense, leaves))

    def forward():
        e = dict(base)
        for op in seg_ops:
            run_op(op, e, ctx)
            for n in op.output_names():
                i = perturb_of.get(n)
                if i is not None:
                    e[n] = e[n] + perturbs[i]
        return {n: e[n] for n in [loss_name] + produced if n in e}

    if remat:
        ctx.deferred = []
    try:
        with torch.enable_grad():
            with record_function("vjp_region/forward"):
                if segmented:
                    out = _segmented_forward(region_op, segments, base, ctx,
                                             produced)
                elif remat:
                    out = _checkpointed(forward, ctx,
                                        attrs.get("remat_policy"))
                else:
                    out = forward()
            loss = out[loss_name]
            seed = torch.ones_like(loss)
            wrt = leaves + perturbs
            with record_function("vjp_region/backward"):
                grads = (torch.autograd.grad(loss, wrt, seed,
                                             allow_unused=True)
                         if loss.requires_grad else [None] * len(wrt))
        for fn in ctx.deferred or ():
            fn()
    finally:
        ctx.deferred = None
    for n in produced:
        if n in out:       # an optional output nobody reads is absent
            v = out[n]
            # state a forward op updated in place (batch_norm's running
            # statistics) keeps its tensor: a bound step holds it
            env[n] = v.detach() if v.requires_grad else v
    env[grad_var_name(loss_name)] = seed.detach()
    for name, leaf, g in zip(dense, leaves, grads):
        env[grad_var_name(name)] = (torch.zeros_like(leaf.detach())
                                    if g is None else g)
    for (w, _, ids_name, padding_idx), pert, g in zip(
            specs, perturbs, grads[len(leaves):]):
        height = env[w].shape[0]
        ids = env[ids_name]
        rows = ids.reshape(-1).to(torch.long)
        vals = (torch.zeros_like(pert) if g is None else g).reshape(
            rows.shape[0], -1)
        if padding_idx is not None:
            pad = padding_idx if padding_idx >= 0 else padding_idx + height
            vals = vals * (rows != pad)[:, None].to(vals.dtype)
        env[grad_var_name(w)] = TracedSelectedRows(rows, vals, height)
    # a data-parallel run reduces the gradients over its ranks here, where
    # they leave the region (ParallelExecutor's AllReduce mode)
    reduce_grads = ctx.extras.get("grad_allreduce")
    if reduce_grads is not None:
        reduce_grads(env, [grad_var_name(n) for n in targets])


@register_op("vjp_region")
def _vjp_region_stub(ctx, ins, attrs):
    # never lowered directly: build_plan / run_plan hand it to
    # run_vjp_region. Registered so Operator construction validates.
    raise RuntimeError("vjp_region must be executed via the block planner")
