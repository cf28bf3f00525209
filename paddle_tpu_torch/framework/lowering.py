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
`<name>@GRAD` variables, so optimizer ops read them like any other.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Set

import torch
from torch.autograd.profiler import record_function

from ..core import flags
from ..core.enforce import EnforceError, NotFoundError
from .program import Block, Operator
from .registry import LowerCtx, lookup_op, register_op

GRAD_SUFFIX = "@GRAD"

_SPARSE_GRADS = ("sparse embedding gradients (SelectedRows) are not ported: "
                 "ROADMAP.md port queue item 1b (sparse embedding "
                 "gradients)")
_REMAT = ("rematerialization (remat / remat_segments) is not ported: "
          "ROADMAP.md port queue item 1b (remat and live-out narrowing)")
_LIVE_OUT = ("live-out narrowing of a vjp_region (live_out) is not ported: "
             "ROADMAP.md port queue item 1b (remat and live-out narrowing)")


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
    try:
        outs = opdef.lower(ctx, ins, op.attrs)
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


def build_plan(block: Block) -> List[Operator]:
    """The block's ops in execution order. Ops consumed by a vjp_region run
    inside it; the region runs at the position of its earliest forward op,
    so later consumers see the forward values. Regions sharing their first
    op keep program order."""
    regions: Dict[int, List[Operator]] = {}
    consumed: Set[int] = set()
    for op in block.ops:
        if op.type == "vjp_region" and op.attrs["fwd_ops"]:
            seg = op.attrs["fwd_ops"]
            regions.setdefault(min(seg), []).append(op)
            consumed |= set(seg)
    plan = []
    for i, op in enumerate(block.ops):
        plan.extend(regions.get(i, ()))
        if i in consumed or op.type == "vjp_region":
            continue
        plan.append(op)
    return plan


def run_plan(plan: List[Operator], env: Dict[str, Any], ctx: LowerCtx):
    for op in plan:
        if op.type == "vjp_region":
            run_vjp_region(op, env, ctx)
        else:
            run_op(op, env, ctx)
    return env


# Optimizer ops with a SelectedRows (sparse) apply branch in the JAX package
# — the only consumers for which it ships a sparse embedding gradient.
SPARSE_CAPABLE_OPT_OPS = frozenset({"sgd", "momentum", "adam"})


def _find_sparse_embedding_specs(seg_ops, target_names, env, block, ctx):
    """Params whose gradient the JAX package ships as (rows, values)
    instead of a dense [vocab, dim] array: an is_sparse lookup_table param,
    read exactly once in the segment, ids available before the region,
    every block-level consumer of its @GRAD a sparse-capable optimizer op,
    and the grad not fetched."""
    specs = []
    for op in seg_ops:
        if op.type != "lookup_table" or not op.attrs.get("is_sparse"):
            continue
        w = op.inputs["W"][0]
        gname = grad_var_name(w)
        if w not in target_names or gname in ctx.fetch_names:
            continue
        if op.inputs["Ids"][0] not in env:
            continue
        reads = sum(n == w for o in seg_ops
                    for ns in o.inputs.values() for n in ns)
        if reads != 1:
            continue
        consumers = [o.type for o in block.ops
                     if gname in {n for ns in o.inputs.values() for n in ns}]
        if not consumers or any(t not in SPARSE_CAPABLE_OPT_OPS
                                for t in consumers):
            continue
        specs.append(w)
    return specs


def run_vjp_region(region_op: Operator, env: Dict[str, Any], ctx: LowerCtx):
    """Run a forward segment with grad enabled and differentiate its loss
    (≙ append_backward's grad-op chain, reference backward.py:315-469).

    Each target is replaced by a detached alias of its tensor that
    requires grad — the scope's tensor itself never enters the graph. The
    loss gradient is seeded with ones (`loss@GRAD`); each target's gradient
    lands in `<name>@GRAD`, zeros where the loss does not reach it (as
    jax.vjp gives). The forward values come out detached."""
    attrs = region_op.attrs
    if attrs.get("remat") or attrs.get("remat_segments"):
        raise NotImplementedError(_REMAT)
    if attrs.get("live_out") is not None:
        raise NotImplementedError(_LIVE_OUT)
    block = region_op.block
    seg_ops = [block.ops[i] for i in attrs["fwd_ops"]]
    targets: Sequence[str] = attrs["targets"]
    loss_name: str = attrs["loss"]
    if _find_sparse_embedding_specs(seg_ops, targets, env, block, ctx):
        raise NotImplementedError(_SPARSE_GRADS)
    missing = [n for n in targets if n not in env]
    if missing:
        raise NotFoundError(
            f"vjp_region differentiates wrt {missing} which are not "
            f"initialized — run the startup program or feed them")
    leaves = [env[n].detach().requires_grad_() for n in targets]
    env2 = dict(env)
    env2.update(zip(targets, leaves))
    with torch.enable_grad():
        with record_function("vjp_region/forward"):
            for op in seg_ops:
                run_op(op, env2, ctx)
        loss = env2[loss_name]
        seed = torch.ones_like(loss)
        with record_function("vjp_region/backward"):
            grads = (torch.autograd.grad(loss, leaves, seed,
                                         allow_unused=True)
                     if loss.requires_grad else [None] * len(leaves))
    for op in seg_ops:
        for n in op.output_names():
            if n in env2:        # an optional output nobody reads is absent
                v = env2[n]
                # state a forward op updated in place (batch_norm's running
                # statistics) keeps its tensor: a bound step holds it
                env[n] = v.detach() if v.requires_grad else v
    env[grad_var_name(loss_name)] = seed.detach()
    for name, leaf, g in zip(targets, leaves, grads):
        env[grad_var_name(name)] = (torch.zeros_like(leaf.detach())
                                    if g is None else g)


@register_op("vjp_region")
def _vjp_region_stub(ctx, ins, attrs):
    # never lowered directly: build_plan / run_plan hand it to
    # run_vjp_region. Registered so Operator construction validates.
    raise RuntimeError("vjp_region must be executed via the block planner")
