"""Block → eager op-by-op execution.

≙ paddle_tpu/framework/lowering.py. Where the JAX package traces the whole
block into one jax function for XLA to compile, the port interprets the
block eagerly: `build_plan` fixes the op order once, `run_plan` calls each
op's torch lowering in turn over a name → tensor environment.

Autodiff regions (`vjp_region`, appended by `append_backward`) belong to the
training slice (ROADMAP.md, "Modules still to port", item 3) and raise
NotImplementedError here.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..core import flags
from ..core.enforce import EnforceError, NotFoundError
from .program import Block, Operator
from .registry import LowerCtx, lookup_op, register_op

_TRAINING_SLICE = ("autodiff (vjp_region) is not ported yet: it belongs to "
                   "the training slice, ROADMAP.md 'Modules still to port' "
                   "item 3 (Transformer LM train step)")


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
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        for n, v in zip(names, vals):
            if v is None:
                continue
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


def build_plan(block: Block) -> List[Operator]:
    """The block's ops in execution order. Raises on autodiff regions."""
    for op in block.ops:
        if op.type == "vjp_region":
            raise NotImplementedError(_TRAINING_SLICE)
    return list(block.ops)


def run_plan(plan: List[Operator], env: Dict[str, Any], ctx: LowerCtx):
    for op in plan:
        run_op(op, env, ctx)
    return env


@register_op("vjp_region")
def _vjp_region_stub(ctx, ins, attrs):
    # registered so a serialized training program loads (Operator
    # construction validates the type); running it is the training slice
    raise NotImplementedError(_TRAINING_SLICE)
