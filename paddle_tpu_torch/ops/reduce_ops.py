"""Reduction op lowerings.

≙ paddle_tpu/ops/reduce_ops.py, trimmed to `reduce_sum`, `mean` (the
training loss), `sum` (the n-ary add a multi-input `fc` emits), `arg_max`
(the decode tick's greedy sample) and `top_k` (the classifiers'
`accuracy`).
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op


@register_op("reduce_sum")
def _reduce_sum(ctx, ins, attrs):
    x = ins["X"][0]
    dim = attrs.get("dim")
    keep = attrs.get("keep_dim", False)
    if attrs.get("reduce_all", False) or dim is None:
        out = x.sum()
        if keep:
            out = out.reshape((1,) * x.dim())
    else:
        out = x.sum(dim=tuple(dim) if isinstance(dim, (list, tuple))
                    else (dim,), keepdim=keep)
    if not x.is_floating_point() and x.dtype != torch.bool:
        out = out.to(x.dtype)      # jnp keeps the integer width
    return {"Out": [out]}


@register_op("mean")
def _mean(ctx, ins, attrs):
    return {"Out": [ins["X"][0].mean()]}


@register_op("sum")
def _sum(ctx, ins, attrs):
    # ≙ sum_op.cc: add_n over the inputs, in order
    out = ins["X"][0]
    for x in ins["X"][1:]:
        out = out + x
    return {"Out": [out]}


@register_op("arg_max")
def _arg_max(ctx, ins, attrs):
    # ties resolve to the first maximal index, as jnp.argmax
    return {"Out": [torch.argmax(ins["X"][0], dim=attrs.get("axis", -1))
                    .to(torch.int64)]}


@register_op("top_k")
def _top_k(ctx, ins, attrs):
    # ≙ jax.lax.top_k over the last axis: values in descending order, the
    # lower index first among equal values (torch.topk promises no order
    # among ties, so a stable sort decides them)
    vals, idx = torch.sort(ins["X"][0], dim=-1, descending=True, stable=True)
    k = attrs["k"]
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k].to(torch.int64)]}
