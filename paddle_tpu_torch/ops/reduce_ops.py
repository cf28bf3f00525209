"""Reduction op lowerings.

≙ paddle_tpu/ops/reduce_ops.py, trimmed to `reduce_sum` / `_mean` /
`_max` / `_min` / `_prod`, `mean` (the training loss), `sum` (the n-ary
add a multi-input `fc` emits and the regularizers' grad + decay),
`arg_max` (the decode tick's greedy sample) and `arg_min`, `top_k` (the
classifiers' `accuracy`), `argsort`, `squared_l2_norm` (the global-norm
clip), `cos_sim`, `squared_l2_distance` and `norm`. Ties go to the lower
index everywhere, as in jax: argmax / argmin take the first extreme, and
argsort and top_k sort stably.
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op


def _dims(attrs):
    """The reduced dims, or None for all of them. An empty `dim` (with
    `reduce_all` off) is `axis=()` in the JAX package: nothing reduced."""
    dim = attrs.get("dim")
    if attrs.get("reduce_all", False) or dim is None:
        return None
    return tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)


def _prod(x, dim, keepdim):
    # torch.prod takes one dim at a time
    for d in sorted((d % x.dim() for d in dim), reverse=True):
        x = x.prod(dim=d, keepdim=keepdim)
    return x


def _reduce(fn, mean=False):
    """≙ the JAX package's `_reduce`: X reduced over `dim` (all dims when
    `reduce_all` or no dim), keeping them as size 1 when `keep_dim`. An
    integer X keeps its type, but for the mean, which is float32 (jnp's
    promotion with x64 off)."""
    def lower(ctx, ins, attrs):
        x = ins["X"][0]
        if mean and not x.is_floating_point():
            x = x.float()
        dims = _dims(attrs)
        keep = attrs.get("keep_dim", False)
        if dims == ():
            # torch reads dim=() as every dim: reduce a new size-1 dim
            # instead, which keeps fn's type rules
            out = fn(x.unsqueeze(0), (0,), False)
        else:
            out = fn(x, tuple(range(x.dim())) if dims is None else dims,
                     keep)
        if dims is None and not keep:
            out = out.reshape(())
        if not x.is_floating_point() and x.dtype != torch.bool:
            out = out.to(x.dtype)      # jnp keeps the integer width
        return {"Out": [out]}
    return lower


register_op("reduce_sum")(_reduce(
    lambda x, d, k: x.sum(dim=d, keepdim=k)))
register_op("reduce_mean")(_reduce(
    lambda x, d, k: x.mean(dim=d, keepdim=k), mean=True))
register_op("reduce_max")(_reduce(
    lambda x, d, k: x.amax(dim=d, keepdim=k)))
register_op("reduce_min")(_reduce(
    lambda x, d, k: x.amin(dim=d, keepdim=k)))
register_op("reduce_prod")(_reduce(_prod))


@register_op("mean")
def _mean(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [(x if x.is_floating_point() else x.float()).mean()]}


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


@register_op("arg_min")
def _arg_min(ctx, ins, attrs):
    # ties resolve to the first minimal index, as jnp.argmin
    return {"Out": [torch.argmin(ins["X"][0], dim=attrs.get("axis", -1))
                    .to(torch.int64)]}


@register_op("argsort")
def _argsort(ctx, ins, attrs):
    # jnp.argsort is stable: equal values keep their order
    vals, idx = torch.sort(ins["X"][0], dim=attrs.get("axis", -1),
                           stable=True)
    return {"Out": [vals], "Indices": [idx.to(torch.int64)]}


def top_k_lower_first(x, k):
    """≙ jax.lax.top_k over the last axis: values in descending order, the
    lower index first among equal values (torch.topk promises no order
    among ties, so a stable sort decides them). Returns (values, int64
    indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int64)


@register_op("top_k")
def _top_k(ctx, ins, attrs):
    vals, idx = top_k_lower_first(ins["X"][0], attrs["k"])
    return {"Out": [vals], "Indices": [idx]}


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    # Σ x², shape [1] (the global-norm clip sums these over parameters)
    return {"Out": [ins["X"][0].square().sum().reshape(1)]}


@register_op("cos_sim")
def _cos_sim(ctx, ins, attrs):
    # row-wise cosine over the last dim; Y may be one row, broadcast
    x, y = ins["X"][0], ins["Y"][0]
    xn = x.square().sum(dim=-1, keepdim=True).sqrt()
    yn = y.square().sum(dim=-1, keepdim=True).sqrt()
    out = (x * y).sum(dim=-1, keepdim=True) / torch.clamp_min(xn * yn, 1e-12)
    return {"Out": [out], "XNorm": [xn], "YNorm": [yn]}


@register_op("squared_l2_distance")
def _squared_l2_distance(ctx, ins, attrs):
    sub = ins["X"][0] - ins["Y"][0]
    return {"Out": [sub.square().sum(dim=-1, keepdim=True)],
            "sub_result": [sub]}


@register_op("norm")
def _norm(ctx, ins, attrs):
    x = ins["X"][0]
    norm = (x.square().sum(dim=attrs.get("axis", -1), keepdim=True)
            + attrs.get("epsilon", 1e-10)).sqrt()
    return {"Out": [x / norm], "Norm": [norm]}
