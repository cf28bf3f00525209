"""Elementwise / scale / compare / activation op lowerings.

≙ paddle_tpu/ops/elementwise.py (reference operators/elementwise_*.cc,
scale_op.cc, compare_op.cc, activation_op.cc), trimmed to the serving and
training slices, the recurrent models, gradient clipping and the
learning-rate schedules and the control-flow builders: elementwise
add/sub/mul/div/max/min/pow, the six comparisons, logical and/or/xor/not,
scale, clip, clip_by_norm, sign, pow and the unary relu, sigmoid, tanh,
exp, sqrt, ceil, floor, cos, reciprocal.
Dtype promotion follows torch, which agrees with jnp on the pairs the
slices meet (bfloat16 + float32 → float32).
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op


def _broadcast_y(x, y, axis):
    """Reference elementwise broadcast semantics: align y's dims to x starting
    at `axis` (reference operators/elementwise_op_function.h)."""
    if y.dim() == x.dim():
        return y
    if axis is None or axis == -1:
        return y  # trailing-aligned: torch broadcasting handles it
    # leading-aligned at `axis`: pad y with trailing singleton dims
    pad = x.dim() - axis - y.dim()
    return y.reshape(tuple(y.shape) + (1,) * pad)


def _binary(fn):
    def lower(ctx, ins, attrs):
        x, y = ins["X"][0], ins["Y"][0]
        if attrs.get("use_bf16", False) and x.dtype != y.dtype and \
                x.dtype == torch.bfloat16:
            # bias/residual add on the bf16 activation path: cast the fp32
            # side down instead of letting promotion lift the whole
            # activation tensor back to fp32
            y = y.to(x.dtype)
        y = _broadcast_y(x, y, attrs.get("axis", -1))
        return {"Out": [fn(x, y)]}
    return lower


register_op("elementwise_add")(_binary(torch.add))
register_op("elementwise_sub")(_binary(torch.sub))
register_op("elementwise_mul")(_binary(torch.mul))
register_op("elementwise_div")(_binary(torch.div))
register_op("elementwise_max")(_binary(torch.maximum))
register_op("elementwise_min")(_binary(torch.minimum))
register_op("elementwise_pow")(_binary(torch.pow))
register_op("less_than")(_binary(torch.lt))
register_op("less_equal")(_binary(torch.le))
register_op("greater_than")(_binary(torch.gt))
register_op("greater_equal")(_binary(torch.ge))
register_op("equal")(_binary(torch.eq))
register_op("not_equal")(_binary(torch.ne))
register_op("logical_and")(_binary(torch.logical_and))
register_op("logical_or")(_binary(torch.logical_or))
register_op("logical_xor")(_binary(torch.logical_xor))


@register_op("logical_not")
def _logical_not(ctx, ins, attrs):
    return {"Out": [torch.logical_not(ins["X"][0])]}


@register_op("scale")
def _scale(ctx, ins, attrs):
    # ≙ scale_op.cc: out = scale * x + bias, or scale * (x + bias)
    x = ins["X"][0]
    scale = attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * scale + bias]}
    return {"Out": [(x + bias) * scale]}


@register_op("clip")
def _clip(ctx, ins, attrs):
    return {"Out": [torch.clamp(ins["X"][0], attrs["min"], attrs["max"])]}


@register_op("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    # X scaled to L2 norm max_norm where its norm is larger
    x = ins["X"][0]
    max_norm = attrs["max_norm"]
    norm = x.square().sum().sqrt()
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp_min(norm, 1e-12),
                        torch.ones((), dtype=norm.dtype, device=x.device))
    return {"Out": [x * scale]}


@register_op("pow")
def _pow(ctx, ins, attrs):
    return {"Out": [torch.pow(ins["X"][0], attrs.get("factor", 1.0))]}


def _unary(fn):
    def lower(ctx, ins, attrs):
        return {"Out": [fn(ins["X"][0])]}
    return lower


for _name, _fn in (("relu", torch.relu), ("sigmoid", torch.sigmoid),
                   ("tanh", torch.tanh), ("exp", torch.exp),
                   ("sqrt", torch.sqrt), ("ceil", torch.ceil),
                   ("floor", torch.floor), ("cos", torch.cos),
                   ("reciprocal", torch.reciprocal)):
    register_op(_name)(_unary(_fn))


@register_op("sign")
def _sign(ctx, ins, attrs):
    # ≙ jnp.sign, which keeps NaN (torch.sign maps it to 0)
    x = ins["X"][0]
    return {"Out": [torch.where(torch.isnan(x), x, torch.sign(x))]}
